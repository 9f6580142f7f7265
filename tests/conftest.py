"""Test configuration: an 8-device virtual CPU mesh by default.

The backend comes from JAX_PLATFORMS, set to the CPU only when nothing
else is set, so the `gpu`-marked tests can run on a card with
JAX_PLATFORMS=cuda (chip_smoke.py does).  Whether a card is present is
decided inside the `gpu_device` fixture, never at import: every xdist
worker must collect the same tests.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# keep the JAX bp kernels (the device production path) under test: on
# the CPU backend _kernels would otherwise auto-select the native C
# replicas.  The native path is covered by tests/test_native_bp.py,
# which overrides this per-test.
os.environ.setdefault("DAMAR_BP", "jax")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one; run "
        "on the card by chip_smoke.py)")


@pytest.fixture
def gpu_device(request):
    """The first GPU device; skips the test where JAX has none."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (JAX finds none)")
    return devs[0]


@pytest.fixture
def rng(request):
    """Per-test deterministic rng: a session-scoped generator made
    test outcomes depend on execution ORDER (different state depending
    on which tests ran before).  Seeding from the test id makes every
    test reproducible in isolation and in any selection."""
    import zlib
    seed = zlib.crc32(request.node.nodeid.encode()) & 0xFFFFFFFF
    return np.random.default_rng(seed)


@pytest.fixture(scope="session")
def small_sim():
    """A small simulated dataset shared across tests: 50 kb genome,
    ~12x coverage, 14% error."""
    from damar_tpu.utils.sim import make_genome, sample_reads
    g = make_genome(50_000, seed=7)
    return sample_reads(g, coverage=12.0, mean_len=4000, err=0.14, seed=8)
