"""GPU bp kernels (ops.wave_bp_gpu) vs the plain-JAX bp kernels: the
outputs must be BIT-IDENTICAL, so the platform can never change
results.  On the CPU the kernels run in the Pallas interpreter
(interpret=True); the `gpu`-marked tests compile them for the card.
Also covers the wrapper's padding and packed/with_active forms, the
platform's kernel choice, and the compile-cache and native-library
keys."""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from damar_tpu.ops.wave_bp import (_pack_bases, extend_wave_bp,
                                   trace_wave_bp)
from damar_tpu.ops.wave_bp_gpu import extend_wave_bp_gpu, trace_wave_bp_gpu
from damar_tpu.utils.sim import mutate, read_pair_units
from test_native_bp import _unit_batch

EXT_KW = dict(R=128, max_rows=65536, diff_cost=5, xdrop=60)


def _assert_same(ref, out, names, msg=""):
    for n, x, y in zip(names, ref, out):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{n} {msg}")


def _ext_args(seed, S=48):
    rng = np.random.default_rng(seed)
    A, B, ao, bo, alim, blim, rv = _unit_batch(rng, S)
    return tuple(jnp.asarray(x) for x in (A, B, ao, bo, alim, blim)), \
        jnp.asarray(rv)


def _trace_args(seed, S=32):
    rng = np.random.default_rng(seed)
    A, B, ao, bo, alim, blim, _ = _unit_batch(rng, S)
    alim = np.minimum(alim, len(A) - ao).astype(np.int32)
    blim = np.minimum(blim, len(B) - bo).astype(np.int32)
    z = np.zeros(len(ao), np.int32)
    return tuple(jnp.asarray(x) for x in (A, B, ao, bo, z, z, alim, blim))


class TestExtendBitIdentity:
    @pytest.mark.parametrize("seed", [5, 6, 7])
    def test_fuzz_batches(self, seed):
        args, rv = _ext_args(seed)
        ref = extend_wave_bp(*args, dirs=rv, **EXT_KW)
        out = extend_wave_bp_gpu(*args, dirs=rv, interpret=True, **EXT_KW)
        _assert_same(ref, out, "va vb d s".split(), f"s{seed}")

    def test_static_reverse_and_small_batch(self):
        rng = np.random.default_rng(13)
        src = rng.integers(0, 4, 2000).astype(np.uint8)
        der = mutate(src, 0.13, rng)
        S = 3                     # far below one seed block
        ao = jnp.full(S, 1000, jnp.int32)
        bo = jnp.full(S, 1005, jnp.int32)
        al = jnp.array([1000, 500, 0], jnp.int32)
        bl = jnp.full(S, 1005, jnp.int32)
        a = (jnp.asarray(src), jnp.asarray(der), ao, bo, al, bl)
        for rev in (False, True):
            ref = extend_wave_bp(*a, reverse=rev)
            out = extend_wave_bp_gpu(*a, reverse=rev, interpret=True)
            _assert_same(ref, out, "va vb d s".split(), f"rev={rev}")

    @pytest.mark.parametrize("S", [48, 130])
    def test_block_padding(self, S):
        """S below one seed block, and one past a block multiple: the
        wrapper pads with dead seeds and slices them off."""
        args, rv = _ext_args(21, S=S)
        ref = extend_wave_bp(*args, dirs=rv, **EXT_KW)
        out = extend_wave_bp_gpu(*args, dirs=rv, interpret=True, **EXT_KW)
        assert out[0].shape == (S,)
        _assert_same(ref, out, "va vb d s".split(), f"S={S}")

    def test_packed_words_form(self):
        args, rv = _ext_args(22)
        ref = extend_wave_bp_gpu(*args, dirs=rv, interpret=True, **EXT_KW)
        packed = (_pack_bases(args[0]), _pack_bases(args[1])) + args[2:]
        out = extend_wave_bp_gpu(*packed, dirs=rv, packed=True,
                                 interpret=True, **EXT_KW)
        _assert_same(ref, out, "va vb d s".split())

    def test_with_active_two_phase(self):
        """Phase-1 depth with the active mask: equal to the plain
        kernel's, and False wherever the unit already finished."""
        args, rv = _ext_args(23)
        kw = dict(EXT_KW, max_rows=256, with_active=True)
        ref = extend_wave_bp(*args, dirs=rv, **kw)
        out = extend_wave_bp_gpu(*args, dirs=rv, interpret=True, **kw)
        assert len(out) == 5 and out[4].dtype == jnp.bool_
        _assert_same(ref, out, "va vb d s active".split())


class TestTraceBitIdentity:
    @pytest.mark.parametrize("seed", [8, 9])
    def test_fuzz_batches(self, seed):
        args = _trace_args(seed)
        ref = trace_wave_bp(*args, tspace=100, max_segs=32)
        out = trace_wave_bp_gpu(*args, tspace=100, max_segs=32,
                                interpret=True)
        _assert_same(ref, out, ("trace", "nseg", "dsum"), f"s{seed}")

    @pytest.mark.parametrize("tspace", [100, 126, 250])
    def test_odd_tspace_and_offsets(self, tspace):
        rng = np.random.default_rng(11)
        src = rng.integers(0, 4, 3000).astype(np.uint8)
        der = mutate(src, 0.12, rng)
        ab = jnp.array([137], jnp.int32)
        bb = jnp.array([140], jnp.int32)
        alim = jnp.array([2500], jnp.int32)
        blim = jnp.array([len(der) - 140], jnp.int32)
        z = jnp.zeros(1, jnp.int32)
        args = (jnp.asarray(src), jnp.asarray(der), z, z, ab, bb, alim,
                blim)
        ref = trace_wave_bp(*args, tspace=tspace, max_segs=40)
        out = trace_wave_bp_gpu(*args, tspace=tspace, max_segs=40,
                                interpret=True)
        _assert_same(ref, out, ("trace", "nseg", "dsum"), f"ts{tspace}")

    def test_packed_words_form(self):
        args = _trace_args(24, S=20)
        ref = trace_wave_bp(*args, tspace=100, max_segs=32)
        packed = (_pack_bases(args[0]), _pack_bases(args[1])) + args[2:]
        out = trace_wave_bp_gpu(*packed, tspace=100, max_segs=32,
                                packed=True, interpret=True)
        assert out[0].shape == (20, 32, 2)
        _assert_same(ref, out, ("trace", "nseg", "dsum"))


def test_read_pair_units_layout():
    u = read_pair_units(4, 10, min_len=500, max_len=800, err=0.1, seed=3)
    assert len(u["aorigin"]) == 10 and u["rev"].sum() == 5
    # forward units start at a pair's first base, reverse ones at its end
    fwd, rev = ~u["rev"], u["rev"]
    np.testing.assert_array_equal(u["aorigin"][fwd], u["astart"][fwd])
    np.testing.assert_array_equal(u["aorigin"][rev],
                                  u["astart"][rev] + u["alim"][rev])
    assert (u["alim"] >= 400).all() and u["A"].dtype == np.uint8


# --- platform kernel choice --------------------------------------------------

def _kernel_names(monkeypatch, backend, bp=None, dp_kernel="bp"):
    from damar_tpu.core.config import OverlapConfig
    from damar_tpu.pipeline import overlap
    monkeypatch.setattr(overlap.jax, "default_backend", lambda: backend)
    if bp is None:
        monkeypatch.delenv("DAMAR_BP", raising=False)
    else:
        monkeypatch.setenv("DAMAR_BP", bp)
    ext, tr = overlap._kernels(OverlapConfig(dp_kernel=dp_kernel))
    ext = getattr(ext, "func", ext)
    return ext.__module__ + "." + ext.__name__, tr.__name__


@pytest.mark.parametrize("backend,bp,want", [
    ("gpu", None, ("damar_tpu.ops.wave_bp_gpu.extend_wave_bp_gpu",
                   "trace_wave_bp_gpu")),
    ("gpu", "jax", ("damar_tpu.ops.wave_bp.extend_wave_bp",
                    "trace_wave_bp")),
    ("cpu", "jax", ("damar_tpu.ops.wave_bp.extend_wave_bp",
                    "trace_wave_bp")),
    ("cpu", "native", ("damar_tpu.pipeline.overlap._native_bp_extend",
                       "_native_bp_trace")),
])
def test_kernel_choice(monkeypatch, backend, bp, want):
    assert _kernel_names(monkeypatch, backend, bp) == want


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_wide_kernel_choice_is_platform_free(monkeypatch, backend):
    from damar_tpu.core.config import OverlapConfig
    from damar_tpu.pipeline import overlap
    assert _kernel_names(monkeypatch, backend, "jax", "wide") == (
        "damar_tpu.ops.wave.extend_wave", "trace_wave")
    # the wide retry tier is the host C DP on every platform
    assert overlap._wide_trace_kernel(OverlapConfig()) is \
        overlap._native_wide_trace


@pytest.mark.parametrize("backend,want", [
    ("gpu", "extend_wave_bp_gpu"), ("cpu", "extend_wave_bp")])
def test_mesh_kernel_choice(monkeypatch, backend, want):
    from damar_tpu.parallel import distributed
    monkeypatch.setattr(distributed.jax, "default_backend",
                        lambda: backend)
    ext, _ = distributed._mesh_kernels()
    assert ext.__name__ == want


def test_gpu_selection_overlap_equals_xla(monkeypatch, small_sim):
    """The whole pair driver with the GPU kernel choice (kernels run
    interpreted here) emits the same .las records as XLA's plain
    kernels."""
    from damar_tpu.core.blocks import block_from_reads
    from damar_tpu.core.config import OverlapConfig
    from damar_tpu.ops import wave_bp_gpu
    from damar_tpu.pipeline import overlap
    blk = block_from_reads(small_sim.reads[:40])
    cfg = OverlapConfig(seed_batch_dev=2048)
    kw = dict(self_block=True, hit_cap=1 << 20, seed_cap=1 << 15,
              emit_mirrors=False)
    monkeypatch.setenv("DAMAR_BP", "jax")
    ref, _, _ = overlap.overlap_block_pair(blk, blk, cfg, **kw)
    blk.cache.clear()
    monkeypatch.delenv("DAMAR_BP")
    monkeypatch.setattr(overlap.jax, "default_backend", lambda: "gpu")
    for name in ("extend_wave_bp_gpu", "trace_wave_bp_gpu"):
        fn = getattr(wave_bp_gpu, name)
        wrapped = partial(fn, interpret=True)
        wrapped.takes_packed = True
        wrapped.supports_active = True
        monkeypatch.setattr(wave_bp_gpu, name, wrapped)
    out, _, st = overlap.overlap_block_pair(blk, blk, cfg, **kw)
    assert ref.novl > 0
    np.testing.assert_array_equal(out.columns.headers,
                                  ref.columns.headers)
    np.testing.assert_array_equal(out.columns.trace, ref.columns.trace)


# --- memory-derived limits, compile cache, native library key ----------------

def test_memory_scaled(monkeypatch):
    from damar_tpu.utils import platform
    assert platform.memory_scaled(1 << 27) == 1 << 27      # CPU: unchanged
    monkeypatch.setattr(platform, "device_bytes_limit",
                        lambda: 60 * (1 << 30))
    assert platform.memory_scaled(1 << 27) == (1 << 27) * 60 // 16


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    import os
    import damar_tpu
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("DAMAR_NO_COMPILE_CACHE", raising=False)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
    damar_tpu._enable_compilation_cache()
    if env_dir is None:
        root = os.path.dirname(os.path.dirname(damar_tpu.__file__))
        assert calls["jax_compilation_cache_dir"] == \
            os.path.join(root, ".jax_cache")
    else:
        # JAX reads the variable itself; the package sets no other dir
        assert "jax_compilation_cache_dir" not in calls


def test_native_library_key_tracks_host_cpu(monkeypatch):
    import platform as pyplatform
    from damar_tpu import native
    here = native._lib_path()
    assert pyplatform.machine() in native._host_key()
    monkeypatch.setattr(native, "_host_key", lambda: "other\nflags: x")
    other = native._lib_path()
    assert other != here and other.endswith(".so")


def test_chip_smoke_fails_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where JAX
    finds no GPU, and also when it stands alone without the repo."""
    import os
    import shutil
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(root,
                                                     "chip_smoke.py")],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(root, "chip_smoke.py"), tmp_path)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


# --- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("seed", [5])
def test_gpu_compiled_fuzz_batches(gpu_device, seed):
    args, rv = _ext_args(seed)
    ref = extend_wave_bp(*args, dirs=rv, **EXT_KW)
    out = extend_wave_bp_gpu(*args, dirs=rv, **EXT_KW)
    _assert_same(ref, out, "va vb d s".split(), f"s{seed}")
    targs = _trace_args(seed + 3)
    _assert_same(trace_wave_bp(*targs, tspace=100, max_segs=32),
                 trace_wave_bp_gpu(*targs, tspace=100, max_segs=32),
                 ("trace", "nseg", "dsum"), f"s{seed}")
