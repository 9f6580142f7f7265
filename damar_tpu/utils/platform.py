"""Platform helpers: CPU selection and device-memory-derived limits."""
from __future__ import annotations

import os

# the device memory the fixed buffer limits (seeding's _FILL_SORT_MAX
# and _SLICE_CAP, the overlap driver's huge-block threshold) were
# sized for; memory_scaled() keeps their ratio to it
SIZED_FOR_BYTES = 16 << 30


def force_cpu(n_devices: int | None = None) -> None:
    """Select the CPU backend; optionally request n virtual devices.

    Must be called before the first jax backend use in the process.
    The device-count flag only takes effect if the backend is not yet
    initialized (XLA reads XLA_FLAGS at client creation).
    """
    if n_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        want = f"--xla_force_host_platform_device_count={n_devices}"
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " " + want).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


def device_bytes_limit() -> int | None:
    """bytes_limit of the first device's allocator, or None where the
    backend reports no memory statistics (the CPU)."""
    import jax
    stats = jax.devices()[0].memory_stats()
    return int(stats["bytes_limit"]) if stats and \
        stats.get("bytes_limit") else None


def memory_scaled(n: int) -> int:
    """A buffer limit sized for SIZED_FOR_BYTES of device memory,
    scaled to this device's bytes_limit; unchanged on the CPU."""
    lim = device_bytes_limit()
    return n if lim is None else n * lim // SIZED_FOR_BYTES
