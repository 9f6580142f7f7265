"""On-card checks shared by chip_smoke.py and scripts/bench_gpu.py.

bp_kernel_check runs the bit-parallel extension and trace kernels that
the GPU path uses (ops.wave_bp_gpu) next to XLA's build of the plain
kernels (ops.wave_bp) and the native C replicas, on read-scale units
from utils.sim.read_pair_units, and reports whether all three agree
bit for bit, with the device time of each.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def device_desc() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def timed(fn, reps: int):
    """(result, median seconds) of fn() over reps runs after one
    warm-up run; every run ends in block_until_ready."""
    import jax
    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts)


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def _mem(lowered_fn, *args, **kw) -> dict:
    ma = lowered_fn.lower(*args, **kw).compile().memory_analysis()
    if ma is None:
        return {}
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}


def bp_kernel_check(n_units: int, n_pairs: int, reps: int = 3,
                    seed: int = 0, tspace: int = 100, R: int = 128,
                    min_len: int = 10_000, max_len: int = 20_000,
                    interpret: bool = False, with_xla: bool = True,
                    with_native: bool = True) -> dict:
    """Extension (mixed directions) and whole-pair trace over n_units
    read-scale units.  Returns times in seconds, bit-identity flags
    and the compiled kernels' memory analysis."""
    import jax.numpy as jnp
    from damar_tpu import native
    from damar_tpu.ops.wave_bp import extend_wave_bp, trace_wave_bp
    from damar_tpu.ops.wave_bp_gpu import (extend_wave_bp_gpu,
                                           trace_wave_bp_gpu)
    from damar_tpu.utils.sim import read_pair_units
    u = read_pair_units(n_pairs, n_units, min_len=min_len,
                        max_len=max_len, seed=seed)
    A, B = jnp.asarray(u["A"]), jnp.asarray(u["B"])
    ext_args = (A, B) + tuple(jnp.asarray(u[k]) for k in (
        "aorigin", "borigin", "alim", "blim"))
    z = jnp.zeros(n_units, jnp.int32)
    tr_args = (A, B, jnp.asarray(u["astart"]), jnp.asarray(u["bstart"]),
               z, z, jnp.asarray(u["tlim_a"]), jnp.asarray(u["tlim_b"]))
    max_segs = max_len * 2 // tspace + 2
    ekw = dict(R=R, max_rows=65536, diff_cost=5, xdrop=60,
               dirs=jnp.asarray(u["rev"]))
    tkw = dict(tspace=tspace, max_segs=max_segs)
    rows = int(np.minimum(u["alim"], u["blim"]).max())
    out = {"units": n_units, "pairs": n_pairs, "read_len": [min_len,
                                                            max_len],
           "bases_a": int(len(u["A"])), "tspace": tspace, "R": R}
    g_ext, out["t_ext_gpu"] = timed(lambda: extend_wave_bp_gpu(
        *ext_args, interpret=interpret, **ekw), reps)
    g_tr, out["t_trace_gpu"] = timed(lambda: trace_wave_bp_gpu(
        *tr_args, interpret=interpret, **tkw), reps)
    if not interpret:
        out["mem_ext_gpu"] = _mem(extend_wave_bp_gpu, *ext_args, **ekw)
        out["mem_trace_gpu"] = _mem(trace_wave_bp_gpu, *tr_args, **tkw)
    out["ext_reached_rows_max"] = rows
    out["ext_mean_va"] = float(np.asarray(g_ext[0]).mean())
    out["trace_ok_frac"] = float(
        (np.asarray(g_tr[1]) == -(-np.asarray(u["tlim_a"]) // tspace)
         ).mean())
    if with_xla:
        x_ext, out["t_ext_xla"] = timed(
            lambda: extend_wave_bp(*ext_args, **ekw), reps)
        x_tr, out["t_trace_xla"] = timed(
            lambda: trace_wave_bp(*tr_args, **tkw), reps)
        out["ext_equal_xla"] = _same(g_ext, x_ext)
        out["trace_equal_xla"] = _same(g_tr, x_tr)
    if with_native and native.available():
        rv = u["rev"]
        t0 = time.perf_counter()
        n_ext = native.bp_extend_batch(
            u["A"], u["B"], u["aorigin"], u["borigin"], u["alim"],
            u["blim"], rv, R=R, max_rows=65536, diff_cost=5, xdrop=60)
        out["t_ext_native"] = time.perf_counter() - t0
        zz = np.zeros(n_units, np.int32)
        t0 = time.perf_counter()
        n_tr = native.bp_trace_batch(
            u["A"], u["B"], u["astart"], u["bstart"], zz, zz,
            u["tlim_a"], u["tlim_b"], tspace=tspace, max_segs=max_segs)
        out["t_trace_native"] = time.perf_counter() - t0
        out["ext_equal_native"] = _same(g_ext, n_ext)
        out["trace_equal_native"] = _same(g_tr, n_tr)
    return out
