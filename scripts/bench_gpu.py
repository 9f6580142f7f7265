"""GPU measurements behind the kernel and launch-width choices.

    python scripts/bench_gpu.py kernels [--seeds 8192 32768] [--pairs 1024]
    python scripts/bench_gpu.py overlap [--genome 1250000] [--widths ...]

kernels: the Pallas-Triton bp kernels (ops.wave_bp_gpu) against XLA's
build of the plain kernels (ops.wave_bp) on read-scale units (10-20 kb
reads at 13.5 % error per read, forward and reverse extension, whole-
pair trace), with bit-identity against each other and the native C
replicas.
overlap: one self block pair through overlap_block_pair, end to end,
with the Triton kernels and with XLA's (DAMAR_BP=jax), then the
Triton path at each launch width (OverlapConfig.seed_batch_dev).

Every line carries the card's name and power limit.  Exits non-zero
without a GPU; --cpu runs a tiny interpreted rehearsal instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def emit(card, **rec):
    print(json.dumps(dict(rec, card=card)), flush=True)


def run_kernels(args, card):
    from damar_tpu.utils.devcheck import bp_kernel_check
    for i, s in enumerate(args.seeds):
        r = bp_kernel_check(
            s, min(args.pairs, s), reps=args.reps,
            interpret=args.cpu, with_native=(i == 0),
            min_len=1000 if args.cpu else 10_000,
            max_len=2000 if args.cpu else 20_000)
        emit(card, phase="kernels", **r)


def run_overlap(args, card):
    import numpy as np
    from damar_tpu.core.blocks import block_from_reads
    from damar_tpu.core.config import OverlapConfig
    from damar_tpu.pipeline.overlap import overlap_block_pair
    from damar_tpu.utils.sim import make_genome, sample_reads
    g = make_genome(args.genome, seed=2024)
    sim = sample_reads(g, coverage=20.0, mean_len=10_000, err=0.135,
                       seed=2025)
    blk = block_from_reads(sim.reads)
    total = int(sum(len(r) for r in sim.reads))

    def one(cfg, label):
        hints: dict = {}
        walls = []
        # two warm-up runs: the first compiles, the second compiles
        # again for the buffer sizes its size hints pick
        for _ in range(args.reps + 2):
            t0 = time.perf_counter()
            las, _, st = overlap_block_pair(
                blk, blk, cfg, self_block=True, emit_mirrors=False,
                hit_cap=1 << 28, seed_cap=1 << 21, size_hints=hints)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls[2:]))
        aligned = int(las.a_spans().sum())
        emit(card, phase="overlap", variant=label, read_bp=total,
             wall=wall, t_extend=st.get("t_extend"),
             t_seed=st.get("t_seed"), records=int(las.novl),
             aligned_bp=aligned, gbp_s=aligned / wall / 1e9,
             seed_batch_dev=cfg.seed_batch_dev)
        return las

    base = OverlapConfig()
    ref = one(base, "triton")
    if not args.no_xla:
        os.environ["DAMAR_BP"] = "jax"
        try:
            las = one(base, "xla")
        finally:
            os.environ.pop("DAMAR_BP")
        emit(card, phase="overlap", variant="xla_vs_triton_equal",
             equal=bool(np.array_equal(las.columns.headers,
                                       ref.columns.headers)))
    for w in args.widths:
        one(dataclasses.replace(base, seed_batch_dev=w), f"width{w}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["kernels", "overlap"],
                    nargs="+")
    ap.add_argument("--seeds", type=int, nargs="+", default=[8192])
    ap.add_argument("--pairs", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--genome", type=int, default=1_250_000)
    ap.add_argument("--widths", type=int, nargs="*", default=[])
    ap.add_argument("--no-xla", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="tiny CPU rehearsal with interpreted kernels")
    args = ap.parse_args()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        args.seeds = [min(s, 256) for s in args.seeds]
        args.pairs = min(args.pairs, 32)
    elif jax.devices()[0].platform != "gpu":
        print(f"no GPU: {jax.devices()[0].platform}", file=sys.stderr)
        return 2
    from damar_tpu.utils.devcheck import card_line, device_desc
    card = card_line()
    emit(card, device=device_desc())
    for what in args.what:
        {"kernels": run_kernels, "overlap": run_overlap}[what](args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
