#!/usr/bin/env python
"""1 Mbp assembly soak (the round-2/3 regression recipe): repeat-rich
circular genome, 14x 13%-error reads, full pipeline, identity oracle.

    python scripts/soak.py [--genome-bp 1000000] [--finish-raw N]

Prints one summary line per contig plus k16 identity vs the truth
genome — the repo's end-to-end quality regression check (BASELINE.md
soak rows).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=1_000_000)
    ap.add_argument("--coverage", type=float, default=14.0)
    ap.add_argument("--err", type=float, default=0.13)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--finish-raw", type=int, default=None,
                    help="override TourConfig.finish_raw_rounds")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from damar_tpu.core.config import PipelineConfig, TourConfig
    from damar_tpu.formats.fasta import read_fasta
    from damar_tpu.pipeline.run import run_pipeline
    from damar_tpu.utils.sim import (kmer_hit_rate, make_genome,
                                     sample_reads, write_sim_fasta)

    w = args.workdir or tempfile.mkdtemp(prefix="damar_soak_")
    os.makedirs(w, exist_ok=True)
    g = make_genome(args.genome_bp, seed=args.seed, n_repeats=4,
                    repeat_len=1800, tandem=2)
    sim = sample_reads(g, coverage=args.coverage, mean_len=8000,
                       err=args.err, seed=args.seed + 1)
    fa = os.path.join(w, "reads.fasta")
    write_sim_fasta(fa, sim)
    print(f"== soak workdir {w}: {len(sim.reads)} reads, "
          f"{sum(len(r) for r in sim.reads)} bp", flush=True)
    cfg = PipelineConfig()
    if args.finish_raw is not None:
        import dataclasses
        cfg = dataclasses.replace(
            cfg, tour=dataclasses.replace(
                cfg.tour, finish_raw_rounds=args.finish_raw))
    t0 = time.time()
    rep = run_pipeline(fa, w, cfg=cfg, polish=True, verbose=True)
    names, seqs = read_fasta(rep["contig_fasta"])
    total = sum(len(s) for s in seqs)
    best = max(seqs, key=len) if seqs else np.zeros(0, np.uint8)
    hit = kmer_hit_rate(g, best) if len(best) else 0.0
    print(f"== contigs {[(n.split()[0], len(s)) for n, s in zip(names, seqs)]}")
    print(f"== span {total / len(g):.2%}  longest {len(best)}  "
          f"k16 {hit:.4f}  ~identity {hit ** (1 / 16):.5f}  "
          f"wall {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
