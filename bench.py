"""Overlap-phase benchmark (BASELINE.json north-star metric).

Runs the full single-device overlap pipeline (seeding -> extension ->
dedupe -> trace -> .las records) on a deterministic simulated PacBio
dataset and reports aligned Gbp/s: the total A-span of emitted primary
overlap records divided by wall time (compile excluded via a warmup
pass on identical shapes).

    python bench.py [--quick] [--profile]   # needs a GPU
    python bench.py --cpu                    # the CPU, small config only

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}
naming the platform, device kind and count, and the card (nvidia-smi
name and power limit); progress lines on stderr name them too.

vs_baseline is measured against REF_CPU_GBP_S, a provisional estimate
of the C reference's single-socket throughput on the same workload
(lineage daligner-class, no published tables — see BASELINE.md).  Until
the reference binary can be run in-environment this is an
order-of-magnitude anchor, not a measured number.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REF_CPU_GBP_S = 0.050  # provisional: daligner-class socket, aligned Gbp/s


# deterministic workloads over a simulated genome at 20x coverage:
# small (~2 Mbp of reads) and large (~50 Mbp of reads — a device
# cannot be filled by the small config).  The large config is the
# primary metric on the device path.
GENOME = 100_000
GENOME_QUICK = 500_000     # --quick: ~10 Mbp of reads, big enough to
                           # surface device-path regressions
GENOME_LARGE = 2_500_000
COVERAGE = 20.0
MEAN_LEN = 6_000
ERR = 0.14
SEED = 2024


def main() -> int:
    profile_dir = None
    if "--profile" in sys.argv:
        import tempfile
        profile_dir = os.path.join(tempfile.gettempdir(), "damar_profile")
    on_cpu = "--cpu" in sys.argv
    import jax
    if on_cpu:
        jax.config.update("jax_platforms", "cpu")
        # numpy stable sorts beat XLA:CPU's sort ~3.5x on the seeding
        # path, and the native C bit-parallel DP kernels (bit-identical
        # replicas of the device kernels) run extension/trace threaded
        os.environ.setdefault("DAMAR_SORT", "host")
        os.environ.setdefault("DAMAR_BP", "native")
    elif jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform "
              f"{jax.devices()[0].platform}); --cpu runs on the CPU",
              file=sys.stderr)
        return 2
    from damar_tpu.utils.devcheck import card_line, device_desc
    # every printed line names the device and the card
    dev = dict(device_desc(), card=card_line() if not on_cpu else "none")
    tag = f"{dev['platform']} {dev['kind']} x{dev['count']} ({dev['card']})"

    def note(msg: str) -> None:
        print(f"# [{tag}] {msg}", file=sys.stderr, flush=True)
    from damar_tpu.core.blocks import block_from_reads
    from damar_tpu.core.config import OverlapConfig
    from damar_tpu.pipeline.overlap import (overlap_block_pair,
                                            overlap_pairs_pipelined)
    from damar_tpu.utils.sim import make_genome, sample_reads

    def run_config(genome_bp: int, hit_cap: int, seed_cap: int,
                   warmups: int, rounds: int, label: str,
                   pipelined: bool = False):
        t0 = time.time()
        g = make_genome(genome_bp, seed=SEED)
        sim = sample_reads(g, coverage=COVERAGE, mean_len=MEAN_LEN,
                           err=ERR, seed=SEED + 1)
        blk = block_from_reads(sim.reads)
        cfg = OverlapConfig()
        total_bp = sum(len(r) for r in sim.reads)
        note(f"bench[{label}]: {len(sim.reads)} reads, {total_bp} "
              f"bp, block cap {blk.cap}, setup {time.time()-t0:.1f}s")
        # warmup compiles everything on identical shapes and populates
        # the size-hint state that right-sizes device buffers
        hints: dict = {}
        t0 = time.time()
        for _ in range(warmups):
            overlap_block_pair(blk, blk, cfg, self_block=True,
                               hit_cap=hit_cap, seed_cap=seed_cap,
                               emit_mirrors=False, size_hints=hints)
        note(f"warmup(+compile): {time.time()-t0:.1f}s")
        # best of N: min wall is the machine's actual capability
        wall = float("inf")
        for _ in range(rounds):
            t0 = time.time()
            las_a, _, stats = overlap_block_pair(
                blk, blk, cfg, self_block=True,
                hit_cap=hit_cap, seed_cap=seed_cap, emit_mirrors=False,
                size_hints=hints)
            wall = min(wall, time.time() - t0)
        aligned_bp = int(las_a.a_spans().sum())
        gbp_s = aligned_bp / wall / 1e9
        note(f"[{label}] overlaps {las_a.novl}, aligned bp "
              f"{aligned_bp}, wall {wall:.2f}s, "
              f"{gbp_s:.4f} Gbp/s, stats {stats}")
        if not pipelined:
            return gbp_s
        # production sweeps process many pairs: measure the
        # heterogeneous pipeline's steady state (host C trace+emit of
        # pass N hidden behind the device phases of pass N+1).  R = 6:
        # the first pass's unoverlapped device wall and the last
        # pass's exposed trace tail amortize ~1/R, so small R
        # understates the steady state a production sweep runs at
        R = 6
        jobs = [dict(tag=k, blk_a=blk, blk_b=blk, self_block=True,
                     hit_cap=hit_cap, seed_cap=seed_cap,
                     emit_mirrors=False, size_hints=hints)
                for k in range(R)]
        t0 = time.time()
        outs = list(overlap_pairs_pipelined(jobs, cfg))
        pwall = time.time() - t0
        pal = sum(int(la.a_spans().sum()) for _, la, _, _ in outs)
        pgbp = pal / pwall / 1e9
        note(f"[{label}] pipelined x{R}: wall {pwall:.2f}s "
              f"({pwall/R:.2f}s/pass), {pgbp:.4f} Gbp/s")
        return max(gbp_s, pgbp)

    def run_sweep_config(genome_bp: int, nblocks: int, label: str):
        """Distinct-pair all-vs-all sweep through run_overlap_plan
        (manifest, LRU residency, pipelined sweep): the same dataset
        as the same-pair config, split into nblocks DB blocks.  Unlike
        the same-pair headline (N warm repeats of ONE resident pair),
        every pass here meets a fresh B block — uploads, rc twins and
        A-index builds are all INSIDE the measured wall."""
        import shutil
        import tempfile
        from damar_tpu.formats import dazzdb, las as lasmod
        from damar_tpu.pipeline.planner import run_overlap_plan
        from damar_tpu.utils.sim import write_sim_fasta
        t0 = time.time()
        g = make_genome(genome_bp, seed=SEED)
        sim = sample_reads(g, coverage=COVERAGE, mean_len=MEAN_LEN,
                           err=ERR, seed=SEED + 1)
        total_bp = sum(len(r) for r in sim.reads)
        wdir = tempfile.mkdtemp(prefix="damar_bench_sweep_")
        try:
            write_sim_fasta(f"{wdir}/reads.fasta", sim)
            dazzdb.create_db(f"{wdir}/S.db", [f"{wdir}/reads.fasta"])
            size_mb = max(1, int(total_bp / nblocks / 1e6))
            dazzdb.db_split(f"{wdir}/S.db", size_mb=size_mb, cutoff=0)
            db = dazzdb.DazzDB.open(f"{wdir}/S.db")
            n = db.nblocks
            npairs = n * (n + 1) // 2
            note(f"bench[{label}]: {len(sim.reads)} reads, "
                  f"{total_bp} bp in {n} blocks ({npairs} pairs), "
                  f"setup {time.time()-t0:.1f}s")
            cfg = OverlapConfig()

            def one_run():
                t0 = time.time()
                run_overlap_plan(f"{wdir}/S.db", cfg, verbose=False)
                wall = time.time() - t0
                # every alignment appears once primary + once
                # mirrored in the merged per-block shards
                aligned = 0
                for i in range(1, n + 1):
                    la = lasmod.read_las(f"{wdir}/S.{i}.las")
                    aligned += int(la.a_spans().sum())
                return wall, aligned // 2

            def reset():
                for f in os.listdir(wdir):
                    if f.endswith(".las") or ".overlap.manifest" in f:
                        os.remove(os.path.join(wdir, f))

            w0, _ = one_run()          # cold: compiles for n shapes
            note(f"[{label}] cold run (+compile): {w0:.1f}s")
            reset()
            wall, aligned = one_run()  # warm: the measured sweep
            gbp = aligned / wall / 1e9
            note(f"[{label}] warm sweep: {wall:.2f}s over {npairs} "
                  f"pairs, {aligned} aligned bp = {gbp:.4f} Gbp/s")
            return gbp
        finally:
            shutil.rmtree(wdir, ignore_errors=True)

    def result(gbp_s: float, config: str, **extra) -> None:
        print(json.dumps(dict({
            "metric": "overlap_aligned_throughput",
            "value": round(gbp_s, 6),
            "unit": "Gbp-aligned/s/device",
            "vs_baseline": round(gbp_s / REF_CPU_GBP_S, 3),
            "config": config}, **extra, **dev)))

    if "--quick" in sys.argv:
        # regression canary: one mid-size config
        result(run_config(GENOME_QUICK, 1 << 25, 1 << 19, warmups=1,
                          rounds=2, label="quick-10Mbp"), "quick-10Mbp")
        return 0
    small = run_config(GENOME, 1 << 22, 1 << 17, warmups=2, rounds=3,
                       label="small-2Mbp")
    if on_cpu:
        result(small, "small-2Mbp")
        return 0
    # the primary metric: a ~50 Mbp block self-overlap (the small
    # config cannot fill a device; per-launch latency dominates it)
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    # hit_cap must exceed the workload's real hit total (~93M at
    # 50 Mbp / 20x) — a saturated buffer silently truncates hits
    gbp_s = run_config(GENOME_LARGE, 1 << 27, 1 << 21, warmups=1,
                       rounds=2, label="large-50Mbp", pipelined=True)
    if profile_dir:
        jax.profiler.stop_trace()
        note(f"profile trace: {profile_dir}")
    # sweep-realistic number: same dataset, distinct block pairs
    sweep = run_sweep_config(GENOME_LARGE, 4, "sweep-4x12Mbp")
    result(gbp_s, "large-50Mbp", small_gbp_s=round(small, 6),
           sweep_gbp_s=round(sweep, 6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
