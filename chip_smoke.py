#!/usr/bin/env python3
"""Smoke test of damar_tpu on an NVIDIA GPU: the main path, run once
through the entry points a user calls, with every result checked.

    python chip_smoke.py              # all phases on one GPU
    python chip_smoke.py --four       # distributed overlap on 4 GPUs only
    python chip_smoke.py --only kernels|overlap|pipeline

Phases (one process, so one JAX client holds the card):
  kernels   the Pallas-Triton bp extension/trace kernels compiled for the
            card at read scale, bit-identical to XLA's build of the
            plain kernels and to the native C replicas; then the
            `gpu`-marked tests.
  overlap   simulated CLR reads (13.5 % error, ~10 kb, 20x) through
            cli fasta2db -> dbsplit -s 200 -x 500 -> dbdust ->
            overlap-all on one 200 Mbp block (the reference's default
            block size); lacheck, recall against the simulator's truth,
            throughput, peak device memory, trace retries.  Then one
            10 Mbp block pair through cli daligner on the GPU path and
            on the host path (DAMAR_BP=native DAMAR_SORT=host): the
            .las files must be byte-identical.
  pipeline  cli pipeline on a 300 kb genome in ~5 blocks: one contig
            at >= 99 % identity to the truth.
  --four    distributed_overlap_las over 4 blocks of 50 Mbp on 4 GPUs
            against the single-GPU pair driver: the 12 cross-block
            pairs byte for byte (the 4 self pairs are counted; see
            phase_four); every device must produce records.

Prints the card's name and power limit (nvidia-smi) beside each time,
and as its last line {"ok": true, "device": {...}}.  Exits non-zero,
printing no result, when JAX finds no GPU or any check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CARD = "?"
# 9.8 Mb at 20x: ~199 Mbp of reads (insertions lengthen reads ~1.4 %),
# one block under dbsplit -s 200
GENOME = 9_800_000


def say(msg: str) -> None:
    print(msg, flush=True)


def timed_say(label: str, seconds: float, **extra) -> None:
    say(json.dumps(dict(phase=label, seconds=seconds, card=CARD, **extra)))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cli(*argv: str) -> str:
    """Run one damar_tpu.cli tool in-process; returns its stdout."""
    from damar_tpu import cli as _cli
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            _cli.main(list(argv))
        except SystemExit as e:
            code = e.code or 0
    out = buf.getvalue()
    check(code == 0, f"cli {argv[0]} exited {code}: {out[-2000:]}")
    return out


def simulate(path: str, genome_bp: int, coverage: float, seed: int):
    from damar_tpu.utils.sim import make_genome, sample_reads, \
        write_sim_fasta
    g = make_genome(genome_bp, seed=seed)
    sim = sample_reads(g, coverage=coverage, mean_len=10_000, err=0.135,
                       seed=seed + 1)
    write_sim_fasta(path, sim)
    return sim


def true_pairs(sim, n_probe: int, min_olap: int, seed: int):
    """Ground-truth overlapping read pairs (>= min_olap bp of shared
    genome, circular-aware) for n_probe random reads."""
    G = len(sim.genome)
    rng = np.random.default_rng(seed)
    s, e = sim.start.astype(np.int64), sim.end.astype(np.int64)
    out = []
    for i in rng.choice(len(s), size=min(n_probe, len(s)), replace=False):
        best = np.full(len(s), -1, np.int64)
        for di in (0, G):
            for dj in (0, G):
                ov = np.minimum(e[i] + di, e + dj) \
                    - np.maximum(s[i] + di, s + dj)
                best = np.maximum(best, ov)
        best[i] = -1
        out += [(int(i), int(j)) for j in np.nonzero(best >= min_olap)[0]]
    return out


def peak_memory() -> dict:
    import jax
    st = jax.devices()[0].memory_stats() or {}
    return {k: int(st[k]) for k in ("peak_bytes_in_use", "bytes_limit")
            if k in st}


# --- phase 1 ---------------------------------------------------------------

def phase_kernels(n_units: int, reps: int) -> None:
    from damar_tpu.utils.devcheck import bp_kernel_check
    t0 = time.time()
    r = bp_kernel_check(n_units, 1024, reps=reps)
    timed_say("kernels", time.time() - t0, **r)
    for k in ("ext_equal_xla", "trace_equal_xla", "ext_equal_native",
              "trace_equal_native"):
        check(r.get(k) is True, f"kernel check {k} = {r.get(k)}")
    check(r["trace_ok_frac"] > 0.9, f"trace_ok_frac {r['trace_ok_frac']}")
    import pytest
    saved = dict(os.environ)
    os.environ["JAX_PLATFORMS"] = "cuda"       # the card the process has
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(HERE, "tests",
                                       "test_wave_bp_gpu.py")])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    check(rc == 0, f"gpu-marked tests failed (pytest rc {rc})")
    say("gpu-marked tests: passed")


# --- phase 2 ---------------------------------------------------------------

def phase_overlap(work: str, genome_bp: int, pair_genome_bp: int) -> None:
    from damar_tpu.formats import las as lasmod
    from damar_tpu.formats.las import H_AREAD, H_BREAD
    w = os.path.join(work, "ovl")
    os.makedirs(w)
    t0 = time.time()
    sim = simulate(os.path.join(w, "reads.fasta"), genome_bp, 20.0, 11)
    read_bp = int(sum(len(r) for r in sim.reads))
    db = os.path.join(w, "R.db")
    cli("fasta2db", db, os.path.join(w, "reads.fasta"))
    say(cli("dbsplit", db, "-s", "200", "-x", "500").strip())
    cli("dbdust", db)
    timed_say("overlap.setup", time.time() - t0, reads=len(sim.reads),
              read_bp=read_bp)
    t0 = time.time()
    out = cli("overlap-all", db, "-m", "dust").strip().splitlines()
    wall = time.time() - t0
    for line in out[:-1]:
        say(line)                       # per-pair phase walls
    st = json.loads(out[-1])
    las_path = os.path.join(w, "R.1.las")
    chk = cli("lacheck", db, las_path)
    check("OK" in chk, f"lacheck: {chk[-1000:]}")
    las = lasmod.read_las(las_path)
    h = las.columns.headers
    aligned = int(las.a_spans().sum()) // 2    # primary + mirror records
    found = set(zip(h[:, H_AREAD].tolist(), h[:, H_BREAD].tolist()))
    truth = true_pairs(sim, 400, 2000, seed=5)
    recall = sum(p in found for p in truth) / max(len(truth), 1)
    timed_say("overlap.block", wall, read_bp=read_bp, records=las.novl,
              aligned_bp=aligned, gbp_per_s=aligned / wall / 1e9,
              recall=recall, recall_pairs=len(truth), lacheck="OK",
              stats=st, **peak_memory())
    check(recall >= 0.9, f"overlap recall {recall:.3f}")

    # GPU path vs host path on one block pair, byte for byte
    w2 = os.path.join(work, "pair")
    os.makedirs(w2)
    simulate(os.path.join(w2, "reads.fasta"), pair_genome_bp, 20.0, 21)
    db2 = os.path.join(w2, "P.db")
    cli("fasta2db", db2, os.path.join(w2, "reads.fasta"))
    size = max(int(pair_genome_bp * 20 / 2e6), 1)
    say(cli("dbsplit", db2, "-s", str(size), "-x", "500").strip())
    host = os.path.join(work, "pair_host")
    shutil.copytree(w2, host)
    outs = {}
    for label, d, env in (("gpu", w2, {}),
                          ("host", host, {"DAMAR_BP": "native",
                                          "DAMAR_SORT": "host"})):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            import jax
            if env:
                jax.clear_caches()      # DAMAR_SORT is read at trace time
            t0 = time.time()
            cwd = os.getcwd()
            os.chdir(d)                 # daligner writes to the cwd
            try:
                cli("daligner", "P.db", "1", "2")
            finally:
                os.chdir(cwd)
            timed_say(f"pair.{label}", time.time() - t0)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            if env:
                jax.clear_caches()      # no host-sort trace may linger
        outs[label] = [open(os.path.join(d, f), "rb").read()
                       for f in ("P.1.P.2.las", "P.2.P.1.las")]
    same = outs["gpu"] == outs["host"]
    say(json.dumps({"phase": "pair.compare", "byte_identical": same,
                    "bytes": [len(b) for b in outs["gpu"]]}))
    check(same, "GPU and host .las differ")


# --- phase 3 ---------------------------------------------------------------

def phase_pipeline(work: str, genome_bp: int) -> None:
    from damar_tpu.formats.fasta import read_fasta
    from damar_tpu.utils.sim import kmer_hit_rate
    w = os.path.join(work, "asm")
    os.makedirs(w)
    sim = simulate(os.path.join(w, "reads.fasta"), genome_bp, 16.0, 31)
    size = max(int(genome_bp * 16 / 5e6), 1)
    t0 = time.time()
    out = cli("pipeline", os.path.join(w, "reads.fasta"),
              os.path.join(w, "run"), "-s", str(size))
    wall = time.time() - t0
    rep = json.load(open(os.path.join(w, "run", "report.json")))
    names, seqs = read_fasta(rep["contig_fasta"])
    hit = kmer_hit_rate(sim.genome, max(seqs, key=len)) if seqs else 0.0
    ident = hit ** (1 / 16)
    timed_say("pipeline", wall, contigs=len(seqs),
              lengths=[len(s) for s in seqs][:5], genome_bp=genome_bp,
              identity=ident, blocks=rep["phases"]["ingest"]["blocks"],
              phase_walls={k: v["wall_s"] for k, v in
                           rep["phases"].items()})
    check(len(seqs) == 1, f"{len(seqs)} contigs: {out[-500:]}")
    check(ident >= 0.99, f"contig identity {ident:.4f}")


# --- --four ----------------------------------------------------------------

def phase_four(block_genome_bp: int, seed_cap: int = 1 << 18,
               hit_cap: int = 1 << 28, max_read_len: int = 65536) -> None:
    """The 4-GPU ring sweep against the single-GPU pair driver.  The
    12 cross-block pairs must match byte for byte.  The mesh runs a
    block's self pair without the pair driver's upper-triangle +
    mirror scheme, so its 4 self pairs differ by design: their record
    counts are reported, not compared."""
    import jax
    from damar_tpu.core.blocks import block_from_reads, round_up
    from damar_tpu.core.config import OverlapConfig
    from damar_tpu.formats.las import H_BREAD, LasFile
    from damar_tpu.parallel.distributed import (distributed_overlap_las,
                                                make_mesh)
    from damar_tpu.pipeline.overlap import overlap_block_pair
    from damar_tpu.utils.sim import make_genome, sample_reads
    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, JAX has "
          f"{len(jax.devices())}")
    g = make_genome(4 * block_genome_bp, seed=41)
    sim = sample_reads(g, coverage=20.0, mean_len=10_000, err=0.135,
                       seed=42)
    per = -(-len(sim.reads) // 4)
    groups = [sim.reads[k * per:(k + 1) * per] for k in range(4)]
    cap = round_up(max(sum(len(r) for r in gr) for gr in groups) + 4,
                   1 << 20)
    blocks = [block_from_reads(gr, ids=np.arange(k * per, k * per + len(gr),
                                                 dtype=np.int64), cap=cap)
              for k, gr in enumerate(groups)]
    say(f"four: 4 blocks of {[int(b.starts[-1]) for b in blocks]} bp")
    cfg = OverlapConfig(max_read_len=max_read_len)
    t0 = time.time()
    las_list, counts, _ = distributed_overlap_las(
        blocks, cfg, mesh=make_mesh(4), seed_cap=seed_cap,
        hit_cap=hit_cap)
    t_mesh = time.time() - t0
    per_dev = [int(las.novl) for las in las_list]
    timed_say("four.mesh", t_mesh, records_per_device=per_dev,
              **peak_memory())
    check(all(n > 0 for n in per_dev), f"a device made no records: "
          f"{per_dev}")
    t0 = time.time()
    same = True
    for i in range(4):
        parts = []
        for j in range(4):
            if j == i:
                continue
            t1 = time.time()
            la, _, st = overlap_block_pair(blocks[i], blocks[j], cfg,
                                           self_block=False,
                                           emit_mirrors=False)
            timed_say("four.pair", time.time() - t1, pair=[i, j],
                      t_seed=st["t_seed"], t_extend=st["t_extend"],
                      t_trace=st["t_trace"], records=int(la.novl))
            parts.append(la)
        ref = LasFile.concat(parts)
        ref.sort()
        m = las_list[i].columns
        own = np.isin(m.headers[:, H_BREAD], blocks[i].ids)
        cross = m.permute(np.nonzero(~own)[0])
        eq = (np.array_equal(cross.headers, ref.columns.headers)
              and np.array_equal(cross.trace, ref.columns.trace))
        say(json.dumps({"phase": "four.compare", "a_block": i,
                        "cross_pairs_pair_driver": int(ref.novl),
                        "cross_pairs_mesh": int(cross.headers.shape[0]),
                        "cross_byte_identical": eq,
                        "self_pair_mesh": int(own.sum())}))
        same &= eq
    timed_say("four.pair_driver", time.time() - t0)
    check(same, "mesh .las differs from the pair driver's")


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="only the 4-GPU distributed overlap check")
    ap.add_argument("--only", choices=["kernels", "overlap", "pipeline"])
    ap.add_argument("--genome", type=int, default=GENOME,
                    help="overlap-phase genome (20x: 200 Mbp of reads)")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from damar_tpu.utils.devcheck import card_line, device_desc
    CARD = card_line()
    say(f"card: {CARD}")
    desc = device_desc()
    if args.genome != GENOME:
        say(f"overlap block cut to {args.genome * 20 / 1e6:.0f} Mbp "
            "of reads")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    t_all = time.time()
    try:
        if args.four:
            phase_four(2_500_000)           # 4 blocks of 50 Mbp
        else:
            if args.only in (None, "kernels"):
                phase_kernels(8192, reps=3)
            if args.only in (None, "overlap"):
                # 20x of 1 Mb: two blocks of 10 Mbp for the pair check
                phase_overlap(work, args.genome, 1_000_000)
            if args.only in (None, "pipeline"):
                phase_pipeline(work, 300_000)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    timed_say("total", time.time() - t_all)
    say(CARD)
    print(json.dumps({"ok": True, "device": desc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
