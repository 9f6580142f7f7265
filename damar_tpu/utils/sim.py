"""Synthetic long-read simulator (PacBio-CLR-like).

The reference lineage validates with an E. coli PacBio example dataset
(SURVEY.md §4).  With no dataset shippable in this environment, this
simulator is the test/bench data source: a random (optionally
repeat-seeded) genome, reads sampled with known position/strand, and
CLR-style errors (insertions ~ deletions ~ substitutions) applied at a
configurable rate.  Ground truth lets tests assert overlap recall and
contig identity precisely.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SimReads:
    genome: np.ndarray           # uint8 codes
    reads: list[np.ndarray]      # uint8 codes per read
    start: np.ndarray            # genome start of each read's span
    end: np.ndarray              # genome end
    strand: np.ndarray           # 0 fwd, 1 revcomp
    err: float
    # chimeric[i]: read i is a junction artifact of two unrelated
    # genome spans (start/end describe its FIRST segment only)
    chimeric: np.ndarray | None = None

    def true_overlap(self, i: int, j: int, min_olap: int = 1) -> bool:
        """Ground-truth span overlap, circular-aware: reads sampled
        across the origin wrap (end > G in the doubled coordinate), so
        each read is tested at both of its circle representatives."""
        G = len(self.genome)
        for di in (0, G):
            for dj in (0, G):
                lo = max(self.start[i] + di, self.start[j] + dj)
                hi = min(self.end[i] + di, self.end[j] + dj)
                if hi - lo >= min_olap:
                    return True
        return False


def make_genome(length: int, seed: int = 0, n_repeats: int = 0,
                repeat_len: int = 2000, tandem: int = 0,
                tandem_period: int = 100, tandem_len: int = 2000
                ) -> np.ndarray:
    """Random genome; optionally plant exact repeat copies and tandems."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=length, dtype=np.uint8)
    if n_repeats > 0:
        unit = rng.integers(0, 4, size=repeat_len, dtype=np.uint8)
        spots = rng.choice(length - repeat_len, size=n_repeats, replace=False)
        for s in spots:
            g[s:s + repeat_len] = unit
    for _ in range(tandem):
        unit = rng.integers(0, 4, size=tandem_period, dtype=np.uint8)
        s = int(rng.integers(0, length - tandem_len))
        reps = np.tile(unit, tandem_len // tandem_period + 1)[:tandem_len]
        g[s:s + tandem_len] = reps
    return g


def mutate(seq: np.ndarray, err: float, rng: np.random.Generator,
           ins_frac: float = 0.45, del_frac: float = 0.35) -> np.ndarray:
    """Apply CLR-style errors.  err is the total per-base error rate,
    split ins/del/sub (PacBio CLR is insertion-dominated)."""
    if err <= 0:
        return seq.copy()
    n = len(seq)
    r = rng.random(n)
    p_ins = err * ins_frac
    p_del = err * del_frac
    p_sub = err - p_ins - p_del
    # fully vectorized expansion (the per-base Python loop dominated
    # dataset setup at block scale: 50 Mbp = 50M iterations)
    ops = np.zeros(n, dtype=np.uint8)  # 0 keep, 1 sub, 2 del, 3 ins-before
    ops[r < p_sub] = 1
    ops[(r >= p_sub) & (r < p_sub + p_del)] = 2
    ops[(r >= p_sub + p_del) & (r < err)] = 3
    subs = (seq + rng.integers(1, 4, size=n)) % 4
    ins_chars = rng.integers(0, 4, size=n).astype(np.uint8)
    lens = np.ones(n, np.int64)
    lens[ops == 2] = 0
    lens[ops == 3] = 2
    starts = np.cumsum(lens) - lens          # output offset per input
    out = np.empty(int(lens.sum()), np.uint8)
    keepish = ops != 2
    base = np.where(ops == 1, subs, seq)     # char emitted at the base slot
    slot = starts + (ops == 3)               # ins writes its char first
    out[slot[keepish]] = base[keepish]
    ins = ops == 3
    out[starts[ins]] = ins_chars[ins]
    return out


def sample_reads(genome: np.ndarray, coverage: float, mean_len: int,
                 err: float = 0.14, seed: int = 1, min_len: int = 500,
                 circular: bool = True,
                 chimera_frac: float = 0.0) -> SimReads:
    """Sample reads to a target coverage with exponential-ish lengths.

    chimera_frac: fraction of reads turned into chimeras (two
    unrelated genome spans fused at a junction — the artifact LAgap
    exists to break; SURVEY.md §2.6).  start/end of a chimeric read
    describe its first segment.
    """
    from damar_tpu.formats.fasta import revcomp
    rng = np.random.default_rng(seed)
    G = len(genome)
    total = int(G * coverage)
    reads, starts, ends, strands, chims = [], [], [], [], []
    acc = 0
    gg = np.concatenate([genome, genome]) if circular else genome

    def one_span(L):
        s = int(rng.integers(0, G if circular else max(1, G - L)))
        span = gg[s:s + L]
        strand = int(rng.integers(0, 2))
        r = span if strand == 0 else revcomp(span)
        return mutate(r, err, rng), s, s + L, strand

    while acc < total:
        L = int(np.clip(rng.gamma(3.0, mean_len / 3.0), min_len, G))
        chim = chimera_frac > 0 and rng.random() < chimera_frac \
            and L >= 2 * min_len
        if chim:
            l1 = int(rng.integers(L // 4, 3 * L // 4))
            r1, s, e, strand = one_span(l1)
            r2, _, _, _ = one_span(L - l1)
            r = np.concatenate([r1, r2])
            e = s + l1
        else:
            r, s, e, strand = one_span(L)
        if len(r) < min_len:
            continue
        reads.append(r)
        starts.append(s)
        ends.append(e)
        strands.append(strand)
        chims.append(chim)
        acc += L
    return SimReads(
        genome=genome, reads=reads,
        start=np.array(starts), end=np.array(ends),
        strand=np.array(strands), err=err,
        chimeric=np.array(chims, dtype=bool),
    )


def read_pair_units(n_pairs: int, n_units: int, min_len: int = 10_000,
                    max_len: int = 20_000, err: float = 0.135,
                    seed: int = 0) -> dict:
    """Read-scale work units for the bit-parallel DP kernels.

    n_pairs random templates of uniform length in [min_len, max_len]
    are each sampled twice with CLR errors at `err` per read (A and B
    are the two concatenations).  Unit u works on pair u % n_pairs;
    even units extend forward from the pair's start, odd units in
    reverse from its end.  Returns the extension arguments (A, B,
    aorigin, borigin, alim, blim, rev) and whole-pair trace arguments
    (astart, bstart, tlim_a, tlim_b: abpos = bbpos = 0)."""
    rng = np.random.default_rng(seed)
    a_parts, b_parts = [], []
    for _ in range(n_pairs):
        src = rng.integers(0, 4, int(rng.integers(min_len, max_len + 1)),
                           dtype=np.uint8)
        a_parts.append(mutate(src, err, rng))
        b_parts.append(mutate(src, err, rng))
    a_off = np.cumsum([0] + [len(x) for x in a_parts])
    b_off = np.cumsum([0] + [len(x) for x in b_parts])
    p = np.arange(n_units) % n_pairs
    rev = (np.arange(n_units) % 2) == 1
    la = (a_off[p + 1] - a_off[p]).astype(np.int32)
    lb = (b_off[p + 1] - b_off[p]).astype(np.int32)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return dict(
        A=np.concatenate(a_parts), B=np.concatenate(b_parts),
        aorigin=i32(np.where(rev, a_off[p + 1], a_off[p])),
        borigin=i32(np.where(rev, b_off[p + 1], b_off[p])),
        alim=la, blim=lb, rev=rev,
        astart=i32(a_off[p]), bstart=i32(b_off[p]),
        tlim_a=la, tlim_b=lb)


def write_sim_fasta(path: str, sim: SimReads) -> None:
    from damar_tpu.formats.fasta import write_fasta
    headers = [
        f"sim/{i}/0_{len(r)} start={sim.start[i]} end={sim.end[i]} "
        f"strand={sim.strand[i]}"
        for i, r in enumerate(sim.reads)]
    write_fasta(path, headers, sim.reads)


def kmer_hit_rate(genome: np.ndarray, contig: np.ndarray,
                  k: int = 16) -> float:
    """Identity oracle: fraction of the contig's exact k-mers present
    in the truth genome (both strands); identity ~ hit ** (1/k).
    Shared by the worked example and the end-to-end tests."""
    cb = bytes(np.asarray(contig, dtype=np.uint8))
    if len(cb) < k + 1:
        return 0.0
    g = np.asarray(genome, dtype=np.uint8)
    gb = bytes(g)
    rb = bytes((g[::-1] ^ 3).astype(np.uint8))
    gset = {gb[i:i + k] for i in range(len(gb) - k + 1)} \
        | {rb[i:i + k] for i in range(len(rb) - k + 1)}
    return float(np.mean([cb[i:i + k] in gset
                          for i in range(len(cb) - k + 1)]))
