"""Device-facing layout of a DB block: HBM-resident packed read arrays.

A block (the unit of distribution, SURVEY.md §2.10) becomes a fixed set
of dense arrays sized to static, padded shapes so every kernel over a
block compiles once:

  bases    uint8[cap]      concatenated 2-bit codes (0..3), padded with 4
                           (a sentinel that never matches a real base)
  starts   int32[nr+1]     read start offsets into `bases`
  read_id  int32[cap]      position -> local read ordinal (nr at padding)
  rlen     int32[nr]       read lengths
  ids      int32[nr]       local ordinal -> absolute (untrimmed) read id

Padding to a fixed capacity keeps XLA shapes static across blocks of
similar size (capacity buckets of 2^n), the device analogue of the
reference's ~200MB block invariant.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np

PAD_BASE = 4  # sentinel base code; matches nothing (valid codes are 0..3)


@dataclass
class ReadBlock:
    """Host-side staging of one DB block, ready for jnp.asarray upload."""
    bases: np.ndarray     # uint8[cap]
    starts: np.ndarray    # int32[nr+1]
    read_id: np.ndarray   # int32[cap]
    rlen: np.ndarray      # int32[nr]
    ids: np.ndarray       # int32[nr] absolute read ids
    nbases: int           # real base count (before padding)
    # single-entry memo used by the overlap driver to reuse the
    # A-side canonical index across the block's whole B row (the
    # lineage `daligner A B1 B2 ...` A-index reuse); sweep drivers
    # clear it when the A row advances to bound live index memory
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def nreads(self) -> int:
        return len(self.rlen)

    @property
    def cap(self) -> int:
        return len(self.bases)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def capacity_bucket(n: int, quantum: int = 1 << 20) -> int:
    """Round a base count up to a shape bucket so similar-size blocks
    share compiled kernels: next power-of-two quantum multiple."""
    n = max(n, quantum)
    b = quantum
    while b < n:
        b *= 2
    # refine to quarters of the power of two to limit waste to <= 25%
    q = b // 4
    return round_up(n, q)


def build_block(bases: np.ndarray, starts: np.ndarray, ids: np.ndarray,
                cap: int | None = None) -> ReadBlock:
    """Assemble a ReadBlock from concatenated codes + offsets
    (e.g. straight from DazzDB.block_seqs)."""
    n = int(starts[-1])
    if cap is None:
        cap = capacity_bucket(n)
    nr = len(starts) - 1
    out = np.full(cap, PAD_BASE, dtype=np.uint8)
    out[:n] = bases[:n]
    rlen = np.diff(starts).astype(np.int32)
    read_id = np.full(cap, nr, dtype=np.int32)
    # position -> read ordinal via repeat
    read_id[:n] = np.repeat(np.arange(nr, dtype=np.int32), rlen)
    return ReadBlock(
        bases=out, starts=starts.astype(np.int32),
        read_id=read_id, rlen=rlen,
        ids=ids.astype(np.int32), nbases=n,
    )


def block_from_db(db, b: int, cap: int | None = None) -> ReadBlock:
    bases, starts, ids = db.block_seqs(b)
    return build_block(bases, starts, ids, cap=cap)


def block_from_reads(reads: list[np.ndarray], ids: np.ndarray | None = None,
                     cap: int | None = None) -> ReadBlock:
    """Build a block directly from a list of code arrays (tests/sim)."""
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    starts = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    bases = np.concatenate(reads) if reads else np.zeros(0, np.uint8)
    if ids is None:
        ids = np.arange(len(reads))
    return build_block(bases, starts, np.asarray(ids), cap=cap)


def revcomp_block(blk: ReadBlock) -> ReadBlock:
    """Per-read reverse-complemented copy of a block (for the COMP
    orientation pass): read order preserved, each read's bases reversed
    and complemented in place, padding untouched.  One vectorized
    gather — this runs several times per block pair."""
    bases = blk.bases.copy()
    n = blk.nbases
    if n:
        from damar_tpu import native
        if not native.revcomp_reads(blk.bases, blk.starts, bases):
            starts = blk.starts.astype(np.int64)
            rid = blk.read_id[:n].astype(np.int64)
            rev_idx = starts[rid] + starts[rid + 1] - 1 - np.arange(n)
            bases[:n] = 3 - blk.bases[rev_idx]
    return ReadBlock(bases=bases, starts=blk.starts, read_id=blk.read_id,
                     rlen=blk.rlen, ids=blk.ids, nbases=blk.nbases)
