"""K-mer code extraction over packed block base arrays.

Vectorized equivalent of the k-mer tuple build in the overlapper's
seeding stage (SURVEY.md §2.3 'k-mer seeding', upstream dalign/filter.c
Sort_Kmers — upstream-path citation, reference mount empty): instead of
a scalar loop building (code, read, pos) tuples, the whole block's code
vector is computed with k shifted adds over the base array (no
gather), and validity is a vector predicate.

A k-mer starting at global position i is valid iff the window lies
within one read (read_id[i] == read_id[i+k-1]; the padding sentinel
read_id kills windows that touch padding) and no soft-mask covers its
start position.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

def invalid_code(k: int) -> int:
    """Sentinel code for invalid k-mer windows: 4**k, one past the
    largest valid code, so it sorts last with only 2k+1 key bits (the
    radix sort pass count tracks significant bits)."""
    return 1 << (2 * k)


# retained for external callers; invalid_code(k) is what the seeding
# radix path compares against


def kmer_codes(bases: jax.Array, read_id: jax.Array, k: int,
               mask: jax.Array | None = None
               ) -> tuple[jax.Array, jax.Array]:
    """Compute k-mer codes and validity for every position of a block.

    bases:   uint8[N] base codes 0..3 (PAD_BASE=4 padding)
    read_id: int32[N] position -> read ordinal (sentinel at padding)
    mask:    optional bool[N], True = suppress k-mers starting here

    Returns (codes uint32[N], valid bool[N]); invalid positions have
    code invalid_code(k) = 4**k so they sort to the end within 2k+1
    key bits.
    """
    n = bases.shape[0]
    b = bases.astype(jnp.uint32) & 3
    code = jnp.zeros(n, dtype=jnp.uint32)
    for j in range(k):
        # roll wraps at the end; wrapped windows are invalid anyway
        code = (code << 2) | jnp.roll(b, -j)
    valid = read_id == jnp.roll(read_id, -(k - 1))
    # windows wrapping past the array end
    idx = jnp.arange(n)
    valid &= idx <= n - k
    # padding bases (>=4) are masked to 0 in the code accumulation;
    # window start must be a real base
    valid &= bases < 4
    if mask is not None:
        valid &= ~mask
    codes = jnp.where(valid, code, jnp.uint32(invalid_code(k)))
    return codes, valid


def kmer_codes_canonical(bases: jax.Array, read_id: jax.Array, k: int,
                         mask: jax.Array | None = None
                         ) -> tuple[jax.Array, jax.Array]:
    """Canonical k-mer codes: min(code, revcomp_code) per window plus
    the strand bit (True = the reverse complement was smaller, i.e.
    the window's canonical form is its rc).

    One canonical index replaces the per-orientation indexes of the
    reference's seeding (upstream daligner indexes B's complement
    tuples alongside — dalign/filter.c, upstream-path citation): a
    match between windows whose strand bits DIFFER is a comp-
    orientation hit, equal bits a forward hit, so both orientations
    fall out of a single sorted-merge pass.  Palindromic windows
    (code == rc) carry strand False; comp hits between two palindromic
    windows are folded into the forward hit (a ~4^-(k/2) density
    heuristic difference from the two-pass reference).

    Returns (codes uint32[N], strand bool[N]); invalid windows get
    code invalid_code(k) = 4**k and strand False.
    """
    n = bases.shape[0]
    b = bases.astype(jnp.uint32) & 3
    code = jnp.zeros(n, dtype=jnp.uint32)
    rc = jnp.zeros(n, dtype=jnp.uint32)
    for j in range(k):
        bj = jnp.roll(b, -j)
        code = (code << 2) | bj
        rc = rc | ((3 - bj) << (2 * j))
    valid = read_id == jnp.roll(read_id, -(k - 1))
    idx = jnp.arange(n)
    valid &= idx <= n - k
    valid &= bases < 4
    if mask is not None:
        valid &= ~mask
    strand = valid & (rc < code)
    canon = jnp.minimum(code, rc)
    codes = jnp.where(valid, canon, jnp.uint32(invalid_code(k)))
    return codes, strand


def mask_vector_from_track(track_data: list[np.ndarray],
                           starts: np.ndarray, cap: int) -> np.ndarray:
    """Host-side: expand per-read mask intervals (flat [b,e,...] lists,
    read-local coordinates) into a global bool[cap] suppression vector
    for a block (the daligner -m soft-mask input path)."""
    out = np.zeros(cap, dtype=bool)
    for j, iv in enumerate(track_data):
        if len(iv) == 0:
            continue
        s = int(starts[j])
        e = int(starts[j + 1])
        p = iv.reshape(-1, 2)
        for b, t in p:
            lo = min(s + int(b), e)
            hi = min(s + int(t), e)
            out[lo:hi] = True
    return out
