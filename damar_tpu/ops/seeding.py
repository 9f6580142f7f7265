"""Seed hit detection: sorted k-mer merge + diagonal band filter.

Accelerator re-design of the overlapper's Match_Filter stage
(SURVEY.md §2.3, upstream dalign/filter.c — upstream-path citation,
reference mount empty).  The reference does a multi-pass LSD radix sort
of (code,pos) tuples then a scalar merge; this build does the same —
but through ops.sort's stable-sort API (XLA comparator sort by
default; a cumsum+scatter radix fallback for compile-dominated
runs), and with
the scalar merge replaced by a sorted-stream radix merge
(jnp.searchsorted runs ~700 ms at these shapes — never used):

  1. build_index: stable radix sort of (code, pos) over 2k+1 key bits
     — invalid codes are 4**k and sort to the end.
  2. match_hits: per-B-tuple matching A runs located with ONE radix
     merge of the two sorted code streams (ops.sort.merge_ranks); hits
     are materialized into a static-capacity buffer by run expansion
     (two-phase count-then-compact batching — no dynamic shapes).
  3. diagonal_filter: hits are double-bucketed into diagonal bands of
     width 2^w (each hit counted in its band and the next, covering
     band-straddling seeds, as the reference's adjacent-band counting
     does), radix-sorted by (aread, bread, band, apos), novel-coverage
     summed per band segment, and bands with >= h covered bases emit
     one anchor seed (the first hit of the band).

All outputs are (arrays-of-capacity, count, overflowed) triples.

NOTE int32 limits: cumulative hit counts use int32; callers must keep
per-launch tuple counts below ~2^31/t (enforced by block capacity).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from damar_tpu.ops.kmers import invalid_code, kmer_codes
from damar_tpu.utils.platform import memory_scaled
from damar_tpu.ops.sort import (compact_flagged, merge_ranks,
                                pack_fields, radix_sort_bits,
                                radix_sort_packed, seg_last_from_first,
                                seg_starts_from_first,
                                segment_sum_to_elements, unpack_field)



def quantize_bits(n: int, step: int = 4) -> int:
    """Bit width for values in [0, n], rounded up to a multiple of
    `step` so nearby block sizes share one compiled sort."""
    b = max(int(n).bit_length(), 1)
    return -(-b // step) * step


@partial(jax.jit, static_argnames=("k",))
def build_index(bases, read_id, k: int, mask=None):
    """Sorted k-mer index of a block: (codes_sorted, pos_sorted)."""
    codes, _ = kmer_codes(bases, read_id, k, mask)
    pos = jnp.arange(bases.shape[0], dtype=jnp.int32)
    codes_s, (pos_s,) = radix_sort_bits(codes, (pos,), 2 * k + 1)
    return codes_s, pos_s


@partial(jax.jit, static_argnames=("k",))
def build_index_canonical(bases, read_id, k: int, mask=None):
    """Sorted CANONICAL k-mer index: one index serves both orientations
    (see kmers.kmer_codes_canonical).  The payload packs the strand bit
    into the low bit of the position (pos2 = pos << 1 | strand) so the
    sort carries one array; positions still ascend within equal-code
    runs (pos2 is monotone in pos).  Returns (codes_sorted,
    pos2_sorted)."""
    from damar_tpu.ops.kmers import kmer_codes_canonical
    codes, strand = kmer_codes_canonical(bases, read_id, k, mask)
    pos2 = (jnp.arange(bases.shape[0], dtype=jnp.int32) << 1) \
        | strand.astype(jnp.int32)
    codes_s, (pos2_s,) = radix_sort_bits(codes, (pos2,), 2 * k + 1)
    return codes_s, pos2_s


@partial(jax.jit, static_argnames=("k", "max_count"))
def match_count(a_codes, a_pos, b_codes, b_pos, k: int,
                max_count: int = 128):
    """Count phase of the sorted-index merge: per-B-tuple matching A
    run starts/lengths (radix merge of the sorted code streams; runs
    longer than max_count on either side suppressed — the -t k-mer
    frequency cutoff).  Returns (lo, c, cum, total): run start in A,
    per-tuple emitted hit count, its inclusive prefix sum, and the
    total — so callers can pick a right-sized hit buffer BEFORE
    materializing (the fill sorts scale with the buffer, not the
    hits)."""
    n_b = b_codes.shape[0]
    assert 2 * k + 2 <= 32, "merge key must fit 32 bits (k <= 15)"
    lo, count_a = merge_ranks(a_codes, b_codes, 2 * k + 1)
    # B-side run lengths via neighbor compare over the sorted stream
    # (last - first + 1: pure scans, no segment-sum gathers)
    first = jnp.concatenate([jnp.ones((1,), bool),
                             b_codes[1:] != b_codes[:-1]])
    count_b = (seg_last_from_first(first)
               - seg_starts_from_first(first) + 1)
    ok = (b_codes != jnp.uint32(invalid_code(k))) \
        & (count_a <= max_count) & (count_b <= max_count)
    c = jnp.where(ok, count_a, 0)
    cum = jnp.cumsum(c, dtype=jnp.int32)           # inclusive
    return lo, c, cum, cum[-1]


@partial(jax.jit, static_argnames=("k", "max_count"))
def match_count_self(codes, k: int, max_count: int = 128):
    """Count phase for a block against ITSELF (the forward pass of a
    self-block comparison): no merge needed — each tuple's matching
    run is its own code segment, and emitting only the [lo, lo+rank)
    prefix (rank = position within the segment) yields exactly the
    upper-triangle hits (apos < bpos, positions ascend within a
    segment) with the trivial self-diagonal excluded, BEFORE any
    buffer is materialized.  Same returns as match_count.
    """
    n = codes.shape[0]
    first = jnp.concatenate([jnp.ones((1,), bool),
                             codes[1:] != codes[:-1]])
    lo = seg_starts_from_first(first)
    # run length = last - first + 1, both from pure scans (the
    # segment_sum-of-ones form costs two hit-scale gathers)
    last = seg_last_from_first(first)
    cnt = last - lo + 1
    rank = jnp.arange(n, dtype=jnp.int32) - lo
    ok = (codes != jnp.uint32(invalid_code(k))) & (cnt <= max_count)
    c = jnp.where(ok, rank, 0)
    cum = jnp.cumsum(c, dtype=jnp.int32)
    return lo, c, cum, cum[-1]


@partial(jax.jit, static_argnames=("hit_cap",))
def match_fill(a_pos, b_pos, lo, c, cum, hit_cap: int):
    """Materialize (apos, bpos) hit pairs from a match_count result
    into a buffer of hit_cap, B-tuple-major order.

    Returns (apos[i32 cap], bpos[i32 cap], nhits, total) — nhits is the
    number of valid entries (= min(total, hit_cap)); total > hit_cap
    means overflow and the caller should re-run with a bigger cap.
    """
    n_b = b_pos.shape[0]
    total = cum[-1]
    ok = c > 0
    # materialize hit ordinals by run expansion: scatter each B tuple's
    # index at its run start, then a cumulative max assigns every hit
    # ordinal its source tuple — one scan instead of a 4M-query binary
    # search (which costs ~log2(n) dependent gather passes)
    starts = cum - c                               # exclusive prefix
    # only tuples that actually emit hits may claim a run start: with
    # c > 0 the starts are strictly increasing, so targets are unique
    # (a c == 0 tuple shares its start with the next tuple and must
    # not override its mark)
    put = ok & (starts < hit_cap)
    tgt = jnp.where(put, starts, hit_cap)
    mark = jnp.zeros(hit_cap + 1, jnp.int32).at[tgt].max(
        jnp.where(put, jnp.arange(n_b, dtype=jnp.int32), 0))[:hit_cap]
    bidx = jax.lax.cummax(mark)
    off = jnp.arange(hit_cap, dtype=jnp.int32) - starts[bidx]
    apos = a_pos[jnp.minimum(lo[bidx] + off, a_pos.shape[0] - 1)]
    bpos = b_pos[bidx]
    nhits = jnp.minimum(total, hit_cap)
    live = jnp.arange(hit_cap, dtype=jnp.int32) < nhits
    apos = jnp.where(live, apos, -1)
    bpos = jnp.where(live, bpos, -1)
    return apos, bpos, nhits, total


def match_hits(a_codes, a_pos, b_codes, b_pos, k: int, hit_cap: int,
               max_count: int = 128):
    """Merge two sorted k-mer indexes into (apos, bpos) hit pairs
    (count + fill in one call, fixed buffer).  See match_count /
    match_fill."""
    lo, c, cum, _total = match_count(a_codes, a_pos, b_codes, b_pos,
                                     k=k, max_count=max_count)
    return match_fill(a_pos, b_pos, lo, c, cum, hit_cap=hit_cap)


def bias_weight_lut(bases) -> "np.ndarray":
    """daligner -b: per-base information weights (x256 fixed point)
    from block composition — a base contributes -log2(freq)/2 'bases'
    of band coverage, so homopolymer-ish k-mers on biased genomes must
    clear a proportionally higher bar (upstream dalign/daligner.c -b,
    mount empty).  Uniform composition gives exactly 256 per base."""
    import numpy as np
    b = np.asarray(bases)
    cnt = np.bincount(b[b < 4], minlength=4).astype(np.float64)
    f = cnt / max(cnt.sum(), 1.0)
    w = np.round(256.0 * (-np.log2(np.maximum(f, 1e-9)) / 2.0))
    return np.clip(w, 32, 1024).astype(np.uint32)


def _bias_prefix_dev(bases, lut):
    """uint32 prefix of per-base weights (wraps mod 2^32; only short-
    range differences are consumed, which wrap back correctly)."""
    w = jnp.where(bases < 4,
                  jnp.asarray(lut)[jnp.minimum(bases, 3)],
                  jnp.uint32(0)).astype(jnp.uint32)
    return jnp.concatenate([jnp.zeros(1, jnp.uint32), jnp.cumsum(w)])


def _diag_filter_impl(apos, bpos, nhits, a_read_id, b_read_id,
                      pos_bits: int, read_bits: int, band_shift: int,
                      hit_min: int, kmer: int, seed_cap: int,
                      upper_only: bool, suppress_equal,
                      self_only: bool, min_diag, max_diag, strand,
                      include_self: bool = False, wprefix=None):
    """Shared banding core; `strand` is an optional per-hit comp bit
    (bool array or None) carried through the sort key so one pass bands
    both orientations.  Returns (ar, br, apos, bpos, cov[, strand],
    nseeds, total_seeds) — strand output present iff given."""
    n = apos.shape[0]
    live = jnp.arange(n, dtype=jnp.int32) < nhits
    ar = a_read_id[jnp.maximum(apos, 0)]
    br = b_read_id[jnp.maximum(bpos, 0)]
    if upper_only:
        # include_self (daligner -I): keep read-vs-itself pairs too
        # (their trivial self-diagonal never reaches here — the
        # self-pair merge emits strict upper-triangle positions)
        live &= (ar <= br) if include_self else (ar < br)
    if self_only:
        # datander mode: a read against itself on a shifted diagonal
        live &= ar == br
    live &= ~(jnp.asarray(suppress_equal) & (ar == br))
    if min_diag is not None:
        live &= (apos - bpos) >= min_diag
    if max_diag is not None:
        live &= (apos - bpos) <= max_diag
    dead_read = jnp.int32((1 << read_bits) - 1)    # sorts after all reads
    ar_k = jnp.where(live, ar, dead_read)
    br_k = jnp.where(live, br, dead_read)
    bcap = jnp.int32(b_read_id.shape[0])
    diag = apos - bpos + bcap                      # nonnegative
    bucket = (diag >> band_shift).astype(jnp.int32)
    # diag < 2^(pos_bits+1); +2 covers the bucket+1 of the double pass
    bucket_bits = pos_bits + 2 - band_shift

    # double-bucket: count each hit in its band and the next band up,
    # so a seed straddling a band boundary is seen whole in one of them
    ar2 = jnp.concatenate([ar_k, ar_k])
    br2 = jnp.concatenate([br_k, br_k])
    bucket2 = jnp.concatenate([bucket, bucket + 1])
    apos2 = jnp.concatenate([apos, apos])
    bpos2 = jnp.concatenate([bpos, bpos])
    fields = [jnp.maximum(apos2, 0), bucket2]
    widths = [pos_bits, bucket_bits]
    if strand is not None:
        s2 = jnp.concatenate([strand, strand]).astype(jnp.int32)
        fields.append(s2)
        widths.append(1)
    fields += [br2, ar2]
    widths += [read_bits, read_bits]
    total_bits = sum(widths)
    words = pack_fields(tuple(fields), tuple(widths))
    words_s, (bpos_s,) = radix_sort_packed(words, (bpos2,), total_bits)
    apos_s = unpack_field(words_s, 0, pos_bits)
    bucket_s = unpack_field(words_s, pos_bits, bucket_bits)
    off = pos_bits + bucket_bits
    if strand is not None:
        strand_s = unpack_field(words_s, off, 1)
        off += 1
    br_s = unpack_field(words_s, off, read_bits)
    ar_s = unpack_field(words_s, off + read_bits, read_bits)

    brk = ((ar_s[1:] != ar_s[:-1]) | (br_s[1:] != br_s[:-1])
           | (bucket_s[1:] != bucket_s[:-1]))
    if strand is not None:
        brk = brk | (strand_s[1:] != strand_s[:-1])
    first = jnp.concatenate([jnp.ones((1,), bool), brk])
    prev_apos = jnp.concatenate([apos_s[:1], apos_s[:-1]])
    if wprefix is None:
        cov = jnp.where(first, kmer,
                        jnp.minimum(apos_s - prev_apos,
                                    kmer)).astype(jnp.int32)
        thresh = hit_min
    else:
        # -b: novel bases weighted by composition information — the
        # covered interval is [max(prev+k, apos), apos+k); weights via
        # the uint32 prefix (differences wrap back exactly)
        npos = wprefix.shape[0] - 1
        hi_i = jnp.minimum(apos_s + kmer, npos)
        lo_i = jnp.where(first, apos_s,
                         jnp.maximum(prev_apos + kmer, apos_s))
        lo_i = jnp.minimum(jnp.maximum(lo_i, 0), hi_i)
        cov = (wprefix[hi_i] - wprefix[lo_i]).astype(jnp.int32)
        thresh = hit_min * 256
    cov = jnp.maximum(cov, 0)
    seg_sum = segment_sum_to_elements(cov, first)
    good = (seg_sum >= thresh) & (ar_s != dead_read)
    rep = first & good                              # one seed per band

    # compact representatives into the seed buffer (packed words ride
    # the 1-bit sort; unpack only the seed_cap prefix)
    comp, nseeds, total_seeds = compact_flagged(
        rep, tuple(words_s) + (bpos_s, seg_sum), out_cap=seed_cap,
        fill=0)
    w_out, bp_out, cov_out = comp[:-2], comp[-2], comp[-1]
    keep = jnp.arange(seed_cap, dtype=jnp.int32) < nseeds
    mark = lambda x: jnp.where(keep, x, -1)
    out_ap = mark(unpack_field(w_out, 0, pos_bits))
    off = pos_bits + bucket_bits
    outs_mid = ()
    if strand is not None:
        outs_mid = (jnp.where(keep, unpack_field(w_out, off, 1), 0),)
        off += 1
    out_br = mark(unpack_field(w_out, off, read_bits))
    out_ar = mark(unpack_field(w_out, off + read_bits, read_bits))
    return (out_ar, out_br, out_ap, mark(bp_out),
            jnp.where(keep, cov_out, 0)) + outs_mid + (
            nseeds, total_seeds)


@partial(jax.jit, static_argnames=(
    "pos_bits", "read_bits", "band_shift", "hit_min", "kmer",
    "seed_cap", "upper_only", "self_only", "min_diag", "max_diag",
    "include_self"))
def diagonal_filter(apos, bpos, nhits, a_read_id, b_read_id,
                    pos_bits: int, read_bits: int, band_shift: int,
                    hit_min: int, kmer: int, seed_cap: int,
                    upper_only: bool, suppress_equal=False,
                    self_only: bool = False,
                    min_diag: int | None = None,
                    max_diag: int | None = None,
                    include_self: bool = False):
    """Band hits by (read pair, diagonal/2^w) and emit anchor seeds for
    bands whose novel k-mer coverage reaches hit_min bases.

    pos_bits/read_bits (static): significant bits of block base
    positions / read ordinals — they set the radix pass count; the
    (aread, bread, band, apos) key is bit-packed into uint32 words so
    each pass permutes 3-4 arrays total.
    upper_only (static): keep only aread < bread pairs (self-block
    comparison: each unordered pair is processed once; mirrors are
    synthesized at emission).  suppress_equal (traced bool): drop
    aread == bread pairs — used by the ring sweep on its self-rotation,
    where upper_only cannot be static per rotation.  Returns (aread,
    bread, apos, bpos, cov) seed arrays of seed_cap + (nseeds,
    total_seeds).
    """
    return _diag_filter_impl(
        apos, bpos, nhits, a_read_id, b_read_id, pos_bits, read_bits,
        band_shift, hit_min, kmer, seed_cap, upper_only, suppress_equal,
        self_only, min_diag, max_diag, strand=None,
        include_self=include_self)


@partial(jax.jit, static_argnames=(
    "pos_bits", "read_bits", "band_shift", "hit_min", "kmer",
    "seed_cap", "upper_only", "include_self"))
def diagonal_filter_comp(apos, bpos, comp, nhits, a_read_id, b_read_id,
                         pos_bits: int, read_bits: int, band_shift: int,
                         hit_min: int, kmer: int, seed_cap: int,
                         upper_only: bool, suppress_equal=False,
                         include_self: bool = False, wprefix=None):
    """diagonal_filter over a MIXED-orientation hit stream (canonical
    seeding): `comp` is the per-hit orientation bit, carried in the
    band key so forward and comp hits band independently in ONE sort.
    wprefix: optional uint32 weight prefix (-b biased composition).
    Returns (ar, br, apos, bpos, cov, comp, nseeds, total_seeds)."""
    return _diag_filter_impl(
        apos, bpos, nhits, a_read_id, b_read_id, pos_bits, read_bits,
        band_shift, hit_min, kmer, seed_cap, upper_only, suppress_equal,
        False, None, None, strand=comp, include_self=include_self,
        wprefix=wprefix)


def _pos_bits(*caps: int) -> int:
    return max(int(c - 1).bit_length() for c in caps)


def _pow2_cap(want: int, cap: int, floor: int = 1 << 17) -> int:
    """Smallest quarter-power-of-two buffer >= want, floored and
    capped: every hit-scale op (fill scatters, banding sort, scans)
    costs proportional to the BUFFER, not the hits, so the pow2-only
    buckets wasted up to 2x; quarter steps bound waste at 25% while
    keeping the compile cache small."""
    c = floor
    while c < want and c < cap:
        c *= 2
    if c > floor:
        q = c // 4
        c = max(min(-(-want // q) * q, c), floor)
    return min(c, cap)


@partial(jax.jit, static_argnames=("out_cap", "upper_only",
                                   "include_self"))
def compact_hits(apos, bpos, nhits, a_rid, b_rid, out_cap: int,
                 upper_only: bool, suppress_equal=False,
                 include_self: bool = False):
    """Drop pair-filtered hits (a==b self matches, lower-triangle
    duplicates) and compact survivors into a smaller buffer BEFORE the
    banding sort — the sort cost scales with buffer size, and on a
    self-block forward pass read-vs-itself hits are the large
    majority.  include_self (daligner -I) keeps read-vs-itself pairs.
    Returns (apos, bpos, n, total); total > out_cap means
    the caller must retry with a bigger out_cap."""
    n = apos.shape[0]
    live = jnp.arange(n, dtype=jnp.int32) < nhits
    ar = a_rid[jnp.maximum(apos, 0)]
    br = b_rid[jnp.maximum(bpos, 0)]
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    live &= ~(jnp.asarray(suppress_equal) & (ar == br))
    (oa, ob), n_out, total = compact_flagged(live, (apos, bpos),
                                             out_cap=out_cap)
    return oa, ob, n_out, total


def _sized_hits(a_pos, b_pos, lo, c, cum, total: int, hit_cap: int,
                floor: int = 1 << 17):
    """Pick the smallest power-of-two hit buffer >= total (bounded by
    hit_cap) and materialize — the banding sorts scale with the buffer
    size, so right-sizing is a big win on sparse block pairs."""
    cap = floor
    while cap < total and cap < hit_cap:
        cap *= 2
    cap = min(cap, hit_cap)
    return match_fill(a_pos, b_pos, lo, c, cum, hit_cap=cap)


def find_tandem_seeds(blk, cfg, min_period: int = 8,
                      max_period: int = 2000, hit_cap: int = 1 << 20,
                      seed_cap: int = 1 << 15):
    """Self-comparison seeds restricted to a near-diagonal band: a read
    matching itself at positive offset p has tandem period p (the
    datander mode, SURVEY.md §2.5; upstream DAMASKER datander.c —
    upstream-path citation, reference mount empty)."""
    import numpy as np
    bases = jnp.asarray(blk.bases)
    rid = jnp.asarray(blk.read_id)
    c, p = build_index(bases, rid, cfg.kmer)
    t = cfg.max_kmer_count or 128
    lo, cnt, cum, total = match_count(c, p, c, p, k=cfg.kmer,
                                      max_count=t)
    apos, bpos, nhits, total_hits = _sized_hits(
        p, p, lo, cnt, cum, int(total), hit_cap)
    ar, br, sap, sbp, cov, nseeds, total_seeds = diagonal_filter(
        apos, bpos, nhits, rid, rid,
        pos_bits=_pos_bits(blk.cap),
        read_bits=quantize_bits(blk.nreads + 1),
        band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=cfg.kmer,
        seed_cap=seed_cap, upper_only=False, self_only=True,
        min_diag=min_period, max_diag=max_period)
    return {
        "aread": np.asarray(ar), "bread": np.asarray(br),
        "apos": np.asarray(sap), "bpos": np.asarray(sbp),
        "cov": np.asarray(cov),
        "nseeds": int(nseeds), "total_seeds": int(total_seeds),
        "nhits": int(nhits), "total_hits": int(total_hits),
    }


def find_seeds_dev(blk_a, blk_b, cfg, mask_a=None, mask_b=None,
                   upper_only: bool = False, hit_cap: int = 1 << 20,
                   seed_cap: int = 1 << 16, a_index=None,
                   dev_arrays=None, raw_hint: int | None = None,
                   compact_cap: int | None = None,
                   self_pair: bool = False):
    """Device-resident seeding for one (A block, B orientation).

    Unlike find_seeds, performs NO host synchronization: the hit
    buffer is statically sized from the block's base count (quantized
    pow2, capped at hit_cap) instead of from a device->host readback
    of the exact hit total — a scalar sync serializes the pipeline.  Returns a dict of
    DEVICE arrays: aread/bread/apos/bpos/cov [seed_cap], nseeds,
    total_seeds, total_hits, overflow (0-d device scalars; fetch
    once, late) + host ints raw_cap/compact_cap.  overflow=True means
    a buffer was too small: retry with raw_hint/compact_cap >= the
    reported totals.

    dev_arrays: optional (a_bases, a_rid, b_bases, b_rid) already on
    device (callers keep blocks resident across orientations).
    self_pair: A and B are the SAME block in the same orientation (the
    forward pass of a self-block comparison): the B index build and
    merge are skipped (match_count_self derives runs from the A index
    alone) and only upper-triangle hits are materialized, so no
    compact pass is needed.
    """
    if dev_arrays is not None:
        a_bases, a_rid, b_bases, b_rid = dev_arrays
    else:
        a_bases = jnp.asarray(blk_a.bases)
        a_rid = jnp.asarray(blk_a.read_id)
        b_bases = jnp.asarray(blk_b.bases)
        b_rid = jnp.asarray(blk_b.read_id)
    am = jnp.asarray(mask_a) if mask_a is not None else None
    bm = jnp.asarray(mask_b) if mask_b is not None else None
    ac, ap = a_index if a_index is not None \
        else build_index(a_bases, a_rid, cfg.kmer, am)
    t = cfg.max_kmer_count or 128
    nb = b_bases.shape[0]
    if self_pair:
        bp = ap
        lo, cnt, cum, total = match_count_self(ac, k=cfg.kmer,
                                               max_count=t)
        # upper-triangle hits only: far fewer than the full pass
        want_raw = min(raw_hint or nb // 2, hit_cap)
    else:
        bc, bp = build_index(b_bases, b_rid, cfg.kmer, bm)
        lo, cnt, cum, total = match_count(ac, ap, bc, bp, k=cfg.kmer,
                                          max_count=t)
        want_raw = min(raw_hint or 2 * nb, hit_cap)
    # static raw-hit buffer; overflow is reported for the caller to
    # retry bigger (checked in its one late sync)
    cap = _pow2_cap(want_raw, hit_cap)
    apos, bpos, nhits, total_hits = match_fill(ap, bp, lo, cnt, cum,
                                               hit_cap=cap)
    # pair-filter + compact before the banding sort (its cost scales
    # with buffer size); the self_pair path already materialized only
    # upper-triangle hits, so its buffer feeds the banding directly
    if not self_pair and (upper_only or bool(compact_cap)):
        ccap = _pow2_cap(min(compact_cap or max(nb // 4, 1 << 17),
                             hit_cap), hit_cap)
        apos, bpos, nhits, total_c = compact_hits(
            apos, bpos, nhits, a_rid, b_rid, out_cap=ccap,
            upper_only=upper_only,
            include_self=bool(getattr(cfg, "identity", False)))
        overflow = (total_hits > cap) | (total_c > ccap)
    else:
        ccap = cap
        total_c = total_hits
        overflow = total_hits > cap
    ar, br, sap, sbp, cov, nseeds, total_seeds = diagonal_filter(
        apos, bpos, nhits, a_rid, b_rid,
        pos_bits=_pos_bits(blk_a.cap, blk_b.cap),
        read_bits=quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1),
        band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=cfg.kmer,
        seed_cap=seed_cap, upper_only=bool(self_pair and upper_only),
        include_self=bool(getattr(cfg, "identity", False)))
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": cov, "nseeds": nseeds, "total_seeds": total_seeds,
        "total_hits": total_hits, "total_compact": total_c,
        # overflow covers BOTH fixed buffers: truncated seeds silently
        # lose overlaps just like truncated hits
        "overflow": overflow | (total_seeds > seed_cap),
        "raw_cap": cap, "compact_cap": ccap,
    }


@partial(jax.jit, static_argnames=("k",))
def _split_strand_hits(ap2, bp2, b_rid, b_starts, k: int):
    """Decode packed (pos<<1|strand) hit pairs from a canonical-index
    merge: comp = strand_a XOR strand_b; comp hits get bpos mapped to
    the per-read reverse-complement coordinate (rc block layout keeps
    each read in place: rc_pos = start + end - pos - k).  Dead rows
    (pos2 < 0) stay negative."""
    dead = ap2 < 0
    apos = jnp.where(dead, -1, ap2 >> 1)
    bposf = jnp.where(dead, 0, bp2 >> 1)
    comp = ((ap2 ^ bp2) & 1) == 1
    comp = jnp.where(dead, False, comp)
    r = b_rid[bposf]
    lo = b_starts[jnp.maximum(r, 0)]
    hi = b_starts[jnp.maximum(r, 0) + 1]
    bpos = jnp.where(comp, lo + hi - bposf - k, bposf)
    bpos = jnp.where(dead, -1, bpos)
    return apos, bpos, comp


def _find_seeds_canonical_dev_legacy(blk_a, blk_b, cfg, mask_a=None,
                                     mask_b=None,
                                     upper_only: bool = False,
                                     hit_cap: int = 1 << 21,
                                     seed_cap: int = 1 << 17,
                                     a_index=None, dev_arrays=None,
                                     raw_hint: int | None = None,
                                     self_pair: bool = False,
                                     bias_lut=None):
    """v2 canonical seeding (block-absolute positions, double-bucket
    banding) — retained for blocks whose packed payload exceeds 32
    bits; see find_seeds_canonical_dev for the v3 default."""
    if dev_arrays is not None:
        a_bases, a_rid, b_bases, b_rid = dev_arrays
    else:
        a_bases = jnp.asarray(blk_a.bases)
        a_rid = jnp.asarray(blk_a.read_id)
        b_bases = jnp.asarray(blk_b.bases)
        b_rid = jnp.asarray(blk_b.read_id)
    am = jnp.asarray(mask_a) if mask_a is not None else None
    bm = jnp.asarray(mask_b) if mask_b is not None else None
    ac, ap2 = a_index if a_index is not None \
        else build_index_canonical(a_bases, a_rid, cfg.kmer, am)
    t = cfg.max_kmer_count or 128
    nb = b_bases.shape[0]
    import numpy as np
    b_starts = jnp.asarray(np.asarray(blk_b.starts, dtype=np.int32))
    if self_pair:
        bp2 = ap2
        lo, cnt, cum, total = match_count_self(ac, k=cfg.kmer,
                                               max_count=t)
        want_raw = min(raw_hint or nb // 2, hit_cap)
    else:
        bc, bp2 = build_index_canonical(b_bases, b_rid, cfg.kmer, bm)
        lo, cnt, cum, total = match_count(ac, ap2, bc, bp2, k=cfg.kmer,
                                          max_count=t)
        want_raw = min(raw_hint or 2 * nb, hit_cap)
    cap = _pow2_cap(want_raw, hit_cap)
    ap2v, bp2v, nhits, total_hits = match_fill(ap2, bp2, lo, cnt, cum,
                                               hit_cap=cap)
    apos, bpos, comp = _split_strand_hits(ap2v, bp2v, b_rid, b_starts,
                                          cfg.kmer)
    wprefix = _bias_prefix_dev(a_bases, bias_lut) \
        if bias_lut is not None else None
    ar, br, sap, sbp, cov, scomp, nseeds, total_seeds = \
        diagonal_filter_comp(
            apos, bpos, comp, nhits, a_rid, b_rid,
            pos_bits=_pos_bits(blk_a.cap, blk_b.cap),
            read_bits=quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1),
            band_shift=cfg.band_shift, hit_min=cfg.hit_min,
            kmer=cfg.kmer, seed_cap=seed_cap,
            upper_only=bool(self_pair and upper_only),
            include_self=bool(getattr(cfg, "identity", False)),
            wprefix=wprefix)
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": cov, "comp": scomp, "nseeds": nseeds,
        "total_seeds": total_seeds, "total_hits": total_hits,
        "total_compact": total_hits,
        # overflow covers BOTH fixed buffers: truncated seeds silently
        # lose overlaps just like truncated hits
        "overflow": (total_hits > cap) | (total_seeds > seed_cap),
        "raw_cap": cap,
        "compact_cap": cap,
    }


# --------------------------------------------------------------------
# v3 packed-payload canonical seeding (round-3 perf redesign)
#
# The v2 path carried BLOCK-ABSOLUTE positions through the index and
# recovered read ids / rc coordinates by hit-scale random gathers
# (a_read_id[apos], b_read_id[bpos], b_starts[r] — the dominant
# share of the 50 Mbp overlap wall when measured).  v3 packs
# (read id, READ-LOCAL position, strand) into the ONE u32 sort payload
#
#     mp = rid << (1 + rpos_bits) | rpos << 1 | strand
#
# so after hit materialization every banding quantity is an ELEMENTWISE
# unpack: ar/br/arpos/brpos/strand come from the hit payloads, the
# band key uses read-local diagonals (fwd: arpos - brpos; comp: the
# ANTI-diagonal arpos + brpos, constant along an overlap line in the
# B-read's rc frame without knowing the read length), and only the
# <= seed_cap surviving anchors pay the starts[] lookups that convert
# back to block coordinates.  Banding is single-bucket (half the v2
# double-bucket sort traffic); boundary-straddling seeds are kept by
# scoring each band as cov(band) + cov(band + 1) via one neighbor-
# segment lookup (daligner's adjacent-band counting, upstream
# dalign/filter.c Match_Filter ⟨VERIFY⟩, re-derived for sorted-stream
# scans).
#
# Exact twins: ops/seeding_host.py (numpy + native C) reproduces this
# path bit-for-bit; blocks whose rid+rpos+strand exceed 32 bits fall
# back to the v2 legacy path in BOTH twins (same condition).
# --------------------------------------------------------------------


def payload_bits(blk) -> tuple[int, int]:
    """(rid_bits, rpos_bits) of a block's packed payload: exact bit
    widths for the read ordinal (padding rid = nreads must fit) and
    the read-local position (< max read length)."""
    rid_bits = max(int(blk.nreads).bit_length(), 1)
    max_rlen = int(blk.rlen.max()) if blk.nreads else 1
    rpos_bits = max(int(max_rlen).bit_length(), 1)
    return rid_bits, rpos_bits


def packed_payload_base(read_id, starts, nreads: int, cap: int,
                        rid_bits: int, rpos_bits: int):
    """u32[cap] packed payload base for given field widths (strand bit
    left clear; the index build ORs it in).  Padding tail positions are
    clamped into the rpos field — their k-mers are invalid (PAD_BASE)
    and never produce hits, so only well-formed bits matter."""
    import numpy as np
    rid = read_id.astype(np.uint32)
    starts64 = np.asarray(starts, dtype=np.int64)
    rpos = (np.arange(cap, dtype=np.int64)
            - starts64[np.minimum(read_id, nreads)])
    rpos = np.clip(rpos, 0, (1 << rpos_bits) - 1).astype(np.uint32)
    return (rid << np.uint32(1 + rpos_bits)) | (rpos << np.uint32(1))


def packed_payload_host(blk):
    """Per-position packed payload base of a block, cached on it.
    Returns (mp_base, rid_bits, rpos_bits), or None when the fields
    exceed 32 bits (callers use the legacy block-absolute path)."""
    if "mp_base" in blk.cache:
        return blk.cache["mp_base"]
    rid_bits, rpos_bits = payload_bits(blk)
    if rid_bits + rpos_bits + 1 > 32:
        blk.cache["mp_base"] = None
        return None
    mp = packed_payload_base(blk.read_id, blk.starts, blk.nreads,
                             blk.cap, rid_bits, rpos_bits)
    res = (mp, rid_bits, rpos_bits)
    blk.cache["mp_base"] = res
    return res


_CANON_CHUNK = 1 << 24   # k-mer construction chunk (bounds HLO temps)
_FILL_SORT_MAX = 1 << 27  # fill v5 partition-sort table limit, sized
                          # for 16 GiB (scaled at use: utils.platform)


@partial(jax.jit, static_argnames=("k",))
def _canon_codes_packed(bases, read_id, mp_base, k: int, mask=None):
    from damar_tpu.ops.kmers import kmer_codes_canonical
    n = bases.shape[0]
    C = _CANON_CHUNK
    if n <= C or n % C:
        codes, strand = kmer_codes_canonical(bases, read_id, k, mask)
        return codes, mp_base | strand.astype(jnp.uint32)
    # blockwise: the unrolled roll/shift construction materializes
    # O(k) table-sized temporaries — ~15 GB of HLO temp at the 268M-
    # position 200 Mbp block unit, an out-of-memory at compile time.
    # lax.map over 16M-position chunks (k-1 overlap from a padded
    # copy; pad read_id -1 invalidates windows crossing the real end)
    # bounds the working set to one chunk.
    bp = jnp.pad(bases, (0, 32), constant_values=4)
    rp = jnp.pad(read_id, (0, 32), constant_values=-1)
    mp = jnp.pad(mask, (0, 32)) if mask is not None else None

    def chunk(i):
        s = i * C
        b = jax.lax.dynamic_slice(bp, (s,), (C + 32,))
        r = jax.lax.dynamic_slice(rp, (s,), (C + 32,))
        m = (jax.lax.dynamic_slice(mp, (s,), (C + 32,))
             if mp is not None else None)
        codes, strand = kmer_codes_canonical(b, r, k, m)
        return codes[:C], strand[:C]

    codes, strand = jax.lax.map(chunk, jnp.arange(n // C))
    return (codes.reshape(n),
            mp_base | strand.reshape(n).astype(jnp.uint32))


@partial(jax.jit, static_argnames=("k",))
def _sort_index(codes, mp, k: int):
    codes_s, (mp_s,) = radix_sort_bits(codes, (mp,), 2 * k + 1)
    return codes_s, mp_s


def build_index_canonical_packed(bases, read_id, mp_base, k: int,
                                 mask=None):
    """Sorted canonical k-mer index with the PACKED payload (v3): the
    stable sort keeps per-code runs in block-position order, exactly
    like the pos2 payload, so hit enumeration order is unchanged.

    Two jit programs, not one: the k-mer construction's roll/shift
    temporaries and the sort's working set must not coexist in one
    program's allocation plan — fused, a 268M-position block (the
    200 Mbp reference block unit) plans 17.5 GB; split, each program
    peaks well under."""
    codes, mp = _canon_codes_packed(bases, read_id, mp_base, k, mask)
    return _sort_index(codes, mp, k)


def canonical_index_dev(bases_d, rid_d, blk, k: int, mask=None):
    """Build the device canonical index for a block, choosing the v3
    packed payload when it fits 32 bits.  Returns (tag, index) where
    tag is ("packed", rid_bits, rpos_bits) or "legacy" — callers pass
    the pair to find_seeds_canonical_dev via a_index."""
    p = packed_payload_host(blk)
    if p is None:
        return "legacy", build_index_canonical(bases_d, rid_d, k, mask)
    mp_base, rid_bits, rpos_bits = p
    idx = build_index_canonical_packed(bases_d, rid_d,
                                       jnp.asarray(mp_base), k, mask)
    return ("packed", rid_bits, rpos_bits), idx


@partial(jax.jit, static_argnames=("hit_cap", "tcap"))
def match_fill_packed(a_mp, b_mp, lo, c, cum, hit_cap: int,
                      tcap: int | None = None):
    """Materialize packed (A payload, B payload) hit pairs from a
    match_count result, B-tuple-major, into a hit_cap buffer.

    Gather-minimal run expansion: runs tile the buffer contiguously
    (starts = cum - c), so any per-tuple value v expands to its run's
    rows by scattering +v at the run's first slot and -v one past its
    last, then prefix-summing — tuples with c == 0 add +v/-v to the
    SAME slot (a no-op), so no masking or bidx recovery is needed.
    TWO flat expansions suffice: the per-tuple A-index shift
    (lo - starts, so aidx = hit_ordinal + shift) and the B payload;
    the only remaining per-hit gather is the A payload at aidx, which
    varies within a run.  All arrays stay 1-D (no narrow trailing
    dimension for the layout to pad).  int32 wraparound is exact
    under the final subtraction/bitcast.

    v4: difference-encoded expansion.  Runs tile the buffer
    contiguously (s1[t] == s0[t+1]), so the v3 form's "-v one past the
    run" scatter lands exactly where the NEXT tuple's "+v" does —
    scattering the telescoping difference v[t] - v[t-1] at s0[t] alone
    is equivalent (empty runs share a slot and telescope through;
    tuples past the cap all clamp to the excluded slot hit_cap).  This
    HALVES the scatter volume, the fill's dominant cost (the buffer-
    scale cumsums and the one A-payload gather are the rest).  int32
    wraparound is exact under the final subtraction/bitcast.

    v5: the tuple stream is TABLE-sized (one per k-mer position, most
    with c == 0), so v4's diff-scatters paid per TUPLE for mostly-
    empty work — 2x67M scatter inputs at 50 Mbp vs ~8M tuples that
    emit anything.  A single stable 1-bit-key lax.sort partitions the
    emitting tuples to the front IN ORIGINAL ORDER;
    the diffs and scatters then run at tcap.  Exactness: runs tile
    the buffer in tuple order, so in-cap tuples occupy the first
    compact slots and the telescoping-difference argument is
    unchanged; tcap = hit_cap is always safe (every emitting in-cap
    tuple owns >= 1 hit), and callers pass the exact emitting-tuple
    count from the previous pass (size-hint pattern) to tighten it.

    Returns (ap_mp u32[cap], bp_mp u32[cap], nhits, total, n_emit)."""
    total = cum[-1]
    starts = cum - c
    nz = c > 0
    n_emit = nz.sum(dtype=jnp.int32)
    if tcap is None:
        tcap = hit_cap
    if lo.shape[0] <= memory_scaled(_FILL_SORT_MAX):
        s0 = jnp.where(nz, jnp.minimum(starts, hit_cap), hit_cap)
        key = (~nz).astype(jnp.int32)
        _, s0c, v1c, v2c = jax.lax.sort(
            (key, s0, lo - starts,
             jax.lax.bitcast_convert_type(b_mp, jnp.int32)),
            num_keys=1, is_stable=True)
        s0c = s0c[:tcap]

        def expand(vc):
            vc = vc[:tcap]
            d = vc - jnp.concatenate([jnp.zeros(1, vc.dtype), vc[:-1]])
            w = jnp.zeros(hit_cap + 1, jnp.int32).at[s0c].add(d)
            return jnp.cumsum(w[:hit_cap])

        shift = expand(v1c)
        e_bmp = expand(v2c)
    else:
        # very large tables (the 200 Mbp block unit): the 4-operand
        # partition sort's working set alone is ~8-10 GB — fall back
        # to the v4 full-stream diff-scatter (identical buffer, ~3 GB
        # peak; slower per pass but it fits)
        s0 = jnp.minimum(starts, hit_cap)

        def expand(v):
            d = v - jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]])
            w = jnp.zeros(hit_cap + 1, jnp.int32).at[s0].add(d)
            return jnp.cumsum(w[:hit_cap])

        shift = expand(lo - starts)
        e_bmp = expand(jax.lax.bitcast_convert_type(b_mp, jnp.int32))
    hit0 = jnp.arange(hit_cap, dtype=jnp.int32)
    aidx = hit0 + shift
    ap_mp = a_mp[jnp.clip(aidx, 0, a_mp.shape[0] - 1)]
    bp_mp = jax.lax.bitcast_convert_type(e_bmp, jnp.uint32)
    nhits = jnp.minimum(total, hit_cap)
    live = hit0 < nhits
    dead = jnp.uint32(0xFFFFFFFF)
    return (jnp.where(live, ap_mp, dead), jnp.where(live, bp_mp, dead),
            nhits, total, n_emit)


# --- sliced seeding (200 Mbp-class blocks) -----------------------------------
#
# Above _SLICE_CAP (sized for 16 GiB of device memory, scaled to the
# device's bytes_limit at use) the single-buffer pipeline's working
# set — the fill's table-scale scatters and the banding sort at ~200M
# hits — leaves no headroom for cross-pass residency.  The sliced
# pipeline bounds every working set:
#   1. chunked 1-bit partition sorts compact the emitting tuples
#      (c > 0) chunk by chunk — order-preserving, each sort at chunk
#      size instead of table size;
#   2. ONE 3-way partition sort splits the compacted tuples by b-read
#      (bands never cross a b-read, so per-slice banding is exact);
#   3. fill + banding run per slice at ~half-size buffers;
#   4. the merged seeds are re-sorted by the reconstructed band key —
#      bit-identical set AND order to the unsliced pipeline (band
#      anchors are unique per band, so the sort has no ties).
# Ref: DALIGNER/dalign/filter.c processes hits in bounded panels for
# the same working-set reason ⟨VERIFY⟩.

_SLICE_CAP = 1 << 27     # slice when the hit buffer would exceed
                         # this, sized for 16 GiB (scaled at use)
_SLICE_CHUNK = 1 << 26   # tuple-partition chunk (bounds sort memory)


@partial(jax.jit, static_argnames=("chunk", "nchunks", "b_rpos_bits"))
def _sliced_counts(c, b_mp, br_mid, chunk: int, nchunks: int,
                   b_rpos_bits: int):
    """One pass over the tuple table: per-chunk emitting-tuple counts
    (sizes the chunk partition quota) and per-slice tuple/hit totals
    (size the per-slice buffers exactly — no grow-retry)."""
    nz = c > 0
    per_chunk = nz.reshape(nchunks, chunk).sum(axis=1).astype(jnp.int32)
    br = (b_mp >> jnp.uint32(1 + b_rpos_bits)).astype(jnp.int32)
    in1 = br >= br_mid
    n0 = (nz & ~in1).sum().astype(jnp.int32)
    n1 = (nz & in1).sum().astype(jnp.int32)
    t0 = jnp.where(nz & ~in1, c, 0).sum().astype(jnp.int32)
    t1 = jnp.where(nz & in1, c, 0).sum().astype(jnp.int32)
    return jnp.concatenate([per_chunk, jnp.stack([n0, n1, t0, t1])])


@partial(jax.jit, static_argnames=("chunk", "q", "nchunks"))
def _compact_emitting_chunked(lo, c, b_mp, chunk: int, q: int,
                              nchunks: int):
    """Compact emitting tuples (c > 0) to the front IN ORDER, one
    chunk-sized stable partition sort at a time (the global 4-operand
    partition's working set alone is ~8-10 GB at 268M positions).
    Each chunk keeps its first q rows (q >= its emitting count, synced
    beforehand); the non-emitting tail rows carry c == 0 and are
    dropped by the slice partition downstream."""
    los, cs, bs = [], [], []
    for i in range(nchunks):
        s = i * chunk
        ci = c[s:s + chunk]
        key = (ci <= 0).astype(jnp.int32)
        _, lc, cc, bc = jax.lax.sort(
            (key, lo[s:s + chunk], ci,
             jax.lax.bitcast_convert_type(b_mp[s:s + chunk],
                                          jnp.int32)),
            num_keys=1, is_stable=True)
        los.append(lc[:q])
        cs.append(cc[:q])
        bs.append(bc[:q])
    return jnp.concatenate(los), jnp.concatenate(cs), jnp.concatenate(bs)


@partial(jax.jit, static_argnames=("b_rpos_bits",))
def _partition_slices(lo_s, c_s, b_s, br_mid, b_rpos_bits: int):
    """3-way stable partition of the compacted tuple stream:
    slice 0 (br < br_mid) | slice 1 | dead (c == 0).  Stability keeps
    original tuple order within each slice, so per-slice fills see
    exactly the unsliced hit order restricted to the slice."""
    br = (jax.lax.bitcast_convert_type(b_s, jnp.uint32)
          >> jnp.uint32(1 + b_rpos_bits)).astype(jnp.int32)
    key = jnp.where(c_s > 0, jnp.where(br >= br_mid, 1, 0), 2)
    _, lc, cc, bc = jax.lax.sort((key, lo_s, c_s, b_s), num_keys=1,
                                 is_stable=True)
    return lc, cc, bc


@partial(jax.jit, static_argnames=("hcap", "cap_h"))
def _fill_slice(lo_s, c_s, b_s, a_mp, start, n_h, hcap: int,
                cap_h: int):
    """v5-style fill of ONE slice: window [start, start+hcap) of the
    partitioned stream (rows >= n_h masked dead — the static window
    may overrun into the next slice), diff-scatter expansion at cap_h,
    and the A-payload gather.  Returns (ap_mp, bp_mp) with dead hit
    rows = 0xFFFFFFFF, as match_fill_packed does."""
    lo_h = jax.lax.dynamic_slice(lo_s, (start,), (hcap,))
    c_h = jax.lax.dynamic_slice(c_s, (start,), (hcap,))
    b_h = jax.lax.dynamic_slice(b_s, (start,), (hcap,))
    live_t = jnp.arange(hcap, dtype=jnp.int32) < n_h
    c_h = jnp.where(live_t, c_h, 0)
    cum = jnp.cumsum(c_h)
    starts = cum - c_h
    nzh = c_h > 0
    s0 = jnp.where(nzh, jnp.minimum(starts, cap_h), cap_h)

    def expand(vc):
        d = vc - jnp.concatenate([jnp.zeros(1, vc.dtype), vc[:-1]])
        w = jnp.zeros(cap_h + 1, jnp.int32).at[s0].add(d)
        return jnp.cumsum(w[:cap_h])

    shift = expand(lo_h - starts)
    e_bmp = expand(b_h)
    hit0 = jnp.arange(cap_h, dtype=jnp.int32)
    aidx = hit0 + shift
    ap_mp = a_mp[jnp.clip(aidx, 0, a_mp.shape[0] - 1)]
    nhits = jnp.minimum(cum[-1], cap_h)
    live = hit0 < nhits
    dead = jnp.uint32(0xFFFFFFFF)
    return (jnp.where(live, ap_mp, dead),
            jnp.where(live, jax.lax.bitcast_convert_type(e_bmp,
                                                         jnp.uint32),
                      dead), nhits)


@partial(jax.jit, static_argnames=("a_rpos_bits", "b_rpos_bits",
                                   "bucket_bits", "read_bits",
                                   "band_shift", "seed_cap"))
def _merge_seed_slices(parts, a_rpos_bits: int, b_rpos_bits: int,
                       bucket_bits: int, read_bits: int,
                       band_shift: int, seed_cap: int):
    """Restore the global sorted order over per-slice seed buffers:
    rebuild each seed's band key (identical formula to
    diagonal_filter_packed) and ONE small sort merges the slices —
    output bit-identical to the unsliced pipeline (band anchors are
    unique per band: no ties)."""
    ar, br, arp, brp, score, comp = (jnp.concatenate(x)
                                     for x in zip(*parts))
    rpb = max(a_rpos_bits, b_rpos_bits)
    diag = jnp.where(comp == 1, arp + brp, arp - brp + (1 << rpb))
    bucket = (diag >> band_shift).astype(jnp.int32)
    dead = ar < 0
    dr = jnp.int32((1 << read_bits) - 1)
    widths = (a_rpos_bits, bucket_bits, 1, read_bits, read_bits)
    fmax = [jnp.int32((1 << w) - 1) for w in widths]
    fields = [jnp.where(dead, m, f) for f, m in
              zip((arp, bucket, comp, br, ar), fmax)]
    fields[3] = jnp.where(dead, dr, br)
    fields[4] = jnp.where(dead, dr, ar)
    words = pack_fields(fields, widths)
    _, pays = radix_sort_packed(words, (ar, br, arp, brp, score, comp),
                                sum(widths))
    return tuple(p[:seed_cap] for p in pays)


def _find_seeds_sliced(amp, bmp, lo_cnt, *, blk_a, blk_b, cfg,
                       hit_cap: int, seed_cap: int,
                       a_rid_bits: int, a_rpos_bits: int,
                       b_rid_bits: int, b_rpos_bits: int,
                       upper_only: bool, include_self: bool,
                       a_starts_d, b_starts_d,
                       use_bias: bool = False, wprefix=None):
    """Sliced fill + banding for 200 Mbp-class blocks (see the section
    comment above).  Drop-in replacement for the match_fill_packed +
    diagonal_filter_packed tail of find_seeds_canonical_dev; output is
    bit-identical (same seeds, same order).

    lo_cnt: [lo, cnt] as a LIST this function empties — the caller
    must not keep its own refs (table-scale arrays, ~1 GB each at the
    200 Mbp unit)."""
    lo, cnt = lo_cnt
    lo_cnt.clear()
    table = lo.shape[0]
    chunk = min(_SLICE_CHUNK, table)
    nchunks = table // chunk
    br_mid = jnp.int32(max(blk_b.nreads // 2, 1))
    counts = np.asarray(_sliced_counts(
        cnt, bmp, br_mid, chunk=chunk, nchunks=nchunks,
        b_rpos_bits=b_rpos_bits))
    n0, n1, t0, t1 = (int(x) for x in counts[nchunks:])
    q = _pow2_cap(int(counts[:nchunks].max()), chunk)
    stream = _compact_emitting_chunked(lo, cnt, bmp, chunk=chunk, q=q,
                                       nchunks=nchunks)
    # at 268M positions the table-scale inputs are ~1 GB EACH: drop
    # every frame ref the moment its consumer is dispatched, or they
    # ride through the fills and pin their memory
    del lo, cnt
    lc, cc, bc = _partition_slices(*stream, br_mid,
                                   b_rpos_bits=b_rpos_bits)
    del stream
    hcap = _pow2_cap(max(n0, n1, 1), q * nchunks)
    cap_h = _pow2_cap(max(t0, t1, 1), hit_cap)
    read_bits = quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1)
    parts, nseeds_h, totseeds_h = [], [], []
    for start, n_h in ((jnp.int32(0), n0), (jnp.int32(n0), n1)):
        ap_mp, bp_mp, nhits = _fill_slice(
            lc, cc, bc, amp, start, jnp.int32(n_h), hcap=hcap,
            cap_h=cap_h)
        ar, br, arp, brp, score, scomp, ns, ts = \
            diagonal_filter_packed(
                ap_mp, bp_mp, nhits,
                a_rid_bits=a_rid_bits, a_rpos_bits=a_rpos_bits,
                b_rid_bits=b_rid_bits, b_rpos_bits=b_rpos_bits,
                read_bits=read_bits, band_shift=cfg.band_shift,
                hit_min=cfg.hit_min, kmer=cfg.kmer, seed_cap=seed_cap,
                upper_only=upper_only, include_self=include_self,
                use_bias=use_bias, wprefix=wprefix,
                a_starts=a_starts_d if use_bias else None)
        parts.append((ar, br, arp, brp, score, scomp))
        nseeds_h.append(ns)
        totseeds_h.append(ts)
    rpb = max(a_rpos_bits, b_rpos_bits)
    bucket_bits = rpb + 2 - cfg.band_shift
    ar, br, arp, brp, score, scomp = _merge_seed_slices(
        tuple(parts), a_rpos_bits=a_rpos_bits,
        b_rpos_bits=b_rpos_bits, bucket_bits=bucket_bits,
        read_bits=read_bits, band_shift=cfg.band_shift,
        seed_cap=seed_cap)
    total_seeds = totseeds_h[0] + totseeds_h[1]
    nseeds = jnp.minimum(nseeds_h[0] + nseeds_h[1], seed_cap)
    sap, sbp = seeds_to_block_coords(ar, br, arp, brp, scomp,
                                     a_starts_d, b_starts_d, cfg.kmer)
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": score, "comp": scomp, "nseeds": nseeds,
        "total_seeds": total_seeds,
        "total_hits": jnp.int32(t0 + t1),
        "total_compact": jnp.int32(t0 + t1),
        "total_emit": jnp.int32(n0 + n1), "tcap": q * nchunks,
        "overflow": (total_seeds > seed_cap)
        | jnp.bool_(t0 > cap_h or t1 > cap_h),
        "raw_cap": hit_cap,
        "compact_cap": cap_h,
    }


@partial(jax.jit, static_argnames=(
    "a_rid_bits", "a_rpos_bits", "b_rid_bits", "b_rpos_bits",
    "read_bits", "band_shift", "hit_min", "kmer", "seed_cap",
    "upper_only", "include_self", "use_bias"))
def diagonal_filter_packed(ap_mp, bp_mp, nhits,
                           a_rid_bits: int, a_rpos_bits: int,
                           b_rid_bits: int, b_rpos_bits: int,
                           read_bits: int, band_shift: int,
                           hit_min: int, kmer: int, seed_cap: int,
                           upper_only: bool, suppress_equal=False,
                           include_self: bool = False,
                           use_bias: bool = False, wprefix=None,
                           a_starts=None):
    """Single-bucket banding over packed hits: sort by the packed
    (ar, br, strand, bucket, arpos) key, sum novel k-mer coverage per
    band, score each band as cov(band-1) + cov(band) (adjacent-band
    counting without duplicating the hit stream), and emit the first
    hit of every band reaching hit_min as its anchor seed.

    Everything before the sort is an elementwise unpack of the hit
    payloads — no read-id or coordinate gathers.  use_bias (static) +
    wprefix/a_starts enable the -b composition-weighted coverage
    (block-absolute apos recovered per hit for the weight prefix; the
    one hit-scale gather this path retains, -b only).

    Returns (ar, br, arpos, brpos, score, comp, nseeds, total_seeds)
    in READ-LOCAL coordinates; seeds_to_block_coords converts."""
    n = ap_mp.shape[0]
    a_mask = jnp.uint32((1 << a_rpos_bits) - 1)
    b_mask = jnp.uint32((1 << b_rpos_bits) - 1)
    ar = (ap_mp >> (1 + a_rpos_bits)).astype(jnp.int32)
    arp = ((ap_mp >> 1) & a_mask).astype(jnp.int32)
    br = (bp_mp >> (1 + b_rpos_bits)).astype(jnp.int32)
    brp = ((bp_mp >> 1) & b_mask).astype(jnp.int32)
    strand = ((ap_mp ^ bp_mp) & 1).astype(jnp.int32)
    live = jnp.arange(n, dtype=jnp.int32) < nhits
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    live &= ~(jnp.asarray(suppress_equal) & (ar == br))
    rpb = max(a_rpos_bits, b_rpos_bits)
    # fwd diag arpos - brpos (offset nonnegative); comp ANTI-diag
    # arpos + brpos — both constant along an overlap line in the frame
    # the extension uses, per (ar, br), with no read-length lookup
    diag = jnp.where(strand == 1, arp + brp, arp - brp + (1 << rpb))
    bucket = (diag >> band_shift).astype(jnp.int32)
    bucket_bits = rpb + 2 - band_shift      # +1 headroom: bucket+1
    dead_read = jnp.int32((1 << read_bits) - 1)
    ar_k = jnp.where(live, ar, dead_read)
    br_k = jnp.where(live, br, dead_read)
    widths = (a_rpos_bits, bucket_bits, 1, read_bits, read_bits)
    words = pack_fields((arp, bucket, strand, br_k, ar_k), widths)
    assert len(words) <= 2, "band key exceeds 64 bits"
    words_s, (brp_s,) = radix_sort_packed(words, (brp,), sum(widths))
    arp_s = unpack_field(words_s, 0, a_rpos_bits)
    off = a_rpos_bits + bucket_bits + 1
    br_s = unpack_field(words_s, off, read_bits)
    ar_s = unpack_field(words_s, off + read_bits, read_bits)
    # band identity = key bits above the arpos field (fits 41 bits as
    # lo/hi u32 halves; bucket sits wholly in the lo half, and bucket+1
    # never carries past the bucket field thanks to its headroom bit)
    if len(words_s) == 1:
        B_lo = words_s[0] >> a_rpos_bits
        B_hi = jnp.zeros_like(B_lo)
    else:
        B_lo = ((words_s[0] >> a_rpos_bits)
                | (words_s[1] << (32 - a_rpos_bits)))
        B_hi = words_s[1] >> a_rpos_bits
    first = jnp.concatenate([jnp.ones((1,), bool),
                             (B_lo[1:] != B_lo[:-1])
                             | (B_hi[1:] != B_hi[:-1])])
    prev_arp = jnp.concatenate([arp_s[:1], arp_s[:-1]])
    if not use_bias:
        cov = jnp.where(first, kmer,
                        jnp.minimum(arp_s - prev_arp, kmer)
                        ).astype(jnp.int32)
        thresh = hit_min
    else:
        # -b: composition-weighted novel coverage over BLOCK-ABS apos
        ab = a_starts[jnp.minimum(ar_s, a_starts.shape[0] - 1)] + arp_s
        prev_ab = jnp.concatenate([ab[:1], ab[:-1]])
        npos = wprefix.shape[0] - 1
        hi_i = jnp.minimum(ab + kmer, npos)
        lo_i = jnp.where(first, ab, jnp.maximum(prev_ab + kmer, ab))
        lo_i = jnp.minimum(jnp.maximum(lo_i, 0), hi_i)
        cov = (wprefix[hi_i] - wprefix[lo_i]).astype(jnp.int32)
        thresh = hit_min * 256
    cov = jnp.maximum(cov, 0)
    if not use_bias:
        # pure-scan segment sums (wrap-free: cov <= kmer per hit, so
        # cum < 2^31 at hit_cap <= 2^27): cum at own segment's start-1
        # via a forward cummax broadcast (cum is non-decreasing), cum
        # at own last via a flipped cummin broadcast — replaces
        # segment_sum_to_elements' two hit-scale gathers with scans
        cum = jnp.cumsum(cov)
        cum_prev = jnp.concatenate([jnp.zeros(1, cov.dtype), cum[:-1]])
        base = jax.lax.cummax(jnp.where(first, cum_prev, 0))
        is_last = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
        big = jnp.int32(0x7FFFFFFF)
        cum_last = jnp.flip(jax.lax.cummin(jnp.flip(
            jnp.where(is_last, cum, big))))
        seg_sum = cum_last - base
    else:
        # -b weighted coverage can wrap int32; the gather-based form
        # is wrap-exact (within-segment differences)
        seg_sum = segment_sum_to_elements(cov, first)
    # adjacent-band window = (previous band, this band): at a
    # segment's FIRST element, the previous segment's sum and band id
    # sit one element back — a free roll, no gather.  Every band with
    # hits is scored by at least its own coverage, so no straddling
    # window is missed (the window label is arbitrary; v2's
    # double-bucket used (b-1, b) too).
    sentinel = jnp.uint32(0xFFFFFFFF)
    p_lo = jnp.concatenate([jnp.full((1,), sentinel), B_lo[:-1]])
    p_hi = jnp.concatenate([jnp.full((1,), sentinel), B_hi[:-1]])
    p_sum = jnp.concatenate([jnp.zeros((1,), seg_sum.dtype),
                             seg_sum[:-1]])
    adj = (p_lo + 1 == B_lo) & (p_hi == B_hi)
    score = seg_sum + jnp.where(adj, p_sum, 0)
    good = (score >= thresh) & (ar_s != dead_read)
    rep = first & good
    comp, nseeds, total_seeds = compact_flagged(
        rep, tuple(words_s) + (brp_s, score), out_cap=seed_cap, fill=0)
    w_out, brp_out, score_out = comp[:-2], comp[-2], comp[-1]
    keep = jnp.arange(seed_cap, dtype=jnp.int32) < nseeds
    mark = lambda x: jnp.where(keep, x, -1)      # noqa: E731
    out_arp = mark(unpack_field(w_out, 0, a_rpos_bits))
    out_str = jnp.where(keep,
                        unpack_field(w_out, a_rpos_bits + bucket_bits,
                                     1), 0)
    out_br = mark(unpack_field(w_out, off, read_bits))
    out_ar = mark(unpack_field(w_out, off + read_bits, read_bits))
    return (out_ar, out_br, out_arp, mark(brp_out),
            jnp.where(keep, score_out, 0), out_str, nseeds, total_seeds)


@partial(jax.jit, static_argnames=("kmer",))
def seeds_to_block_coords(ar, br, arp, brp, comp, a_starts, b_starts,
                          kmer: int):
    """Convert read-local seed anchors to block coordinates (comp
    seeds' bpos in the B read's rc frame, the extension convention):
    seed_cap-scale gathers into the small starts tables."""
    dead = ar < 0
    arc = jnp.clip(ar, 0, a_starts.shape[0] - 2)
    brc = jnp.clip(br, 0, b_starts.shape[0] - 2)
    sap = a_starts[arc] + arp
    blen = b_starts[brc + 1] - b_starts[brc]
    sbp = jnp.where(comp == 1,
                    b_starts[brc] + blen - brp - kmer,
                    b_starts[brc] + brp)
    return (jnp.where(dead, -1, sap).astype(jnp.int32),
            jnp.where(dead, -1, sbp).astype(jnp.int32))


@partial(jax.jit, static_argnames=("a_rpos_bits", "b_rpos_bits",
                                   "out_cap", "upper_only",
                                   "include_self"))
def compact_hits_packed(ap_mp, bp_mp, nhits, a_rpos_bits: int,
                        b_rpos_bits: int, out_cap: int,
                        upper_only: bool, suppress_equal=False,
                        include_self: bool = False):
    """Pair-filter + compact packed hits before the banding sort (the
    sort scales with buffer size); read ids come from the payloads —
    no gathers.  Returns (ap_mp, bp_mp, n, total)."""
    n = ap_mp.shape[0]
    ar = (ap_mp >> (1 + a_rpos_bits)).astype(jnp.int32)
    br = (bp_mp >> (1 + b_rpos_bits)).astype(jnp.int32)
    live = jnp.arange(n, dtype=jnp.int32) < nhits
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    live &= ~(jnp.asarray(suppress_equal) & (ar == br))
    (oa, ob), n_out, total = compact_flagged(
        live, (ap_mp, bp_mp), out_cap=out_cap, fill=0xFFFFFFFF)
    return oa, ob, n_out, total


def find_seeds_canonical_dev(blk_a, blk_b, cfg, mask_a=None, mask_b=None,
                             upper_only: bool = False,
                             hit_cap: int = 1 << 21,
                             seed_cap: int = 1 << 17, a_index=None,
                             dev_arrays=None, raw_hint: int | None = None,
                             self_pair: bool = False, bias_lut=None,
                             emit_hint: int | None = None):
    """Device-resident CANONICAL seeding: ONE index merge + ONE banding
    sort yields seeds of BOTH orientations (comp bit per seed); comp
    seeds carry bpos in per-read reverse-complement coordinates (the
    blk_b_rc frame the extension's COMP pass uses).  For a self-block
    comparison (self_pair=True) the merge collapses to the per-run
    rank trick of match_count_self.

    v3: the packed-payload path (read ids / local positions / strand
    in the sort payload — no hit-scale coordinate gathers) when the
    payload fits 32 bits, else the v2 legacy path.  a_index: optional
    (tag, index) pair from canonical_index_dev — the A side is
    identical across a block row, so sweep drivers build it once.
    """
    pa = packed_payload_host(blk_a)
    pb = pa if (self_pair or blk_b is blk_a) else packed_payload_host(blk_b)
    tag, idx = a_index if a_index is not None else (None, None)
    if tag == "legacy" or (tag is None and (pa is None or pb is None)):
        return _find_seeds_canonical_dev_legacy(
            blk_a, blk_b, cfg, mask_a, mask_b, upper_only, hit_cap,
            seed_cap, idx, dev_arrays, raw_hint, self_pair, bias_lut)
    if dev_arrays is not None:
        a_bases, a_rid, b_bases, b_rid = dev_arrays
    else:
        a_bases = jnp.asarray(blk_a.bases)
        a_rid = jnp.asarray(blk_a.read_id)
        b_bases = jnp.asarray(blk_b.bases)
        b_rid = jnp.asarray(blk_b.read_id)
    am = jnp.asarray(mask_a) if mask_a is not None else None
    bm = jnp.asarray(mask_b) if mask_b is not None else None
    if idx is None:
        tag, idx = canonical_index_dev(a_bases, a_rid, blk_a, cfg.kmer,
                                       am)
    _, a_rid_bits, a_rpos_bits = tag
    ac, amp = idx
    t = cfg.max_kmer_count or 128
    nb = b_bases.shape[0]
    if self_pair:
        bmp = amp
        b_rid_bits, b_rpos_bits = a_rid_bits, a_rpos_bits
        lo, cnt, cum, _total = match_count_self(ac, k=cfg.kmer,
                                                max_count=t)
    else:
        mpb, b_rid_bits, b_rpos_bits = pb
        bc, bmp = build_index_canonical_packed(
            b_bases, b_rid, jnp.asarray(mpb), cfg.kmer, bm)
        lo, cnt, cum, _total = match_count(ac, amp, bc, bmp, k=cfg.kmer,
                                           max_count=t)
    if raw_hint is None:
        # the count phase knows the EXACT total before anything is
        # materialized: one scalar sync sizes the buffer right and no
        # grow-retry can happen (fill + banding cost scale with the
        # BUFFER; a wrong static guess pays a full re-run).  Sweep
        # drivers pass raw_hint to skip the sync (hits are similar
        # between pairs of one dataset).  The host twin sizes from the
        # same number, so caps — and truncation behavior — stay
        # bit-identical across twins.
        want_raw = min(int(np.asarray(_total)), hit_cap)
    else:
        want_raw = min(raw_hint, hit_cap)
    cap = _pow2_cap(want_raw, hit_cap)
    if cap > memory_scaled(_SLICE_CAP):
        # 200 Mbp-class hit volume: the sliced pipeline bounds every
        # working set (see the sliced-seeding section comment)
        a_starts_d = jnp.asarray(np.asarray(blk_a.starts,
                                            dtype=np.int32))
        b_starts_d = a_starts_d if blk_b is blk_a \
            else jnp.asarray(np.asarray(blk_b.starts, dtype=np.int32))
        use_bias = bias_lut is not None
        # hand lo/cnt over in a list the callee EMPTIES, and drop this
        # frame's refs: at 268M positions these are ~1 GB each and
        # must not stay pinned through the sliced fills (cum too)
        args, lo, cnt, cum = [lo, cnt], None, None, None
        return _find_seeds_sliced(
            amp, bmp, args, blk_a=blk_a, blk_b=blk_b, cfg=cfg,
            hit_cap=hit_cap, seed_cap=seed_cap,
            a_rid_bits=a_rid_bits, a_rpos_bits=a_rpos_bits,
            b_rid_bits=b_rid_bits, b_rpos_bits=b_rpos_bits,
            upper_only=bool(self_pair and upper_only),
            include_self=bool(getattr(cfg, "identity", False)),
            a_starts_d=a_starts_d, b_starts_d=b_starts_d,
            use_bias=use_bias,
            wprefix=(_bias_prefix_dev(a_bases, bias_lut)
                     if use_bias else None))
    # emitting-tuple cap for the fill's compaction partition (v5):
    # hinted from the previous pass like raw_hint, always safe at cap
    tcap = cap if emit_hint is None else _pow2_cap(min(emit_hint, cap),
                                                   cap)
    ap_mp, bp_mp, nhits, total_hits, n_emit = match_fill_packed(
        amp, bmp, lo, cnt, cum, hit_cap=cap, tcap=tcap)
    a_starts_d = jnp.asarray(np.asarray(blk_a.starts, dtype=np.int32))
    b_starts_d = a_starts_d if blk_b is blk_a \
        else jnp.asarray(np.asarray(blk_b.starts, dtype=np.int32))
    use_bias = bias_lut is not None
    wprefix = _bias_prefix_dev(a_bases, bias_lut) if use_bias else None
    ar, br, arp, brp, score, scomp, nseeds, total_seeds = \
        diagonal_filter_packed(
            ap_mp, bp_mp, nhits,
            a_rid_bits=a_rid_bits, a_rpos_bits=a_rpos_bits,
            b_rid_bits=b_rid_bits, b_rpos_bits=b_rpos_bits,
            read_bits=quantize_bits(max(blk_a.nreads,
                                        blk_b.nreads) + 1),
            band_shift=cfg.band_shift, hit_min=cfg.hit_min,
            kmer=cfg.kmer, seed_cap=seed_cap,
            upper_only=bool(self_pair and upper_only),
            include_self=bool(getattr(cfg, "identity", False)),
            use_bias=use_bias, wprefix=wprefix,
            a_starts=a_starts_d if use_bias else None)
    sap, sbp = seeds_to_block_coords(ar, br, arp, brp, scomp,
                                     a_starts_d, b_starts_d, cfg.kmer)
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": score, "comp": scomp, "nseeds": nseeds,
        "total_seeds": total_seeds, "total_hits": total_hits,
        "total_compact": total_hits,
        "total_emit": n_emit, "tcap": tcap,
        # overflow covers BOTH fixed buffers: truncated seeds silently
        # lose overlaps just like truncated hits
        "overflow": (total_hits > cap) | (total_seeds > seed_cap)
        | (n_emit > tcap),
        "raw_cap": cap,
        "compact_cap": cap,
    }


def find_seeds(blk_a, blk_b, cfg, mask_a=None, mask_b=None,
               upper_only: bool = False, hit_cap: int = 1 << 20,
               seed_cap: int = 1 << 16, a_index=None):
    """Host-callable seeding driver for one (A block, B orientation).

    blk_a/blk_b: core.blocks.ReadBlock (B already rev-complemented for
    the COMP pass).  a_index: optional precomputed (codes, pos) from
    build_index — the A side is identical across the fwd/comp passes
    of a block pair, so callers compute it once.  Returns dict of
    numpy seed arrays + counts.
    """
    import numpy as np
    a_bases = jnp.asarray(blk_a.bases)
    a_rid = jnp.asarray(blk_a.read_id)
    b_bases = jnp.asarray(blk_b.bases)
    b_rid = jnp.asarray(blk_b.read_id)
    am = jnp.asarray(mask_a) if mask_a is not None else None
    bm = jnp.asarray(mask_b) if mask_b is not None else None
    ac, ap = a_index if a_index is not None \
        else build_index(a_bases, a_rid, cfg.kmer, am)
    bc, bp = build_index(b_bases, b_rid, cfg.kmer, bm)
    t = cfg.max_kmer_count or 128
    lo, cnt, cum, total = match_count(ac, ap, bc, bp, k=cfg.kmer,
                                      max_count=t)
    apos, bpos, nhits, total_hits = _sized_hits(
        ap, bp, lo, cnt, cum, int(total), hit_cap)
    ar, br, sap, sbp, cov, nseeds, total_seeds = diagonal_filter(
        apos, bpos, nhits, a_rid, b_rid,
        pos_bits=_pos_bits(blk_a.cap, blk_b.cap),
        read_bits=quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1),
        band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=cfg.kmer,
        seed_cap=seed_cap, upper_only=upper_only)
    return {
        "aread": np.asarray(ar), "bread": np.asarray(br),
        "apos": np.asarray(sap), "bpos": np.asarray(sbp),
        "cov": np.asarray(cov),
        "nseeds": int(nseeds), "total_seeds": int(total_seeds),
        "nhits": int(nhits), "total_hits": int(total_hits),
    }
