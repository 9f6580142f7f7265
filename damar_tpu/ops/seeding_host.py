"""Host (numpy + native C) replica of the canonical seeding path.

Serves the CPU backend (selected next to the native bp kernels,
DAMAR_BP; see pipeline.overlap._kernels): the XLA seeding kernels are
the device production path, but on the CPU backend their sorts and
scatter glue dominate the overlap wall clock.  This module reproduces
ops.seeding.find_seeds_canonical_dev EXACTLY — same hits in the same
order, same banding sort order (two-pass stable radix == the packed
lexicographic key), same truncation semantics at hit_cap/seed_cap —
so the emitted .las is byte-identical whichever backend ran
(asserted by tests/test_native_bp.py).

Layout notes mirror ops/seeding.py:
  * canonical codes/strand: native C canon_kmers (exact replica of
    kmers.kmer_codes_canonical);
  * index + banding sorts: native parallel radix argsort;
  * count/fill/coverage: vectorized numpy (run expansion via repeat).
"""
from __future__ import annotations

import numpy as np

from damar_tpu.ops.kmers import invalid_code
from damar_tpu.ops.seeding import _pow2_cap, _pos_bits, quantize_bits


def _argsort(keys: np.ndarray) -> np.ndarray:
    from damar_tpu import native
    order = native.radix_argsort(keys)
    return np.argsort(keys, kind="stable") if order is None else order


def _canon_codes(bases, read_id, k: int, mask):
    """(codes, strand) via native C canon_kmers; numpy/JAX fallback."""
    from damar_tpu import native
    res = native.canon_kmers(bases, read_id, k, mask)
    if res is None:                      # no toolchain: numpy fallback
        from damar_tpu.ops.kmers import kmer_codes_canonical
        import jax.numpy as jnp
        c, s = kmer_codes_canonical(jnp.asarray(bases),
                                    jnp.asarray(read_id), k,
                                    jnp.asarray(mask)
                                    if mask is not None else None)
        res = np.asarray(c), np.asarray(s)
    return res


def _canon_index(bases, read_id, k: int, mask):
    codes, strand = _canon_codes(bases, read_id, k, mask)
    pos2 = (np.arange(len(codes), dtype=np.int32) << 1) \
        | strand.astype(np.int32)
    order = _argsort(codes.astype(np.uint64))
    return codes[order], pos2[order]


def canon_index_host(blk, k: int, mask=None):
    """Tagged canonical index (host twin of seeding.canonical_index_dev):
    ("packed", rid_bits, rpos_bits) with the u32 packed payload when it
    fits, else ("legacy", ...) with the block-absolute pos2 payload."""
    from damar_tpu.ops.seeding import packed_payload_host
    p = packed_payload_host(blk)
    if p is None:
        return "legacy", _canon_index(blk.bases, blk.read_id, k, mask)
    mp_base, rid_bits, rpos_bits = p
    codes, strand = _canon_codes(blk.bases, blk.read_id, k, mask)
    mp = mp_base | strand.astype(np.uint32)
    order = _argsort(codes.astype(np.uint64))
    return ("packed", rid_bits, rpos_bits), (codes[order], mp[order])


def _run_firsts(codes: np.ndarray):
    """(per-element segment start index, per-element segment length)
    of a sorted stream (native C single pass; numpy fallback)."""
    n = len(codes)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z
    from damar_tpu import native
    res = native.run_firsts(codes)
    if res is not None:
        return res
    first = np.empty(n, bool)
    first[0] = True
    np.not_equal(codes[1:], codes[:-1], out=first[1:])
    starts = np.maximum.accumulate(
        np.where(first, np.arange(n, dtype=np.int64), 0))
    seg_start_idx = np.flatnonzero(first)
    seg_len = np.diff(np.append(seg_start_idx, n))
    cnt = np.repeat(seg_len, seg_len)
    return starts, cnt


def _fill_hits(a_pos2, b_pos2, lo, c, cap: int):
    """B-tuple-major hit materialization (match_fill): first `cap`
    hits of the global enumeration.  Returns (ap2v, bp2v, nhits,
    total)."""
    total = int(c.sum())
    nhits = min(total, cap)
    if nhits == 0:
        z = np.empty(0, np.int32)
        return z, z, 0, total
    if total > cap:
        # truncate the run expansion at cap hits, exactly like the
        # fixed device buffer: cut c at the tuple where cum crosses cap
        cum = np.cumsum(c)
        last = int(np.searchsorted(cum, cap, "left"))
        c = c.copy()
        c[last] = cap - (cum[last] - c[last])
        c[last + 1:] = 0
    idx = np.flatnonzero(c)
    reps = c[idx]
    bidx = np.repeat(idx, reps)
    starts = np.cumsum(reps) - reps
    off = np.arange(nhits, dtype=np.int64) - np.repeat(starts, reps)
    ap2v = a_pos2[lo[bidx] + off].astype(np.int32)
    bp2v = b_pos2[bidx].astype(np.int32)
    return ap2v, bp2v, nhits, total


def _fill_hits_packed_np(a_mp, b_mp, lo, c, cap: int):
    """Packed-payload twin of _fill_hits: same B-tuple-major
    enumeration and cap truncation, payloads carried verbatim."""
    total = int(c.sum())
    nhits = min(total, cap)
    if nhits == 0:
        z = np.empty(0, np.uint32)
        return z, z, 0, total
    if total > cap:
        cum = np.cumsum(c)
        last = int(np.searchsorted(cum, cap, "left"))
        c = c.copy()
        c[last] = cap - (cum[last] - c[last])
        c[last + 1:] = 0
    idx = np.flatnonzero(c)
    reps = c[idx]
    bidx = np.repeat(idx, reps)
    starts = np.cumsum(reps) - reps
    off = np.arange(nhits, dtype=np.int64) - np.repeat(starts, reps)
    return a_mp[lo[bidx] + off], b_mp[bidx], nhits, total


def _band_filter_packed_np(ap_mp, bp_mp, a_rpos_bits, b_rpos_bits,
                           nreads1, cfg, seed_cap: int,
                           upper_only: bool, include_self: bool,
                           wprefix=None, a_starts=None):
    """Numpy replica of seeding.diagonal_filter_packed: single-bucket
    banding over packed hits, two-pass stable sort == the packed
    (ar, br, strand, bucket, arpos) key sort, per-band novel coverage,
    score = cov(band) + cov(band+1) via band-key adjacency (key+1
    never carries past the bucket field: it has a headroom bit).
    Returns seed_cap-padded (ar, br, arp, brp, score, comp, nseeds,
    total)."""
    kmer, hit_min, band_shift = cfg.kmer, cfg.hit_min, cfg.band_shift
    read_bits = quantize_bits(nreads1)
    rpb = max(a_rpos_bits, b_rpos_bits)
    bucket_bits = rpb + 2 - band_shift
    n = len(ap_mp)
    ar = (ap_mp >> np.uint32(1 + a_rpos_bits)).astype(np.int64)
    arp = ((ap_mp >> np.uint32(1))
           & np.uint32((1 << a_rpos_bits) - 1)).astype(np.int64)
    br = (bp_mp >> np.uint32(1 + b_rpos_bits)).astype(np.int64)
    brp = ((bp_mp >> np.uint32(1))
           & np.uint32((1 << b_rpos_bits) - 1)).astype(np.int64)
    strand = ((ap_mp ^ bp_mp) & np.uint32(1)).astype(np.int64)
    live = np.ones(n, bool)
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    if not live.all():
        idx = np.flatnonzero(live)
        ar, br, arp, brp = ar[idx], br[idx], arp[idx], brp[idx]
        strand = strand[idx]
        n = len(idx)
    diag = np.where(strand == 1, arp + brp, arp - brp + (1 << rpb))
    bucket = (diag >> band_shift).astype(np.int64)
    if 2 * read_bits + 1 + bucket_bits > 64:
        raise ValueError("band key exceeds 64 bits")
    key2 = (((((ar << read_bits | br) << 1) | strand)
             << bucket_bits) | bucket).astype(np.uint64)
    if n == 0:
        z = np.full(seed_cap, -1, np.int32)
        z0 = np.zeros(seed_cap, np.int32)
        return z, z, z, z, z0, z0, 0, 0
    o1 = _argsort(arp.astype(np.uint64))
    o2 = _argsort(key2[o1])
    order = o1[o2]
    key_s, arp_s = key2[order], arp[order]
    m = n
    first = np.empty(m, bool)
    first[0] = True
    first[1:] = key_s[1:] != key_s[:-1]
    prev_ap = np.empty_like(arp_s)
    prev_ap[0] = arp_s[0]
    prev_ap[1:] = arp_s[:-1]
    if wprefix is None:
        cov = np.where(first, kmer, np.minimum(arp_s - prev_ap, kmer))
        thresh = hit_min
    else:
        # -b: composition-weighted coverage over block-absolute apos
        # (same u32-wrap formula as the device twin)
        ab = a_starts[np.minimum(ar[order],
                                 len(a_starts) - 1)] + arp_s
        prev_ab = np.empty_like(ab)
        prev_ab[0] = ab[0]
        prev_ab[1:] = ab[:-1]
        npos = len(wprefix) - 1
        hi_i = np.minimum(ab + kmer, npos)
        lo_i = np.where(first, ab, np.maximum(prev_ab + kmer, ab))
        lo_i = np.minimum(np.maximum(lo_i, 0), hi_i)
        cov = (wprefix[hi_i] - wprefix[lo_i]).astype(np.int32)
        thresh = hit_min * 256
    cov = np.maximum(cov, 0).astype(np.int64)
    seg_idx = np.flatnonzero(first)
    sums = np.add.reduceat(cov, seg_idx)
    seg_key = key_s[seg_idx]
    # adjacent-band window = (previous band, this band); keys here
    # EXCLUDE arpos (two-pass sort), so adjacency is key-1 directly
    score = sums.copy()
    adj = seg_key[:-1] + 1 == seg_key[1:]
    score[1:] += np.where(adj, sums[:-1], 0)
    good = score >= thresh
    rep_idx = seg_idx[good]
    total_seeds = len(rep_idx)
    nseeds = min(total_seeds, seed_cap)
    rep_idx = rep_idx[:nseeds]
    rep = order[rep_idx]

    def out(vals, fill):
        o = np.full(seed_cap, fill, np.int32)
        o[:nseeds] = vals[:nseeds]
        return o
    return (out(ar[rep], -1), out(br[rep], -1), out(arp[rep], -1),
            out(brp[rep], -1), out(score[good], 0),
            out(strand[rep], 0), nseeds, total_seeds)


def find_seeds_canonical_host(blk_a, blk_b, cfg, mask_a=None,
                              mask_b=None, upper_only: bool = False,
                              hit_cap: int = 1 << 21,
                              seed_cap: int = 1 << 17, a_index=None,
                              raw_hint: int | None = None,
                              self_pair: bool = False,
                              bias_lut=None) -> dict:
    """Drop-in for find_seeds_canonical_dev returning numpy arrays
    (same dict contract; fetch_seeds consumes either).  Dispatches to
    the v3 packed-payload path (exact twin of the device path) when
    the payload fits 32 bits, else the v2 legacy path below.
    a_index: optional (tag, index) pair from canon_index_host."""
    from damar_tpu.ops.seeding import packed_payload_host
    pa = packed_payload_host(blk_a)
    pb = pa if (self_pair or blk_b is blk_a) \
        else packed_payload_host(blk_b)
    tag, idx = a_index if a_index is not None else (None, None)
    if tag == "legacy" or (tag is None and (pa is None or pb is None)):
        return _find_seeds_canonical_host_legacy(
            blk_a, blk_b, cfg, mask_a, mask_b, upper_only, hit_cap,
            seed_cap, idx, raw_hint, self_pair, bias_lut)
    k = cfg.kmer
    t = cfg.max_kmer_count or 128
    inval = invalid_code(k)
    ma = np.asarray(mask_a) if mask_a is not None else None
    mb = np.asarray(mask_b) if mask_b is not None else None
    if idx is None:
        tag, idx = canon_index_host(blk_a, k, ma)
    _, a_rid_bits, a_rpos_bits = tag
    ac, amp = idx
    nb = blk_b.bases.shape[0]
    from damar_tpu import native
    if self_pair:
        bmp = amp
        b_rid_bits, b_rpos_bits = a_rid_bits, a_rpos_bits
        res = native.self_hit_counts(ac, inval, t)
        if res is not None:
            lo, c = res
        else:
            starts, cnt = _run_firsts(ac)
            lo = starts
            rank = np.arange(len(ac), dtype=np.int64) - starts
            ok = (ac != np.uint32(inval)) & (cnt <= t)
            c = np.where(ok, rank, 0)
    else:
        tagb, (bc, bmp) = canon_index_host(blk_b, k, mb)
        _, b_rid_bits, b_rpos_bits = tagb
        lo = np.searchsorted(ac, bc, "left").astype(np.int64)
        hi = np.searchsorted(ac, bc, "right")
        count_a = (hi - lo).astype(np.int64)
        _, count_b = _run_firsts(bc)
        ok = (bc != np.uint32(inval)) & (count_a <= t) & (count_b <= t)
        c = np.where(ok, count_a, 0)
    # exact sizing when no hint (same rule as the device twin, so the
    # caps — and any truncation — stay bit-identical across twins)
    want_raw = min(raw_hint if raw_hint is not None
                   else int(c.sum(dtype=np.int64)), hit_cap)
    cap = _pow2_cap(want_raw, hit_cap)
    fused = native.fill_hits_packed(amp, bmp, lo, c, cap)
    if fused is not None:
        ap_mp, bp_mp, nhits, total_hits = fused
    else:
        ap_mp, bp_mp, nhits, total_hits = _fill_hits_packed_np(
            amp, bmp, lo, c, cap)

    wprefix = None
    a_starts64 = None
    if bias_lut is not None:
        b = np.asarray(blk_a.bases)
        wv = np.where(b < 4, np.asarray(bias_lut, np.uint32)[
            np.minimum(b, 3)], np.uint32(0)).astype(np.uint32)
        wprefix = np.zeros(len(b) + 1, np.uint32)
        np.cumsum(wv, out=wprefix[1:], dtype=np.uint32)
        a_starts64 = np.asarray(blk_a.starts, np.int64)
    up = bool(self_pair and upper_only)
    inc = bool(getattr(cfg, "identity", False))
    nreads1 = max(blk_a.nreads, blk_b.nreads) + 1
    res = None if wprefix is not None else native.band_filter_packed(
        ap_mp, bp_mp, a_rpos_bits=a_rpos_bits, b_rpos_bits=b_rpos_bits,
        read_bits=quantize_bits(nreads1), band_shift=cfg.band_shift,
        kmer=k, hit_min=cfg.hit_min, upper_only=up, include_self=inc,
        seed_cap=seed_cap)
    if res is not None:
        s_ar, s_br, s_arp, s_brp, s_cov, s_comp, nseeds, total = res

        def pad(v, fill):
            o = np.full(seed_cap, fill, np.int32)
            o[:nseeds] = v
            return o
        ar, br, arp, brp, cov, comp = (
            pad(s_ar, -1), pad(s_br, -1), pad(s_arp, -1),
            pad(s_brp, -1), pad(s_cov, 0), pad(s_comp, 0))
        total_seeds = total
    else:
        ar, br, arp, brp, cov, comp, nseeds, total_seeds = \
            _band_filter_packed_np(
                ap_mp, bp_mp, a_rpos_bits, b_rpos_bits, nreads1, cfg,
                seed_cap=seed_cap, upper_only=up, include_self=inc,
                wprefix=wprefix, a_starts=a_starts64)
    # read-local anchors -> block coordinates (comp bpos in the B
    # read's rc frame) — same formulas as seeding.seeds_to_block_coords
    a_starts = np.asarray(blk_a.starts, np.int64)
    b_starts = np.asarray(blk_b.starts, np.int64)
    dead = ar < 0
    arc = np.clip(ar, 0, len(a_starts) - 2)
    brc = np.clip(br, 0, len(b_starts) - 2)
    sap = a_starts[arc] + arp
    blen = b_starts[brc + 1] - b_starts[brc]
    sbp = np.where(comp == 1, b_starts[brc] + blen - brp - k,
                   b_starts[brc] + brp)
    sap = np.where(dead, -1, sap).astype(np.int32)
    sbp = np.where(dead, -1, sbp).astype(np.int32)
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": cov, "comp": comp,
        "nseeds": np.int32(nseeds), "total_seeds": np.int32(total_seeds),
        "total_hits": np.int32(total_hits),
        "total_compact": np.int32(total_hits),
        "overflow": np.bool_((total_hits > cap)
                             | (total_seeds > seed_cap)),
        "raw_cap": cap, "compact_cap": cap,
    }


def _find_seeds_canonical_host_legacy(blk_a, blk_b, cfg, mask_a=None,
                                      mask_b=None,
                                      upper_only: bool = False,
                                      hit_cap: int = 1 << 21,
                                      seed_cap: int = 1 << 17,
                                      a_index=None,
                                      raw_hint: int | None = None,
                                      self_pair: bool = False,
                                      bias_lut=None) -> dict:
    """v2 host canonical seeding (block-absolute, double-bucket) —
    twin of seeding._find_seeds_canonical_dev_legacy."""
    k = cfg.kmer
    t = cfg.max_kmer_count or 128
    inval = invalid_code(k)
    ma = np.asarray(mask_a) if mask_a is not None else None
    mb = np.asarray(mask_b) if mask_b is not None else None
    ac, ap2 = a_index if a_index is not None else _canon_index(
        blk_a.bases, blk_a.read_id, k, ma)
    nb = blk_b.bases.shape[0]
    if self_pair:
        bc, bp2 = ac, ap2
        from damar_tpu import native
        res = native.self_hit_counts(ac, inval, t)
        if res is not None:
            lo, c = res
        else:
            starts, cnt = _run_firsts(ac)
            lo = starts
            rank = np.arange(len(ac), dtype=np.int64) - starts
            ok = (ac != np.uint32(inval)) & (cnt <= t)
            c = np.where(ok, rank, 0)
        want_raw = min(raw_hint or nb // 2, hit_cap)
    else:
        bc, bp2 = _canon_index(blk_b.bases, blk_b.read_id, k, mb)
        lo = np.searchsorted(ac, bc, "left").astype(np.int64)
        hi = np.searchsorted(ac, bc, "right")
        count_a = (hi - lo).astype(np.int64)
        _, count_b = _run_firsts(bc)
        ok = (bc != np.uint32(inval)) & (count_a <= t) & (count_b <= t)
        c = np.where(ok, count_a, 0)
        want_raw = min(raw_hint or 2 * nb, hit_cap)
    cap = _pow2_cap(want_raw, hit_cap)
    b_rid = np.asarray(blk_b.read_id)
    b_starts = np.asarray(blk_b.starts, np.int64)
    from damar_tpu import native
    fused = native.fill_hits_strand(ap2, bp2, lo, c, cap, b_rid,
                                    b_starts, k)
    if fused is not None:
        apos, bpos, comp, nhits, total_hits = fused
    else:
        ap2v, bp2v, nhits, total_hits = _fill_hits(ap2, bp2, lo, c, cap)
        # split strand (comp = strand_a XOR strand_b; comp bpos mapped
        # to the per-read rc frame)
        apos = (ap2v >> 1).astype(np.int32)
        bposf = (bp2v >> 1).astype(np.int64)
        comp = ((ap2v ^ bp2v) & 1) == 1
        r = b_rid[bposf].astype(np.int64)
        blo = b_starts[r]
        bhi = b_starts[r + 1]
        bpos = np.where(comp, blo + bhi - bposf - k,
                        bposf).astype(np.int32)

    wprefix = None
    if bias_lut is not None:
        b = np.asarray(blk_a.bases)
        wv = np.where(b < 4, np.asarray(bias_lut, np.uint32)[
            np.minimum(b, 3)], np.uint32(0)).astype(np.uint32)
        wprefix = np.zeros(len(b) + 1, np.uint32)
        np.cumsum(wv, out=wprefix[1:], dtype=np.uint32)
    seeds = _band_filter(
        apos, bpos, comp, np.asarray(blk_a.read_id),
        b_rid, blk_a.cap, blk_b.cap,
        max(blk_a.nreads, blk_b.nreads) + 1, cfg,
        seed_cap=seed_cap,
        upper_only=bool(self_pair and upper_only),
        include_self=bool(getattr(cfg, "identity", False)),
        wprefix=wprefix)
    ar, br, sap, sbp, cov, scomp, nseeds, total_seeds = seeds
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": cov, "comp": scomp,
        "nseeds": np.int32(nseeds), "total_seeds": np.int32(total_seeds),
        "total_hits": np.int32(total_hits),
        "total_compact": np.int32(total_hits),
        "overflow": np.bool_((total_hits > cap)
                             | (total_seeds > seed_cap)),
        "raw_cap": cap, "compact_cap": cap,
    }


def _band_filter(apos, bpos, comp, a_read_id, b_read_id, a_cap, b_cap,
                 nreads1, cfg, seed_cap: int, upper_only: bool,
                 include_self: bool, self_only: bool = False,
                 min_diag: int | None = None,
                 max_diag: int | None = None, wprefix=None):
    """Numpy replica of _diag_filter_impl (strand present, the
    canonical path's configuration): double-bucket banding, stable
    two-pass sort == the packed (ar,br,strand,bucket,apos) key sort,
    novel-coverage per band, one anchor per qualifying band."""
    kmer, hit_min, band_shift = cfg.kmer, cfg.hit_min, cfg.band_shift
    pos_bits = _pos_bits(a_cap, b_cap)
    read_bits = quantize_bits(nreads1)
    bucket_bits = pos_bits + 2 - band_shift
    n = len(apos)
    ar = a_read_id[np.maximum(apos, 0)].astype(np.int64)
    br = b_read_id[np.maximum(bpos, 0)].astype(np.int64)
    live = np.ones(n, bool)
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    if self_only:                       # datander: a read vs itself
        live &= ar == br
    if min_diag is not None:
        live &= (apos.astype(np.int64) - bpos) >= min_diag
    if max_diag is not None:
        live &= (apos.astype(np.int64) - bpos) <= max_diag
    # (dead_read marking sorts dead rows after every live row — they
    # can never band with live rows nor seed; dropping them up front
    # is order-identical)
    if not live.all():
        idx = np.flatnonzero(live)
        apos, bpos = apos[idx], bpos[idx]
        comp, ar, br = comp[idx], ar[idx], br[idx]
        n = len(idx)
    from damar_tpu import native
    # the native C band filter has no bias-weighted coverage mode:
    # biased runs take the numpy branch (same formula as the device)
    res = None if wprefix is not None else native.band_filter(
        apos, bpos, comp, ar, br, bcap=len(b_read_id),
        band_shift=band_shift, kmer=kmer, hit_min=hit_min,
        read_bits=read_bits, bucket_bits=bucket_bits,
        pos_bits=pos_bits, seed_cap=seed_cap)
    if res is not None:
        s_ar, s_br, s_ap, s_bp, s_cov, s_comp, nseeds, total = res

        def pad(v, fill):
            o = np.full(seed_cap, fill, np.int32)
            o[:nseeds] = v
            return o
        return (pad(s_ar, -1), pad(s_br, -1), pad(s_ap, -1),
                pad(s_bp, -1), pad(s_cov, 0), pad(s_comp, 0),
                nseeds, total)
    diag = apos.astype(np.int64) - bpos + len(b_read_id)
    bucket = (diag >> band_shift).astype(np.int64)
    # double-bucket concat: [band, band + 1]
    ar2 = np.concatenate([ar, ar])
    br2 = np.concatenate([br, br])
    bkt2 = np.concatenate([bucket, bucket + 1])
    ap2 = np.concatenate([apos, apos])
    bp2 = np.concatenate([bpos, bpos])
    st2 = np.concatenate([comp, comp]).astype(np.int64)
    # two-pass stable sort == one lexicographic sort by
    # (ar, br, strand, bucket, apos): pass 1 by the least-significant
    # field, pass 2 by the rest folded into one u64
    if 2 * read_bits + 1 + bucket_bits <= 64:
        o1 = _argsort(np.maximum(ap2, 0).astype(np.uint64))
        key2 = (((ar2 << read_bits | br2) << 1 | st2)
                << bucket_bits | bkt2).astype(np.uint64)
        o2 = _argsort(key2[o1])
        order = o1[o2]
    else:
        # band key alone exceeds 64 bits (very large blocks):
        # lexsort columns directly — primary key LAST
        order = np.lexsort((np.maximum(ap2, 0), bkt2, st2, br2, ar2))
    ar_s, br_s = ar2[order], br2[order]
    bkt_s, st_s = bkt2[order], st2[order]
    ap_s, bp_s = ap2[order], bp2[order]
    m = len(order)
    if m == 0:
        z = np.full(seed_cap, -1, np.int32)
        z0 = np.zeros(seed_cap, np.int32)
        return z, z, z, z, z0, z0, 0, 0
    first = np.empty(m, bool)
    first[0] = True
    first[1:] = ((ar_s[1:] != ar_s[:-1]) | (br_s[1:] != br_s[:-1])
                 | (bkt_s[1:] != bkt_s[:-1]) | (st_s[1:] != st_s[:-1]))
    prev_ap = np.empty_like(ap_s)
    prev_ap[0] = ap_s[0]
    prev_ap[1:] = ap_s[:-1]
    if wprefix is None:
        cov = np.where(first, kmer, np.minimum(ap_s - prev_ap, kmer))
        thresh = hit_min
    else:
        # -b: composition-weighted novel coverage (device twin in
        # ops.seeding._diag_filter_impl — formulas must match exactly)
        npos = len(wprefix) - 1
        hi_i = np.minimum(ap_s + kmer, npos)
        lo_i = np.where(first, ap_s, np.maximum(prev_ap + kmer, ap_s))
        lo_i = np.minimum(np.maximum(lo_i, 0), hi_i)
        cov = (wprefix[hi_i] - wprefix[lo_i]).astype(np.int32)
        thresh = hit_min * 256
    cov = np.maximum(cov, 0)
    seg_idx = np.flatnonzero(first)
    seg_sum = np.add.reduceat(cov, seg_idx)
    good = seg_sum >= thresh
    rep_idx = seg_idx[good]                   # first hit of each band
    total_seeds = len(rep_idx)
    nseeds = min(total_seeds, seed_cap)
    rep_idx = rep_idx[:nseeds]

    def out(vals, fill):
        o = np.full(seed_cap, fill, np.int32)
        o[:nseeds] = vals[:nseeds]
        return o
    return (out(ar_s[rep_idx], -1), out(br_s[rep_idx], -1),
            out(ap_s[rep_idx], -1), out(bp_s[rep_idx], -1),
            out(seg_sum[good], 0), out(st_s[rep_idx], 0),
            nseeds, total_seeds)


def find_tandem_seeds_host(blk, cfg, min_period: int = 8,
                           max_period: int = 2000,
                           hit_cap: int = 1 << 20,
                           seed_cap: int = 1 << 15) -> dict:
    """Host twin of ops.seeding.find_tandem_seeds (datander seeding:
    a block against itself on bounded positive diagonals).  Exact
    replica — same hits, same band order, same outputs."""
    from damar_tpu import native
    k = cfg.kmer
    t = cfg.max_kmer_count or 128
    inval = invalid_code(k)
    codes = native.plain_kmers(blk.bases, blk.read_id, k)
    if codes is None:
        import jax.numpy as jnp
        from damar_tpu.ops.kmers import kmer_codes
        c, _ = kmer_codes(jnp.asarray(blk.bases),
                          jnp.asarray(blk.read_id), k)
        codes = np.asarray(c)
    order = _argsort(codes.astype(np.uint64))
    c_s = codes[order]
    p_s = order.astype(np.int32)           # pos payload == stable order
    starts, cnt = _run_firsts(c_s)
    # generic self-merge: every tuple matches its whole code segment
    ok = (c_s != np.uint32(inval)) & (cnt <= t)
    c = np.where(ok, cnt, 0)
    cap = _pow2_cap(int(c.sum()), hit_cap)
    ap, bp, nhits, total_hits = _fill_hits(p_s, p_s, starts, c, cap)
    rid = np.asarray(blk.read_id)
    comp = np.zeros(nhits, bool)
    ar, br, sap, sbp, cov, _, nseeds, total_seeds = _band_filter(
        ap, bp, comp, rid, rid, blk.cap, blk.cap, blk.nreads + 1, cfg,
        seed_cap=seed_cap, upper_only=False, include_self=False,
        self_only=True, min_diag=min_period, max_diag=max_period)
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": cov, "nseeds": int(nseeds),
        "total_seeds": int(total_seeds), "nhits": int(nhits),
        "total_hits": int(total_hits),
    }


def fetch_seeds_host(seeds: dict) -> dict:
    """fetch_seeds twin for host dicts (no device transfer)."""
    n = int(seeds["nseeds"])
    out = {"nseeds": n, "total_seeds": int(seeds["total_seeds"]),
           "total_hits": int(seeds["total_hits"]),
           "total_compact": int(seeds["total_compact"]),
           "overflow": bool(seeds["overflow"]),
           "raw_cap": seeds["raw_cap"],
           "compact_cap": seeds["compact_cap"]}
    for kk in ("aread", "bread", "apos", "bpos", "cov", "comp"):
        if kk in seeds:
            out[kk] = np.asarray(seeds[kk])[:n]
    return out
