"""Block-pair overlap driver (daligner equivalent).

Chains the device stages (SURVEY.md §3.2 call stack, re-designed):

  seeding (ops.seeding)  ->  batched bidirectional extension
  (ops.wave.extend_wave) ->  columnar dedupe/containment filter ->
  batched trace-point pass (ops.wave.trace_wave) -> .las records

For a block pair (A, B) both orientations of B are processed (COMP
pass aligns A against the reverse-complemented B block; .las B
coordinates are in complement space, matching the lineage convention).
Mirrored records (B as A-read) are synthesized by coordinate reflection
and their traces computed by a swapped-role trace pass, so a self-block
comparison yields the full pile for every read, like the reference's
symmetric output.

The host layer is COLUMNAR: candidate alignments ("extents") live in
struct-of-array numpy dicts from harvest through dedupe to trace
batching, so block-scale record counts (10^5-10^6 per pair at the
reference's 200+ MB block sizes) never materialize per-record Python
objects until the final .las assembly.

Read ids in emitted .las records are ABSOLUTE untrimmed DB read ids
(MARVEL convention).
"""
from __future__ import annotations

import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from damar_tpu.core.blocks import ReadBlock, revcomp_block
from damar_tpu.core.config import OverlapConfig
from damar_tpu.formats.las import (TRACE_XOVR, LasColumns, LasFile, Overlap,
                                   encode_trace_columns, n_segments)
from damar_tpu.formats.oflags import OVL_COMP
from damar_tpu.utils.platform import memory_scaled


EXT_KEYS = ("aread", "bread", "abpos", "aepos", "bbpos", "bepos",
            "diffs")

# block capacity above which a block counts as huge (the 200 Mbp
# reference block unit): sized for 16 GiB, scaled to the device's
# memory at use (utils.platform.memory_scaled)
HUGE_BLOCK = 1 << 27


def _host_compute_enabled() -> bool:
    """Whether the native-C host compute path (bit-identical replicas
    of the bp kernels + the host seeding twin) serves this process.
    The device kernels are the GPU production path; on the CPU backend
    the C replicas are several-fold faster, so they are the default
    there (DAMAR_BP=jax opts out, DAMAR_BP=native forces)."""
    mode = os.environ.get("DAMAR_BP")
    if mode == "jax":
        return False
    if mode != "native" and jax.default_backend() != "cpu":
        return False
    from damar_tpu import native
    return native.available()


def _kernels(cfg: "OverlapConfig"):
    """Select the DP kernel implementation.  Default is the
    bit-parallel band kernels (each seed's band packed in one 32-bit
    word pair): the native C replicas when the host compute path
    serves the process, the fused Pallas-Triton kernels on a GPU
    (ops.wave_bp_gpu), and XLA's build of ops.wave_bp otherwise or
    under DAMAR_BP=jax.  All three are bit-identical.
    dp_kernel="wide" selects the lane-per-diagonal reference kernels
    (ops.wave) on every platform."""
    if cfg.dp_kernel == "wide":
        from damar_tpu.ops.wave import extend_wave, trace_wave
        return extend_wave, trace_wave
    if _host_compute_enabled():
        return (partial(_native_bp_extend, R=cfg.bp_chunk),
                _native_bp_trace)
    if (jax.default_backend() == "gpu"
            and os.environ.get("DAMAR_BP") != "jax"):
        from damar_tpu.ops.wave_bp_gpu import (extend_wave_bp_gpu,
                                               trace_wave_bp_gpu)
        return partial(extend_wave_bp_gpu, R=cfg.bp_chunk), \
            trace_wave_bp_gpu
    from damar_tpu.ops.wave_bp import extend_wave_bp, trace_wave_bp
    return partial(extend_wave_bp, R=cfg.bp_chunk), trace_wave_bp


def _mask_fp(mask) -> bytes | None:
    """Cheap fingerprint of a soft-mask vector (cache key part)."""
    if mask is None:
        return None
    import hashlib
    return hashlib.blake2b(np.ascontiguousarray(mask).tobytes(),
                           digest_size=8).digest()


def _cached_a_index(blk: ReadBlock, kind: str, k: int, mask, builder):
    """A-side canonical index, memoized on the block (one entry,
    replaced when k/mask/backend changes).  Reference parity: daligner
    builds the A-block index once and sweeps it over every B block on
    the command line (upstream dalign/daligner.c ⟨VERIFY⟩); sweep
    drivers iterate the pair matrix A-row-major, so one cached entry
    captures the same reuse."""
    key = (kind, k, _mask_fp(mask))
    ent = blk.cache.get("a_index")
    if ent is not None and ent[0] == key:
        return ent[1]
    idx = builder()
    blk.cache["a_index"] = (key, idx)
    return idx


def _rc_cached(blk: ReadBlock) -> ReadBlock:
    """Per-read reverse-complement of a block, memoized on the block.
    Sweep drivers and the bench call overlap_block_pair many times on
    the same blocks; the rc copy is a block-scale host gather and (on
    the device path) a block-scale upload — both must happen once per
    block, not once per call."""
    rc = blk.cache.get("rc_block")
    if rc is None:
        rc = revcomp_block(blk)
        blk.cache["rc_block"] = rc
    return rc


def _dev_arr(blk: ReadBlock, name: str):
    """Upload-once device residency for a block array (bases/read_id).

    jnp.asarray re-uploads a host array on EVERY call, and the overlap
    driver would pay it per block pair.  The device buffer lives
    exactly as long as the block object."""
    d = blk.cache.setdefault("dev_arrs", {})
    arr = d.get(name)
    if arr is None:
        arr = jnp.asarray(getattr(blk, name))
        d[name] = arr
    return arr


def release_device_buffers(blk: ReadBlock) -> None:
    """Drop a block's cached DEVICE buffers (bases/read_id uploads,
    packed words, trace pool — and the same on its cached rc twin).
    The residency caches pin HBM for as long as the block object
    lives; sweep drivers over many blocks must bound how many blocks
    stay resident (round-3 advisor: a 200 Mbp block pins ~1.3 GB).
    Host-side caches (rc bases, host indexes) are kept — re-uploading
    is cheap next to recomputing them."""
    blk.cache.pop("dev_arrs", None)
    blk.cache.pop("trace_pool", None)
    ent = blk.cache.get("a_index")
    if ent is not None and ent[0][0] == "dev3":
        blk.cache.pop("a_index", None)
    rc = blk.cache.get("rc_block")
    if rc is not None:
        rc.cache.pop("dev_arrs", None)
        rc.cache.pop("trace_pool", None)


def _takes_packed(fn) -> bool:
    return getattr(getattr(fn, "func", fn), "takes_packed", False)


def _supports_active(fn) -> bool:
    return getattr(getattr(fn, "func", fn), "supports_active", False)


def _packed_words_of(blk: ReadBlock):
    """Block bases as device-resident _pack_bases words, memoized —
    the GPU bp kernels would repack the whole block per launch
    otherwise."""
    d = blk.cache.setdefault("dev_arrs", {})
    w = d.get("words")
    if w is None:
        from damar_tpu.ops.wave_bp import _pack_bases
        w = jax.jit(_pack_bases)(_dev_arr(blk, "bases"))
        d["words"] = w
    return w


def empty_extents() -> dict:
    out = {k: np.zeros(0, np.int32) for k in EXT_KEYS}
    out["n"] = 0
    return out


def _take_extents(ext: dict, idx) -> dict:
    out = {k: ext[k][idx] for k in EXT_KEYS}
    out["n"] = len(out["aread"])
    return out


def concat_extents(parts: list[dict]) -> dict:
    parts = [p for p in parts if p["n"]]
    if not parts:
        return empty_extents()
    out = {k: np.concatenate([p[k] for p in parts]) for k in EXT_KEYS}
    out["n"] = len(out["aread"])
    return out


def _pad(a, size, fill):
    out = np.full(size, fill, dtype=np.int32)
    out[:len(a)] = a
    return out


def _round_slice(n: int, q: int = 1024) -> int:
    """Round a prefix length up to a q multiple (bounded shape-bucket
    count for the device slice kernels)."""
    return max(q, -(-n // q) * q)


SEED_COLS = ("aread", "bread", "apos", "bpos", "cov", "comp")


def fetch_seeds(seeds_dev: dict) -> dict:
    """One-sync harvest of a find_seeds(_canonical)_dev result: reads
    all counts as one stacked scalar fetch, then pulls the seed arrays
    as ONE stacked device->host transfer of the live prefix only."""
    counts = np.asarray(jnp.stack(
        [seeds_dev["nseeds"], seeds_dev["total_seeds"],
         seeds_dev["total_hits"], seeds_dev["total_compact"],
         seeds_dev["overflow"].astype(jnp.int32)]))
    n = int(counts[0])
    cols = [k for k in SEED_COLS if k in seeds_dev]
    out = {"nseeds": n, "total_seeds": int(counts[1]),
           "total_hits": int(counts[2]), "total_compact": int(counts[3]),
           "overflow": bool(counts[4]),
           "raw_cap": seeds_dev["raw_cap"],
           "compact_cap": seeds_dev["compact_cap"]}
    if n == 0:
        for k in cols:
            out[k] = np.zeros(0, np.int32)
        return out
    m = min(_round_slice(n), seeds_dev["aread"].shape[0])
    stacked = np.asarray(jnp.stack(
        [seeds_dev[k][:m].astype(jnp.int32) for k in cols]))
    for i, k in enumerate(cols):
        out[k] = stacked[i][:n]
    return out


def dedupe_anchor_seeds(seeds: dict) -> dict:
    """Drop seeds with identical (aread, bread[, comp], apos, bpos)
    anchors.

    The diagonal filter's double-bucket pass counts every hit in its
    band and the next, so a band passing the threshold in both buckets
    emits the same anchor twice (~40% of all seeds on typical data).
    Identical anchors extend identically — dropping them is free.
    Mutates and returns `seeds`.
    """
    n = seeds["nseeds"]
    if n == 0:
        return seeds
    cols = [k for k in SEED_COLS if k in seeds]
    key = ((seeds["aread"].astype(np.int64) << 32)
           | seeds["bread"].astype(np.uint32).astype(np.int64))
    if "comp" in seeds:
        key = (key << 1) | seeds["comp"].astype(np.int64)
    pos = ((seeds["apos"].astype(np.int64) << 32)
           | seeds["bpos"].astype(np.uint32).astype(np.int64))
    from damar_tpu.ops.sort import host_lexsort
    order = host_lexsort((pos, key))
    ks, ps = key[order], pos[order]
    keep = np.concatenate([[True], (ks[1:] != ks[:-1])
                           | (ps[1:] != ps[:-1])])
    idx = np.sort(order[keep])
    for k in cols:
        seeds[k] = seeds[k][idx]
    seeds["nseeds"] = len(idx)
    return seeds


def split_seeds_by_comp(seeds: dict) -> dict:
    """Partition a canonical seed dict into per-orientation seed dicts
    {False: fwd, True: comp} (cheap views via boolean take)."""
    cols = [k for k in SEED_COLS if k in seeds and k != "comp"]
    out = {}
    cmp_col = seeds.get("comp")
    for comp in (False, True):
        sel = np.nonzero((cmp_col == 1) == comp)[0] \
            if cmp_col is not None else (
                np.arange(seeds["nseeds"]) if not comp
                else np.zeros(0, np.int64))
        part = {k: seeds[k][sel] for k in cols}
        part["nseeds"] = len(sel)
        out[comp] = part
    return out


# ---------------------------------------------------------------------------
# Device-resident extension (the GPU production path)
#
# Host<->device transfers are the one cost XLA cannot fuse away.  The
# original device flow downloaded every seed (5 MB/pass at 50 Mbp),
# deduped/split/batched on the host, re-uploaded every unit coordinate
# per launch (~13 MB/comp), and downloaded padded result stacks
# (~10 MB/comp).
# This section keeps seeds -> units -> extents ON DEVICE end-to-end:
# the host only sees a few stacked scalars, a downsampled copy of the
# length-sorted bound array (to plan launch batches), and ONE exact-
# sized packed download of the surviving extents (~16 B/extent).
# Per-pass transfer drops ~15x; results are bit-identical (the anchor
# dedupe is an exact twin of dedupe_anchor_seeds, and batching never
# affects kernel outputs — lanes are independent).
# ---------------------------------------------------------------------------

SEED_PREP_Q = 512          # bound-array downsample stride for batch planning


def fetch_seeds_meta(seeds_dev: dict) -> dict:
    """Counts-only harvest of a find_seeds(_canonical)_dev result: the
    seed arrays STAY on device (see _extend_all_dev)."""
    counts = np.asarray(jnp.stack(
        [seeds_dev["nseeds"], seeds_dev["total_seeds"],
         seeds_dev["total_hits"], seeds_dev["total_compact"],
         seeds_dev["overflow"].astype(jnp.int32),
         seeds_dev.get("total_emit", jnp.int32(0))]))
    return {"nseeds": int(counts[0]), "total_seeds": int(counts[1]),
            "total_hits": int(counts[2]), "total_compact": int(counts[3]),
            "overflow": bool(counts[4]),
            "total_emit": int(counts[5]),
            "tcap": seeds_dev.get("tcap", 0),
            "raw_cap": seeds_dev["raw_cap"],
            "compact_cap": seeds_dev["compact_cap"],
            "dev": seeds_dev}


@partial(jax.jit, static_argnames=("rb", "pb"))
def _prep_units_dev(ar, br, ap, bp, cmp_, n, a_starts, b_starts,
                    rb: int, pb: int):
    """Anchor dedupe + comp split + unit building, all on device.

    Inputs are the [n_pad] prefixes of the device seed arrays.  The
    dedupe is an exact twin of dedupe_anchor_seeds: stable sort by
    (aread, bread, comp, apos_local, bpos_local), keep the first of
    each identical-anchor group (= lowest original index), survivors
    kept in ascending original order.  Per orientation, the
    bidirectional unit arrays ([fwd | rev], ap/bp local frames), the
    stable length-sort order, and the sorted bound array are built for
    the launch planner."""
    from damar_tpu.ops.sort import pack_fields, radix_sort_packed
    n_pad = ar.shape[0]
    idx = jnp.arange(n_pad, dtype=jnp.int32)
    live = idx < n
    nA = a_starts.shape[0] - 1
    nB = b_starts.shape[0] - 1
    a0 = a_starts[jnp.clip(ar, 0, nA - 1)]
    a1 = a_starts[jnp.clip(ar + 1, 0, nA)]
    b0 = b_starts[jnp.clip(br, 0, nB - 1)]
    b1 = b_starts[jnp.clip(br + 1, 0, nB)]
    ap_l = ap - a0
    bp_l = bp - b0
    fmax = jnp.int32((1 << pb) - 1)
    rmax = jnp.int32((1 << rb) - 1)
    key_fields = (jnp.where(live, bp_l, fmax),
                  jnp.where(live, ap_l, fmax),
                  jnp.where(live, cmp_, 1),
                  jnp.where(live, br, rmax),
                  jnp.where(live, ar, rmax))
    widths = (pb, pb, 1, rb, rb)
    words = pack_fields(key_fields, widths)
    srt, (sidx,) = radix_sort_packed(words, (idx,), sum(widths))
    neq = jnp.zeros(n_pad - 1, bool)
    for w in srt:
        neq = neq | (w[1:] != w[:-1])
    first = jnp.concatenate([jnp.ones(1, bool), neq])
    kb = jnp.zeros(n_pad, bool).at[sidx].set(first & live[sidx])

    parts = []
    for comp in (0, 1):
        is_c = kb & (cmp_ == comp)
        m = is_c.sum(dtype=jnp.int32)
        pos = jnp.cumsum(is_c.astype(jnp.int32)) - 1
        sel = jnp.zeros(n_pad + 1, jnp.int32).at[
            jnp.where(is_c, pos, n_pad)].set(idx)[:n_pad]
        aps_l = ap_l[sel]
        bps_l = bp_l[sel]
        half = jnp.arange(n_pad, dtype=jnp.int32) < m
        al_f = (a1 - ap)[sel]
        bl_f = (b1 - bp)[sel]
        u_alim = jnp.concatenate([jnp.where(half, al_f, 0),
                                  jnp.where(half, aps_l, 0)])
        u_blim = jnp.concatenate([jnp.where(half, bl_f, 0),
                                  jnp.where(half, bps_l, 0)])
        u_ao = jnp.concatenate([ap[sel], ap[sel]])
        u_bo = jnp.concatenate([bp[sel], bp[sel]])
        u_rev = jnp.concatenate([jnp.zeros(n_pad, bool),
                                 jnp.ones(n_pad, bool)])
        live2 = jnp.concatenate([half, half])
        bound = jnp.where(live2, jnp.minimum(u_alim, u_blim),
                          jnp.int32(np.iinfo(np.int32).max))
        order = jnp.argsort(bound, stable=True).astype(jnp.int32)
        sb = bound[order]
        parts.append(dict(m=m, u_ao=u_ao, u_bo=u_bo, u_alim=u_alim,
                          u_blim=u_blim, u_rev=u_rev, ap_l=aps_l,
                          bp_l=bps_l, ar_s=ar[sel], br_s=br[sel],
                          order=order, sb=sb))
    return kb.sum(dtype=jnp.int32), parts[0], parts[1]


@partial(jax.jit, static_argnames=("w",))
def _slice_unit_batch(order, u_ao, u_bo, u_alim, u_blim, u_rev,
                      lo, m, w: int):
    """One launch batch's unit arrays, sliced/gathered on device
    (start `lo` and live count `m` are traced operands: no per-batch
    recompilation, no host upload).  Lanes >= m are masked dead via
    alim = 0 and scatter to the trash slot (tgt = len(u_alim))."""
    sel = jax.lax.dynamic_slice(order, (lo,), (w,))
    lane = jnp.arange(w, dtype=jnp.int32)
    ok = lane < m
    alim = jnp.where(ok, u_alim[sel], 0)
    blim = jnp.where(ok, u_blim[sel], 0)
    tgt = jnp.where(ok, sel, jnp.int32(u_alim.shape[0]))
    return u_ao[sel], u_bo[sel], alim, blim, u_rev[sel], tgt


@jax.jit
def _scatter_unit_results(va_u, vb_u, vd_u, tgt, va, vb, vd):
    return (va_u.at[tgt].set(va), vb_u.at[tgt].set(vb),
            vd_u.at[tgt].set(vd))


@jax.jit
def _scatter_unit_act(act_u, tgt, act):
    return act_u.at[tgt].set(act.astype(jnp.int32))


@jax.jit
def _p2_order_dev(act_u, u_alim, u_blim):
    """Phase-2 survivor ordering: still-active units first, stable by
    bound — equivalent to host surv[argsort(bound[surv])]."""
    n2 = u_alim.shape[0]
    act = act_u[:n2] != 0
    bound = jnp.where(act, jnp.minimum(u_alim, u_blim),
                      jnp.int32(np.iinfo(np.int32).max))
    order = jnp.argsort(bound, stable=True).astype(jnp.int32)
    return order, bound[order], act.sum(dtype=jnp.int32)


@partial(jax.jit, static_argnames=("pack16",))
def _assemble_extents_dev(va_u, vb_u, vd_u, ap_l, bp_l, ar_s, br_s,
                          pack16: bool):
    """Per-seed extent assembly + good-compaction on device.

    Unit i (fwd) and unit n_pad+i (rev) combine into seed i's extent;
    junk/dead slots produce empty spans and compact away.  pack16
    (valid when nreads and every read length fit 16 bits) packs to a
    [4, n_pad] buffer whose first `g` columns are survivors in seed
    order: [ar<<16|br, abp<<16|aep, bbp<<16|bep, diffs].  Otherwise
    raw [7, n_pad] i32 rows [ar, br, abp, aep, bbp, bep, diffs]."""
    n_pad = ap_l.shape[0]
    va_f, va_r = va_u[:n_pad], va_u[n_pad:2 * n_pad]
    vb_f, vb_r = vb_u[:n_pad], vb_u[n_pad:2 * n_pad]
    vd = vd_u[:n_pad] + vd_u[n_pad:2 * n_pad]
    abp = ap_l - va_r
    aep = ap_l + va_f
    bbp = bp_l - vb_r
    bep = bp_l + vb_f
    good = (aep - abp > 0) & (bep - bbp > 0)
    g = good.sum(dtype=jnp.int32)
    pos = jnp.cumsum(good.astype(jnp.int32)) - 1
    tgt = jnp.where(good, pos, n_pad)
    if pack16:
        rows = [(ar_s << 16) | br_s, (abp << 16) | aep,
                (bbp << 16) | bep, vd]
    else:
        rows = [ar_s, br_s, abp, aep, bbp, bep, vd]
    out = jnp.zeros((len(rows), n_pad + 1), jnp.int32)
    for i, r in enumerate(rows):
        out = out.at[i, tgt].set(r)
    return out[:, :n_pad], g


def _plan_batches_sampled(samples: np.ndarray, m_u: int, chunk_rows: int,
                          s_max: int, area: int, clip: int,
                          s_min: int = 1024,
                          Q: int = SEED_PREP_Q) -> list:
    """Equal-area launch batches from a DOWNSAMPLED ascending bound
    array (samples[i] = sorted_bound[(i+1)*Q-1], so a batch ending in
    stride i has exact max length samples[i]).  Same contract as
    _area_batches; only the width choice sees stride granularity.
    Batching never changes kernel outputs (lanes are independent)."""
    out = []
    ns = len(samples)
    lo = 0
    while lo < m_u:
        w = s_max
        while w > s_min:
            j = min((lo + w - 1) // Q, ns - 1)
            top = min(int(samples[j]), clip)
            chunks = max(top // chunk_rows + 1, 1)
            if w * chunks <= area:
                break
            w //= 2
        m = min(w, m_u - lo)
        out.append((lo, m, w))
        lo += m
    return out


def _starts32_dev(blk: ReadBlock):
    d = blk.cache.get("starts32_dev")
    if d is None:
        d = jnp.asarray(np.asarray(blk.starts, dtype=np.int32))
        blk.cache["starts32_dev"] = d
    return d


def _extend_all_dev(blk_a: ReadBlock, blk_b: ReadBlock,
                    blk_b_rc: ReadBlock, seeds_meta: dict,
                    cfg: OverlapConfig, stats: dict) -> list[dict]:
    """Device-resident dedupe + split + extension for BOTH
    orientations; returns [fwd_exts, comp_exts] host dicts (exact-
    sized packed downloads).  See the section comment above."""
    from damar_tpu.ops.seeding import quantize_bits
    sd = seeds_meta["dev"]
    n = seeds_meta["nseeds"]
    empty = [dict(empty_extents(), comp=False),
             dict(empty_extents(), comp=True)]
    if n == 0:
        stats["seeds"] += 0
        return empty
    cap = sd["aread"].shape[0]
    n_pad = min(_round_slice(n, 8192), cap)
    ar, br = sd["aread"][:n_pad], sd["bread"][:n_pad]
    ap, bp = sd["apos"][:n_pad], sd["bpos"][:n_pad]
    cmp_ = sd["comp"][:n_pad]
    a_st = _starts32_dev(blk_a)
    b_st = a_st if blk_b is blk_a else _starts32_dev(blk_b)
    maxr = int(max(blk_a.rlen.max(initial=1), blk_b.rlen.max(initial=1)))
    rb = quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1)
    pb = quantize_bits(maxr + 1)
    m_d, part0, part1 = _prep_units_dev(ar, br, ap, bp, cmp_,
                                        jnp.int32(n), a_st, b_st,
                                        rb=rb, pb=pb)
    prep = {0: part0, 1: part1}
    Q = SEED_PREP_Q
    samp = {c: prep[c]["sb"][Q - 1::Q] for c in (0, 1)}
    ns = 2 * n_pad // Q
    meta = np.asarray(jnp.concatenate(
        [jnp.stack([m_d, prep[0]["m"], prep[1]["m"]]),
         samp[0], samp[1]]))
    stats["seeds"] += int(meta[0])
    m_com = {0: int(meta[1]), 1: int(meta[2])}
    samples = {0: meta[3:3 + ns], 1: meta[3 + ns:3 + 2 * ns]}

    ext_fn, _ = _kernels(cfg)
    kw = dict(W=cfg.band_width, max_rows=cfg.max_read_len,
              diff_cost=cfg.diff_cost, xdrop=cfg.xdrop)
    if _takes_packed(ext_fn):
        kw["packed"] = True
        a_words = _packed_words_of(blk_a)
        bw_of = {0: _packed_words_of(blk_b),
                 1: _packed_words_of(blk_b_rc)}
    else:
        a_words = _dev_arr(blk_a, "bases")
        bw_of = {0: _dev_arr(blk_b, "bases"),
                 1: _dev_arr(blk_b_rc, "bases")}
    P1 = getattr(cfg, "ext_phase1_rows", 0)
    two_phase = (P1 > 0 and _supports_active(ext_fn)
                 and kw["max_rows"] > P1)
    s_max = cfg.seed_batch_dev

    def launches(u, plan, b_words, kw_extra):
        out = []
        for lo, m, w in plan:
            w = min(w, 2 * n_pad)
            ao, bo, alim, blim, rev, tgt = _slice_unit_batch(
                u["order"], u["u_ao"], u["u_bo"], u["u_alim"],
                u["u_blim"], u["u_rev"], jnp.int32(lo), jnp.int32(m),
                w)
            res = ext_fn(a_words, b_words, ao, bo, alim, blim,
                         dirs=rev, **dict(kw, **kw_extra))
            out.append((res, tgt))
        return out

    # phase 1 (or the only phase): dispatch BOTH comps before any sync
    kw1 = dict(max_rows=P1, with_active=True) if two_phase else {}
    pend1 = {}
    for c in (0, 1):
        u = prep[c]
        clip1 = P1 if two_phase else maxr
        plan1 = _plan_batches_sampled(samples[c], 2 * m_com[c],
                                      cfg.bp_chunk, s_max,
                                      AREA_CHUNKS_DEV, clip1)
        pend1[c] = launches(u, plan1, bw_of[c], kw1)
    # scatter results into unit slots (queued behind the launches)
    acc = {}
    for c in (0, 1):
        va_u = jnp.zeros(2 * n_pad + 1, jnp.int32)
        vb_u = jnp.zeros(2 * n_pad + 1, jnp.int32)
        vd_u = jnp.zeros(2 * n_pad + 1, jnp.int32)
        act_u = jnp.zeros(2 * n_pad + 1, jnp.int32)
        for res, tgt in pend1[c]:
            va_u, vb_u, vd_u = _scatter_unit_results(
                va_u, vb_u, vd_u, tgt, res[0], res[1], res[2])
            if two_phase:
                act_u = _scatter_unit_act(act_u, tgt, res[4])
        acc[c] = [va_u, vb_u, vd_u, act_u]
    if two_phase:
        # phase-2 survivor ordering on device; ONE fetch for both comps
        o2 = {c: _p2_order_dev(acc[c][3], prep[c]["u_alim"],
                               prep[c]["u_blim"]) for c in (0, 1)}
        meta2 = np.asarray(jnp.concatenate(
            [jnp.stack([o2[0][2], o2[1][2]]),
             o2[0][1][Q - 1::Q], o2[1][1][Q - 1::Q]]))
        m2 = {0: int(meta2[0]), 1: int(meta2[1])}
        samples2 = {0: meta2[2:2 + ns], 1: meta2[2 + ns:2 + 2 * ns]}
        for c in (0, 1):
            if not m2[c]:
                continue
            u2 = dict(prep[c], order=o2[c][0])
            plan2 = _plan_batches_sampled(samples2[c], m2[c],
                                          cfg.bp_chunk, s_max,
                                          AREA_CHUNKS_DEV, maxr)
            for res, tgt in launches(u2, plan2, bw_of[c], {}):
                va_u, vb_u, vd_u = _scatter_unit_results(
                    acc[c][0], acc[c][1], acc[c][2], tgt,
                    res[0], res[1], res[2])
                acc[c][:3] = [va_u, vb_u, vd_u]
    pack16 = (max(blk_a.nreads, blk_b.nreads) < 65536 and maxr < 65536)
    packs = {}
    for c in (0, 1):
        u = prep[c]
        packs[c] = _assemble_extents_dev(
            acc[c][0], acc[c][1], acc[c][2], u["ap_l"], u["bp_l"],
            u["ar_s"], u["br_s"], pack16=pack16)
    gs = np.asarray(jnp.stack([packs[0][1], packs[1][1]]))
    g = {0: int(gs[0]), 1: int(gs[1])}
    gp = {c: min(_round_slice(g[c], 4096), n_pad) for c in (0, 1)}
    data = np.asarray(jnp.concatenate(
        [packs[0][0][:, :gp[0]], packs[1][0][:, :gp[1]]], axis=1))
    out = []
    off = 0
    for c in (0, 1):
        d = data[:, off:off + g[c]]
        off += gp[c]
        if pack16:
            u = d.view(np.uint32) if d.flags.c_contiguous \
                else np.ascontiguousarray(d).view(np.uint32)
            ext = {"aread": (u[0] >> 16).astype(np.int32),
                   "bread": (u[0] & 0xFFFF).astype(np.int32),
                   "abpos": (u[1] >> 16).astype(np.int32),
                   "aepos": (u[1] & 0xFFFF).astype(np.int32),
                   "bbpos": (u[2] >> 16).astype(np.int32),
                   "bepos": (u[2] & 0xFFFF).astype(np.int32),
                   "diffs": d[3]}
        else:
            ext = {k: d[i] for i, k in enumerate(EXT_KEYS)}
        ext["n"] = g[c]
        ext["comp"] = bool(c)
        stats["extents"] += g[c]
        out.append(ext)
    return out


def extend_seeds(blk_a: ReadBlock, blk_b: ReadBlock, seeds: dict,
                 cfg: OverlapConfig, comp: bool) -> dict:
    """Bidirectional extension of all seeds -> columnar extents.

    Forward and reverse extensions are independent work units; all 2n
    units are sorted by their maximum possible extent (min of A/B room)
    and batched together with per-unit directions — a batch runs until
    its LONGEST unit finishes, so length-homogeneous batches cut the
    wasted masked rows severalfold.
    """
    pend = extend_seeds_launch(blk_a, blk_b, seeds, cfg, comp)
    return extend_seeds_harvest(pend)


def _area_batches(sorted_lens: np.ndarray, chunk_rows: int,
                  s_max: int, area_chunks: int,
                  s_min: int = 1024) -> list[tuple[int, int, int]]:
    """Variable-width launch batches over an ASCENDING length-sorted
    unit stream: each batch's width w (a power of two in
    [s_min, s_max]) satisfies w * ceil(batch_max_len/chunk_rows) <=
    area_chunks, so launches cover a roughly constant seed-chunk area.

    Fixed-width batching makes the launch count scale with
    n_units/width while long-tail batches run hundreds of device-loop
    iterations at full width; equal-area batches give the short bulk
    (most units) wide launches and the long tail narrow ones, cutting
    total loop iterations ~4x at 50 Mbp with the same padded work.
    Results are unaffected: the kernels are lane-independent, so any
    partitioning computes identical per-unit outputs.

    Returns [(lo, m, width)]: units sorted_order[lo:lo+m] padded to
    width."""
    n = len(sorted_lens)
    out = []
    lo = 0
    while lo < n:
        w = s_max
        while w > s_min:
            top = sorted_lens[min(lo + w, n) - 1]
            chunks = max(int(top) // chunk_rows + 1, 1)
            if w * chunks <= area_chunks:
                break
            w //= 2
        m = min(w, n - lo)
        out.append((lo, m, w))
        lo += m
    return out


# seed-chunks per device launch (width x loop-iterations); tuned so
# the bulk of short units rides 32-64k-wide launches while 64-band
# tails stay at the 1024 floor
AREA_CHUNKS_DEV = 1 << 19


def extend_seeds_launch(blk_a: ReadBlock, blk_b: ReadBlock,
                        seeds: dict, cfg: OverlapConfig, comp: bool,
                        dev_bases=None) -> dict | None:
    """Dispatch all extension batches asynchronously.

    Returns a pending handle for extend_seeds_harvest.  Results stay
    on device; the harvest concatenates them there and performs ONE
    device->host transfer — per-batch readbacks would serialize on
    the device link round-trip latency.
    dev_bases: optional (a_bases_dev, b_bases_dev) already uploaded.
    """
    n = seeds["nseeds"]
    if n == 0:
        return None
    ext_fn, _ = _kernels(cfg)
    host = getattr(ext_fn, "host_kernel", False)
    S = cfg.seed_batch if host else cfg.seed_batch_dev
    if host:
        a_bases, b_bases = blk_a.bases, blk_b.bases
    elif dev_bases is not None:
        a_bases, b_bases = dev_bases
    else:
        a_bases = jnp.asarray(blk_a.bases)
        b_bases = jnp.asarray(blk_b.bases)
    sa = blk_a.starts.astype(np.int64)
    sb = blk_b.starts.astype(np.int64)
    ar_all = seeds["aread"][:n]
    br_all = seeds["bread"][:n]
    ap_all = seeds["apos"][:n]
    bp_all = seeds["bpos"][:n]
    a0 = sa[ar_all]
    a1 = sa[ar_all + 1]
    b0 = sb[br_all]
    b1 = sb[br_all + 1]
    # unit arrays: [fwd units | rev units]
    u_alim = np.concatenate([a1 - ap_all, ap_all - a0]).astype(np.int32)
    u_blim = np.concatenate([b1 - bp_all, bp_all - b0]).astype(np.int32)
    u_rev = np.concatenate([np.zeros(n, bool), np.ones(n, bool)])
    u_ao = np.concatenate([ap_all, ap_all]).astype(np.int32)
    u_bo = np.concatenate([bp_all, bp_all]).astype(np.int32)
    bound = np.minimum(u_alim, u_blim)
    order = np.argsort(bound, kind="stable").astype(np.int64)

    kw = dict(W=cfg.band_width, max_rows=cfg.max_read_len,
              diff_cost=cfg.diff_cost, xdrop=cfg.xdrop)
    if not host and _takes_packed(ext_fn):
        a_bases = _packed_words_of(blk_a)
        b_bases = _packed_words_of(blk_b)
        kw["packed"] = True
    arr = (lambda x: x) if host else jnp.asarray

    def launch(sel_order, sel_bound, batches, kw_extra):
        out = []
        for lo, m, w in batches:
            sel = sel_order[lo:lo + m]
            res = ext_fn(
                a_bases, b_bases,
                arr(_pad(u_ao[sel], w, 0)),
                arr(_pad(u_bo[sel], w, 0)),
                arr(_pad(u_alim[sel], w, 0)),
                arr(_pad(u_blim[sel], w, 0)),
                dirs=arr(np.pad(u_rev[sel], (0, w - m))),
                **dict(kw, **kw_extra))
            out.append(res)
        return out

    def stack(results):
        xp = np if host else jnp
        return xp.concatenate(
            [xp.stack([r[0][:], r[1][:], r[2][:]]) for r in results],
            axis=1)

    P1 = getattr(cfg, "ext_phase1_rows", 0)
    two_phase = (not host and P1 > 0 and _supports_active(ext_fn)
                 and kw["max_rows"] > P1)
    if host:
        batches = [(lo, min(S, 2 * n - lo), S)
                   for lo in range(0, 2 * n, S)]
    elif two_phase:
        # phase 1: shallow uniform launches over ALL units — most
        # false seeds die by X-drop within a chunk or two, so running
        # every unit to its length bound wastes the batch on its
        # longest member; the active mask marks the survivors that
        # genuinely need depth
        batches = _area_batches(np.minimum(bound[order], P1),
                                cfg.bp_chunk, S, AREA_CHUNKS_DEV)
    else:
        batches = _area_batches(bound[order], cfg.bp_chunk, S,
                                AREA_CHUNKS_DEV)
    # launch every batch before harvesting any: dispatch is async, so
    # the device queue stays full (host kernels run synchronously)
    kw1 = dict(max_rows=P1, with_active=True) if two_phase else {}
    results = launch(order, bound, batches, kw1)
    stacked = stack(results)
    pend = dict(stacked=stacked, order=order, n=n, batches=batches,
                comp=comp, ar=ar_all, br=br_all, ap=ap_all, bp=bp_all,
                a0=a0, b0=b0, p2=None)
    if two_phase:
        # the phase-1 active-mask fetch is a device sync: defer it (and
        # the phase-2 dispatch) so callers can put BOTH orientations'
        # phase-1 launches in flight first (round-3 advisor: fetching
        # here serialized the two comp pipelines)
        pend["p2_pending"] = dict(
            results=results, launch=launch, stack=stack, bound=bound,
            S=S, bp_chunk=cfg.bp_chunk)
    return pend


def extend_seeds_dispatch_p2(pend: dict | None) -> None:
    """Fetch the phase-1 active mask and dispatch the full-depth
    phase-2 launches for surviving units (a deterministic re-run from
    row 0 — dead units' phase-1 results are already final, so outputs
    are identical to a single full-depth pass).  Idempotent; called by
    extend_seeds_harvest if the caller didn't."""
    if pend is None:
        return
    pp = pend.pop("p2_pending", None)
    if pp is None:
        return
    results, launch, stack = pp["results"], pp["launch"], pp["stack"]
    bound = pp["bound"]
    n = pend["n"]
    act = np.asarray(jnp.concatenate([r[4] for r in results]))
    act_units = np.zeros(2 * n, bool)
    off = 0
    for (lo, m, w), r in zip(pend["batches"], results):
        act_units[pend["order"][lo:lo + m]] = act[off:off + m]
        off += w
    surv = np.nonzero(act_units)[0]
    if len(surv):
        order2 = surv[np.argsort(bound[surv],
                                 kind="stable")].astype(np.int64)
        batches2 = _area_batches(bound[order2], pp["bp_chunk"],
                                 pp["S"], AREA_CHUNKS_DEV)
        pend["p2"] = dict(order=order2, batches=batches2,
                          stacked=stack(launch(order2, bound,
                                               batches2, {})))


def extend_seeds_harvest(pend: dict | None) -> dict:
    """Fetch one extend_seeds_launch (single transfer) and build the
    columnar per-seed extents (rows with empty spans dropped)."""
    if pend is None:
        return empty_extents()
    extend_seeds_dispatch_p2(pend)
    n = pend["n"]
    res = np.asarray(pend["stacked"])          # [3, sum(widths)]
    # undo batch padding: batch (lo, m, w) covered order[lo:lo+m] at
    # stacked offset sum of previous widths
    inv = np.empty(2 * n, np.int64)
    pos_parts = []
    off = 0
    for lo, m, w in pend["batches"]:
        pos_parts.append(np.arange(off, off + m))
        off += w
    inv[pend["order"]] = np.concatenate(pos_parts)
    va = res[0][inv]
    vb = res[1][inv]
    vd = res[2][inv]
    if pend.get("p2") is not None:
        # two-phase: overwrite survivors with their full-depth results
        p2 = pend["p2"]
        res2 = np.asarray(p2["stacked"])
        off = 0
        for lo, m, w in p2["batches"]:
            sel = p2["order"][lo:lo + m]
            va[sel] = res2[0][off:off + m]
            vb[sel] = res2[1][off:off + m]
            vd[sel] = res2[2][off:off + m]
            off += w
    ap_l = (pend["ap"] - pend["a0"]).astype(np.int64)  # read-local
    bp_l = (pend["bp"] - pend["b0"]).astype(np.int64)
    abp = ap_l - va[n:]
    aep = ap_l + va[:n]
    bbp = bp_l - vb[n:]
    bep = bp_l + vb[:n]
    good = (aep - abp > 0) & (bep - bbp > 0)
    out = {
        "aread": pend["ar"][good].astype(np.int32),
        "bread": pend["br"][good].astype(np.int32),
        "abpos": abp[good].astype(np.int32),
        "aepos": aep[good].astype(np.int32),
        "bbpos": bbp[good].astype(np.int32),
        "bepos": bep[good].astype(np.int32),
        "diffs": (vd[:n] + vd[n:])[good].astype(np.int32),
    }
    out["n"] = len(out["aread"])
    return out


def dedupe_extents(ext: dict, min_len: int,
                   max_err: float | None = None) -> dict:
    """Drop short alignments, exact duplicates, and alignments whose A
    and B intervals are both contained in another alignment of the same
    (aread, bread, comp-partition) group (the reference's bridge/dedupe
    step), fully vectorized.

    Containment implies the container's A-span is >= the contained's,
    so under a (group, -alen, abpos, bbpos) sort every dominator
    precedes its dominated rows, and containment nests transitively —
    "dominated by ANY earlier row in the group" is therefore exactly
    "dominated by a kept row".  Groups are compared all-pairs in padded
    [ngroups, G, G] batches (G = per-group size, overwhelmingly small;
    rare big groups fall back to a per-group O(g^2) numpy sweep).
    """
    alen = ext["aepos"] - ext["abpos"]
    ok = alen >= min_len
    if max_err is not None and ext["n"]:
        # daligner -e: drop alignments whose pairwise error rate
        # (diffs over the mean span) exceeds 1 - err
        span = (alen + (ext["bepos"] - ext["bbpos"])) / 2.0
        ok &= ext["diffs"] <= max_err * np.maximum(span, 1)
    if not ok.any():
        return empty_extents()
    e = _take_extents(ext, np.nonzero(ok)[0])
    alen = e["aepos"] - e["abpos"]
    gkey = (e["aread"].astype(np.int64) << 32) | e["bread"].astype(
        np.uint32).astype(np.int64)
    from damar_tpu.ops.sort import host_lexsort
    order = host_lexsort((e["bbpos"], e["abpos"],
                          int(alen.max()) - alen if len(alen) else alen,
                          gkey))
    e = _take_extents(e, order)
    gkey = gkey[order]
    n = e["n"]
    new_g = np.concatenate([[True], gkey[1:] != gkey[:-1]])
    gid = np.cumsum(new_g) - 1
    g_start = np.nonzero(new_g)[0]
    g_size = np.diff(np.concatenate([g_start, [n]]))
    rank = np.arange(n) - g_start[gid]

    drop = np.zeros(n, bool)
    GCAP = 64
    small = g_size[gid] <= GCAP
    # exact-duplicate pass (covers all group sizes)
    same = np.zeros(n, bool)
    same[1:] = ((gkey[1:] == gkey[:-1])
                & (e["abpos"][1:] == e["abpos"][:-1])
                & (e["aepos"][1:] == e["aepos"][:-1])
                & (e["bbpos"][1:] == e["bbpos"][:-1])
                & (e["bepos"][1:] == e["bepos"][:-1]))
    drop |= same

    if small.any():
        sm_g = np.nonzero((g_size <= GCAP) & (g_size > 1))[0]
        if len(sm_g):
            G = int(g_size[sm_g].max())
            idx = g_start[sm_g][:, None] + np.arange(G)[None, :]
            valid = np.arange(G)[None, :] < g_size[sm_g][:, None]
            idxc = np.minimum(idx, n - 1)
            ab = np.where(valid, e["abpos"][idxc], 0)
            ae = np.where(valid, e["aepos"][idxc], -1)
            bb = np.where(valid, e["bbpos"][idxc], 0)
            be = np.where(valid, e["bepos"][idxc], -1)
            # dom[g, i, j]: row j dominated by earlier row i
            earlier = (np.arange(G)[:, None] < np.arange(G)[None, :])
            dom = ((ab[:, :, None] <= ab[:, None, :])
                   & (ae[:, :, None] >= ae[:, None, :])
                   & (bb[:, :, None] <= bb[:, None, :])
                   & (be[:, :, None] >= be[:, None, :])
                   & earlier[None] & valid[:, :, None]
                   & valid[:, None, :])
            dmask = dom.any(axis=1)                # [ng, G]
            drop[idxc[valid & dmask]] = True
    big_g = np.nonzero(g_size > GCAP)[0]
    for g in big_g:
        s, z = g_start[g], g_size[g]
        ab = e["abpos"][s:s + z]
        ae = e["aepos"][s:s + z]
        bb = e["bbpos"][s:s + z]
        be = e["bepos"][s:s + z]
        earlier = np.arange(z)[:, None] < np.arange(z)[None, :]
        dom = ((ab[:, None] <= ab[None, :]) & (ae[:, None] >= ae[None, :])
               & (bb[:, None] <= bb[None, :])
               & (be[:, None] >= be[None, :]) & earlier)
        drop[s:s + z] |= dom.any(axis=0)
    return _take_extents(e, np.nonzero(~drop)[0])


@partial(jax.jit, static_argnames=("total_cap",))
def _pack_trace_jit(tr, expect, total_cap: int):
    """Compact a padded trace buffer [S, segs, 2] into a ragged-concat
    [total_cap, 2] using host-known per-row segment counts `expect`
    [S] — shipping only real segments through the device link instead
    of the padded buffer."""
    S = expect.shape[0]
    starts = jnp.cumsum(expect) - expect                 # exclusive
    total = starts[-1] + expect[-1]
    ind = jnp.zeros(total_cap, jnp.int32).at[
        jnp.minimum(starts, total_cap - 1)].add(
        jnp.where(expect > 0, 1, 0))
    row = jnp.cumsum(ind) - 1                            # [total_cap]
    row = jnp.clip(row, 0, S - 1)
    j = jnp.arange(total_cap, dtype=jnp.int32)
    seg = jnp.clip(j - starts[row], 0, tr.shape[1] - 1)
    out = tr[row, seg]                                   # [total_cap, 2]
    return jnp.where((j < total)[:, None], out, -1)


def _n_segments_vec(abp: np.ndarray, aep: np.ndarray, tspace: int):
    return np.where(aep > abp,
                    (aep - 1) // tspace - abp // tspace + 1, 0
                    ).astype(np.int32)


def _wide_trace_kernel(cfg: "OverlapConfig"):
    """The wide-band trace kernel: the robustness fallback for extents
    the 32-lane bit-parallel band cannot force through (long
    low-identity stretches, e.g. stitched records spanning quality
    dropouts).  The native C per-segment banded DP on every platform
    (these records are rare, and the host twin keeps the .las bytes of
    the GPU and host paths equal); the pure-JAX wide kernel (ops.wave)
    only where no C toolchain exists."""
    from damar_tpu import native
    if native.available():
        return _native_wide_trace
    from damar_tpu.ops.wave import trace_wave
    return trace_wave


def _retry_tiers(cfg: "OverlapConfig") -> list:
    """Trace kernels for extents the default band could not force
    through, in the order they are tried: the 64-diagonal bit-parallel
    tier (native C; ~2x the default band's cost), then the wide
    (128-lane) DP — stitchable low-identity stretches exceed the
    bit-parallel bands' reach.  Host kernels on every platform (no JAX
    twin), so the GPU and host paths, the pair driver and the ring
    sweep all emit the same bytes."""
    from damar_tpu import native
    tiers = [_native_bp64_trace] if native.available() else []
    return tiers + [_wide_trace_kernel(cfg)]


def _native_wide_trace(a_bases, b_bases, astart, bstart, abpos, bbpos,
                       alim, blim, tspace: int, W: int, max_segs: int):
    """trace_wave-signature wrapper over native.trace_points_batch
    (host arrays; read-local coordinates + block origins)."""
    from damar_tpu import native
    a = np.asarray(a_bases)
    b = np.asarray(b_bases)
    ab = np.asarray(abpos, np.int64)
    bb = np.asarray(bbpos, np.int64)
    return native.trace_points_batch(
        a, b, np.asarray(astart, np.int64), np.asarray(bstart, np.int64),
        ab, ab + np.asarray(alim, np.int64),
        bb, bb + np.asarray(blim, np.int64),
        tspace=tspace, band=W, max_segs=max_segs)


def _native_bp_extend(a_bases, b_bases, aorigin, borigin, alim, blim,
                      reverse: bool = False, R: int = 128,
                      max_rows: int = 65536, diff_cost: int = 5,
                      xdrop: int = 60, dirs=None, W: int = 128,
                      SB: int = 256):
    """extend_wave_bp-signature wrapper over native.bp_extend_batch —
    the C replica is bit-identical to the JAX kernel (see
    tests/test_native_bp.py), so the CPU fallback path (DAMAR_BP=
    native) produces the same .las byte-for-byte.  W/SB are accepted
    for signature parity (the bp band is fixed at 32 diagonals)."""
    from damar_tpu import native
    rv = (np.asarray(dirs) if dirs is not None
          else np.full(np.asarray(aorigin).shape[0], reverse, bool))
    return native.bp_extend_batch(
        np.asarray(a_bases), np.asarray(b_bases), np.asarray(aorigin),
        np.asarray(borigin), np.asarray(alim), np.asarray(blim), rv,
        R=R, max_rows=max_rows, diff_cost=diff_cost, xdrop=xdrop)


_native_bp_extend.host_kernel = True


def _native_bp_trace(a_bases, b_bases, astart, bstart, abpos, bbpos,
                     alim, blim, tspace: int = 100, max_segs: int = 660,
                     W: int = 128, SB: int = 256):
    """trace_wave_bp-signature wrapper over native.bp_trace_batch
    (bit-identical C replica; W/SB accepted for signature parity)."""
    from damar_tpu import native
    return native.bp_trace_batch(
        np.asarray(a_bases), np.asarray(b_bases), np.asarray(astart),
        np.asarray(bstart), np.asarray(abpos), np.asarray(bbpos),
        np.asarray(alim), np.asarray(blim), tspace=tspace,
        max_segs=max_segs)


_native_bp_trace.host_kernel = True


def _native_bp64_trace(a_bases, b_bases, astart, bstart, abpos, bbpos,
                       alim, blim, tspace: int = 100,
                       max_segs: int = 660, W: int = 128,
                       SB: int = 256):
    """64-diagonal bit-parallel trace (native-only retry tier): ~2x
    the 32-lane kernel's cost vs ~100x for the wide per-cell DP, and
    it forces through most drift failures."""
    from damar_tpu import native
    return native.bp_trace_batch(
        np.asarray(a_bases), np.asarray(b_bases), np.asarray(astart),
        np.asarray(bstart), np.asarray(abpos), np.asarray(bbpos),
        np.asarray(alim), np.asarray(blim), tspace=tspace,
        max_segs=max_segs, wide=True)


_native_bp64_trace.host_kernel = True


def _pack_trace_np(tr: np.ndarray, expect: np.ndarray,
                   total_cap: int) -> np.ndarray:
    """Numpy twin of _pack_trace_jit for host trace kernels."""
    S = len(expect)
    starts = np.cumsum(expect) - expect
    total = min(int(starts[-1] + expect[-1]) if S else 0, total_cap)
    out = np.full((total_cap, 2), -1, np.int32)
    if total:
        rows = np.repeat(np.arange(S), expect)[:total]
        seg = (np.arange(total) - np.repeat(starts, expect)[:total])
        seg = np.minimum(seg, tr.shape[1] - 1)
        out[:total] = tr[rows, seg]
    return out


def _trace_launch(a_bases, b_bases, a_starts, b_starts, coords: dict,
                  cfg: OverlapConfig, kernel=None):
    """Launch (async) the trace pass for a batch of extents.

    coords: columnar dict with int32 arrays ar, br, abp, aep, bbp, bep
    in the role/orientation of THIS pass (may be mirrored).  Returns a
    pending handle for _trace_finish — callers queue several launches
    before harvesting so the device never waits on the host round trip.
    kernel: optional trace-kernel override (e.g. _wide_trace_kernel).
    """
    S = len(coords["ar"])
    if S == 0:
        return None
    ar, br = coords["ar"], coords["br"]
    abp, aep = coords["abp"], coords["aep"]
    bbp, bep = coords["bbp"], coords["bep"]
    if "ast" in coords:
        # pre-resolved absolute starts (merged launch stream over a
        # concatenated oriented base pool)
        astart, bstart = coords["ast"], coords["bst"]
    else:
        astart, bstart = a_starts[ar], b_starts[br]
    # bucket the trace buffer to the batch's real segment need (batches
    # are length-sorted, so the bucket is tight); power-of-two buckets
    # keep the compile cache small
    expect = _n_segments_vec(abp, aep, cfg.tspace)
    need = int(expect.max()) + 2
    cap_segs = cfg.max_read_len // cfg.tspace + 2
    max_segs = 8
    while max_segs < min(need, cap_segs):
        max_segs *= 2
    max_segs = min(max_segs, cap_segs)
    trace_fn = kernel if kernel is not None else _kernels(cfg)[1]
    # (bases, packed-words) pool pairs: kernels that accept the packed
    # form skip the per-launch block-scale repack
    kw_packed = {}
    if isinstance(a_bases, tuple):
        if _takes_packed(trace_fn) and a_bases[1] is not None:
            a_bases = b_bases = a_bases[1]
            kw_packed["packed"] = True
        else:
            a_bases = b_bases = a_bases[0]
    # host kernels take numpy directly: wrapping their args in
    # jnp.asarray makes every launch pay device round trips on a
    # non-CPU backend (upload + the kernel's np.asarray fetch-back)
    arr = ((lambda x: x) if getattr(trace_fn, "host_kernel", False)
           else jnp.asarray)
    tr, nseg, dsum = trace_fn(
        a_bases, b_bases,
        arr(astart.astype(np.int32)),
        arr(bstart.astype(np.int32)),
        arr(abp), arr(bbp),
        arr(aep - abp), arr(bep - bbp),
        tspace=cfg.tspace, W=cfg.band_width, max_segs=max_segs,
        **kw_packed)
    total_cap = _round_slice(int(expect.sum()), 2048)
    if isinstance(tr, np.ndarray):            # host trace kernel
        packed = _pack_trace_np(tr, expect, total_cap)
    else:
        packed = _pack_trace_jit(tr, jnp.asarray(expect), total_cap)
    return dict(packed=packed, nseg=nseg, dsum=dsum, expect=expect,
                abp=abp, aep=aep, bbp=bbp, bep=bep, S=S)


def _finish_from_host(packed, nseg, dsum, pend, cfg: OverlapConfig):
    """Validate fetched trace arrays; returns (offs [S+1], ok bool[S],
    packed [total, 2], dsum [S]) — per-extent slices are
    packed[offs[i]:offs[i+1]] for rows with ok[i]."""
    expect = pend["expect"]
    offs = np.concatenate([[0], np.cumsum(expect)])
    bbp, bep = pend["bbp"], pend["bep"]
    nz = offs[:-1] < offs[1:]
    bsum = np.zeros(pend["S"], np.int64)
    tmin = np.zeros(pend["S"], np.int64)
    tmax = np.zeros(pend["S"], np.int64)
    if offs[-1] > 0:
        bsum[nz] = np.add.reduceat(
            packed[:offs[-1], 1], offs[:-1][nz])
        tmin[nz] = np.minimum.reduceat(
            packed[:offs[-1], :].min(axis=1), offs[:-1][nz])
        tmax[nz] = np.maximum.reduceat(
            packed[:offs[-1], :].max(axis=1), offs[:-1][nz])
    # trace values must fit the file encoding (u8 for small tspace);
    # over-range records go to the wide retry, then count as dropped
    enc_max = 255 if cfg.tspace <= TRACE_XOVR else 32767
    ok = (nseg == expect) & (bsum == (bep - bbp)) & (tmin >= 0) \
        & (tmax <= enc_max)
    return offs, ok, packed, np.asarray(dsum)


def _trace_finish(pend, cfg: OverlapConfig):
    """Harvest one _trace_launch -> (offs, ok, packed, dsum)."""
    if pend is None:
        return None
    packed = np.asarray(pend["packed"])
    nseg = np.asarray(pend["nseg"])
    dsum = np.asarray(pend["dsum"])
    return _finish_from_host(packed, nseg, dsum, pend, cfg)


def _trace_harvest_all(pends: list, cfg: OverlapConfig) -> list:
    """Harvest many _trace_launch handles with TWO device->host
    transfers total (one for all packed traces, one for all counts) —
    per-launch readbacks each pay the device link round trip."""
    live = [p for p in pends if p is not None]
    if not live:
        return [None for _ in pends]
    if all(isinstance(p["packed"], np.ndarray) for p in live):
        packed_all = np.concatenate([p["packed"] for p in live])
        counts_all = np.concatenate(
            [np.stack([np.asarray(p["nseg"]), np.asarray(p["dsum"])],
                      axis=1) for p in live])
    else:
        packed_all = np.asarray(jnp.concatenate(
            [p["packed"] for p in live]))
        counts_all = np.asarray(jnp.concatenate(
            [jnp.stack([p["nseg"], p["dsum"]], axis=1) for p in live]))
    out, po, co = [], 0, 0
    for p in pends:
        if p is None:
            out.append(None)
            continue
        tc = p["packed"].shape[0]
        packed = packed_all[po:po + tc]
        nseg = counts_all[co:co + p["S"], 0]
        dsum = counts_all[co:co + p["S"], 1]
        po += tc
        co += p["S"]
        out.append(_finish_from_host(packed, nseg, dsum, p, cfg))
    return out


def _trace_batch(a_bases, b_bases, a_starts, b_starts, coords: dict,
                 cfg: OverlapConfig, kernel=None):
    """Synchronous launch+finish (used by retrace_las and retries)."""
    return _trace_finish(
        _trace_launch(a_bases, b_bases, a_starts, b_starts, coords,
                      cfg, kernel=kernel), cfg)


def retrace_las(las: LasFile, blk_a: ReadBlock, blk_b: ReadBlock,
                cfg: OverlapConfig, only: list[Overlap] | None = None
                ) -> int:
    """Recompute trace arrays + diffs for records in-place (used after
    LAstitch merges fragments, whose traces must span the merged
    extent).  blk_a/blk_b: blocks containing the a-/b-reads (absolute
    ids mapped via blk.ids).  Returns number of records dropped
    (replaced trace inconsistent -> flagged discard)."""
    from damar_tpu.formats.oflags import OVL_DISCARD
    a_local = {int(i): j for j, i in enumerate(blk_a.ids)}
    b_local = {int(i): j for j, i in enumerate(blk_b.ids)}
    blk_b_rc = revcomp_block(blk_b)
    a_bases = jnp.asarray(blk_a.bases)
    sa = blk_a.starts.astype(np.int64)
    sb = blk_b.starts.astype(np.int64)
    dropped = 0
    targets = only if only is not None else las.overlaps
    S = cfg.seed_batch
    for comp in (False, True):
        sel = [o for o in targets if bool(o.flags & OVL_COMP) == comp]
        sel.sort(key=lambda o: o.aepos - o.abpos)
        bb = jnp.asarray((blk_b_rc if comp else blk_b).bases)
        for lo in range(0, len(sel), S):
            chunk = sel[lo:lo + S]
            coords = dict(
                ar=np.array([a_local[o.aread] for o in chunk], np.int32),
                br=np.array([b_local[o.bread] for o in chunk], np.int32),
                abp=np.array([o.abpos for o in chunk], np.int32),
                aep=np.array([o.aepos for o in chunk], np.int32),
                bbp=np.array([o.bbpos for o in chunk], np.int32),
                bep=np.array([o.bepos for o in chunk], np.int32))
            # stitched records span low-identity patches by
            # construction: use the wide trace band directly
            res = _trace_batch(a_bases, bb, sa, sb, coords, cfg,
                               kernel=_wide_trace_kernel(cfg))
            offs, okv, packed, dsum = res
            for i, o in enumerate(chunk):
                if not okv[i]:
                    o.flags |= OVL_DISCARD
                    dropped += 1
                else:
                    o.trace = packed[offs[i]:offs[i + 1]].copy()
                    o.diffs = int(dsum[i])
    return dropped


def retrace_rows(las: LasFile, rows: np.ndarray, blk_a: ReadBlock,
                 blk_b: ReadBlock, cfg: OverlapConfig) -> int:
    """Columnar retrace_las: recompute trace arrays + diffs for the
    given ROW INDICES of a columnar las in place (splicing the payload
    buffer).  Rows whose recomputed trace is inconsistent — or whose
    reads are not present in the provided blocks — are flagged
    OVL_DISCARD with an empty trace.  Returns the number dropped."""
    from damar_tpu.formats.las import (H_ABPOS, H_AEPOS, H_AREAD,
                                       H_BBPOS, H_BEPOS, H_BREAD,
                                       H_DIFFS, H_FLAGS, H_TLEN)
    from damar_tpu.formats.oflags import OVL_DISCARD
    cols = las.columns
    assert cols is not None, "retrace_rows needs a columnar las"
    rows = np.asarray(rows, dtype=np.int64)
    if not len(rows):
        return 0
    h = cols.headers
    a_local = {int(i): j for j, i in enumerate(blk_a.ids)}
    b_local = {int(i): j for j, i in enumerate(blk_b.ids)}
    blk_b_rc = revcomp_block(blk_b)
    a_bases = jnp.asarray(blk_a.bases)
    sa = blk_a.starts.astype(np.int64)
    sb = blk_b.starts.astype(np.int64)
    small = cfg.tspace <= TRACE_XOVR
    wide = _wide_trace_kernel(cfg)
    new_rows: dict[int, np.ndarray] = {}
    dropped = 0
    S = cfg.seed_batch
    # rows whose reads aren't in the provided blocks can't be retraced
    # here (e.g. a per-block pile whose B-read lives in another block
    # and no combined block was passed): discard, don't crash
    known = np.array([int(a) in a_local and int(b) in b_local
                      for a, b in zip(h[rows, H_AREAD],
                                      h[rows, H_BREAD])])
    for r in rows[~known]:
        h[r, H_FLAGS] = np.int32(np.uint32(h[r, H_FLAGS]) | OVL_DISCARD)
        h[r, H_TLEN] = 0
        new_rows[int(r)] = np.zeros((0, 2), np.int32)
        dropped += 1
    rows = rows[known]
    if not len(rows):
        rows = np.zeros(0, np.int64)
    comp_bits = (h[rows, H_FLAGS] & 1).astype(bool)
    for comp in (False, True):
        sel = rows[comp_bits == comp]
        if not len(sel):
            continue
        sel = sel[np.argsort(h[sel, H_AEPOS] - h[sel, H_ABPOS],
                             kind="stable")]
        bb = jnp.asarray((blk_b_rc if comp else blk_b).bases)
        for lo in range(0, len(sel), S):
            chunk_rows = sel[lo:lo + S]
            coords = dict(
                ar=np.array([a_local[int(r)] for r in
                             h[chunk_rows, H_AREAD]], np.int32),
                br=np.array([b_local[int(r)] for r in
                             h[chunk_rows, H_BREAD]], np.int32),
                abp=h[chunk_rows, H_ABPOS].astype(np.int32),
                aep=h[chunk_rows, H_AEPOS].astype(np.int32),
                bbp=h[chunk_rows, H_BBPOS].astype(np.int32),
                bep=h[chunk_rows, H_BEPOS].astype(np.int32))
            res = _trace_batch(a_bases, bb, sa, sb, coords, cfg,
                               kernel=wide)
            offs, okv, packed, dsum = res
            for i, r in enumerate(chunk_rows):
                if not okv[i]:
                    h[r, H_FLAGS] = np.int32(
                        np.uint32(h[r, H_FLAGS]) | OVL_DISCARD)
                    h[r, H_TLEN] = 0
                    new_rows[int(r)] = np.zeros((0, 2), np.int32)
                    dropped += 1
                else:
                    tr = packed[offs[i]:offs[i + 1]]
                    h[r, H_TLEN] = 2 * len(tr)
                    h[r, H_DIFFS] = int(dsum[i])
                    new_rows[int(r)] = tr
    # splice the payload: rebuild offsets with the new per-row lengths
    width = 2 if small else 4
    lens = np.diff(cols.offsets)
    new_lens = lens.copy()
    for r, tr in new_rows.items():
        new_lens[r] = tr.shape[0] * width
    offs2 = np.zeros(cols.n + 1, np.int64)
    np.cumsum(new_lens, out=offs2[1:])
    buf = np.zeros(int(offs2[-1]), np.uint8)
    untouched = np.ones(cols.n, bool)
    untouched[list(new_rows)] = False
    # bulk-copy untouched rows' bytes, then write the recomputed ones
    if cols.offsets[-1]:
        src = np.arange(int(cols.offsets[-1]), dtype=np.int64)[
            np.repeat(untouched, lens)]
        if len(src):
            u = np.nonzero(untouched)[0]
            ul = lens[u]
            dst = (np.arange(int(ul.sum()), dtype=np.int64)
                   - np.repeat(np.cumsum(ul) - ul, ul)
                   + np.repeat(offs2[:-1][u], ul))
            buf[dst] = cols.trace[src]
    for r, tr in new_rows.items():
        if tr.shape[0]:
            flat = (tr.astype(np.uint8).reshape(-1) if small
                    else tr.astype("<i2").reshape(-1).view(np.uint8))
            buf[offs2[r]:offs2[r + 1]] = flat
    cols.trace = buf
    cols.offsets = offs2
    return dropped


def default_caps(blk_a: ReadBlock, blk_b: ReadBlock) -> tuple[int, int]:
    """(hit_cap, seed_cap) for a block pair whose caller names none.
    The hit buffer is sized from the exact count phase total, so
    hit_cap only bounds it (cumulative counts are int32); the seed
    buffer is static, one anchor slot per 32 block positions (the
    overflow retry grows it up to 4x).  Fixed small defaults silently
    truncated the hits of 200 Mbp blocks."""
    cap = max(blk_a.cap, blk_b.cap)
    seed_cap = 1 << 17
    while seed_cap < cap // 32:
        seed_cap *= 2
    return 1 << 30, seed_cap


def overlap_block_pair(blk_a: ReadBlock, blk_b: ReadBlock,
                       cfg: OverlapConfig, self_block: bool,
                       mask_a=None, mask_b=None,
                       hit_cap: int | None = None,
                       seed_cap: int | None = None,
                       emit_mirrors: bool = True,
                       size_hints: dict | None = None,
                       ) -> tuple[LasFile, LasFile, dict]:
    """Overlap all reads of block A against block B (both orientations).

    Returns (las_a, las_b, stats): las_a holds records with A-block
    reads as aread; las_b the mirrored records (B-block reads as
    aread; equal to las_a for self comparisons where both land in the
    same pile set).  For self_block, las_b contains the mirrors within
    the same block and callers should merge las_a + las_b.

    size_hints: optional mutable dict carried across pairs by sweep
    drivers.  Hit totals are similar between pairs of the same
    dataset, so the previous pair's measured total right-sizes this
    pair's fixed device buffers (fill + banding-sort cost scales with
    buffer size); the overflow retry keeps undersized guesses correct.
    """
    state = overlap_pair_device(
        blk_a, blk_b, cfg, self_block, mask_a=mask_a, mask_b=mask_b,
        hit_cap=hit_cap, seed_cap=seed_cap, emit_mirrors=emit_mirrors,
        size_hints=size_hints)
    # one-shot calls on the DEVICE backend route trace+emit through
    # the bit-identical host C kernels too (the pipelined sweep
    # already does): the device trace harvest was the slower side
    # when this was measured (DAMAR_TRACE=dev opts out; which side
    # wins on the GPU is an open question in PERF.md)
    trace_host = (not _host_compute_enabled()
                  and os.environ.get("DAMAR_TRACE", "") != "dev")
    return overlap_pair_emit(state, trace_host=trace_host)


def overlap_pair_device(blk_a: ReadBlock, blk_b: ReadBlock,
                        cfg: OverlapConfig, self_block: bool,
                        mask_a=None, mask_b=None,
                        hit_cap: int | None = None,
                        seed_cap: int | None = None,
                        emit_mirrors: bool = True,
                        size_hints: dict | None = None) -> dict:
    """The DEVICE phases of a block pair: seeding -> extension ->
    extent dedupe.  Returns a state dict for overlap_pair_emit, which
    runs the trace + .las emission.  The split lets a pipelined sweep
    run pass N's trace/emit on the HOST (bit-identical C kernels)
    while the device seeds/extends pass N+1 (see
    overlap_pairs_pipelined).  hit_cap/seed_cap default to
    default_caps(blk_a, blk_b)."""
    dh, ds = default_caps(blk_a, blk_b)
    hit_cap = dh if hit_cap is None else hit_cap
    seed_cap = ds if seed_cap is None else seed_cap
    blk_b_rc = _rc_cached(blk_b)
    blk_a_rc = _rc_cached(blk_a) if emit_mirrors else None
    stats = dict(seeds=0, extents=0, kept=0, dropped_trace=0)

    host = _host_compute_enabled()
    if (not host and max(blk_a.cap, blk_b.cap) > memory_scaled(HUGE_BLOCK)
            and os.environ.get("DAMAR_HUGE_RELEASE", "0") == "1"):
        # huge block: with the SLICED seeding pipeline
        # (ops/seeding._find_seeds_sliced) every working set is
        # bounded and full cross-pass residency fits.
        # DAMAR_HUGE_RELEASE=1 restores the conservative full release
        # (cold-pass state every pass) if a workload's peak regresses.
        release_device_buffers(blk_a)
        if blk_b is not blk_a:
            release_device_buffers(blk_b)
        for b in (blk_b_rc, blk_a_rc):
            if b is not None:
                b.cache.pop("dev_arrs", None)
    # -b: composition weights from the A block (host LUT; both seeding
    # twins apply the identical fixed-point formula)
    bias_lut = None
    if getattr(cfg, "bias", False):
        from damar_tpu.ops.seeding import bias_weight_lut
        bias_lut = bias_weight_lut(blk_a.bases)
    # ONE canonical seeding pass covers both orientations (comp bit per
    # seed); comp seeds carry bpos already in rc-block coordinates
    if host:
        # native/numpy seeding twin — exact replica of the device
        # path, so results (and the emitted .las) are byte-identical
        from damar_tpu.ops import seeding_host as sh
        am_np = np.asarray(mask_a) if mask_a is not None else None
        a_index = _cached_a_index(
            blk_a, "host3", cfg.kmer, am_np,
            lambda: sh.canon_index_host(blk_a, cfg.kmer, am_np))
        a_bases_d = blk_a.bases

        def run_seeding(kw):
            return sh.fetch_seeds_host(
                sh.find_seeds_canonical_host(blk_a, blk_b, cfg, **kw))
    else:
        from damar_tpu.ops.seeding import (canonical_index_dev,
                                           find_seeds_canonical_dev)
        am = jnp.asarray(mask_a) if mask_a is not None else None

        def _build_dev():
            # the A block's bases + index stay device-resident for
            # the whole A row.  Uploads go through _dev_arr so they
            # UNIFY with the B-side / prefetch residency cache — a
            # block that was a B block (or prefetched) moments ago
            # must not re-upload when it becomes the A row
            ab = _dev_arr(blk_a, "bases")
            rid = _dev_arr(blk_a, "read_id")
            return ab, rid, canonical_index_dev(ab, rid, blk_a,
                                                cfg.kmer, am)

        a_bases_d, a_rid_d, a_index = _cached_a_index(
            blk_a, "dev3", cfg.kmer, mask_a, _build_dev)

        def run_seeding(kw):
            # self pairs never touch the B arrays (match_count_self
            # runs on the A index alone) — skip the upload entirely
            if self_block or blk_b is blk_a:
                bb_d, br_d = a_bases_d, a_rid_d
            else:
                bb_d = _dev_arr(blk_b, "bases")
                br_d = _dev_arr(blk_b, "read_id")
            kw = dict(kw, dev_arrays=(a_bases_d, a_rid_d, bb_d, br_d))
            return fetch_seeds_meta(find_seeds_canonical_dev(
                blk_a, blk_b, cfg, **kw))
    if bias_lut is not None:
        _orig_run_seeding = run_seeding
        run_seeding = lambda kw: _orig_run_seeding(  # noqa: E731
            dict(kw, bias_lut=bias_lut))
    kw = dict(mask_a=mask_a, mask_b=mask_b, upper_only=self_block,
              hit_cap=hit_cap, seed_cap=seed_cap, a_index=a_index,
              self_pair=self_block)
    # hints are a running max of EXACT measured totals: pass them
    # unpadded.  Buffer caps are pow2-bucketed downstream, so padding
    # only matters when it crosses a pow2 edge — where it DOUBLES the
    # multi-GB hit buffers; an undershoot costs one exact grow-retry.
    if size_hints and size_hints.get("raw"):
        kw["raw_hint"] = size_hints["raw"]
    if size_hints and size_hints.get("nnz") and not host:
        kw["emit_hint"] = size_hints["nnz"]
    t_ph = time.time()
    seeds = run_seeding(kw)
    # overflow retries grow whichever fixed buffer saturated: the raw
    # hit buffer (up to hit_cap), the seed buffer (up to 4x the
    # requested cap), and the fill's emitting-tuple partition
    # (truncation in any silently loses overlaps)
    seed_cap_max = seed_cap * 4
    while seeds["overflow"] and (
            (seeds["total_hits"] > seeds["raw_cap"]
             and seeds["raw_cap"] < hit_cap)
            or (seeds["total_seeds"] > kw["seed_cap"]
                and kw["seed_cap"] < seed_cap_max)
            or (seeds.get("total_emit", 0) > seeds.get("tcap", 1 << 62)
                and seeds.get("tcap", 0) < seeds["raw_cap"])):
        if seeds["total_hits"] > seeds["raw_cap"]:
            # total_hits is EXACT (count phase) — no need to double
            kw = dict(kw, raw_hint=seeds["total_hits"])
        if seeds["total_seeds"] > kw["seed_cap"]:
            sc = kw["seed_cap"]
            while sc < min(2 * seeds["total_seeds"], seed_cap_max):
                sc *= 2
            kw = dict(kw, seed_cap=sc)
        if seeds.get("total_emit", 0) > seeds.get("tcap", 1 << 62):
            kw = dict(kw, emit_hint=seeds["total_emit"])
        seeds = run_seeding(kw)
    if size_hints is not None:
        size_hints["raw"] = max(seeds["total_hits"],
                                size_hints.get("raw", 0) // 2)
        if seeds.get("total_emit"):
            size_hints["nnz"] = max(seeds["total_emit"],
                                    size_hints.get("nnz", 0) // 2)
    if host:
        seeds = dedupe_anchor_seeds(seeds)
        stats["t_seed"] = round(time.time() - t_ph, 3)
        stats["seeds"] += seeds["nseeds"]
        by_comp = split_seeds_by_comp(seeds)
        t_ph = time.time()
        ext_parts: list[dict] = []
        pends = []
        for comp in (False, True):
            bb = blk_b_rc if comp else blk_b
            pends.append((comp, extend_seeds_launch(
                blk_a, bb, by_comp[comp], cfg, comp)))
        # both orientations' phase-1 launches are now in flight; the
        # phase-2 dispatch (which syncs on the phase-1 mask) comes next
        # so neither comp's pipeline stalls behind the other's harvest
        for _, pend in pends:
            extend_seeds_dispatch_p2(pend)
        for comp, pend in pends:
            exts = extend_seeds_harvest(pend)
            stats["extents"] += exts["n"]
            exts["comp"] = comp
            ext_parts.append(exts)
    else:
        stats["t_seed"] = round(time.time() - t_ph, 3)
        t_ph = time.time()
        ext_parts = _extend_all_dev(blk_a, blk_b, blk_b_rc, seeds,
                                    cfg, stats)
    stats["t_extend"] = round(time.time() - t_ph, 3)
    t_ph = time.time()
    # dedupe within each orientation (comp partitions the groups)
    kept_parts = [dedupe_extents(p, cfg.min_len,
                                 max_err=1.0 - cfg.err)
                  for p in ext_parts]
    for kp, p in zip(kept_parts, ext_parts):
        kp["comp"] = p["comp"]
    stats["kept"] = sum(p["n"] for p in kept_parts)
    stats["t_dedupe"] = round(time.time() - t_ph, 3)
    return dict(blk_a=blk_a, blk_b=blk_b, kept_parts=kept_parts,
                cfg=cfg, emit_mirrors=emit_mirrors, stats=stats,
                a_bases_d=a_bases_d, blk_b_rc=blk_b_rc,
                blk_a_rc=blk_a_rc)


def overlap_pair_emit(state: dict, trace_host: bool = False
                      ) -> tuple[LasFile, LasFile, dict]:
    """Trace + .las emission for an overlap_pair_device state.

    trace_host: force the native C trace kernels (bit-identical
    replicas of the device kernels) regardless of backend — the
    pipelined sweep uses this to run pass N's trace on host cores
    while the chip works on pass N+1."""
    stats = state["stats"]
    kernel = None
    if trace_host:
        from damar_tpu import native
        if native.available():
            kernel = _native_bp_trace
    t_dde = time.time()
    las_a, las_b = las_from_extents(
        state["blk_a"], state["blk_b"], state["kept_parts"],
        state["cfg"], emit_mirrors=state["emit_mirrors"], stats=stats,
        a_bases_d=state["a_bases_d"], blk_b_rc=state["blk_b_rc"],
        blk_a_rc=state["blk_a_rc"], trace_kernel=kernel)
    stats["t_trace"] = round(time.time() - t_dde, 3)
    return las_a, las_b, stats


def las_from_extents(blk_a: ReadBlock, blk_b: ReadBlock,
                     kept_parts: list[dict], cfg: OverlapConfig,
                     emit_mirrors: bool = True, stats: dict | None = None,
                     a_bases_d=None, blk_b_rc=None, blk_a_rc=None,
                     trace_kernel=None) -> tuple[LasFile, LasFile]:
    """Trace pass + columnar .las assembly for deduped extents.

    kept_parts: columnar extent dicts (aread/bread LOCAL ids, .las
    coordinates, a per-dict 'comp' flag).  Shared by the single-chip
    block-pair driver and the distributed ring sweep (whose extents
    arrive from the mesh and flow through the same emission).  Returns
    (las_a, mirrored las_b) — las_b empty unless emit_mirrors.
    """
    t_fs = time.time()
    if stats is None:
        stats = {}
    stats.setdefault("dropped_trace", 0)
    if blk_b_rc is None:
        blk_b_rc = _rc_cached(blk_b)
    if emit_mirrors and blk_a_rc is None:
        blk_a_rc = blk_b_rc if blk_a is blk_b else _rc_cached(blk_a)
    default_trace = (trace_kernel if trace_kernel is not None
                     else _kernels(cfg)[1])
    host = getattr(default_trace, "host_kernel", False)
    sa = blk_a.starts.astype(np.int64)
    sb = blk_b.starts.astype(np.int64)
    alen = blk_a.rlen.astype(np.int32)
    blen = blk_b.rlen.astype(np.int32)
    S = cfg.seed_batch if host else cfg.seed_batch_dev

    # one oriented base pool [A fwd | B fwd | B rc | A rc] (identity-
    # deduped for self pairs): EVERY role/orientation combination
    # traces through a single launch stream against this pool, so a
    # block pair costs ~2 trace launches instead of 4 groups x many
    # batches — each launch pays a dispatch, and each jitted call is
    # one device program.
    srcs = [blk_a.bases, blk_b.bases, blk_b_rc.bases]
    if emit_mirrors:
        srcs.append(blk_a_rc.bases)
    uniq: list = []
    uniq_off: dict[int, int] = {}
    offs: list[int] = []
    for arr in srcs:
        o = uniq_off.get(id(arr))
        if o is None:
            o = sum(len(u) for u in uniq)
            uniq_off[id(arr)] = o
            uniq.append(arr)
        offs.append(o)
    OA, OBF, OBC = offs[0], offs[1], offs[2]
    OAR = offs[3] if emit_mirrors else 0
    if host:
        # the concatenated oriented pool is block-pair-invariant; the
        # ~200 MB host concat costs ~0.5 s per 50 Mbp pass un-memoized
        pkey = tuple(id(u) for u in uniq)
        ent = blk_a.cache.get("trace_pool_host")
        if ent is not None and ent[0] == pkey:
            cat = ent[2]
        else:
            cat = np.concatenate(uniq) if len(uniq) > 1 else uniq[0]
            blk_a.cache["trace_pool_host"] = (pkey, list(uniq), cat)
    else:
        # the concatenated oriented pool is block-pair-invariant:
        # memoize it on blk_a (strong refs to the source arrays keep
        # the id() key valid) together with its packed-word form —
        # rebuilding re-concatenated ~134 MB on device per call, and
        # the bp kernels would repack it per LAUNCH
        pkey = tuple(id(u) for u in uniq)
        ent = blk_a.cache.get("trace_pool")
        if ent is not None and ent[0] == pkey:
            cat = ent[2]
            cat_words = ent[3]
        else:
            t_pool = time.time()
            dev = {}
            # reuse any device-resident copy of a part (extension
            # keeps fwd + rc bases in dev_arrs): a rebuild after the
            # huge-block eviction is then pure on-device concat+pack,
            # never a re-upload
            for _b in (blk_a, blk_b, blk_b_rc, blk_a_rc):
                if _b is None:
                    continue
                _c = _b.cache.get("dev_arrs", {}).get("bases")
                if _c is not None:
                    dev[id(_b.bases)] = _c
            if a_bases_d is not None:
                dev[id(blk_a.bases)] = a_bases_d
            parts_d = [dev.get(id(u)) if dev.get(id(u)) is not None
                       else jnp.asarray(u) for u in uniq]
            cat = jnp.concatenate(parts_d) if len(parts_d) > 1 \
                else parts_d[0]
            from damar_tpu.ops.wave_bp import _pack_bases
            cat_words = jax.jit(_pack_bases)(cat)
            blk_a.cache["trace_pool"] = (pkey, list(uniq), cat,
                                         cat_words)
            # surface the rebuild cost (and any upload) so a
            # regression here shows in the stats
            stats["t_trace_pool_rebuild"] = round(time.time() - t_pool, 3)
            n_up = sum(1 for u in uniq if dev.get(id(u)) is None)
            if n_up:
                stats["trace_pool_uploads"] = n_up
        cat = (cat, cat_words)

    def units_of(kept: dict, mirrored: bool) -> dict:
        """Per-record trace-unit arrays for one (part, role) group:
        role coordinates, absolute starts into the pool, and the
        output header fields."""
        comp = kept["comp"]
        n = kept["n"]
        if not mirrored:
            u = dict(ar=kept["aread"], br=kept["bread"],
                     abp=kept["abpos"], aep=kept["aepos"],
                     bbp=kept["bbpos"], bep=kept["bepos"])
            u["ast"] = (OA + sa[kept["aread"]]).astype(np.int64)
            u["bst"] = ((OBC if comp else OBF)
                        + sb[kept["bread"]]).astype(np.int64)
            u["hdr_ar"] = blk_a.ids[kept["aread"]].astype(np.int32)
            u["hdr_br"] = blk_b.ids[kept["bread"]].astype(np.int32)
        else:
            if not comp:
                u = dict(ar=kept["bread"], br=kept["aread"],
                         abp=kept["bbpos"], aep=kept["bepos"],
                         bbp=kept["abpos"], bep=kept["aepos"])
            else:
                bl = blen[kept["bread"]]
                al = alen[kept["aread"]]
                u = dict(ar=kept["bread"], br=kept["aread"],
                         abp=bl - kept["bepos"],
                         aep=bl - kept["bbpos"],
                         bbp=al - kept["aepos"],
                         bep=al - kept["abpos"])
            u["ast"] = (OBF + sb[kept["bread"]]).astype(np.int64)
            u["bst"] = ((OAR if comp else OA)
                        + sa[kept["aread"]]).astype(np.int64)
            u["hdr_ar"] = blk_b.ids[kept["bread"]].astype(np.int32)
            u["hdr_br"] = blk_a.ids[kept["aread"]].astype(np.int32)
        u["comp"] = np.full(n, comp, np.int32)
        u["mir"] = np.full(n, int(mirrored), np.int32)
        return u

    # uid links the primary and mirrored roles of one extent so trace
    # failures can be discarded SYMMETRICALLY (a record and its mirror
    # both survive or neither does — the reference's symmetric output
    # is an invariant, not a ratio)
    base = 0
    groups = []
    bases_of = []
    for kp in kept_parts:
        if kp["n"]:
            g = units_of(kp, False)
            g["uid"] = (base + np.arange(kp["n"])).astype(np.int32)
            groups.append(g)
            bases_of.append(base)
            base += kp["n"]
    if emit_mirrors:
        for kp, b0 in zip([k for k in kept_parts if k["n"]], bases_of):
            g = units_of(kp, True)
            g["uid"] = (b0 + np.arange(kp["n"])).astype(np.int32)
            groups.append(g)
    cols_a: list[LasColumns] = []
    cols_b: list[LasColumns] = []
    uids_a: list[np.ndarray] = []
    uids_b: list[np.ndarray] = []
    small = cfg.tspace <= TRACE_XOVR
    UKEYS = ("ar", "br", "abp", "aep", "bbp", "bep", "ast", "bst",
             "hdr_ar", "hdr_br", "comp", "mir", "uid")

    def emit(chunk, res, retry_sink=None):
        """Append one trace batch's surviving records as columnar
        .las shards (no per-record objects: block pairs emit 10^5-10^6
        records).  chunk rows carry per-record comp/mir tags; mir < 0
        marks shape-bucket padding rows, dropped here."""
        offs_t, okv, packed, dsum = res
        okv = okv & (chunk["mir"] >= 0)
        bad = np.nonzero(~okv & (chunk["mir"] >= 0))[0]
        if len(bad):
            if retry_sink is not None:
                retry_sink.append({k: v[bad] for k, v in chunk.items()})
            else:
                stats["dropped_trace"] += len(bad)
        seg_lens_all = offs_t[1:] - offs_t[:-1]
        for mir, sink, usink in ((0, cols_a, uids_a),
                                 (1, cols_b, uids_b)):
            ok_idx = np.nonzero(okv & (chunk["mir"] == mir))[0]
            if not len(ok_idx):
                continue
            usink.append(chunk["uid"][ok_idx])
            seg_lens = seg_lens_all[ok_idx]
            n = len(ok_idx)
            h = np.zeros((n, 10), np.int32)
            h[:, 0] = 2 * seg_lens
            h[:, 1] = dsum[ok_idx]
            h[:, 2] = chunk["abp"][ok_idx]
            h[:, 3] = chunk["bbp"][ok_idx]
            h[:, 4] = chunk["aep"][ok_idx]
            h[:, 5] = chunk["bep"][ok_idx]
            h[:, 6] = np.where(chunk["comp"][ok_idx] != 0, OVL_COMP, 0)
            h[:, 7] = chunk["hdr_ar"][ok_idx]
            h[:, 8] = chunk["hdr_br"][ok_idx]
            starts = offs_t[:-1][ok_idx].astype(np.int64)
            new_off = np.zeros(n + 1, np.int64)
            np.cumsum(seg_lens, out=new_off[1:])
            total = int(new_off[-1])
            from damar_tpu import native
            rows = None
            if native.available() and packed.flags.c_contiguous:
                # [row, 2] i32 rows = 8-byte runs: one C memcpy pass
                # replaces the arange+repeat row-index construction
                rc = native.ragged_copy(
                    packed.reshape(-1).view(np.uint8),
                    starts * 8, seg_lens.astype(np.int64) * 8)
                if rc is not None:
                    rows = rc.view(np.int32).reshape(-1, 2)
            if rows is None:
                rowpos = (np.arange(total, dtype=np.int64)
                          - np.repeat(new_off[:-1], seg_lens)
                          + np.repeat(starts, seg_lens))
                rows = packed[rowpos]
            payload, boffs = encode_trace_columns(rows, new_off, small)
            sink.append(LasColumns(h, payload, boffs))

    def launch_stream(units: dict, kernel=None):
        """Sort all units by span, pad each batch to a 1024 bucket
        (bounded jit-shape count), launch all batches async.  Batch
        widths are area-equalized (see _area_batches): the short bulk
        rides wide launches, the long tail narrow ones."""
        nu = len(units["ar"])
        spans = units["aep"] - units["abp"]
        order = np.argsort(spans, kind="stable")
        if host:
            batches = [(lo, min(S, nu - lo), S)
                       for lo in range(0, nu, S)]
        else:
            batches = _area_batches(spans[order], cfg.tspace, S,
                                    AREA_CHUNKS_DEV)
        out = []
        kern = kernel if kernel is not None else trace_kernel
        for lo, mb, w in batches:
            sel = order[lo:lo + mb]
            m = min(w, _round_slice(len(sel), 1024))
            chunk = {}
            for k in UKEYS:
                fill = -1 if k == "mir" else 0
                buf = np.full(m, fill, units[k].dtype)
                buf[:len(sel)] = units[k][sel]
                chunk[k] = buf
            pend = _trace_launch(cat, cat, None, None, chunk, cfg,
                                 kernel=kern)
            out.append((pend, chunk))
        return out

    stats["t_trace_setup"] = round(time.time() - t_fs, 3)
    t0 = time.time()
    if groups:
        units = {k: np.concatenate([g[k] for g in groups])
                 for k in UKEYS}
        pending = launch_stream(units)
    else:
        pending = []
    stats["t_trace_launch"] = round(time.time() - t0, 3)
    retries: list = []
    # pipelined harvest: fetch launch-groups in slices and hand each
    # slice to a worker thread that finishes + encodes it while the
    # NEXT slice is still in flight on the device link — the fetch
    # and the host encode are the two serial tails
    # of the trace phase, and they overlap almost entirely.  A single
    # worker preserves emission order (cols_* appends must stay in
    # batch order); only the worker touches the sinks.
    t0 = time.time()
    if len(pending) > 8:
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=2)
        t_emit = [0.0]

        def _drain():
            while True:
                item = q.get()
                if item is None:
                    return
                te = time.time()
                for (pend, chunk), res in item:
                    if res is not None:
                        emit(chunk, res, retry_sink=retries)
                t_emit[0] += time.time() - te

        th = threading.Thread(target=_drain, daemon=True)
        th.start()
        GS = max(4, len(pending) // 6)
        for lo in range(0, len(pending), GS):
            grp = pending[lo:lo + GS]
            res = _trace_harvest_all([p[0] for p in grp], cfg)
            q.put(list(zip(grp, res)))
        q.put(None)
        th.join()
        stats["t_trace_emit_thread"] = round(t_emit[0], 3)
    else:
        all_res = _trace_harvest_all([p[0] for p in pending], cfg)
        for (pend, chunk), res in zip(pending, all_res):
            if res is not None:
                emit(chunk, res, retry_sink=retries)
    stats["t_trace_harvest_emit"] = round(time.time() - t0, 3)

    # extents the default trace band could not force through get
    # retried with progressively wider kernels (_retry_tiers)
    def retry_round(rows: list, kernel, sink):
        chunk = {k: np.concatenate([p[k] for p in rows])
                 for k in rows[0]}
        retry_pend = launch_stream(chunk, kernel=kernel)
        retry_res = _trace_harvest_all([p[0] for p in retry_pend], cfg)
        for (pend, ch), res in zip(retry_pend, retry_res):
            if res is not None:
                emit(ch, res, retry_sink=sink)

    t_rt = time.time()
    stats["trace_retries"] = sum(len(p["ar"]) for p in retries)
    tiers = _retry_tiers(cfg)
    for k, kernel in enumerate(tiers):
        if not retries:
            break
        if k == len(tiers) - 1:
            stats["trace_retries_wide"] = sum(len(p["ar"])
                                              for p in retries)
        still: list | None = [] if k < len(tiers) - 1 else None
        retry_round(retries, kernel, still)
        retries = still
    stats["t_trace_retry"] = round(time.time() - t_rt, 3)
    t_fin = time.time()
    ca = LasColumns.concat(cols_a)
    cb = LasColumns.concat(cols_b)
    if emit_mirrors:
        # symmetric discard: a record survives only if its mirror did
        ua = (np.concatenate(uids_a) if uids_a
              else np.zeros(0, np.int32))
        ub = (np.concatenate(uids_b) if uids_b
              else np.zeros(0, np.int32))
        both = np.intersect1d(ua, ub)
        ka = np.nonzero(np.isin(ua, both))[0]
        kb = np.nonzero(np.isin(ub, both))[0]
        if len(ka) != ca.n:
            stats["dropped_trace"] += ca.n - len(ka)
            ca = ca.permute(ka)
        if len(kb) != cb.n:
            stats["dropped_trace"] += cb.n - len(kb)
            cb = cb.permute(kb)
    las_a = LasFile(tspace=cfg.tspace, columns=ca)
    las_a.sort()
    las_b = LasFile(tspace=cfg.tspace, columns=cb)
    las_b.sort()
    stats["t_trace_final"] = round(time.time() - t_fin, 3)
    return las_a, las_b


def overlap_pairs_pipelined(jobs, cfg: OverlapConfig,
                            trace_host: bool = True):
    """Heterogeneous pipelined sweep over block pairs.

    The device's strengths are the seeding sort/scan pipeline and the
    lockstep extension; the trace phase is random-access bound (it
    re-fetches drifting per-seed character windows every tspace
    rows).  The native C trace kernels are bit-identical replicas of the device
    kernels, so a sweep can run pass N's trace + .las encode on HOST
    cores while the device seeds/extends pass N+1 — production sweeps
    process thousands of block pairs, and in steady state the whole
    trace/emit wall hides behind the next pair's device phases.
    (ctypes releases the GIL during the C calls, so the worker thread
    genuinely overlaps the main thread's device dispatch.)

    jobs: iterable of dicts with blk_a, blk_b, self_block and optional
    overlap_pair_device kwargs, plus an optional "tag" passed through.
    Yields (tag, las_a, las_b, stats) in submission order.
    trace_host is ignored (emission runs inline) when the native
    library is unavailable or the backend is already the CPU.
    """
    import concurrent.futures as cf
    from damar_tpu import native
    do_host = (trace_host and native.available()
               and jax.default_backend() != "cpu"
               and not _host_compute_enabled())
    if not do_host:
        for job in jobs:
            job = dict(job)
            tag = job.pop("tag", None)
            state = overlap_pair_device(
                job.pop("blk_a"), job.pop("blk_b"), cfg,
                job.pop("self_block"), **job)
            yield (tag,) + overlap_pair_emit(state)
        return
    def prefetch(job):
        """Async-dispatch the NEXT pair's block uploads while the
        current pair computes: jnp.asarray returns immediately and the
        host->device transfer proceeds in the background into the
        residency cache the pair will hit.  Skipped for blocks above
        the huge-block threshold, whose memory budget cannot carry a
        spare block.  A failed upload is counted in the next pair's
        stats (prefetch_failed) and the pair uploads on demand."""
        for b in (job.get("blk_a"), job.get("blk_b")):
            if b is not None and b.cap <= memory_scaled(HUGE_BLOCK):
                try:
                    _dev_arr(b, "bases")
                    _dev_arr(b, "read_id")
                except (RuntimeError, MemoryError) as e:
                    prefetch_failed.append(f"{type(e).__name__}: {e}")
                    print(f"prefetch upload failed: {e}",
                          file=sys.stderr)

    prefetch_failed: list[str] = []
    ex = cf.ThreadPoolExecutor(max_workers=1)
    try:
        pending = None
        it = iter(jobs)
        job = next(it, None)
        while job is not None:
            job = dict(job)
            tag = job.pop("tag", None)
            state = overlap_pair_device(
                job.pop("blk_a"), job.pop("blk_b"), cfg,
                job.pop("self_block"), **job)
            if prefetch_failed:
                state["stats"]["prefetch_failed"] = len(prefetch_failed)
                prefetch_failed.clear()
            # pull the next job only AFTER the current pair's device
            # phases: job generators (run_overlap_plan) clear caches
            # on row advance as a side effect of iteration, and an
            # early pull would evict the CURRENT pair's A index.  The
            # prefetched upload overlaps this pair's host trace+emit.
            nxt = next(it, None)
            if nxt is not None:
                prefetch(nxt)
            if pending is not None:
                ptag, fut = pending
                yield (ptag,) + fut.result()
            pending = (tag, ex.submit(overlap_pair_emit, state, True))
            job = nxt
        if pending is not None:
            ptag, fut = pending
            yield (ptag,) + fut.result()
    finally:
        ex.shutdown(wait=False)
