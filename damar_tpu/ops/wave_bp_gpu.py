"""Pallas (Triton route) kernels for the bit-parallel band DP on GPUs.

The plain-JAX bp kernels (ops.wave_bp) run every DP row as one
iteration of an XLA loop of ~60 tiny elementwise ops on [S] vectors:
on a GPU that is several kernel launches per row.  These kernels fuse
a whole R-row chunk — row loop, Peq plane maintenance, best/X-drop
tracking and the chunk tail's band-wide scan and recenter — into one
launch.

Layout (Hopper, one seed per thread): a launch of S seeds runs
S/BLOCK programs of BLOCK seeds each (S is padded with dead seeds).  Per-seed state is a set of [S]
vectors.  The chunk's packed-word windows are gathered by XLA
(ops.wave_bp._gather_packed_words) and transposed seed-minor to
[words, S], so the block's load of one word row coalesces across its
threads; the kernel unpacks 16 chars per word with static shifts, so
the row loop runs over words with a 16-row unrolled body.  All band
state (VP/VN/Db/Dc and the Peq planes) stays in registers.

Bit identity: outputs equal ops.wave_bp (which in turn equals the
native C replicas) exactly — tests/test_wave_bp_gpu.py checks it in
interpret mode.  The chunk tail recenters with per-seed variable
shifts and popcounts instead of the wide reconstruct, with the same
first-min / first-max tie-breaking.

Algorithm: DALIGNER dalign/align.c forward_wave/reverse_wave
(upstream-path citation, mount empty); the bit-parallel band follows
Myers JACM 1999 / Hyyrö 2003 (public algorithms, re-derived for this
band frame in ops.wave_bp).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as _np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from damar_tpu.ops.wave_bp import (BW, CTR, _eq_bits, _gather_packed_words,
                                   _pack_bases, _row_step)

INF_I = 1 << 20
NEG_I = -(1 << 20)
U1 = 1
MASKW = _np.uint32(0xFFFFFFFF)
NOT1 = _np.uint32(0xFFFFFFFE)
VN0 = _np.uint32((1 << (CTR + 1)) - 1)       # V-shaped fresh band
VP0 = _np.uint32(0xFFFFFFFF ^ ((1 << (CTR + 1)) - 1))

BLOCK = 128        # seeds per program (one per thread at 4 warps)
NUM_WARPS = 4


def _i(x):
    return x.astype(jnp.int32)


def _u(x):
    return x.astype(jnp.uint32)


def _char(w, t: int):
    """Char t (static, 0..15) of each packed word in w [block]."""
    return _i((w >> (2 * t)) & 3)


def _shift_in(PH, PL, PV, c, ok):
    """Advance the B window one position: drop band 0, insert char c
    (validity ok) at the top bit."""
    return ((PH >> U1) | (_u((c >> 1) & 1) << (BW - 1)),
            (PL >> U1) | (_u(c & 1) << (BW - 1)),
            (PV >> U1) | (_u(ok) << (BW - 1)))


def _init_planes(bT_ref, v0b, blim):
    """Peq planes from the first BW chars of the B word tile (bit j =
    char at B v-index v0b + j, valid iff 0 <= v0b + j < blim)."""
    PH = jnp.zeros(v0b.shape, jnp.uint32)
    PL = jnp.zeros(v0b.shape, jnp.uint32)
    PV = jnp.zeros(v0b.shape, jnp.uint32)
    for jw in range(BW // 16):
        w = bT_ref[jw, :]
        for t in range(16):
            j = jw * 16 + t
            c = _char(w, t)
            p = v0b + j
            PH = PH | (_u((c >> 1) & 1) << j)
            PL = PL | (_u(c & 1) << j)
            PV = PV | (_u((p >= 0) & (p < blim)) << j)
    return PH, PL, PV


def _band_scan(VP, VN, Db, vbb_t, blim, extra_valid, diff_cost,
               prev_vb=None, want_score=True, want_end=False):
    """Walk the 32 band positions once, reconstructing D from the delta
    words.  Returns (smax without the +t term, jbest) over the score
    vb - diff_cost*D on valid positions; (jmin, dsel): the first
    minimum of the INF-masked D and the raw D there; dend: raw D at
    the end column clip(blim - vbb_t).  Ties break like jnp.argmin /
    argmax on the wide form (strict compare, increasing j)."""
    D = Db
    smax = jnp.full_like(Db, NEG_I)
    jbest = jnp.zeros_like(Db)
    dmin = jnp.full_like(Db, 1 << 30)
    jmin = jnp.zeros_like(Db)
    dsel = jnp.zeros_like(Db)
    dend = jnp.zeros_like(Db)
    j_end = jnp.clip(blim - vbb_t, 0, BW - 1) if want_end else None
    for j in range(BW):
        D = D + _i((VP >> j) & U1) - _i((VN >> j) & U1)
        vb = vbb_t + j
        in_b = (vb >= 0) & (vb <= blim)
        if want_score:
            sc = jnp.where(in_b & extra_valid, vb - diff_cost * D, NEG_I)
            upd = sc > smax
            smax = jnp.where(upd, sc, smax)
            jbest = jnp.where(upd, j, jbest)
        mvalid = in_b if prev_vb is None else in_b & (vb > prev_vb)
        Dm = jnp.where(mvalid, D, INF_I)
        updm = Dm < dmin
        dmin = jnp.where(updm, Dm, dmin)
        jmin = jnp.where(updm, j, jmin)
        dsel = jnp.where(updm, D, dsel)
        if want_end:
            dend = jnp.where(j_end == j, D, dend)
    return smax, jbest, jmin, dsel, dend


def _popcount(x):
    """Popcount of uint32 words, taken on their int32 bit pattern: the
    Triton route lowers int32 popcount to the __nv_popc intrinsic."""
    return jax.lax.population_count(
        jax.lax.bitcast_convert_type(x, jnp.int32))


def _prefix_d(VP, VN, Db, idx):
    """D[idx] for per-seed idx in [0, BW): base plus the popcount of
    the deltas at bits 0..idx."""
    m = _u(idx + 1)
    mask = jnp.where(m >= BW, MASKW, (_np.uint32(1) << (m & 31)) - 1)
    return Db + _popcount(VP & mask) - _popcount(VN & mask)


def _recenter(VP, VN, Db, drift):
    """Shift the band by per-seed drift: equal to ops.wave_bp's wide
    clip-gather-repack (out-of-range positions extend at +1 per step),
    as variable per-seed shifts.  Returns (VP', VN', Db', Dc') in the
    canonical bit-0 = +1 form."""
    d = drift
    du = _u(jnp.maximum(d, 0))
    mu = _u(jnp.maximum(-d, 0))
    # positive drift: shift down, fill the top bits with +1 deltas
    VPp = (VP >> du) | ~(MASKW >> du)
    VNp = (VN >> du) & (MASKW >> du)
    # negative drift: shift up, fill bits 1..m with -1 deltas
    VPm = VP << mu
    VNm = (VN << mu) | ((_np.uint32(2) << mu) - 2)
    pos = d >= 0
    VPn = jnp.where(pos, VPp, VPm)
    VNn = jnp.where(pos, VNp, VNm)
    # Dn[0] = D[clip(d, 0, 31)] + max(-d, 0)
    D0 = _prefix_d(VP, VN, Db, jnp.clip(d, 0, BW - 1)) + jnp.maximum(-d, 0)
    # Dn[CTR] = D[clip(CTR + d, 0, 31)] + |CTR + d - clip|
    idxc = jnp.clip(CTR + d, 0, BW - 1)
    Dc = _prefix_d(VP, VN, Db, idxc) + jnp.abs(CTR + d - idxc)
    return VPn | U1, VNn & NOT1, D0 - 1, Dc


# --- extension ---------------------------------------------------------------

def _ext_kernel(rt_ref, aT_ref, bT_ref, VP_ref, VN_ref, Db_ref, Dc_ref,
                vbb_ref, alim_ref, blim_ref, act_ref, bs_ref, bva_ref,
                bvb_ref, VP_o, VN_o, Db_o, Dc_o, vbb_o, act_o, bs_o,
                bva_o, bvb_o, *, R: int, diff_cost: int, xdrop: int):
    """One R-row extension chunk for BLOCK seeds: the body of
    ops.wave_bp.extend_wave_bp's while loop (rows, chunk tail, X-drop,
    recenter)."""
    rtot = rt_ref[...]
    vbb = vbb_ref[...]
    alim = alim_ref[...]
    blim = blim_ref[...]
    active = act_ref[...] != 0
    PH, PL, PV = _init_planes(bT_ref, vbb - 1, blim)

    def word(w, carry):
        VP, VN, Db, Dc, PH, PL, PV, bs, bva, bvb, died = carry
        aw = aT_ref[w, :]
        # row r's new top B char sits at tile column r + BW: word w + 2
        bw = bT_ref[w + BW // 16, :]
        for t in range(16):
            r = w * 16 + t
            Eq = _eq_bits(PH, PL, PV, _char(aw, t))
            VP, VN, Db, Dc, _ = _row_step(VP, VN, Db, Dc, Eq)
            tt = rtot + r + 1
            vc = vbb + r + CTR
            sc = tt + vc - diff_cost * Dc
            ok = active & (tt <= alim) & (vc >= 0) & (vc <= blim)
            improve = ok & (sc > bs)
            bs = jnp.where(improve, sc, bs)
            bva = jnp.where(improve, tt, bva)
            bvb = jnp.where(improve, vc, bvb)
            died = died | _i(ok & (sc < bs - (xdrop + diff_cost)))
            nbp = vbb + r + BW - 1
            PH, PL, PV = _shift_in(PH, PL, PV, _char(bw, t),
                                   (nbp >= 0) & (nbp < blim))
        return VP, VN, Db, Dc, PH, PL, PV, bs, bva, bvb, died

    carry = (VP_ref[...], VN_ref[...], Db_ref[...], Dc_ref[...],
             PH, PL, PV, bs_ref[...], bva_ref[...], bvb_ref[...],
             jnp.zeros_like(vbb))
    VP, VN, Db, Dc, _, _, _, bs, bva, bvb, died = jax.lax.fori_loop(
        0, R // 16, word, carry)
    # ---- chunk tail: exact band-wide eval, X-drop, recenter ----
    t = rtot + R
    vbb_t = vbb + R - 1
    smax, jbest, jmin, _, _ = _band_scan(VP, VN, Db, vbb_t, blim,
                                         t <= alim, diff_cost)
    # the scan omits the +t term; add it back where a candidate existed
    smax = jnp.where(smax > NEG_I, smax + t, smax)
    better = active & (smax > bs)
    bs = jnp.where(better, smax, bs)
    bva = jnp.where(better, t, bva)
    bvb = jnp.where(better, vbb_t + jbest, bvb)
    act = active & (smax >= bs - xdrop) & (t < alim) & (died == 0)
    drift = jnp.where(act, jmin - CTR, 0)
    VP, VN, Db, Dc = _recenter(VP, VN, Db, drift)
    VP_o[...] = VP
    VN_o[...] = VN
    Db_o[...] = Db
    Dc_o[...] = Dc
    vbb_o[...] = vbb_t + 1 + drift
    act_o[...] = _i(act)
    bs_o[...] = bs
    bva_o[...] = bva
    bvb_o[...] = bvb


def _chunk_call(kernel, S, nwa, nwb, vec_dtypes, out_dtypes, interpret):
    """pallas_call over S/BLOCK programs: per-seed [S] vectors blocked
    on the seed axis, seed-minor word tiles [nw, S] blocked on it too."""
    vec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    in_specs = [vec,
                pl.BlockSpec((nwa, BLOCK), lambda i: (0, i)),
                pl.BlockSpec((nwb, BLOCK), lambda i: (0, i))]
    in_specs += [vec] * len(vec_dtypes)
    return pl.pallas_call(
        kernel,
        grid=(S // BLOCK,),
        in_specs=in_specs,
        out_specs=tuple(vec for _ in out_dtypes),
        out_shape=tuple(jax.ShapeDtypeStruct((S,), d) for d in out_dtypes),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
    )


def _word_rows(tile):
    """[S, nw] int32 word windows -> seed-minor uint32 [nw, S]."""
    return jax.lax.bitcast_convert_type(tile, jnp.uint32).T


def _pad_to(x, S):
    return jnp.pad(x, (0, S - x.shape[0])) if x.shape[0] != S else x


@functools.partial(jax.jit, static_argnames=(
    "reverse", "R", "max_rows", "diff_cost", "xdrop", "W", "SB",
    "packed", "with_active", "interpret"))
def extend_wave_bp_gpu(a_bases, b_bases, aorigin, borigin, alim, blim,
                       reverse: bool = False, R: int = 128,
                       max_rows: int = 65536, diff_cost: int = 5,
                       xdrop: int = 60, dirs=None, W: int = 128,
                       SB: int = 256, packed: bool = False,
                       with_active: bool = False,
                       interpret: bool = False):
    """Drop-in for ops.wave_bp.extend_wave_bp (same returns, identical
    outputs).  packed=True: a_bases/b_bases are already _pack_bases
    words (callers keep the block-scale pack resident).  with_active:
    also return the final active mask (see extend_wave_bp).  W/SB are
    accepted for signature parity.  interpret: run the kernel in the
    Pallas interpreter (tests on the CPU)."""
    assert R % 16 == 0, "bp chunk must be word-aligned (R % 16 == 0)"
    rv = reverse if dirs is None else dirs
    S0 = aorigin.shape[0]
    S = -(-S0 // BLOCK) * BLOCK
    aorigin, borigin = _pad_to(aorigin, S), _pad_to(borigin, S)
    alim = _pad_to(alim.astype(jnp.int32), S)
    blim = _pad_to(blim.astype(jnp.int32), S)
    if not isinstance(rv, bool):
        rv = _pad_to(rv, S)
    a_words = a_bases if packed else _pack_bases(a_bases)
    b_words = b_bases if packed else _pack_bases(b_bases)

    z = jnp.zeros(S, jnp.int32)
    state = dict(VP=jnp.full(S, VP0, jnp.uint32),
                 VN=jnp.full(S, VN0, jnp.uint32),
                 Db=jnp.full(S, CTR + 1, jnp.int32), Dc=z,
                 vbb=jnp.full(S, 1 - CTR, jnp.int32),
                 rtot=jnp.int32(0), active=_i(alim > 0),
                 bs=z, bva=z, bvb=z)
    u32, i32 = jnp.uint32, jnp.int32
    call = _chunk_call(
        functools.partial(_ext_kernel, R=R, diff_cost=diff_cost,
                          xdrop=xdrop),
        S, R // 16, (R + BW) // 16, [u32, u32] + [i32] * 9,
        [u32, u32] + [i32] * 7, interpret)

    def cond(st):
        return jnp.any(st["active"] != 0) & (st["rtot"] < max_rows)

    def body(st):
        rt = jnp.full((S,), st["rtot"], jnp.int32)
        a_tile = _gather_packed_words(a_words, aorigin, rt, R, rv)
        b_tile = _gather_packed_words(b_words, borigin, st["vbb"] - 1,
                                      R + BW, rv)
        VP, VN, Db, Dc, vbb, act, bs, bva, bvb = call(
            rt, _word_rows(a_tile), _word_rows(b_tile),
            st["VP"], st["VN"], st["Db"], st["Dc"], st["vbb"], alim,
            blim, st["active"], st["bs"], st["bva"], st["bvb"])
        return dict(VP=VP, VN=VN, Db=Db, Dc=Dc, vbb=vbb,
                    rtot=st["rtot"] + R, active=act, bs=bs, bva=bva,
                    bvb=bvb)

    st = jax.lax.while_loop(cond, body, state)
    bs, bva, bvb = st["bs"][:S0], st["bva"][:S0], st["bvb"][:S0]
    none = bs <= 0
    zed = jnp.zeros_like(bs)
    d = jnp.where(none, zed, (bva + bvb - bs) // diff_cost)
    out = (jnp.where(none, zed, bva), jnp.where(none, zed, bvb),
           d, jnp.where(none, zed, bs))
    return out + (st["active"][:S0] != 0,) if with_active else out


# --- trace -------------------------------------------------------------------

def _trace_kernel(segr_ref, aT_ref, bT_ref, VP_ref, VN_ref, Db_ref,
                  vbb_ref, live_ref, blim_ref, alim_ref, done_ref,
                  prev_ref, VP_o, VN_o, Db_o, vbb_o, dcom_o, vbcom_o, *,
                  TS: int):
    """One trace segment for BLOCK seeds: up to TS lockstep rows with
    per-seed freezing past seg_rows, then the commit-point selection of
    ops.wave_bp.trace_wave_bp (the commit stacking stays in JAX)."""
    seg_rows = segr_ref[...]
    vbb = vbb_ref[...]
    blim = blim_ref[...]
    live = live_ref[...] != 0
    PH, PL, PV = _init_planes(bT_ref, vbb - 1, blim)

    def word(w, carry):
        VP, VN, Db, PH, PL, PV = carry
        aw = aT_ref[w, :]
        bw = bT_ref[w + BW // 16, :]
        for t in range(16):
            r = w * 16 + t
            gu = _np.uint32(0) - _u(r < seg_rows)     # all ones if live
            Eq = _eq_bits(PH, PL, PV, _char(aw, t))
            VPn, VNn, Dbn, _, _ = _row_step(VP, VN, Db, Db, Eq)
            nbp = vbb + r + BW - 1
            PHn, PLn, PVn = _shift_in(PH, PL, PV, _char(bw, t),
                                      (nbp >= 0) & (nbp < blim))
            VP = (VPn & gu) | (VP & ~gu)
            VN = (VNn & gu) | (VN & ~gu)
            Db = jnp.where(r < seg_rows, Dbn, Db)
            PH = (PHn & gu) | (PH & ~gu)
            PL = (PLn & gu) | (PL & ~gu)
            PV = (PVn & gu) | (PV & ~gu)
        return VP, VN, Db, PH, PL, PV

    VP, VN, Db, _, _, _ = jax.lax.fori_loop(
        0, -(-TS // 16), word,
        (VP_ref[...], VN_ref[...], Db_ref[...], PH, PL, PV))
    # ---- commit-point selection ----
    alim = alim_ref[...]
    prev_vb = prev_ref[...]
    at_end = live & (done_ref[...] + seg_rows == alim)
    vbb_end = vbb + seg_rows - 1
    _, _, jmin, dsel, dend = _band_scan(
        VP, VN, Db, vbb_end, blim, live, 0, prev_vb=prev_vb,
        want_score=False, want_end=True)
    j_com = jnp.where(at_end, jnp.clip(blim - vbb_end, 0, BW - 1), jmin)
    vb_com = jnp.clip(vbb_end + j_com, prev_vb, blim)
    d_com = jnp.where(at_end, dend, dsel)
    d_com = jnp.where(d_com >= INF_I, alim + blim, d_com)
    # reset the band at the committed column for live seeds
    gu = _np.uint32(0) - _u(live)
    VP_o[...] = (jnp.full_like(VP, VP0) & gu) | (VP & ~gu)
    VN_o[...] = (jnp.full_like(VN, VN0) & gu) | (VN & ~gu)
    Db_o[...] = jnp.where(live, CTR + 1, Db)
    vbb_o[...] = jnp.where(live, vb_com - CTR + 1, vbb)
    dcom_o[...] = d_com
    vbcom_o[...] = vb_com


@functools.partial(jax.jit, static_argnames=(
    "tspace", "max_segs", "W", "SB", "packed", "interpret"))
def trace_wave_bp_gpu(a_bases, b_bases, astart, bstart, abpos, bbpos,
                      alim, blim, tspace: int = 100, max_segs: int = 660,
                      W: int = 128, SB: int = 256, packed: bool = False,
                      interpret: bool = False):
    """Drop-in for ops.wave_bp.trace_wave_bp (same returns, identical
    outputs).  packed / interpret: see extend_wave_bp_gpu."""
    S0 = abpos.shape[0]
    S = -(-S0 // BLOCK) * BLOCK
    astart, bstart = _pad_to(astart, S), _pad_to(bstart, S)
    abpos, bbpos = _pad_to(abpos, S), _pad_to(bbpos, S)
    alim = _pad_to(alim.astype(jnp.int32), S)
    blim = _pad_to(blim.astype(jnp.int32), S)
    a_words = a_bases if packed else _pack_bases(a_bases)
    b_words = b_bases if packed else _pack_bases(b_bases)
    aorigin = astart + abpos
    borigin = bstart + bbpos
    nwa = -(-tspace // 16)
    u32, i32 = jnp.uint32, jnp.int32
    call = _chunk_call(
        functools.partial(_trace_kernel, TS=tspace), S, nwa, nwa + 2,
        [u32, u32] + [i32] * 7, [u32, u32] + [i32] * 4, interpret)

    def seg_rows_of(done):
        a = abpos + done
        nxt = (a // tspace + 1) * tspace - a
        return jnp.minimum(nxt, alim - done)

    z = jnp.zeros(S, jnp.int32)
    state = dict(VP=jnp.full(S, VP0, jnp.uint32),
                 VN=jnp.full(S, VN0, jnp.uint32),
                 Db=jnp.full(S, CTR + 1, jnp.int32),
                 vbb=jnp.full(S, 1 - CTR, jnp.int32),
                 done=z, nseg=z, prev_vb=z, dsum=z)

    def body(st, _):
        live = st["done"] < alim
        seg_rows = jnp.where(live, seg_rows_of(st["done"]), 0)
        a_tile = _gather_packed_words(a_words, aorigin, st["done"],
                                      16 * nwa, False)
        b_tile = _gather_packed_words(b_words, borigin, st["vbb"] - 1,
                                      16 * (nwa + 2), False)
        VP, VN, Db, vbb, d_com, vb_com = call(
            seg_rows, _word_rows(a_tile), _word_rows(b_tile),
            st["VP"], st["VN"], st["Db"], st["vbb"], _i(live), blim,
            alim, st["done"], st["prev_vb"])
        bspan = vb_com - st["prev_vb"]
        # commits are stacked scan outputs (lockstep: a live seed's
        # k-th iteration is its k-th segment), as in trace_wave_bp
        out = (jnp.where(live, d_com, 0), jnp.where(live, bspan, 0))
        return dict(
            VP=VP, VN=VN, Db=Db, vbb=vbb,
            done=st["done"] + seg_rows,
            nseg=jnp.where(live, st["nseg"] + 1, st["nseg"]),
            prev_vb=jnp.where(live, vb_com, st["prev_vb"]),
            dsum=jnp.where(live, st["dsum"] + d_com, st["dsum"])), out

    st, (ds, bs) = jax.lax.scan(body, state, None, length=max_segs)
    trace = jnp.stack([ds, bs], axis=-1).transpose(1, 0, 2)
    return trace[:S0], st["nseg"][:S0], st["dsum"][:S0]


extend_wave_bp_gpu.takes_packed = True
trace_wave_bp_gpu.takes_packed = True
extend_wave_bp_gpu.supports_active = True
