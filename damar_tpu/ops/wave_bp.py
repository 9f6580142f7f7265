"""Bit-parallel banded-DP kernels: the band lives inside an integer.

Redesign of the wave kernels (SURVEY.md §2.3 seed-extend, upstream
dalign/align.c forward_wave/reverse_wave — upstream-path citation,
reference mount empty), replacing the lane-per-diagonal layout of
ops.wave with a Myers/Hyyrö-style
bit-vector formulation (Myers JACM 1999; Hyyrö 2003 banded variant —
public algorithms, re-derived for this band frame):

  * each seed's BW=32-diagonal band is encoded as +1/-1 deltas in two
    uint32 words (VP/VN) plus an int32 base — one vector element holds
    an entire band, so every DP row costs ~60 elementwise ops on [S]
    vectors instead of ~45 ops on [S, 128] tiles (a ~100x reduction
    in lane-work for the hottest loop in the framework);
  * the serial within-row prefix-min becomes the carry propagation of
    a single 32-bit add — the hardware adder resolves the horizontal
    dependency chain;
  * band-frame recurrence (band advances one diagonal per row):
        D'[j] = min(D[j] + s_j, D[j+1] + 1, D'[j-1] + 1)
    with the diagonal-delta mask computed as
        X  = Eq | (VN >> 1)
        G0 = (((X & VP) + VP) ^ VP) | X        # G[j]==0 positions
    and delta/base updates derived from G (see _row_step).

Deviations from the lane-per-diagonal kernels (validated empirically
by tests/test_wave_bp.py and the end-to-end recall checks):
  * out-of-band cells are approximated by a V-shaped cost profile
    (|j - CTR| at init) instead of INF — paths through the virtual
    region pay at least the gap cost they skip;
  * extension tracks the exact per-row score at the band CENTER lane
    (the recentered optimum's neighborhood) every row, and the exact
    band-wide maximum at chunk tails — endpoints are therefore exact
    at row granularity on the center lane and at chunk granularity
    elsewhere (the lane-per-diagonal kernel tracked every lane every
    row; differences are a few bp of extent, corrected by the trace
    pass which re-anchors endpoints).

Trace commits, band recentering and X-drop tests reconstruct the band
in wide [S, BW] form from the delta words — once per chunk/segment, so
their cost amortizes to ~1 op/row.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

import numpy as _np

from damar_tpu.ops.wave import INF, reduce_best_lanes  # noqa: F401

BW = 32
CTR = 16
# numpy scalars: module-level jnp scalars would initialize the JAX
# backend at import time, and large uint32 literals overflow JAX's
# weak-int32 canonicalization
NEG = -(1 << 20)
U1 = 1
NOT1 = _np.uint32(0xFFFFFFFE)
MASKW = _np.uint32(0xFFFFFFFF)


def _pack_bases(bases_u8):
    """uint8 base codes -> int32 words, 16 bases per word (2 bits each,
    base i of word w at bits [2i, 2i+2)).  The PAD_BASE sentinel (4)
    packs as 0; wave kernels never read unmasked out-of-read positions
    (validity comes from alim/blim lane masks, not the sentinel).

    Built from 16 strided flat slices, so no [n/16, 16] intermediate
    with a 16-wide minor dimension is ever laid out."""
    n = bases_u8.shape[0]
    m = -(-n // 16) * 16
    if m != n:
        bases_u8 = jnp.pad(bases_u8, (0, m - n))
    b = bases_u8.astype(jnp.int32) & 3
    acc = jnp.zeros(m // 16, jnp.int32)
    for j in range(16):
        acc = acc | (jax.lax.slice(b, (j,), (m - 15 + j,), (16,))
                     << (2 * j))
    return acc


def _rev16(w):
    """Reverse the 16 2-bit groups of each uint32 word (char-order
    reversal within a packed word)."""
    w = ((w >> 2) & jnp.uint32(0x33333333)) \
        | ((w & jnp.uint32(0x33333333)) << 2)
    w = ((w >> 4) & jnp.uint32(0x0F0F0F0F)) \
        | ((w & jnp.uint32(0x0F0F0F0F)) << 4)
    w = ((w >> 8) & jnp.uint32(0x00FF00FF)) \
        | ((w & jnp.uint32(0x00FF00FF)) << 8)
    return (w >> 16) | (w << 16)


def _gather_packed_words(words, origin, v0, length: int, reverse):
    """Bit-0-aligned packed-word windows: [S, length//16] int32 words
    whose char i (= bits [2*(i&15), 2*(i&15)+2) of word i>>4) equals
    _gather_packed(...)[:, i] exactly.  length must be a multiple of
    16 (the bp chunk sizes R and R+BW always are).

    This replaces the char-tile materialization of _gather_packed on
    the GPU kernel path: the [S, length] char array and its 4-step
    binary roll are ~16x the traffic of the word window itself — the
    kernel unpacks chars in registers (word r >> 4, shift 2*(r & 15)),
    so XLA only gathers, funnel-aligns, and transposes words.
    Out-of-range words are clip-
    gathered garbage the callers mask via v-space limits (same
    contract as _gather_packed).

    reverse: static bool or traced bool[S].  Reversal keeps the SAME
    output contract (char i = reversed stream's char i): the window is
    gathered forward, funnel-aligned, then word-reversed with a 2-bit
    group swizzle (_rev16) — exact because length % 16 == 0.  Forward-
    only callers may pass any length (rounded up internally; the tail
    chars past length are in-pool continuation the kernels never
    read)."""
    if length % 16:
        assert reverse is False, "reversal needs length % 16 == 0"
    nwc = -(-length // 16)
    nw = nwc + 2
    both = not isinstance(reverse, bool)
    if both:
        start_f = origin + v0
        start_r = origin - v0 - length
        start = jnp.where(reverse, start_r, start_f)
    else:
        start = (origin - v0 - length) if reverse else (origin + v0)
    w0 = start >> 4                    # arithmetic shift: floors negatives
    j0 = start & 15
    widx = w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :]
    wg = _cu(words[jnp.clip(widx, 0, words.shape[0] - 1)])
    # funnel shift: aligned[i] = (wg[i] >> 2*j0) | (wg[i+1] << (32-2*j0))
    sh = (2 * j0)[:, None].astype(jnp.uint32)
    lo = wg[:, :-1] >> sh
    hi = jnp.where(sh > 0, wg[:, 1:] << (32 - sh), jnp.uint32(0))
    aligned = (lo | hi)[:, :nwc]       # [S, nwc]
    if both:
        rev_w = _rev16(aligned[:, ::-1])
        out = jnp.where(reverse[:, None], rev_w, aligned)
    elif reverse:
        out = _rev16(aligned[:, ::-1])
    else:
        out = aligned
    return jax.lax.bitcast_convert_type(out, jnp.int32)


def _cu(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _gather_packed(words, origin, v0, length: int, reverse):
    """[S, length] int32 chars at v-space positions v0..v0+length-1,
    gathered WORD-wise from the packed base array (16x fewer gathered
    elements than a byte gather — the XLA byte gather was the dominant
    cost of the whole wave path).  Word misalignment is fixed with a
    4-step binary roll; per-word index clipping preserves alignment of
    in-range words, and out-of-range chars are garbage the callers mask
    via v-space limits (same contract as ops.wave._gather_chars).
    reverse: static bool or traced bool[S] (mixed-direction batches)."""
    nw = length // 16 + 2
    if isinstance(reverse, bool):
        start = (origin - v0 - length) if reverse else (origin + v0)
    else:
        start = jnp.where(reverse, origin - v0 - length, origin + v0)
    w0 = start >> 4                    # arithmetic shift: floors negatives
    j0 = start & 15                    # nonnegative remainder
    widx = w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :]
    words_g = words[jnp.clip(widx, 0, words.shape[0] - 1)]
    rep = jnp.repeat(words_g, 16, axis=1)             # [S, nw*16]
    sh = (2 * (jnp.arange(nw * 16, dtype=jnp.int32) & 15))[None, :]
    chars = (rep >> sh) & 3
    for k in (1, 2, 4, 8):             # left-roll by j0 in binary steps
        chars = jnp.where((j0[:, None] & k) != 0,
                          jnp.roll(chars, -k, axis=1), chars)
    chars = chars[:, :length]
    if isinstance(reverse, bool):
        return chars[:, ::-1] if reverse else chars
    return jnp.where(reverse[:, None], chars[:, ::-1], chars)


def _bit_weights():
    return (U1 << jnp.arange(BW, dtype=jnp.uint32))


def _pack_bits(bits):
    """[S, BW] {0,1} int32 -> uint32[S] (bit j = column j)."""
    return jnp.sum(bits.astype(jnp.uint32) * _bit_weights()[None, :],
                   axis=1, dtype=jnp.uint32)


def _unpack_bits(word):
    """uint32[S] -> [S, BW] int32 of {0,1}."""
    return ((word[:, None] >> jnp.arange(BW, dtype=jnp.uint32)[None, :])
            & U1).astype(jnp.int32)


def _reconstruct(VP, VN, Db):
    """Wide band values D[S, BW] from delta words + base (D[-1]=Db)."""
    delta = _unpack_bits(VP) - _unpack_bits(VN)
    return Db[:, None] + jnp.cumsum(delta, axis=1)


def _vinit(S):
    """V-shaped fresh band: D[j] = |j - CTR|, base D[-1] = CTR + 1.
    Deltas: VN on bits 0..CTR, VP on bits CTR+1..W-1."""
    vn = jnp.uint32((1 << (CTR + 1)) - 1)
    vp = MASKW ^ vn
    VP = jnp.full(S, vp, jnp.uint32)
    VN = jnp.full(S, vn, jnp.uint32)
    Db = jnp.full(S, CTR + 1, jnp.int32)
    Dc = jnp.zeros(S, jnp.int32)
    return VP, VN, Db, Dc


def _plane_pack(chars_w, valid_w):
    """chars_w [S, BW] int32 (0..3), valid_w [S, BW] bool -> Peq planes
    (H, L, V) uint32[S]."""
    h = _pack_bits((chars_w >> 1) & 1)
    l = _pack_bits(chars_w & 1)
    v = _pack_bits(valid_w.astype(jnp.int32))
    return h, l, v


def _row_step(VP, VN, Db, Dc, Eq):
    """One DP row (band frame advances implicitly).  Returns updated
    (VP, VN, Db, Dc, G0).

    Derivation (G[j] = D'[j] - D[j] in {0,1}):
      G[j]=0 iff s_j=0, or D[j+1]+1==D[j] (VN bit j+1), or the carry
      D'[j-1]+1==D[j] (needs VP[j] and G[j-1]=0).  Zeros therefore
      propagate upward through runs of VP bits from any seed G0 bit
      BELOW a run position.  The binary add ripples those carries:
      within a run, every position at-or-above the lowest seed either
      has its sum bit flipped ((seed + VP) ^ VP) or is itself a seed
      (1+1+carry keeps the bit — hence the |seed); the final carry-out
      lands on a non-VP bit and is masked off.  New deltas follow from
      Delta'[j] = Delta[j] + G[j] - G[j-1]; the base moves by
      D'[-1] = D[0] + 1 (exact: its only in-band predecessor).
    """
    X = Eq | (VN >> U1)
    seed = (X << U1) & VP
    G0 = X | (VP & (seed | ((seed + VP) ^ VP)))
    g = ~G0                                   # G[j] == 1
    gp = g << U1                              # G[j-1]; G[-1] handled below
    d = g ^ gp
    nd = ~d
    Z = ~(VP | VN)
    VPn = (VP & nd) | (Z & g & ~gp)
    VNn = (VN & nd) | (Z & gp & G0)
    # bit 0 exact: D'[0]-D'[-1] = G[0]-1  (D'[-1] = D[0]+1)
    VPn = VPn & NOT1
    VNn = (VNn & NOT1) | (G0 & U1)
    Dbn = Db + 1 + ((VP & U1) - (VN & U1)).astype(jnp.int32)
    Dcn = Dc + 1 - ((G0 >> CTR) & U1).astype(jnp.int32)
    return VPn, VNn, Dbn, Dcn, G0


def _eq_bits(PeqH, PeqL, PeqV, x):
    """Match mask for A char x[S] against the packed B planes."""
    xh = (x >> 1).astype(jnp.uint32)
    xl = (x & 1).astype(jnp.uint32)
    mh = xh - U1          # 0 -> all ones, 1 -> 0  (xor -> bit equality)
    ml = xl - U1
    return (PeqH ^ mh) & (PeqL ^ ml) & PeqV & MASKW


def _shift_planes(PeqH, PeqL, PeqV, nb, nvalid):
    """Advance the B window one position: drop band 0, insert the new
    top char nb[S] (validity nvalid[S] bool)."""
    nh = ((nb >> 1) & 1).astype(jnp.uint32)
    nl = (nb & 1).astype(jnp.uint32)
    nv = nvalid.astype(jnp.uint32)
    PeqH = (PeqH >> U1) | (nh << (BW - 1))
    PeqL = (PeqL >> U1) | (nl << (BW - 1))
    PeqV = (PeqV >> U1) | (nv << (BW - 1))
    return PeqH, PeqL, PeqV


def _window_planes(b_tile_T, p0, blim):
    """Initial Peq planes from the first BW columns of a transposed
    char tile b_tile_T [L, S]; bit j holds the B char at index
    p0 + j (p0[S] = B index of tile column 0), valid iff the index is
    a real B char (0 <= p < blim)."""
    chars = jax.lax.dynamic_slice_in_dim(b_tile_T, 0, BW, axis=0)
    chars = chars.T                                   # [S, BW]
    p = p0[:, None] + jnp.arange(BW, dtype=jnp.int32)[None, :]
    valid = (p >= 0) & (p < blim[:, None])
    return _plane_pack(chars, valid)


@partial(jax.jit, static_argnames=("reverse", "R", "max_rows",
                                   "diff_cost", "xdrop", "W", "SB",
                                   "with_active"))
def extend_wave_bp(a_bases, b_bases, aorigin, borigin, alim, blim,
                   reverse: bool = False, R: int = 128,
                   max_rows: int = 65536, diff_cost: int = 5,
                   xdrop: int = 60, dirs=None, W: int = 128,
                   SB: int = 256, with_active: bool = False):
    """Bit-parallel drop-in for ops.wave.extend_wave (same returns:
    best_va, best_vb, best_d, best_score).  with_active: also return
    the final active mask — True means the unit hit max_rows while
    still extending, so a deeper re-run can produce a different
    (better) result; False means the result is final (X-drop death or
    read-end).  Drives the two-phase extension launch."""
    rv = reverse if dirs is None else dirs
    S = aorigin.shape[0]
    a_words = _pack_bases(a_bases)
    b_words = _pack_bases(b_bases)
    lanew = jnp.arange(BW, dtype=jnp.int32)[None, :]

    VP0, VN0, Db0, Dc0 = _vinit(S)
    z = jnp.zeros(S, jnp.int32)
    state = dict(VP=VP0, VN=VN0, Db=Db0, Dc=Dc0,
                 vbb=jnp.full(S, 1 - CTR, jnp.int32),  # v_b of band 0 at t=1
                 rtot=jnp.int32(0), active=alim > 0,
                 bs=z, bva=z, bvb=z)

    def cond(st):
        return jnp.any(st["active"]) & (st["rtot"] < max_rows)

    def body(st):
        rtot = st["rtot"]
        # chunk window gathers: band 0 of row t=rtot+1 sits at
        # v_b = vbb; the chunk consumes A rows rtot..rtot+R-1 and B
        # window vbb-1 .. vbb-1 + (R+W)
        # B tile column c holds the char at index vbb - 1 + c: row r's
        # Eq needs chars at vbb + (r - 1) + j (the pre-row frame)
        v0b = st["vbb"] - 1
        a_tile = _gather_packed(a_words, aorigin,
                                jnp.full((S,), rtot, jnp.int32), R, rv)
        b_tile = _gather_packed(b_words, borigin, v0b, R + BW, rv)
        aT = a_tile.T                                  # [R, S]
        bT = b_tile.T                                  # [R+BW, S]
        PeqH, PeqL, PeqV = _window_planes(bT, v0b, blim)

        def row(r, carry):
            (VP, VN, Db, Dc, PH, PL, PV, bs, bva, bvb, died) = carry
            x = jax.lax.dynamic_slice_in_dim(aT, r, 1, axis=0)[0]
            Eq = _eq_bits(PH, PL, PV, x)
            VP, VN, Db, Dc, _ = _row_step(VP, VN, Db, Dc, Eq)
            t = rtot + r + 1                       # A chars consumed
            vc = st["vbb"] + r + CTR               # v_b at center lane
            sc = t + vc - diff_cost * Dc
            # a unit deactivated by X-drop must stop accumulating best
            # candidates — its band keeps evolving (no per-row freeze)
            # while OTHER units keep the launch alive, and could
            # otherwise "recover" past a bad stretch it already died in
            ok = st["active"] & (t <= alim) & (vc >= 0) & (vc <= blim)
            improve = ok & (sc > bs)
            bs = jnp.where(improve, sc, bs)
            bva = jnp.where(improve, t, bva)
            bvb = jnp.where(improve, vc, bvb)
            # per-row X-drop on the center-lane score (small slack for
            # off-center wander between recenterings) — stops
            # extensions inside long bad stretches that chunk-tail
            # sampling alone can straddle
            died = died | (ok & (sc < bs - (xdrop + diff_cost)))
            # advance B window: next row's top bit reads the char at
            # index vbb + r + (BW - 1) = tile column r + BW
            nbp = st["vbb"] + r + BW - 1
            nb = jax.lax.dynamic_slice_in_dim(bT, r + BW, 1, axis=0)[0]
            PH, PL, PV = _shift_planes(PH, PL, PV, nb,
                                       (nbp >= 0) & (nbp < blim))
            return (VP, VN, Db, Dc, PH, PL, PV, bs, bva, bvb, died)

        carry = (st["VP"], st["VN"], st["Db"], st["Dc"], PeqH, PeqL,
                 PeqV, st["bs"], st["bva"], st["bvb"],
                 jnp.zeros(S, bool))
        (VP, VN, Db, Dc, _, _, _, bs, bva, bvb, died) = \
            jax.lax.fori_loop(0, R, row, carry)
        # ---- chunk tail: exact band-wide eval, X-drop, recenter ----
        t = rtot + R
        Dw = _reconstruct(VP, VN, Db)                 # [S, BW]
        vbb = st["vbb"] + R - 1                       # band 0 v_b at t
        vb_w = vbb[:, None] + lanew
        valid = (vb_w >= 0) & (vb_w <= blim[:, None]) & \
            (t <= alim)[:, None]
        sc_w = jnp.where(valid, t + vb_w - diff_cost * Dw, NEG)
        smax = jnp.max(sc_w, axis=1)
        jbest = jnp.argmax(sc_w, axis=1).astype(jnp.int32)
        better = st["active"] & (smax > bs)
        bs = jnp.where(better, smax, bs)
        bva = jnp.where(better, t, bva)
        bvb = jnp.where(better, vbb + jbest, bvb)
        # X-drop on the chunk-tail max vs all-time best, plus any
        # per-row center-lane kill recorded during the chunk
        active = st["active"] & (smax >= bs - xdrop) & (t < alim) \
            & ~died
        # recenter on the min-D valid lane
        Dm = jnp.where((vb_w >= 0) & (vb_w <= blim[:, None]), Dw,
                       jnp.int32(INF))
        jmin = jnp.argmin(Dm, axis=1).astype(jnp.int32)
        drift = jnp.where(active, jmin - CTR, 0)
        idx = jnp.clip(lanew + drift[:, None], 0, BW - 1)
        over = jnp.abs(lanew + drift[:, None] - idx)
        Dn = jnp.take_along_axis(Dw, idx, axis=1) + over
        dlt = jnp.clip(jnp.diff(Dn, axis=1), -1, 1)       # deltas 1..BW-1
        pad0 = lambda m: jnp.pad(m.astype(jnp.int32), ((0, 0), (1, 0)))
        VP = _pack_bits(pad0(dlt > 0)) | U1     # bit 0: +1 (Db = Dn[0]-1)
        VN = _pack_bits(pad0(dlt < 0))
        Db = Dn[:, 0] - 1                     # delta(0) = +1 via VP bit 0
        Dc = Dn[:, CTR]
        # next chunk's band-0 v_b at its first row: advances by one
        # from the tail frame, plus the recenter shift
        return dict(VP=VP, VN=VN, Db=Db, Dc=Dc, vbb=vbb + 1 + drift,
                    rtot=t, active=active, bs=bs, bva=bva, bvb=bvb)

    st = jax.lax.while_loop(cond, body, state)
    bs, bva, bvb = st["bs"], st["bva"], st["bvb"]
    none = bs <= 0
    zed = jnp.zeros_like(bs)
    d = jnp.where(none, zed, (bva + bvb - bs) // diff_cost)
    out = (jnp.where(none, zed, bva), jnp.where(none, zed, bvb),
           d, jnp.where(none, zed, bs))
    return out + (st["active"],) if with_active else out


@partial(jax.jit, static_argnames=("tspace", "max_segs", "W",
                                   "SB"))
def trace_wave_bp(a_bases, b_bases, astart, bstart, abpos, bbpos,
                  alim, blim, tspace: int = 100, max_segs: int = 660,
                  W: int = 128, SB: int = 256):
    """Bit-parallel drop-in for ops.wave.trace_wave (same returns:
    trace [S, max_segs, 2], nseg [S], dsum [S]).

    Every outer iteration advances each live seed through one trace
    segment (to its next absolute tspace boundary in A, lockstep rows
    with per-seed freezing for shorter first/last segments), commits
    the (diffs, bspan) pair at the min-distance band column (the known
    endpoint for the final segment), and resets the band (V-init) at
    the committed column — greedy segment chaining exactly like
    ops.wave.trace_wave.
    """
    S = abpos.shape[0]
    a_words = _pack_bases(a_bases)
    b_words = _pack_bases(b_bases)
    aorigin = astart + abpos
    borigin = bstart + bbpos
    lanew = jnp.arange(BW, dtype=jnp.int32)[None, :]

    def seg_rows_of(done):
        a = abpos + done
        nxt = (a // tspace + 1) * tspace - a
        return jnp.minimum(nxt, alim - done)

    VP0, VN0, Db0, Dc0 = _vinit(S)
    z = jnp.zeros(S, jnp.int32)
    state = dict(VP=VP0, VN=VN0, Db=Db0,
                 vbb=jnp.full(S, 1 - CTR, jnp.int32),
                 done=z, nseg=z, prev_vb=z, dsum=z)

    def body(st, _):
        live = st["done"] < alim
        seg_rows = jnp.where(live, seg_rows_of(st["done"]), 0)
        v0b = st["vbb"] - 1
        a_tile = _gather_packed(a_words, aorigin, st["done"], tspace,
                                False)
        b_tile = _gather_packed(b_words, borigin, v0b, tspace + BW,
                                False)
        aT = a_tile.T
        bT = b_tile.T
        PeqH, PeqL, PeqV = _window_planes(bT, v0b, blim)

        def row(r, carry):
            (VP, VN, Db, PH, PL, PV) = carry
            go = r < seg_rows
            x = jax.lax.dynamic_slice_in_dim(aT, r, 1, axis=0)[0]
            Eq = _eq_bits(PH, PL, PV, x)
            VPn, VNn, Dbn, _, _ = _row_step(VP, VN, Db, Db, Eq)
            nbp = st["vbb"] + r + BW - 1
            nb = jax.lax.dynamic_slice_in_dim(bT, r + BW, 1, axis=0)[0]
            PHn, PLn, PVn = _shift_planes(PH, PL, PV, nb,
                                          (nbp >= 0) & (nbp < blim))
            gu = (0 - go.astype(jnp.uint32))      # all-ones where live
            VP = (VPn & gu) | (VP & ~gu)
            VN = (VNn & gu) | (VN & ~gu)
            Db = jnp.where(go, Dbn, Db)
            PH = (PHn & gu) | (PH & ~gu)
            PL = (PLn & gu) | (PL & ~gu)
            PV = (PVn & gu) | (PV & ~gu)
            return (VP, VN, Db, PH, PL, PV)

        carry = (st["VP"], st["VN"], st["Db"], PeqH, PeqL, PeqV)
        VP, VN, Db, _, _, _ = jax.lax.fori_loop(0, tspace, row, carry)

        # ---- commit at the segment end ----
        va = st["done"] + seg_rows
        at_end = live & (va == alim)
        # per-seed frame after seg_rows rows: band 0 at vbb + seg_rows - 1
        vbb_end = st["vbb"] + seg_rows - 1
        Dw = _reconstruct(VP, VN, Db)
        vb_w = vbb_end[:, None] + lanew
        lane_valid = (vb_w >= 0) & (vb_w <= blim[:, None]) & \
            (vb_w > st["prev_vb"][:, None])
        Dm = jnp.where(lane_valid, Dw, jnp.int32(INF))
        j_min = jnp.argmin(Dm, axis=1).astype(jnp.int32)
        j_end = jnp.clip(blim - vbb_end, 0, BW - 1)
        j_com = jnp.where(at_end, j_end, j_min)
        # clamp the commit into [prev_vb, blim]: when the alignment's
        # drift overruns the 32-diagonal band every lane is invalid and
        # argmin degenerates — an unclamped commit emits b coordinates
        # past the read (callers' trace validation would catch the
        # record, but the kernel must stay self-consistent)
        vb_com = jnp.clip(vbb_end + j_com, st["prev_vb"], blim)
        d_com = jnp.take_along_axis(Dw, j_com[:, None], 1)[:, 0]
        d_com = jnp.where(d_com >= INF, alim + blim, d_com)
        bspan = vb_com - st["prev_vb"]

        # reset band at the committed column: fresh V-init, each
        # segment's DP restarts from zero (greedy chaining)
        VPr, VNr, Dbr, _ = _vinit(S)
        gu = 0 - live.astype(jnp.uint32)
        VP = (VPr & gu) | (VP & ~gu)
        VN = (VNr & gu) | (VN & ~gu)
        Db = jnp.where(live, Dbr, Db)
        # per-segment commits are SCAN OUTPUTS, not a scatter into a
        # carried [S, max_segs, 2] buffer: seeds march lockstep (a
        # live seed's k-th iteration IS its k-th segment), so stacking
        # (d_com, bspan) per step and masking dead lanes reproduces
        # the old buffer exactly — without a buffer-sized scatter in
        # the loop carry (the device-loop cost of the trace phase)
        out = (jnp.where(live, d_com, 0), jnp.where(live, bspan, 0))
        return dict(
            VP=VP, VN=VN, Db=Db,
            vbb=jnp.where(live, vb_com - CTR + 1, st["vbb"]),
            done=st["done"] + seg_rows,
            nseg=jnp.where(live, st["nseg"] + 1, st["nseg"]),
            prev_vb=jnp.where(live, vb_com, st["prev_vb"]),
            dsum=jnp.where(live, st["dsum"] + d_com, st["dsum"])), out

    st, (ds, bs) = jax.lax.scan(body, state, None, length=max_segs)
    trace = jnp.stack([ds, bs], axis=-1).transpose(1, 0, 2)
    return trace, st["nseg"], st["dsum"]


extend_wave_bp.supports_active = True
