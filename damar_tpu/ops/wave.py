"""Batched banded-DP alignment kernels: seed extension and trace points.

Accelerator re-design of the O(nd) wavefront aligner (SURVEY.md §2.3
'seed-extend', upstream dalign/align.c forward_wave/reverse_wave —
upstream-path citation, reference mount empty).  The reference's
scalar, data-dependent furthest-reaching wave is replaced by a
fixed-shape vector program over a batch of seeds:

  * state is an edit-distance band D[S, W] (W = 128 lanes per seed);
  * each DP row costs a handful of [S, W] vector ops — the serial
    prefix dependency of the classic row recurrence is broken with a
    log2(W)-step prefix-min scan (min-plus formulation);
  * the band advances one diagonal per row and is recentered on the
    best column at chunk/commit boundaries (the adaptive-band
    equivalent of the reference's lag-based trimming);
  * termination is X-drop on the score p - diff_cost*d, where p is
    antidiagonal progress (the analogue of the reference's
    trailing-match-rate stop rule);
  * trace points are produced by the same row kernel with a
    commit-and-reset at every absolute multiple of tspace in A
    (greedy segment chaining — each segment's (diffs, bspan) pair is
    exact for the committed path, making .las records self-consistent
    by construction).

Coordinate convention: both kernels run in "v-space" — virtual
positions v >= 0 counted from the seed origin in the direction of
extension.  real_index = origin + v (forward) or origin - 1 - v
(reverse), which lets one kernel serve forward/reverse extension and
the mirrored (B-as-A) trace pass.

All shapes are static: S seeds per launch, W lanes, R rows per chunk.
Seeds are padded with alim = 0 rows, which deactivates them on entry.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

INF = 1 << 20   # plain int: a module-level jnp scalar
                # would initialize the backend at import


def _shift_left(x, fill):
    return jnp.concatenate([x[:, 1:], jnp.full_like(x[:, :1], fill)], axis=1)


def _shift_right_by(x, s, fill):
    return jnp.concatenate(
        [jnp.full_like(x[:, :s], fill), x[:, :-s]], axis=1)


def _prefix_min(u):
    """Inclusive prefix-min along axis 1 in log2(W) shift steps."""
    w = u.shape[1]
    s = 1
    while s < w:
        u = jnp.minimum(u, _shift_right_by(u, s, INF))
        s *= 2
    return u


def _row_update(D, x, bw, diag_valid, lane_valid, lane_iota):
    """One DP row: consume one A char x[S] against B window bw[S, W].

    D[j] holds distances for b-endpoints one diagonal behind; returns
    the new row.  min-plus: Dn[j] = min_i<=j ( min(D[i]+sub, D[i+1]+1)
    + (j-i) ), computed as prefix-min of (tmp[i] - i) plus j.
    """
    sub = jnp.where(diag_valid, jnp.where(bw == x[:, None], 0, 1), INF)
    tmp = jnp.minimum(D + sub, _shift_left(D, INF) + 1)
    Dn = _prefix_min(tmp - lane_iota) + lane_iota
    return jnp.where(lane_valid, Dn, INF)


def reduce_best_lanes(bs_l, bva_l, bvb_l, bd_l):
    """Collapse per-lane best trackers to the global best per seed,
    deterministic tie-break: max score, then min va, then min vb.
    (Given score, va and vb, the diff count is determined, so the
    tuple is fully reproducible.)  Returns (va, vb, d, score)."""
    s = jnp.max(bs_l, axis=1)
    at = bs_l == s[:, None]
    va = jnp.min(jnp.where(at, bva_l, INF), axis=1)
    at &= bva_l == va[:, None]
    vb = jnp.min(jnp.where(at, bvb_l, INF), axis=1)
    at &= bvb_l == vb[:, None]
    d = jnp.min(jnp.where(at, bd_l, INF), axis=1)
    none = s <= 0
    z = jnp.zeros_like(s)
    return (jnp.where(none, z, va), jnp.where(none, z, vb),
            jnp.where(none, z, d), jnp.where(none, z, s))


def _gather_chars(bases, origin, v0, length, reverse):
    """[S, length] chars at v-space positions v0.. v0+length-1.

    origin[S] are real base-array indices; out-of-range positions
    return clipped garbage that callers must mask via v-space limits.
    reverse: static bool, or a traced bool array [S] for mixed-
    direction batches (real index = origin - 1 - v when reversed).
    """
    v = v0[:, None] + jnp.arange(length, dtype=jnp.int32)[None, :]
    if isinstance(reverse, bool):
        idx = (origin[:, None] - 1 - v) if reverse else (origin[:, None] + v)
    else:
        idx = jnp.where(reverse[:, None], origin[:, None] - 1 - v,
                        origin[:, None] + v)
    return bases[jnp.clip(idx, 0, bases.shape[0] - 1)]


@partial(jax.jit, static_argnames=(
    "reverse", "W", "R", "max_rows", "diff_cost", "xdrop"))
def extend_wave(a_bases, b_bases, aorigin, borigin, alim, blim,
                reverse: bool = False, W: int = 128, R: int = 32,
                max_rows: int = 65536, diff_cost: int = 5,
                xdrop: int = 60, dirs=None):
    """Greedy banded extension of S seeds in one direction.

    a_bases/b_bases: uint8 block base arrays (global positions).
    aorigin/borigin: int32[S] global anchor positions.
    alim/blim:       int32[S] max v-space extent (distance to read end
                     in the extension direction); alim=0 pads a slot.

    Returns (best_va, best_vb, best_d, best_score): the endpoint with
    maximal score = (va + vb) - diff_cost * d found before X-drop
    termination (va = A bases consumed, vb = B bases consumed).
    """
    S = aorigin.shape[0]
    CTR = W // 2
    rv = reverse if dirs is None else dirs
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    lane_iota = jnp.arange(W, dtype=jnp.int32)[None, :]

    lane0 = jnp.arange(W, dtype=jnp.int32)
    D0 = jnp.where(lane0 >= CTR, lane0 - CTR, INF)[None, :].repeat(S, 0)
    zl = jnp.zeros((S, W), jnp.int32)
    state = dict(
        D=D0,
        boff=jnp.zeros(S, jnp.int32),
        rtot=jnp.int32(0),
        active=alim > 0,
        # per-LANE best trackers: elementwise updates per row (no
        # cross-lane reductions in the hot loop); reduced once at exit
        bs_l=zl, bva_l=zl, bvb_l=zl, bd_l=zl,
    )

    def row_body(r, carry):
        st, a_chars, b_tile = carry
        t = st["rtot"] + r
        x = a_chars[:, r]
        bw = jax.lax.dynamic_slice_in_dim(b_tile, r, W, axis=1)
        v_b = (t + 1) + lane - CTR + st["boff"][:, None]
        lane_valid = (v_b >= 0) & (v_b <= blim[:, None])
        diag_valid = (v_b >= 1) & (v_b <= blim[:, None])
        row_active = st["active"] & (t < alim)
        Dn = _row_update(st["D"], x, bw, diag_valid, lane_valid, lane_iota)
        D = jnp.where(row_active[:, None], Dn, st["D"])
        # per-lane score tracking (valid lanes only)
        p = (t + 1) + v_b
        score = jnp.where(lane_valid & (D < INF), p - diff_cost * D,
                          -INF)
        improve = row_active[:, None] & (score > st["bs_l"])
        st = dict(st)
        st["D"] = D
        st["bs_l"] = jnp.where(improve, score, st["bs_l"])
        st["bva_l"] = jnp.where(improve, t + 1, st["bva_l"])
        st["bvb_l"] = jnp.where(improve, v_b, st["bvb_l"])
        st["bd_l"] = jnp.where(improve, D, st["bd_l"])
        return st, a_chars, b_tile

    def chunk_cond(st):
        return jnp.any(st["active"]) & (st["rtot"] < max_rows)

    def chunk_body(st):
        v0a = jnp.full((S,), st["rtot"], jnp.int32)
        a_chars = _gather_chars(a_bases, aorigin, v0a, R, rv)
        v0b = st["rtot"] + st["boff"] - CTR
        b_tile = _gather_chars(b_bases, borigin, v0b, R + W, rv)
        st, _, _ = jax.lax.fori_loop(
            0, R, row_body, (st, a_chars, b_tile))
        st["rtot"] = st["rtot"] + R
        # X-drop at chunk granularity: stop when the final row's best
        # score fell more than xdrop below the all-time best.  (Per-row
        # deactivation saved no vector work — rows are masked, not
        # skipped — so the chunk boundary is the natural check point.)
        t_fin = st["rtot"] - 1
        v_b = (t_fin + 1) + lane - CTR + st["boff"][:, None]
        lane_valid = (v_b >= 0) & (v_b <= blim[:, None])
        score_fin = jnp.where(lane_valid & (st["D"] < INF),
                              (t_fin + 1) + v_b - diff_cost * st["D"],
                              -INF)
        smax_fin = jnp.max(score_fin, axis=1)
        bs_glob = jnp.max(st["bs_l"], axis=1)
        st["active"] = st["active"] & (smax_fin >= bs_glob - xdrop) \
            & (st["rtot"] < alim)
        # recenter band on the best (minimum-distance) column
        Dv = st["D"]
        jmin = jnp.argmin(Dv, axis=1).astype(jnp.int32)
        drift = jnp.where(st["active"] & (jnp.min(Dv, axis=1) < INF),
                          jmin - CTR, 0)
        def _roll_row(row, s):
            rolled = jnp.roll(row, -s)
            idx = jnp.arange(W, dtype=jnp.int32)
            ok = (idx + s >= 0) & (idx + s < W)
            return jnp.where(ok, rolled, INF)
        st["D"] = jax.vmap(_roll_row)(st["D"], drift)
        st["boff"] = st["boff"] + drift
        return st

    st = jax.lax.while_loop(chunk_cond, chunk_body, state)
    return reduce_best_lanes(st["bs_l"], st["bva_l"], st["bvb_l"],
                             st["bd_l"])


@partial(jax.jit, static_argnames=("tspace", "W", "max_segs"))
def trace_wave(a_bases, b_bases, astart, bstart, abpos, bbpos, alim, blim,
               tspace: int = 100, W: int = 128, max_segs: int = 660):
    """Trace-point pass over S confirmed overlap extents (forward only).

    astart/bstart: int32[S] global base-array offsets of the A/B reads.
    abpos/bbpos:   int32[S] read-local alignment start coordinates.
    alim/blim:     int32[S] spans (aepos-abpos, bepos-bbpos); alim=0
                   pads a slot.

    Each outer iteration advances every live seed through exactly one
    trace segment (to its next absolute multiple of tspace in A-read
    coordinates, or to its end row), committing a (diffs, bspan) pair
    and resetting the DP band to the committed column (greedy segment
    chaining).  Seeds have different boundary phases, so row progress
    is per-seed; rows beyond a seed's segment length are masked.  The
    final segment is forced through the known endpoint blim.

    Returns (trace[S, max_segs, 2] int32, nseg[S], total_diffs[S]).
    """
    S = abpos.shape[0]
    CTR = W // 2
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    aorigin = astart + abpos          # global A start of the alignment
    borigin = bstart + bbpos

    def seg_rows_of(done):
        """Rows to the next commit for each seed given progress `done`:
        distance to the next absolute tspace boundary, capped at the
        end row."""
        a = abpos + done
        nxt = (a // tspace + 1) * tspace - a
        return jnp.minimum(nxt, alim - done)

    lane0 = jnp.arange(W, dtype=jnp.int32)
    D0 = jnp.where(lane0 >= CTR, lane0 - CTR, INF)[None, :].repeat(S, 0)
    state = dict(
        D=D0,
        boff=jnp.zeros(S, jnp.int32),
        done=jnp.zeros(S, jnp.int32),        # per-seed rows committed
        nseg=jnp.zeros(S, jnp.int32),
        prev_vb=jnp.zeros(S, jnp.int32),
        dsum=jnp.zeros(S, jnp.int32),
        trace=jnp.zeros((S, max_segs, 2), jnp.int32),
    )
    rows_idx = jnp.arange(S)

    def chunk_cond(st):
        return jnp.any(st["done"] < alim)

    def chunk_body(st):
        live = st["done"] < alim
        seg_rows = jnp.where(live, seg_rows_of(st["done"]), 0)
        # gather this segment's chars at per-seed offsets; boff is
        # constant within the segment (commits only at segment ends)
        a_chars = _gather_chars(a_bases, aorigin, st["done"], tspace, False)
        v0b = st["done"] + st["boff"] - CTR
        b_tile = _gather_chars(b_bases, borigin, v0b, tspace + W, False)

        def row_body(r, D):
            t = st["done"] + r
            row_active = r < seg_rows
            x = a_chars[:, r]
            bw = jax.lax.dynamic_slice_in_dim(b_tile, r, W, axis=1)
            v_b = (t + 1)[:, None] + lane - CTR + st["boff"][:, None]
            lane_valid = (v_b >= 0) & (v_b <= blim[:, None])
            diag_valid = (v_b >= 1) & (v_b <= blim[:, None])
            Dn = _row_update(D, x, bw, diag_valid, lane_valid, lane)
            return jnp.where(row_active[:, None], Dn, D)

        D = jax.lax.fori_loop(0, tspace, row_body, st["D"])

        # commit: every live seed is now exactly at its segment end
        va = st["done"] + seg_rows
        at_end = live & (va == alim)
        commit = live
        v_b_fin = va[:, None] + lane - CTR + st["boff"][:, None]
        lane_valid = (v_b_fin >= 0) & (v_b_fin <= blim[:, None])
        Dm = jnp.where(lane_valid, D, INF)
        j_min = jnp.argmin(Dm, axis=1).astype(jnp.int32)
        j_end = jnp.clip(blim - va + CTR - st["boff"], 0, W - 1)
        j_com = jnp.where(at_end, j_end, j_min)
        vb_com = jnp.take_along_axis(v_b_fin, j_com[:, None], 1)[:, 0]
        d_com = jnp.take_along_axis(D, j_com[:, None], 1)[:, 0]
        # an endpoint outside the band (pathological) -> bounded cost
        d_com = jnp.where(d_com >= INF, alim + blim, d_com)
        bspan = vb_com - st["prev_vb"]

        ns = jnp.minimum(st["nseg"], max_segs - 1)
        cur = st["trace"][rows_idx, ns]
        pair = jnp.stack([d_com, bspan], axis=1)
        newv = jnp.where(commit[:, None], pair, cur)
        trace = st["trace"].at[rows_idx, ns].set(newv)

        # reset row 0 of the next segment: committed column at cost 0,
        # leading B-insertions at cost q (standard DP row 0)
        reset_D = jnp.broadcast_to(
            jnp.where(lane >= CTR, lane - CTR, INF), D.shape)
        st = dict(st)
        st["D"] = jnp.where(commit[:, None], reset_D, D)
        st["boff"] = jnp.where(commit, st["boff"] + (j_com - CTR),
                               st["boff"])
        st["trace"] = trace
        st["nseg"] = jnp.where(commit, st["nseg"] + 1, st["nseg"])
        st["prev_vb"] = jnp.where(commit, vb_com, st["prev_vb"])
        st["dsum"] = jnp.where(commit, st["dsum"] + d_com, st["dsum"])
        st["done"] = st["done"] + seg_rows
        return st

    st = jax.lax.while_loop(chunk_cond, chunk_body, state)
    return st["trace"], st["nseg"], st["dsum"]
