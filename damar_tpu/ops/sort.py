"""Device stable sorts and sorted-stream helpers.

The reference overlapper's seeding stage is built on a multi-pass LSD
radix sort of k-mer tuples (SURVEY.md §2.3, upstream dalign/filter.c
Sort_Kmers — upstream-path citation, reference mount empty).  This
module provides the device equivalent with interchangeable backends
behind one stable-sort API:

  * "xla" (default): jax.lax.sort (is_stable=True) — one fused sort,
    far cheaper than anything composed from scatters (a 29-bit radix
    chain needs dozens).  Its cost is compile time per distinct
    (shape, operand-count) bucket, paid once per process and excluded
    by warmup — the right trade for production runs where one process
    sweeps many same-shaped block pairs.
  * "radix" (DAMAR_SORT=radix): stable LSD radix passes built from
    cumsum + permutation-scatter, fully UNROLLED, 2-bit digits.
    Compiles in seconds.  Kept for compile-dominated situations
    (one-shot tiny jobs, debugging).
  * "host" (DAMAR_SORT=host): numpy/C stable sort via pure_callback,
    for the CPU backend.

jnp.searchsorted is avoided throughout: a radix merge of the two
sorted streams replaces it.

All functions are shape-static, stable, and deterministic.
"""
from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp


def host_lexsort(keys) -> "object":
    """np.lexsort drop-in (LAST key primary, stable) that routes
    through the native threaded radix when all keys are nonnegative
    integers — ~9x np.lexsort at block-scale shapes."""
    import numpy as np
    from damar_tpu import native
    order = native.lexsort(list(keys))
    return np.lexsort(tuple(keys)) if order is None else order


def _backend() -> str:
    """Sort backend: "xla" (default, the device path), "radix"
    (compile-cheap unrolled passes), or "host" (numpy stable sort via
    pure_callback — ~3.5x faster than XLA's sort on the CPU fallback
    path; NEVER the right choice on a real accelerator, and not safe
    under shard_map, so it is opt-in via DAMAR_SORT=host).  Read at
    trace time: flipping the env var mid-process needs
    jax.clear_caches()."""
    return os.environ.get("DAMAR_SORT", "xla")


def _use_xla_sort() -> bool:
    return _backend() not in ("radix", "host")


def _host_lexsort(keys, payloads):
    """Stable lexicographic host sort (keys most-significant first)
    carrying payloads, as a pure_callback.  Used only by the "host"
    backend on the CPU fallback path."""
    import numpy as np
    keys = tuple(keys)
    payloads = tuple(payloads)
    arrs = keys + payloads
    nk = len(keys)

    def _argsort_u64(key64):
        from damar_tpu import native
        order = native.radix_argsort(key64)
        return np.argsort(key64, kind="stable") if order is None \
            else order

    def cb(*a):
        # the callback may receive jax.Array views (CPU zero-copy);
        # force real numpy or the u64 fold silently truncates to u32
        # under the default x64-disabled config
        a = tuple(np.asarray(x) for x in a)
        ks = a[:nk]
        if nk == 1 and ks[0].dtype.itemsize <= 8:
            order = _argsort_u64(ks[0].astype(np.uint64))
        elif nk == 2 and all(k.dtype.itemsize <= 4 for k in ks):
            # fold two <=32-bit keys into one u64: a single radix
            # argsort replaces the 2-key lexsort
            hi = ks[0].astype(np.uint32).astype(np.uint64)
            lo = ks[1].astype(np.uint32).astype(np.uint64)
            order = _argsort_u64((hi << np.uint64(32)) | lo)
        else:
            # np.lexsort's primary key is its LAST element
            order = np.lexsort(tuple(reversed(ks)))
        return tuple(np.ascontiguousarray(x[order]) for x in a)

    out = jax.pure_callback(
        cb,
        tuple(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in arrs),
        *arrs)
    return tuple(out[:nk]), tuple(out[nk:])


def _split_by_digit(dig, nd: int, arrays):
    """One stable counting-sort pass by digit value in [0, nd).

    Returns arrays permuted so digit values ascend, ties in order.
    """
    n = dig.shape[0]
    cums = [jnp.cumsum((dig == v).astype(jnp.int32)) for v in range(nd)]
    pos = jnp.zeros(n, jnp.int32)
    acc = jnp.int32(0)
    for v in range(nd):
        pos = jnp.where(dig == v, acc + cums[v] - 1, pos)
        acc = acc + cums[v][-1]
    return tuple(
        jnp.zeros_like(a).at[pos].set(a, unique_indices=True)
        for a in arrays)


def _radix_passes(arrays, key_index: int, bits: int):
    """`bits` stable radix passes (2-bit digits) on arrays[key_index],
    permuting all arrays.  Unrolled: compile cost scales with bits, but
    the scatters stay vectorized (in-loop scatters do not)."""
    if bits <= 0:
        return arrays
    for b in range(0, bits, 2):
        if b + 2 <= bits:
            dig = ((arrays[key_index] >> b) & 3).astype(jnp.int32)
            arrays = _split_by_digit(dig, 4, arrays)
        else:
            dig = ((arrays[key_index] >> b) & 1).astype(jnp.int32)
            arrays = _split_by_digit(dig, 2, arrays)
    return tuple(arrays)


@partial(jax.jit, static_argnames=("bits",))
def radix_sort_bits(key, payloads, bits: int):
    """Stable ascending sort of `key` (uint32/int32, values < 2**bits)
    carrying payload arrays.  Returns (key_sorted, payloads_sorted)."""
    if _backend() == "host":
        (k,), ps = _host_lexsort((key,), payloads)
        return k, ps
    if _use_xla_sort():
        out = jax.lax.sort((key,) + tuple(payloads), num_keys=1,
                           is_stable=True)
        return out[0], tuple(out[1:])
    arrays = _radix_passes((key,) + tuple(payloads), 0, bits)
    return arrays[0], tuple(arrays[1:])


@partial(jax.jit, static_argnames=("bits_list",))
def radix_sort_multi(keys, payloads, bits_list: tuple):
    """Stable lexicographic sort by multiple integer keys.

    keys: tuple of arrays, MOST significant first (like lax.sort's
    num_keys order); bits_list[i] = significant bits of keys[i].
    LSD: sort by the least significant key first.  Returns
    (keys_sorted tuple, payloads_sorted tuple).
    """
    nk = len(keys)
    if _backend() == "host":
        return _host_lexsort(keys, payloads)
    if _use_xla_sort():
        out = jax.lax.sort(tuple(keys) + tuple(payloads), num_keys=nk,
                           is_stable=True)
        return out[:nk], out[nk:]
    arrays = tuple(keys) + tuple(payloads)
    for ki in range(nk - 1, -1, -1):
        arrays = _radix_passes(arrays, ki, bits_list[ki])
    return arrays[:nk], arrays[nk:]


def pack_fields(fields, widths):
    """Bit-concatenate integer fields (LSB-first list, each < 2**w)
    into a tuple of uint32 words (word 0 = least significant)."""
    total = sum(widths)
    nw = -(-total // 32)
    words = [jnp.zeros_like(fields[0], dtype=jnp.uint32)
             for _ in range(nw)]
    off = 0
    for f, w in zip(fields, widths):
        f = f.astype(jnp.uint32)
        wi, bi = off // 32, off % 32
        words[wi] = words[wi] | (f << bi)    # bits >= 32 drop out
        if bi + w > 32:
            words[wi + 1] = words[wi + 1] | (f >> (32 - bi))
        off += w
    return tuple(words)


def unpack_field(words, offset: int, width: int):
    """Extract a field packed by pack_fields, as int32."""
    mask = jnp.uint32((1 << width) - 1) if width < 32 \
        else jnp.uint32(0xFFFFFFFF)
    wi, bi = offset // 32, offset % 32
    v = words[wi] >> bi
    if bi + width > 32:
        v = v | (words[wi + 1] << (32 - bi))
    return (v & mask).astype(jnp.int32)


@partial(jax.jit, static_argnames=("total_bits",))
def radix_sort_packed(words, payloads, total_bits: int):
    """Stable sort by a multi-word key from pack_fields (word 0 least
    significant): LSD passes word by word.  Returns (words, payloads)
    sorted."""
    nw = len(words)
    if _backend() == "host":
        ks, ps = _host_lexsort(tuple(reversed(words)), payloads)
        return tuple(reversed(ks)), ps
    if _use_xla_sort():
        # lax.sort keys are most-significant first
        out = jax.lax.sort(tuple(reversed(words)) + tuple(payloads),
                           num_keys=nw, is_stable=True)
        return tuple(reversed(out[:nw])), out[nw:]
    arrays = tuple(words) + tuple(payloads)
    for wi in range(nw):
        bits = min(32, total_bits - 32 * wi)
        arrays = _radix_passes(arrays, wi, bits)
    return arrays[:nw], arrays[nw:]


@partial(jax.jit, static_argnames=("out_cap", "fill"))
def compact_flagged(live, arrays, out_cap: int, fill: int = -1):
    """Compact elements where live=True into a prefix buffer of
    out_cap, preserving original order, via ONE 1-bit stable sort —
    measured far cheaper on this hardware than the cumsum + scatter
    compaction idiom (a single multi-million-row scatter costs
    ~25-40 ms; the sort ~5-15 ms).

    Returns (arrays_out tuple [out_cap], n, total): n = valid prefix
    length (= min(total, out_cap)); rows >= n are `fill`.
    """
    n_in = live.shape[0]
    dead = (~live).astype(jnp.int32)
    _, moved = radix_sort_bits(dead, tuple(arrays), 1)
    total = jnp.sum(live.astype(jnp.int32))
    n = jnp.minimum(total, out_cap)
    keep = jnp.arange(out_cap, dtype=jnp.int32) < n
    out = []
    for a in moved:
        if out_cap <= n_in:
            a = a[:out_cap]
        else:
            a = jnp.pad(a, (0, out_cap - n_in))
        out.append(jnp.where(keep, a, fill))
    return tuple(out), n, total


def seg_starts_from_first(first):
    """Per-element index of its segment's first element, given the
    boolean run-break flags of a sorted stream (first[0] must be True).
    One cummax — no scatter, no segment_sum."""
    n = first.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.cummax(jnp.where(first, idx, 0))


def seg_last_from_first(first):
    """Per-element index of its segment's LAST element, given run-break
    flags — the reverse twin of seg_starts_from_first (one flipped
    cummin, no gather)."""
    n = first.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt = jnp.where(first, idx, n)
    rev_min = jnp.flip(jax.lax.cummin(jnp.flip(
        jnp.concatenate([nxt[1:], jnp.full((1,), n, jnp.int32)]))))
    return rev_min - 1


def segment_sum_to_elements(values, first):
    """For a sorted stream with run-break flags `first`, return
    per-element totals of their segment (what the pile tools get from
    segment_sum + gather, but via cumsum + two gathers: XLA's
    scatter-add segment_sum runs ~40 ms at 4M, this ~1 ms).

    Each element's segment total = cum[last_of_seg] - cum[first_of_seg
    - 1], where cum is the inclusive cumsum of `values`.
    """
    n = values.shape[0]
    cum = jnp.cumsum(values, dtype=values.dtype)
    starts = seg_starts_from_first(first)             # [n] first idx of seg
    # last element of each segment: next segment's first - 1; for the
    # final segment it's n-1.  Compute via reversed cummin of "next
    # first index".
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt = jnp.where(first, idx, n)                    # candidate seg starts
    # next start AFTER my position: reverse cummin over nxt shifted
    rev_min = jnp.flip(jax.lax.cummin(jnp.flip(
        jnp.concatenate([nxt[1:], jnp.full((1,), n, jnp.int32)]))))
    last = rev_min - 1                                # [n] last idx of seg
    base = jnp.where(starts > 0, cum[jnp.maximum(starts - 1, 0)], 0)
    return cum[last] - base


def merge_ranks(a_codes, b_codes, bits: int):
    """For sorted a_codes and sorted b_codes, compute per-b-element
    (lo, count) where lo = searchsorted(a_codes, b, 'left') and count =
    number of equal a codes — via ONE radix merge instead of binary
    search (measured: searchsorted 2M = ~330 ms; this ~15 ms).

    Codes must be < 2**bits with bits <= 31 (key packs code<<1|side).
    Returns (lo int32[nb], count int32[nb]) in SORTED-b order (the
    same order as b_codes, which callers already hold sorted).
    """
    na = a_codes.shape[0]
    nb = b_codes.shape[0]
    side = jnp.concatenate([jnp.zeros(na, jnp.uint32),
                            jnp.ones(nb, jnp.uint32)])
    code = jnp.concatenate([a_codes.astype(jnp.uint32),
                            b_codes.astype(jnp.uint32)])
    key = (code << 1) | side                           # a's before b's
    key_s, (side_s,) = radix_sort_bits(key, (side.astype(jnp.int32),),
                                       bits + 1)
    is_a = side_s == 0
    ia = is_a.astype(jnp.int32)
    na_before = jnp.cumsum(ia) - ia                    # exclusive count
    # run-break flags on code value (ignore the side bit)
    code_s = key_s >> 1
    first = jnp.concatenate([jnp.ones((1,), bool),
                             code_s[1:] != code_s[:-1]])
    # a's with code < mine = na_before at my segment start, broadcast
    # to the segment by a cummax (na_before is non-decreasing) — a
    # pure scan where na_before[seg_starts] is a hit-scale gather
    lo_all = jax.lax.cummax(jnp.where(first, na_before, 0))
    cnt_all = na_before - lo_all        # for b: equal a's all precede it
    # extract the b rows: the stable 1-bit sort keeps them in sorted-b
    # order, so the [na:] suffix lines up with b_codes element-wise —
    # this replaces two multi-million-row write-back scatters
    _, (lo_b, cnt_b) = radix_sort_bits(side_s, (lo_all, cnt_all), 1)
    return lo_b[na:], cnt_b[na:]
