"""Native host-runtime bindings: build-on-demand C library + ctypes.

The shared library is compiled from damar_native.c on first use (cached
next to the source; rebuilt when the source changes) and loaded with
ctypes.  All entry points have numpy fallbacks so the package works
without a C toolchain; `available()` reports which path is active.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "damar_native.c")
_LIB = None
_TRIED = False


def _host_key() -> str:
    """The build host's architecture and CPU feature flags: code built
    with -march=native is only valid on a CPU with the same flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = line.strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()}\n{flags}"


def _lib_path() -> str:
    """Library path keyed on the C source and the host CPU, so a
    checkout copied to another machine rebuilds instead of loading
    code compiled for a different CPU."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(_host_key().encode())
    return os.path.join(_HERE, f"libdamar_native.{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    so = _lib_path()
    if os.path.exists(so):
        return so
    for cc in ("cc", "gcc", "clang"):
        # -march=native vectorizes the lockstep bp kernels; the .so is
        # keyed on the host CPU (see _lib_path), so host-specific
        # codegen is safe.  Fall back without it.
        # Compile to a temp name and rename only on success: a killed/
        # timed-out cc must not leave a partial .so that the exists()
        # check above would hand to CDLL forever after.
        tmp = so + ".build"
        for extra in (["-march=native"], []):
            try:
                r = subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-pthread"]
                    + extra + [_SRC, "-o", tmp],
                    capture_output=True, timeout=120)
                if r.returncode == 0:
                    os.replace(tmp, so)
                    return so
            except (FileNotFoundError, subprocess.TimeoutExpired):
                break
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
    return None


def _lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        if os.environ.get("DAMAR_NO_NATIVE"):
            return None
        so = _build()
        if so:
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                # corrupt cached artifact: drop it so the next process
                # rebuilds, and fall back to the numpy paths now
                try:
                    os.remove(so)
                except OSError:
                    pass
                return None
            lib.pack2bit.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.unpack2bit.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.las_merge.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_char_p]
            lib.las_merge.restype = ctypes.c_int
            lib.las_scan.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.las_scan.restype = ctypes.c_int64
            lib.band_align_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32)]
            lib.band_align_batch.restype = ctypes.c_int64
            lib.trace_points_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32]
            lib.trace_points_batch.restype = ctypes.c_int64
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.bp_extend_batch.argtypes = [
                u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                i32p, i32p, i32p, i32p, u8p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                i32p, i32p, i32p, i32p]
            lib.bp_extend_batch.restype = None
            lib.bp_trace_batch.argtypes = [
                u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                i32p, i32p, i32p, i32p, i32p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, i32p, i32p, i32p]
            lib.bp_trace_batch.restype = None
            lib.bp_trace64_batch.argtypes = \
                lib.bp_trace_batch.argtypes
            lib.bp_trace64_batch.restype = None
            lib.radix_argsort_u64.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.radix_argsort_u64.restype = ctypes.c_int64
            lib.canon_kmers.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint8)]
            lib.canon_kmers.restype = None
            lib.revcomp_reads.argtypes = [
                u8p, i32p, ctypes.c_int32, u8p]
            lib.revcomp_reads.restype = None
            lib.plain_kmers.argtypes = [
                u8p, ctypes.c_int64, i32p, u8p, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint32)]
            lib.plain_kmers.restype = None
            lib.dust_batch.argtypes = [
                u8p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_double, i32p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.dust_batch.restype = ctypes.c_int64
            i64 = ctypes.c_int64
            lib.band_filter.argtypes = [
                i32p, i32p, u8p, i32p, i32p, i64, i64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i64,
                i32p, i32p, i32p, i32p, i32p, i32p,
                ctypes.POINTER(i64)]
            lib.band_filter.restype = i64
            i64p = ctypes.POINTER(i64)
            lib.run_firsts.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), i64, i64p, i64p]
            lib.run_firsts.restype = None
            lib.fill_hits_strand.argtypes = [
                i32p, i32p, i64p, i64p, i64, i64, i32p, i64p,
                ctypes.c_int32, ctypes.c_int32,
                i32p, i32p, u8p, i64p]
            lib.fill_hits_strand.restype = i64
            lib.self_hit_counts.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), i64,
                ctypes.c_uint32, i64, i64p, i64p]
            lib.self_hit_counts.restype = None
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.fill_hits_packed.argtypes = [
                u32p, u32p, i64p, i64p, i64, i64, ctypes.c_int32,
                u32p, u32p, i64p]
            lib.fill_hits_packed.restype = i64
            lib.band_filter_packed.argtypes = [
                u32p, u32p, i64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, i64,
                i32p, i32p, i32p, i32p, i32p, i32p,
                ctypes.POINTER(i64)]
            lib.band_filter_packed.restype = i64
            lib.ragged_copy_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(i64),
                ctypes.POINTER(i64), i64,
                ctypes.POINTER(ctypes.c_uint8)]
            _LIB = lib
    return _LIB


def _nthreads() -> int:
    v = os.environ.get("DAMAR_NATIVE_THREADS")
    if v:
        return max(1, int(v))
    return min(os.cpu_count() or 1, 16)


def available() -> bool:
    return _lib() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    lib = _lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if lib is None:
        from damar_tpu.formats import dazzdb
        return dazzdb._pack_2bit_np(codes)
    out = np.empty((len(codes) + 3) // 4, dtype=np.uint8)
    lib.pack2bit(_u8p(codes), len(codes), _u8p(out))
    return out


def unpack_2bit(packed: np.ndarray, length: int) -> np.ndarray:
    lib = _lib()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if lib is None:
        from damar_tpu.formats import dazzdb
        return dazzdb._unpack_2bit_np(packed, length)
    out = np.empty(length, dtype=np.uint8)
    lib.unpack2bit(_u8p(packed), length, _u8p(out))
    return out


def las_merge(paths: list[str], out: str) -> bool:
    """Streaming k-way merge of sorted .las files (LAmerge).  Returns
    True on success; callers fall back to the Python merge on False."""
    lib = _lib()
    if lib is None:
        return False
    arr = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths])
    rc = lib.las_merge(arr, len(paths), out.encode())
    if rc != 0 and os.path.exists(out):
        os.remove(out)
    return rc == 0


def las_scan(path: str):
    """Fast .las reader: (headers [n,10] int32, trace bytes, offsets)
    or None when native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    size = os.path.getsize(path)
    novl = int(np.fromfile(path, dtype="<i8", count=1)[0]) \
        if size >= 12 else 0
    if novl < 0 or 12 + 40 * novl > size:
        # corrupt header: never size an allocation from it
        raise IOError(f"las_scan({path}): header claims {novl} "
                      f"records in a {size}-byte file")
    headers = np.zeros((max(novl, 1), 10), dtype=np.int32)
    trace = np.zeros(max(size, 1), dtype=np.uint8)
    offs = np.zeros(novl + 1, dtype=np.int64)
    n = lib.las_scan(
        path.encode(),
        headers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8p(trace), size,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n < 0:
        raise IOError(f"las_scan({path}) failed: {n}")
    return headers[:n], trace[:offs[n]], offs


def band_align_paths(template: np.ndarray, covers: list[np.ndarray],
                     band: int, semiglobal: bool = True):
    """Banded edit alignments of covers vs one template (consensus hot
    path; mirrors pipeline.consensus.banded_align_path semantics).
    Returns (ops_concat u8, offs int64 [n+1], jstarts int32 [n]) or
    None when the native library is unavailable.  ops: 0=match/sub,
    1=del(template), 2=ins(cover); jstart = leading cover chars
    skipped before the path."""
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(template, dtype=np.uint8)
    n_cov = len(covers)
    b_offs = np.zeros(n_cov + 1, np.int64)
    for i, c in enumerate(covers):
        b_offs[i + 1] = b_offs[i] + len(c)
    b_cat = (np.concatenate([np.ascontiguousarray(c, dtype=np.uint8)
                             for c in covers])
             if n_cov and b_offs[-1] else np.zeros(1, np.uint8))
    cap = int(b_offs[-1]) + (len(a) + 2) * max(n_cov, 1)
    ops = np.zeros(max(cap, 1), np.uint8)
    offs = np.zeros(n_cov + 1, np.int64)
    jst = np.zeros(max(n_cov, 1), np.int32)
    total = lib.band_align_batch(
        _u8p(a), np.int32(len(a)), _u8p(b_cat),
        b_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int32(n_cov), np.int32(band), np.int32(1 if semiglobal else 0),
        _u8p(ops), np.int64(len(ops)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        jst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if total < 0:
        return None
    return ops[:total], offs, jst[:n_cov]


def trace_points_batch(a_codes, b_codes, astart, bstart, abpos, aepos,
                       bbpos, bepos, tspace: int, band: int,
                       max_segs: int):
    """Trace-point pairs for a batch of alignments.  astart/bstart:
    the records' read origins in the block arrays; abpos..bepos are
    READ-LOCAL (tspace boundaries live in the A read's frame).
    Returns (trace [n, max_segs, 2] int32, nseg int32[n],
    dsum int32[n]) or None when native is unavailable.  Records whose
    banded chain cannot reach the pinned endpoint get nseg 0 (callers'
    consistency check drops them)."""
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a_codes, dtype=np.uint8)
    b = np.ascontiguousarray(b_codes, dtype=np.uint8)
    n = len(abpos)
    i64 = lambda x: np.ascontiguousarray(x, dtype=np.int64)
    as_, bs_ = i64(astart), i64(bstart)
    ab, ae = i64(abpos), i64(aepos)
    bb, be = i64(bbpos), i64(bepos)
    out = np.zeros((max(n, 1), max_segs, 2), np.int32)
    nseg = np.zeros(max(n, 1), np.int32)
    dsum = np.zeros(max(n, 1), np.int32)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.trace_points_batch(
        _u8p(a), _u8p(b), np.int32(n), p64(as_), p64(bs_),
        p64(ab), p64(ae), p64(bb),
        p64(be), np.int32(tspace), np.int32(band), p32(out), p32(nseg),
        p32(dsum), np.int32(max_segs), np.int32(_nthreads()))
    if rc != 0:
        return None
    return out[:n], nseg[:n], dsum[:n]


def revcomp_reads(bases: np.ndarray, starts: np.ndarray,
                  out: np.ndarray) -> bool:
    """Per-read reverse complement into `out` (bases/out uint8,
    starts int32 [nreads+1]).  Returns False when native is
    unavailable (caller keeps the numpy gather)."""
    lib = _lib()
    if lib is None:
        return False
    s = np.ascontiguousarray(starts, dtype=np.int32)
    lib.revcomp_reads(
        _u8p(bases), s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int32(len(s) - 1), _u8p(out))
    return True


def canon_kmers(bases: np.ndarray, read_id: np.ndarray, k: int,
                mask: np.ndarray | None = None):
    """Canonical k-mer codes + strand bits — exact C replica of
    ops.kmers.kmer_codes_canonical (asserted by tests/test_native_bp
    .py).  Returns (codes uint32[n], strand bool[n]) or None when
    native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    b = np.ascontiguousarray(bases, dtype=np.uint8)
    rid = np.ascontiguousarray(read_id, dtype=np.int32)
    n = len(b)
    m = (np.ascontiguousarray(mask, dtype=np.uint8)
         if mask is not None else None)
    codes = np.empty(n, np.uint32)
    strand = np.empty(n, np.uint8)
    lib.canon_kmers(
        _u8p(b), np.int64(n),
        rid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8p(m) if m is not None else None, np.int32(k),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _u8p(strand))
    return codes, strand.astype(bool)


def band_filter(apos, bpos, comp, ar, br, bcap: int, band_shift: int,
                kmer: int, hit_min: int, read_bits: int,
                bucket_bits: int, pos_bits: int, seed_cap: int):
    """Diagonal band filter C core (see damar_native.c band_filter;
    exact replica of the numpy/_diag_filter_impl banding).  Returns
    (s_ar, s_br, s_ap, s_bp, s_cov, s_comp, nseeds, total_seeds) with
    arrays sized nseeds, or None when native is unavailable or the
    fused sort key exceeds 64 bits (caller falls back to numpy)."""
    lib = _lib()
    if lib is None:
        return None
    i32 = lambda x: np.ascontiguousarray(x, dtype=np.int32)
    ap, bp = i32(apos), i32(bpos)
    a, b = i32(ar), i32(br)
    cm = np.ascontiguousarray(np.asarray(comp), dtype=np.uint8)
    n = len(ap)
    cap = max(min(seed_cap, max(n, 1) * 2), 1)
    outs = [np.zeros(cap, np.int32) for _ in range(6)]
    ns = ctypes.c_int64(0)
    p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    total = lib.band_filter(
        p32(ap), p32(bp), _u8p(cm), p32(a), p32(b),
        np.int64(n), np.int64(bcap), np.int32(band_shift),
        np.int32(kmer), np.int32(hit_min), np.int32(read_bits),
        np.int32(bucket_bits), np.int32(pos_bits), np.int64(seed_cap),
        *[p32(o) for o in outs], ctypes.byref(ns))
    if total < 0:
        return None
    k = int(ns.value)
    return tuple(o[:k] for o in outs) + (k, int(total))


def dust_batch(seqs: list[np.ndarray], window: int, thresh: float):
    """DUST intervals for a batch of reads — exact C replica of
    utils.dust.dust_read.  Returns list of flat [b,e,...] int32
    arrays, or None when native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    starts = np.zeros(len(seqs) + 1, np.int64)
    for i, s in enumerate(seqs):
        starts[i + 1] = starts[i] + len(s)
    cat = (np.concatenate([np.ascontiguousarray(s, np.uint8)
                           for s in seqs])
           if len(seqs) and starts[-1] else np.zeros(1, np.uint8))
    cap = int(starts[-1]) + 2 * len(seqs) + 2
    out = np.zeros(cap, np.int32)
    offs = np.zeros(len(seqs) + 1, np.int64)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    total = lib.dust_batch(
        _u8p(cat), p64(starts), np.int32(len(seqs)), np.int32(window),
        ctypes.c_double(thresh),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int64(cap), p64(offs))
    if total < 0:
        return None
    return [out[offs[i]:offs[i + 1]].copy() for i in range(len(seqs))]


def plain_kmers(bases: np.ndarray, read_id: np.ndarray, k: int,
                mask: np.ndarray | None = None):
    """Forward-only k-mer codes — exact C replica of
    ops.kmers.kmer_codes.  Returns uint32[n] codes or None."""
    lib = _lib()
    if lib is None:
        return None
    b = np.ascontiguousarray(bases, dtype=np.uint8)
    rid = np.ascontiguousarray(read_id, dtype=np.int32)
    m = (np.ascontiguousarray(mask, dtype=np.uint8)
         if mask is not None else None)
    codes = np.empty(len(b), np.uint32)
    lib.plain_kmers(
        _u8p(b), np.int64(len(b)),
        rid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8p(m) if m is not None else None, np.int32(k),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return codes


def lexsort(keys) -> np.ndarray | None:
    """np.lexsort twin (LAST key is primary, stable) built on the
    threaded radix argsort: keys are greedily bit-packed into as few
    u64 words as possible, then LSD-sorted word by word.  Requires
    nonnegative integer keys; returns None when native is unavailable
    or a key is unpackable (caller falls back to np.lexsort)."""
    if _lib() is None or not keys:
        return None
    words: list[np.ndarray] = []
    cur = None
    used = 0
    for k in keys:                       # least-significant first
        k = np.asarray(k)
        if k.dtype.kind not in "iu" or (len(k) and int(k.min()) < 0):
            return None
        hi = int(k.max()) if len(k) else 0
        bits = max(hi.bit_length(), 1)
        if bits > 64:
            return None
        v = k.astype(np.uint64)
        if cur is None or used + bits > 64:
            if cur is not None:
                words.append(cur)
            cur, used = v, bits
        else:
            cur = cur | (v << np.uint64(used))
            used += bits
    words.append(cur)
    order = None
    for w in words:                      # LSD over packed words
        key = w if order is None else w[order]
        o = radix_argsort(key)
        if o is None:
            return None
        order = o if order is None else order[o]
    return order


def radix_argsort(keys: np.ndarray):
    """Stable ascending argsort of u64 (or any nonneg integer) keys
    via the C LSD radix; returns int64 indices or None when native is
    unavailable.  ~4x faster than numpy's stable argsort at the
    seeding stage's 1-4M-element shapes."""
    lib = _lib()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    order = np.empty(len(k), np.int64)
    rc = lib.radix_argsort_u64(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.int64(len(k)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    return order


def run_firsts(codes: np.ndarray):
    """Segment starts/lengths of a sorted code stream — exact C
    replica of ops.seeding_host._run_firsts's (starts, cnt) outputs.
    Returns (starts int64[n], cnt int64[n]) or None when native is
    unavailable."""
    lib = _lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes, dtype=np.uint32)
    n = len(c)
    starts = np.empty(max(n, 1), np.int64)
    cnt = np.empty(max(n, 1), np.int64)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.run_firsts(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        np.int64(n), p64(starts), p64(cnt))
    return starts[:n], cnt[:n]


def self_hit_counts(codes: np.ndarray, inval: int, tmax: int):
    """Fused self-pair tuple counts — one C pass producing the
    (lo, c) arrays seeding_host's self_pair branch derives from
    run_firsts + rank/ok/where.  Returns (lo int64[n], c int64[n]) or
    None when native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    cc = np.ascontiguousarray(codes, dtype=np.uint32)
    n = len(cc)
    lo = np.empty(max(n, 1), np.int64)
    c = np.empty(max(n, 1), np.int64)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.self_hit_counts(
        cc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        np.int64(n), ctypes.c_uint32(inval), np.int64(tmax),
        p64(lo), p64(c))
    return lo[:n], c[:n]


def fill_hits_strand(a_pos2, b_pos2, lo, c, cap: int, b_rid, b_starts,
                     k: int):
    """Fused hit materialization + strand split + rc bpos mapping —
    exact C replica of seeding_host._fill_hits followed by the
    strand-split block of find_seeds_canonical_host.  Returns
    (apos int32, bpos int32, comp bool, nhits, total) with arrays
    sized nhits, or None when native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    i32 = lambda x: np.ascontiguousarray(x, dtype=np.int32)
    i64 = lambda x: np.ascontiguousarray(x, dtype=np.int64)
    ap2, bp2 = i32(a_pos2), i32(b_pos2)
    lo_, c_ = i64(lo), i64(c)
    rid = i32(b_rid)
    bst = i64(b_starts)
    nt = len(c_)
    cap = int(cap)
    apos = np.empty(max(cap, 1), np.int32)
    bpos = np.empty(max(cap, 1), np.int32)
    comp = np.empty(max(cap, 1), np.uint8)
    total = ctypes.c_int64(0)
    p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    nhits = lib.fill_hits_strand(
        p32(ap2), p32(bp2), p64(lo_), p64(c_), np.int64(nt),
        np.int64(cap), p32(rid), p64(bst), np.int32(k),
        np.int32(_nthreads()), p32(apos), p32(bpos), _u8p(comp),
        ctypes.byref(total))
    if nhits < 0:
        return None
    n = int(nhits)
    return (apos[:n], bpos[:n], comp[:n].view(bool), n,
            int(total.value))


def fill_hits_packed(a_mp, b_mp, lo, c, cap: int):
    """Packed-payload hit materialization (v3 twin of
    seeding_host._fill_hits_packed_np): B-tuple-major run expansion
    truncated at cap, payload words carried verbatim.  Returns
    (ap_mp u32, bp_mp u32, nhits, total) sized nhits, or None."""
    lib = _lib()
    if lib is None:
        return None
    u32 = lambda x: np.ascontiguousarray(x, dtype=np.uint32)
    i64 = lambda x: np.ascontiguousarray(x, dtype=np.int64)
    amp, bmp = u32(a_mp), u32(b_mp)
    lo_, c_ = i64(lo), i64(c)
    cap = int(cap)
    ap = np.empty(max(cap, 1), np.uint32)
    bp = np.empty(max(cap, 1), np.uint32)
    total = ctypes.c_int64(0)
    pu = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    nhits = lib.fill_hits_packed(
        pu(amp), pu(bmp), p64(lo_), p64(c_), np.int64(len(c_)),
        np.int64(cap), np.int32(_nthreads()), pu(ap), pu(bp),
        ctypes.byref(total))
    if nhits < 0:
        return None
    n = int(nhits)
    return ap[:n], bp[:n], n, int(total.value)


def band_filter_packed(ap_mp, bp_mp, a_rpos_bits: int, b_rpos_bits: int,
                       read_bits: int, band_shift: int, kmer: int,
                       hit_min: int, upper_only: bool,
                       include_self: bool, seed_cap: int):
    """v3 single-bucket packed banding C core (damar_native.c
    band_filter_packed; exact replica of
    seeding_host._band_filter_packed_np).  Returns (s_ar, s_br, s_arp,
    s_brp, s_cov, s_comp, nseeds, total_seeds) sized nseeds in
    READ-LOCAL coordinates, or None when native is unavailable or the
    band key exceeds 64 bits (caller falls back to numpy)."""
    lib = _lib()
    if lib is None:
        return None
    u32 = lambda x: np.ascontiguousarray(x, dtype=np.uint32)
    amp, bmp = u32(ap_mp), u32(bp_mp)
    n = len(amp)
    cap = max(min(int(seed_cap), max(n, 1)), 1)
    outs = [np.zeros(cap, np.int32) for _ in range(6)]
    ns = ctypes.c_int64(0)
    pu = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    total = lib.band_filter_packed(
        pu(amp), pu(bmp), np.int64(n), np.int32(a_rpos_bits),
        np.int32(b_rpos_bits), np.int32(read_bits),
        np.int32(band_shift), np.int32(kmer), np.int32(hit_min),
        np.int32(bool(upper_only)), np.int32(bool(include_self)),
        np.int64(seed_cap), *[p32(o) for o in outs], ctypes.byref(ns))
    if total < 0:
        return None
    k = int(ns.value)
    return tuple(o[:k] for o in outs) + (k, int(total))


def bp_extend_batch(a_bases, b_bases, aorigin, borigin, alim, blim,
                    dirs, R: int, max_rows: int, diff_cost: int,
                    xdrop: int):
    """Batched bit-parallel band extension — exact native replica of
    ops.wave_bp.extend_wave_bp (bit-identical outputs, asserted by
    tests/test_native_bp.py).  Returns (best_va, best_vb, best_d,
    best_score) int32 arrays, or None when native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a_bases, dtype=np.uint8)
    b = np.ascontiguousarray(b_bases, dtype=np.uint8)
    i32 = lambda x: np.ascontiguousarray(x, dtype=np.int32)
    ao, bo = i32(aorigin), i32(borigin)
    al, bl = i32(alim), i32(blim)
    S = len(ao)
    rv = np.ascontiguousarray(
        np.zeros(S, np.uint8) if dirs is None
        else np.asarray(dirs).astype(np.uint8))
    va = np.zeros(max(S, 1), np.int32)
    vb = np.zeros(max(S, 1), np.int32)
    d = np.zeros(max(S, 1), np.int32)
    sc = np.zeros(max(S, 1), np.int32)
    p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.bp_extend_batch(
        _u8p(a), np.int64(len(a)), _u8p(b), np.int64(len(b)),
        p32(ao), p32(bo), p32(al), p32(bl), _u8p(rv),
        np.int32(S), np.int32(R), np.int32(max_rows),
        np.int32(diff_cost), np.int32(xdrop), np.int32(_nthreads()),
        p32(va), p32(vb), p32(d), p32(sc))
    return va[:S], vb[:S], d[:S], sc[:S]


def bp_trace_batch(a_bases, b_bases, astart, bstart, abpos, bbpos,
                   alim, blim, tspace: int, max_segs: int,
                   wide: bool = False):
    """Batched bit-parallel trace-point pass — exact native replica of
    ops.wave_bp.trace_wave_bp.  wide=True selects the 64-diagonal
    band variant (the cheap retry tier for drifting alignments).
    Returns (trace [S, max_segs, 2], nseg, dsum) int32, or None when
    native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a_bases, dtype=np.uint8)
    b = np.ascontiguousarray(b_bases, dtype=np.uint8)
    i32 = lambda x: np.ascontiguousarray(x, dtype=np.int32)
    as_, bs_ = i32(astart), i32(bstart)
    al, bl = i32(alim), i32(blim)
    S = len(as_)
    ab_bb = np.empty(2 * max(S, 1), np.int32)
    ab_bb[0::2] = np.asarray(abpos, np.int32)[:S] if S else 0
    ab_bb[1::2] = np.asarray(bbpos, np.int32)[:S] if S else 0
    trace = np.zeros((max(S, 1), max_segs, 2), np.int32)
    nseg = np.zeros(max(S, 1), np.int32)
    dsum = np.zeros(max(S, 1), np.int32)
    p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    fn = lib.bp_trace64_batch if wide else lib.bp_trace_batch
    fn(_u8p(a), np.int64(len(a)), _u8p(b), np.int64(len(b)),
       p32(as_), p32(bs_), p32(ab_bb), p32(al), p32(bl),
       np.int32(S), np.int32(tspace), np.int32(max_segs),
       np.int32(_nthreads()), p32(trace), p32(nseg), p32(dsum))
    return trace[:S], nseg[:S], dsum[:S]


def ragged_copy(src: np.ndarray, starts: np.ndarray,
                lens: np.ndarray) -> np.ndarray | None:
    """Contiguous gather of ragged byte runs src[starts[i]:
    starts[i]+lens[i]] (BYTE offsets/lengths) — the C twin of the
    formats.las numpy chunked gather, ~60x faster at block scale.
    Returns the packed uint8 buffer, or None when native is
    unavailable."""
    lib = _lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint8)
    st = np.ascontiguousarray(starts, dtype=np.int64)
    ln = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(int(ln.sum()), np.uint8)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.ragged_copy_u8(_u8p(src), p64(st), p64(ln),
                       np.int64(len(st)), _u8p(out))
    return out
