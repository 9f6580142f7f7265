"""Differential test: _gather_packed_words vs _gather_packed.

The word-tile gather must reproduce the char-tile gather EXACTLY
(including clip-gathered garbage regions the kernels mask) — the bp
Pallas kernels unpack chars from it with scalar row indices, so any
mismatch would silently change alignment results.
"""
import numpy as np
import jax.numpy as jnp

from damar_tpu.ops.wave_bp import (_gather_packed,
                                   _gather_packed_words,
                                   _pack_bases)


def _unpack(tile_words, length):
    """[S, nw] aligned words -> [S, length] chars (the kernels'
    (w[i>>4] >> 2*(i&15)) & 3 read, vectorized)."""
    w = np.asarray(tile_words).astype(np.uint32)
    i = np.arange(length)
    return ((w[:, i >> 4] >> (2 * (i & 15)).astype(np.uint32)) & 3
            ).astype(np.int32)


def _setup(seed, n=4096, S=64):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, n).astype(np.uint8)
    words = _pack_bases(jnp.asarray(bases))
    origin = jnp.asarray(rng.integers(64, n - 64, S).astype(np.int32))
    v0 = jnp.asarray(rng.integers(-16, 48, S).astype(np.int32))
    return words, origin, v0


def test_forward_matches_char_gather():
    words, origin, v0 = _setup(0)
    for length in (64, 96, 288):
        chars = np.asarray(_gather_packed(words, origin, v0, length,
                                          False))
        tile = _gather_packed_words(words, origin, v0, length, False)
        np.testing.assert_array_equal(_unpack(tile, length), chars)


def test_reverse_matches_char_gather():
    words, origin, v0 = _setup(1)
    for length in (64, 96, 288):
        chars = np.asarray(_gather_packed(words, origin, v0, length,
                                          True))
        tile = _gather_packed_words(words, origin, v0, length, True)
        np.testing.assert_array_equal(_unpack(tile, length), chars)


def test_traced_mixed_directions():
    words, origin, v0 = _setup(2, S=128)
    rng = np.random.default_rng(3)
    rev = jnp.asarray(rng.integers(0, 2, 128).astype(bool))
    for length in (64, 288):
        chars = np.asarray(_gather_packed(words, origin, v0, length,
                                          rev))
        tile = _gather_packed_words(words, origin, v0, length, rev)
        np.testing.assert_array_equal(_unpack(tile, length), chars)


def test_garbage_regions_match_too():
    # windows that run off both pool ends: the clip-gather garbage
    # must be IDENTICAL (kernels mask it, but bit-identity of the
    # masked inputs keeps the differential chain honest)
    words, _, _ = _setup(4, n=512)
    origin = jnp.asarray(np.array([0, 4, 500, 508], np.int32))
    v0 = jnp.asarray(np.array([-32, -8, 40, 4], np.int32))
    for reverse in (False, True):
        chars = np.asarray(_gather_packed(words, origin, v0, 96,
                                          reverse))
        tile = _gather_packed_words(words, origin, v0, 96, reverse)
        np.testing.assert_array_equal(_unpack(tile, 96), chars)


def test_chunked_canonical_codes_match_unchunked():
    # the 200 Mbp block unit OOMs the fused k-mer construction at
    # compile time; the chunked lax.map path must be bit-identical
    import jax.numpy as jnp
    from damar_tpu.ops import seeding as sd
    from damar_tpu.ops.kmers import kmer_codes_canonical
    old = sd._CANON_CHUNK
    sd._CANON_CHUNK = 1 << 12
    try:
        n = 1 << 13
        rng = np.random.default_rng(5)
        bases = rng.integers(0, 4, n).astype(np.uint8)
        bases[100] = 4
        rid = np.repeat(np.arange(n // 500 + 1), 500)[:n].astype(np.int32)
        mp_base = rng.integers(0, 1 << 31, n,
                               dtype=np.uint32) & ~np.uint32(1)
        k = 14
        c1, m1 = sd._canon_codes_packed.__wrapped__(
            jnp.asarray(bases), jnp.asarray(rid), jnp.asarray(mp_base),
            k)
        codes, strand = kmer_codes_canonical(jnp.asarray(bases),
                                             jnp.asarray(rid), k, None)
        m0 = jnp.asarray(mp_base) | strand.astype(jnp.uint32)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(codes))
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m0))
    finally:
        sd._CANON_CHUNK = old
