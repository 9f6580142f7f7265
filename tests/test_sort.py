"""Differential tests for the sort backends.

The seeding stage's determinism (and the .las bit-identity goal) rests
on every backend of damar_tpu.ops.sort producing the SAME stable
order.  "xla" is the device production path, "radix" the compile-cheap
fallback, "host" the numpy path the CPU bench fallback uses — all
three must agree element-for-element.

Backend selection is read at trace time, so each flip clears the jit
caches (see sort._backend docstring).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from damar_tpu.ops.sort import (compact_flagged, merge_ranks,
                                pack_fields, radix_sort_bits,
                                radix_sort_multi, radix_sort_packed)

BACKENDS = ("xla", "radix", "host")


@pytest.fixture
def backend_env():
    """Restore DAMAR_SORT and the jit caches after the test."""
    prev = os.environ.get("DAMAR_SORT")
    yield
    if prev is None:
        os.environ.pop("DAMAR_SORT", None)
    else:
        os.environ["DAMAR_SORT"] = prev
    jax.clear_caches()


def _per_backend(fn):
    out = {}
    for b in BACKENDS:
        os.environ["DAMAR_SORT"] = b
        jax.clear_caches()
        out[b] = jax.tree.map(np.asarray, fn())
    return out


def _assert_all_equal(res):
    ref = res["xla"]
    for b in BACKENDS[1:]:
        for r, x in zip(jax.tree.leaves(ref), jax.tree.leaves(res[b])):
            np.testing.assert_array_equal(r, x, err_msg=f"backend {b}")


class TestBackendsAgree:
    def test_radix_sort_bits(self, backend_env):
        rng = np.random.default_rng(7)
        n = 5000
        key = rng.integers(0, 1 << 20, n).astype(np.int32)
        pay = rng.integers(0, 1 << 30, n).astype(np.int32)
        res = _per_backend(lambda: radix_sort_bits(
            jnp.asarray(key), (jnp.asarray(pay),), 20))
        _assert_all_equal(res)
        # and it really is a stable sort of the key
        ks = np.asarray(res["xla"][0])
        assert (np.diff(ks) >= 0).all()

    def test_radix_sort_multi(self, backend_env):
        rng = np.random.default_rng(8)
        n = 3000
        k0 = rng.integers(0, 1 << 10, n).astype(np.int32)   # most sig
        k1 = rng.integers(0, 1 << 12, n).astype(np.int32)
        pay = np.arange(n, dtype=np.int32)
        res = _per_backend(lambda: radix_sort_multi(
            (jnp.asarray(k0), jnp.asarray(k1)),
            (jnp.asarray(pay),), (10, 12)))
        _assert_all_equal(res)
        # stability: equal (k0,k1) rows keep original payload order
        (ks0, ks1), (ps,) = res["xla"]
        key = np.asarray(ks0).astype(np.int64) << 32 | np.asarray(ks1)
        same = key[1:] == key[:-1]
        assert (np.asarray(ps)[1:][same] > np.asarray(ps)[:-1][same]).all()

    def test_radix_sort_packed(self, backend_env):
        rng = np.random.default_rng(9)
        n = 4000
        f0 = rng.integers(0, 1 << 17, n).astype(np.int32)
        f1 = rng.integers(0, 1 << 17, n).astype(np.int32)
        f2 = rng.integers(0, 1 << 9, n).astype(np.int32)
        pay = np.arange(n, dtype=np.int32)

        def run():
            words = pack_fields(
                (jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(f2)),
                (17, 17, 9))
            return radix_sort_packed(words, (jnp.asarray(pay),), 43)
        res = _per_backend(run)
        _assert_all_equal(res)

    def test_compact_and_merge(self, backend_env):
        rng = np.random.default_rng(10)
        n = 3000
        live = rng.random(n) < 0.3
        vals = rng.integers(0, 1 << 28, n).astype(np.int32)
        a = np.sort(rng.integers(0, 1 << 16, 2000).astype(np.int32))
        b = np.sort(rng.integers(0, 1 << 16, 1500).astype(np.int32))

        def run():
            c = compact_flagged(jnp.asarray(live), (jnp.asarray(vals),),
                                out_cap=1024)
            m = merge_ranks(jnp.asarray(a), jnp.asarray(b), 16)
            return c, m
        res = _per_backend(run)
        _assert_all_equal(res)
        # merge_ranks oracle vs searchsorted
        (_, _, _), (lo, cnt) = res["xla"]
        np.testing.assert_array_equal(np.asarray(lo),
                                      np.searchsorted(a, b, "left"))
        np.testing.assert_array_equal(
            np.asarray(cnt), np.searchsorted(a, b, "right")
            - np.searchsorted(a, b, "left"))
