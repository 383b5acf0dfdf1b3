"""The ESC pipeline's stages against dense references: the gather-free
expansion (``expand_products``), the packed-key sort + compress
(``sort_compress``) and the row-chunked driver, on the semirings, empty rows
and sentinels, and duplicate runs spanning many elements."""
import jax.numpy as jnp
import numpy as np
import pytest

from combblas_tpu.ops.coo import SpCOO, sort_compress, sort_compress_packed
from combblas_tpu.ops.spgemm import (
    _slab_bounds_host,
    expand_products,
    spgemm,
    spgemm_bounds,
    spgemm_flops,
    spgemm_rowchunked,
    stream_capacity,
)
from combblas_tpu.semiring import MIN_PLUS, PLUS_TIMES
from tests.test_spgemm import dense_semiring_matmul


def _rand(m, k, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((m, k)) < density) * rng.random((m, k))
    return d.astype(np.float32)


def _spgemm(a, b, sr=PLUS_TIMES):
    fc, oc = spgemm_bounds(a, b)
    return spgemm(a, b, sr, flops_cap=fc, out_capacity=oc)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("density", [0.02, 0.15])
def test_esc_matches_dense(seed, density):
    m, k, n = 96, 80, 64
    ad = _rand(m, k, density, seed)
    bd = _rand(k, n, density, seed + 10)
    c = _spgemm(SpCOO.from_dense(ad), SpCOO.from_dense(bd))
    np.testing.assert_allclose(
        np.asarray(c.to_dense()), ad @ bd, rtol=1e-5, atol=1e-5
    )


def test_esc_minplus_matches_dense():
    m = k = n = 48
    ad = _rand(m, k, 0.1, 3)
    bd = _rand(k, n, 0.1, 4)
    c = _spgemm(SpCOO.from_dense(ad), SpCOO.from_dense(bd), MIN_PLUS)
    np.testing.assert_allclose(
        np.asarray(c.to_dense()), dense_semiring_matmul(ad, bd, "min_plus"),
        rtol=1e-6)


def test_esc_empty_rows_and_sentinels():
    # rows of A hitting empty B rows, plus an empty A tail
    m, k, n = 16, 32, 24
    ad = np.zeros((m, k), np.float32)
    ad[0, 5] = 2.0   # B row 5 empty
    ad[3, 7] = 1.5
    ad[9, 7] = -1.0
    bd = np.zeros((k, n), np.float32)
    bd[7, [0, 5, 23]] = [1.0, 2.0, 3.0]
    c = _spgemm(SpCOO.from_dense(ad), SpCOO.from_dense(bd))
    np.testing.assert_allclose(np.asarray(c.to_dense()), ad @ bd, rtol=1e-6)
    assert int(c.nnz) == 6


def test_compress_duplicate_run_spans_many_elements():
    """A run of equal keys tens of thousands of elements long, between
    ordinary keys, folds into one entry with the exact sum."""
    rng = np.random.default_rng(7)
    m = n = 200
    nreal = 70000
    keys = np.sort(rng.integers(0, m * (n + 1), nreal))
    keys = keys[(keys % (n + 1)) != n].astype(np.int32)  # col < n
    keys[20000:52000] = keys[20000]
    keys = np.sort(keys)
    vals = rng.random(len(keys)).astype(np.float32)
    cap = 3 * 32768
    K = np.full(cap, (m + 1) * (n + 1) - 1, np.int32)
    V = np.zeros(cap, np.float32)
    K[: len(keys)] = keys
    V[: len(keys)] = vals
    perm = rng.permutation(len(keys))  # the sort must restore the runs
    K[: len(keys)], V[: len(keys)] = K[perm], V[perm]
    c = sort_compress_packed(jnp.asarray(K), jnp.asarray(V),
                             jnp.asarray(len(keys)), (m, n),
                             out_capacity=1 << 15)
    uk, inv = np.unique(keys, return_inverse=True)
    ref = np.zeros(len(uk), np.float64)
    np.add.at(ref, inv, vals.astype(np.float64))
    nnz = int(c.nnz)
    assert nnz == len(uk)
    np.testing.assert_array_equal(np.asarray(c.row)[:nnz], uk // (n + 1))
    np.testing.assert_array_equal(np.asarray(c.col)[:nnz], uk % (n + 1))
    np.testing.assert_allclose(np.asarray(c.val)[:nnz], ref, rtol=1e-5)


def test_rowchunked_matches_dense():
    m, k, n = 200, 160, 120
    ad = _rand(m, k, 0.05, 11)
    bd = _rand(k, n, 0.05, 12)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    slab_cap, slab_rows = _slab_bounds_host(a, b, 4)
    c = spgemm_rowchunked(a, b, PLUS_TIMES, num_slabs=4, slab_rows=slab_rows,
                          flops_cap=slab_cap, out_capacity=1 << 14)
    np.testing.assert_allclose(np.asarray(c.to_dense()), ad @ bd,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("density", [0.02, 0.15])
def test_expansion_stream_matches_dense(density):
    """The expansion into a stream of ``stream_capacity(flops)`` slots holds
    every product exactly once, in A-entry order (rows non-decreasing)."""
    m, k, n = 96, 80, 64
    ad = _rand(m, k, density, 21)
    bd = _rand(k, n, density, 22)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    flops = int(spgemm_flops(a, b))
    scap = stream_capacity(flops)
    b_rp = b.row_ptr()
    i, j, v, total = expand_products(
        a.row, a.col, a.val, a.mask(), b.col, b.val, b_rp[:-1], b_rp[1:],
        PLUS_TIMES, scap, (m, n))
    assert int(total) == flops
    assert np.all(np.diff(np.asarray(i)[:flops]) >= 0)
    c = sort_compress(i, j, v, total, (m, n), out_capacity=scap)
    np.testing.assert_allclose(
        np.asarray(c.to_dense()), ad @ bd, rtol=1e-5, atol=1e-5
    )
