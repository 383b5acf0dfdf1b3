"""Two-key (row and column as separate int32 keys) ESC pipeline — the path
the streamed SpGEMM's flat slabs take, with no packed-key range limit
(square R-MAT A² overflows an int32 packed key at scale >= 16; the reference
runs these shapes with IT=int64_t, ``mtSpGEMM.h:214``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from combblas_tpu.ops.coo import SpCOO, compress_sorted
from combblas_tpu.ops.spgemm import (
    _slab_bounds_host,
    expand_products,
    spgemm_flops,
    spgemm_rowchunked,
    stream_capacity,
)
from combblas_tpu.ops.spgemm_seg import spgemm_streamed_seg2
from combblas_tpu.semiring import MIN_PLUS, PLUS_TIMES
from tests.test_spgemm import dense_semiring_matmul


def _rand(m, k, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((m, k)) < density) * rng.random((m, k))
    return d.astype(np.float32)


def _wide(a, b, sr=PLUS_TIMES):
    """expand -> two-key sort -> compress, as the flat slab step runs it."""
    m, n = a.shape[0], b.shape[1]
    scap = stream_capacity(int(spgemm_flops(a, b)))
    b_rp = b.row_ptr()
    i, j, v, total = expand_products(
        a.row, a.col, a.val, a.mask(), b.col, b.val, b_rp[:-1], b_rp[1:],
        sr, scap, (m, n))
    i, j, v = jax.lax.sort((i, j, v), num_keys=2)
    return compress_sorted(i, j, v, total, (m, n), sr=sr, out_capacity=scap)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("density", [0.03, 0.15])
def test_wide_matches_dense(seed, density):
    m, k, n = 96, 80, 64
    ad = _rand(m, k, density, seed)
    bd = _rand(k, n, density, seed + 10)
    c = _wide(SpCOO.from_dense(ad), SpCOO.from_dense(bd))
    np.testing.assert_allclose(
        np.asarray(c.to_dense()), ad @ bd, rtol=1e-5, atol=1e-5
    )


def test_wide_minplus_semiring():
    m = k = n = 48
    ad = _rand(m, k, 0.1, 3)
    bd = _rand(k, n, 0.1, 4)
    c = _wide(SpCOO.from_dense(ad), SpCOO.from_dense(bd), MIN_PLUS)
    np.testing.assert_allclose(
        np.asarray(c.to_dense()), dense_semiring_matmul(ad, bd, "min_plus"),
        rtol=1e-6)


def test_wide_rowchunked_matches_dense():
    m = k = n = 120
    ad = _rand(m, k, 0.08, 7)
    bd = _rand(k, n, 0.08, 8)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    slab_cap, slab_rows = _slab_bounds_host(a, b, 4)
    c = spgemm_rowchunked(a, b, PLUS_TIMES, num_slabs=4, slab_rows=slab_rows,
                          flops_cap=slab_cap, out_capacity=1 << 14)
    np.testing.assert_allclose(
        np.asarray(c.to_dense()), ad @ bd, rtol=1e-5, atol=1e-5
    )


def test_wide_streamed_digest_matches():
    """The non-materializing digest equals the materialized product's
    (nnz, value-sum)."""
    m = k = n = 100
    ad = _rand(m, k, 0.1, 11)
    bd = _rand(k, n, 0.1, 12)
    total, checksum, truncated = spgemm_streamed_seg2(
        SpCOO.from_dense(ad), SpCOO.from_dense(bd), PLUS_TIMES,
        flops_cap=1 << 12, pad_cap=1 << 15)
    cd = ad @ bd
    assert not bool(truncated)
    assert int(total) == int((cd != 0).sum())
    np.testing.assert_allclose(float(checksum), float(cd.sum()), rtol=1e-4)


def test_wide_compress_long_run():
    """A pair-key run tens of thousands of elements long, then a run of
    distinct pairs, then sentinel padding, folds exactly."""
    n = 2 * 32768
    m_sent = n_sent = 1 << 20
    hi = np.full((n,), m_sent, np.int32)
    lo = np.full((n,), n_sent, np.int32)
    val = np.zeros((n,), np.float32)
    run = 32768 + 100
    hi[:run], lo[:run], val[:run] = 5, 7, 1.0
    distinct = 300
    hi[run: run + distinct] = 6
    lo[run: run + distinct] = np.arange(distinct)
    val[run: run + distinct] = 1.0
    c = compress_sorted(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(val),
                        jnp.asarray(run + distinct), (m_sent, n_sent),
                        out_capacity=4096)
    nnz = int(c.nnz)
    assert nnz == 1 + distinct
    oh, ol, ov = (np.asarray(x)[:nnz] for x in (c.row, c.col, c.val))
    assert oh[0] == 5 and ol[0] == 7 and ov[0] == run
    np.testing.assert_array_equal(oh[1:], np.full(distinct, 6))
    np.testing.assert_array_equal(ol[1:], np.arange(distinct))
    np.testing.assert_array_equal(ov[1:], np.ones(distinct))


def test_wide_same_col_adjacent_rows():
    """Adjacent rows ending/starting on the SAME column must not merge —
    the failure mode a column-only key would have."""
    m = k = n = 8
    ad = np.zeros((m, k), np.float32)
    bd = np.zeros((k, n), np.float32)
    ad[0, 1] = 1.0
    ad[1, 2] = 2.0
    bd[1, 7] = 3.0   # row 0 -> (0,7)
    bd[2, 7] = 4.0   # row 1 -> (1,7): same col, adjacent in (row,col) order
    c = _wide(SpCOO.from_dense(ad), SpCOO.from_dense(bd))
    np.testing.assert_allclose(np.asarray(c.to_dense()), ad @ bd)
    assert int(c.nnz) == 2
