"""Local SpMV / SpMSpV / SpMM vs dense references."""

import numpy as np
import jax.numpy as jnp
import pytest

from combblas_tpu import SpCOO, PLUS_TIMES, MIN_PLUS, MAX_SECOND
from combblas_tpu.ops.spmv import spmv, spmv_transpose, spmsv_masked, spmm
from tests.test_coo import rand_sparse


def test_spmv_plus_times():
    d = rand_sparse(12, 9, 0.4, seed=20)
    x = np.random.default_rng(21).random(9).astype(np.float32)
    y = spmv(SpCOO.from_dense(d), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), d @ x, rtol=1e-5)


def test_spmv_transpose():
    d = rand_sparse(12, 9, 0.4, seed=22)
    x = np.random.default_rng(23).random(12).astype(np.float32)
    y = spmv_transpose(SpCOO.from_dense(d), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), d.T @ x, rtol=1e-5)


def test_spmv_min_plus():
    d = rand_sparse(8, 8, 0.5, seed=24)
    x = np.random.default_rng(25).random(8).astype(np.float32)
    y = np.asarray(spmv(SpCOO.from_dense(d), jnp.asarray(x), MIN_PLUS))
    expect = np.full(8, np.inf, np.float32)
    for i in range(8):
        for k in range(8):
            if d[i, k] != 0:
                expect[i] = min(expect[i], d[i, k] + x[k])
    np.testing.assert_allclose(y, expect, rtol=1e-5)


def test_spmsv_masked_frontier():
    """BFS-style: y = A^T x over (max, select2nd) with a sparse frontier —
    the SpMXSpV pattern (SpImpl.cpp:345)."""
    d = (rand_sparse(10, 10, 0.3, seed=26) != 0).astype(np.float32)
    x_val = np.arange(1, 11, dtype=np.float32)
    x_mask = np.zeros(10, bool)
    x_mask[[2, 5]] = True
    y, ym = spmsv_masked(
        SpCOO.from_dense(d), jnp.asarray(x_val), jnp.asarray(x_mask),
        MAX_SECOND, transpose=True,
    )
    y, ym = np.asarray(y), np.asarray(ym)
    for j in range(10):
        srcs = [i for i in (2, 5) if d[i, j] != 0]
        if srcs:
            assert ym[j]
            assert y[j] == max(x_val[i] for i in srcs)
        else:
            assert not ym[j]


def _spmm_case(name):
    rng = np.random.default_rng(1)
    if name in ("small", "small_b"):
        seed = 27 if name == "small" else 120
        return rand_sparse(16, 12, 0.4, seed=seed), rng.random((12, 8))
    if name == "empty":
        return np.zeros((6, 5)), np.ones((5, 4))
    m = 300 if name == "hub_row" else 301
    n, d = 257, (128 if name == "hub_row" else 8)
    ad = (rng.random((m, n)) < 0.05) * rng.random((m, n))
    ad[7] = (rng.random(n) < 0.6) * 1.0  # heavy row
    ad[8] = 0                            # empty row
    return ad, rng.random((n, d))


@pytest.mark.parametrize(
    "name", ["small", "small_b", "empty", "hub_row", "narrow_d"])
def test_spmm_vs_dense(name):
    ad, x = _spmm_case(name)
    ad = ad.astype(np.float32)
    x = x.astype(np.float32)
    a = SpCOO.from_dense(ad) if ad.any() else SpCOO.empty(ad.shape)
    y = spmm(a, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), ad @ x, rtol=1e-4, atol=1e-5)
