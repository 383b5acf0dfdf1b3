"""One-sided (Cannon ring, ppermute hops) SUMMA vs the all-gather SUMMA and
dense."""
import jax
import numpy as np
import pytest

from combblas_tpu import SpCOO
from combblas_tpu.parallel.dist import DistSpMat
from combblas_tpu.parallel.grid import ProcGrid
from combblas_tpu.parallel.rma import summa_spgemm_rma
from combblas_tpu.parallel.summa import summa_bounds, summa_spgemm
from combblas_tpu.semiring import MIN_PLUS
from tests.test_coo import rand_sparse


def grid22():
    return ProcGrid.make(2, 2, devices=jax.devices()[:4])


def test_rma_summa_vs_dense():
    g = grid22()
    ad = rand_sparse(30, 26, 0.15, seed=60)
    bd = rand_sparse(26, 34, 0.15, seed=61)
    a = DistSpMat.from_local(SpCOO.from_dense(ad), g)
    b = DistSpMat.from_local(SpCOO.from_dense(bd), g)
    fc, oc = summa_bounds(a, b)
    c = summa_spgemm_rma(a, b, stage_flops_cap=fc, out_capacity=oc)
    np.testing.assert_allclose(c.to_dense(), ad @ bd, rtol=1e-5, atol=1e-6)


def test_rma_summa_matches_allgather_minplus():
    g = grid22()
    ad = rand_sparse(24, 24, 0.2, seed=62)
    bd = rand_sparse(24, 24, 0.2, seed=63)
    a = DistSpMat.from_local(SpCOO.from_dense(ad), g)
    b = DistSpMat.from_local(SpCOO.from_dense(bd), g)
    fc, oc = summa_bounds(a, b)
    c1 = summa_spgemm_rma(a, b, MIN_PLUS, stage_flops_cap=fc,
                          out_capacity=oc)
    c2 = summa_spgemm(a, b, MIN_PLUS, flops_cap=fc, out_capacity=oc)
    np.testing.assert_allclose(c1.to_dense(), c2.to_dense(), rtol=1e-6)
