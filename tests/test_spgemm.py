"""Local SpGEMM vs dense references, across semirings and variants.

Mirrors the reference's tier-2 strategy (SURVEY.md §4): cross-check every
execution variant (single-pass vs row-chunked) against a dense ground truth.
"""

import numpy as np
import pytest

from combblas_tpu import SpCOO, PLUS_TIMES, MIN_PLUS, OR_AND, MAX_TIMES
from combblas_tpu.ops.spgemm import (
    spgemm,
    spgemm_auto,
    spgemm_bounds,
    spgemm_flops,
    spgemm_rowchunked,
    _slab_bounds_host,
)
from tests.test_coo import rand_sparse


def dense_semiring_matmul(a, b, sr_name):
    m, k = a.shape
    _, n = b.shape
    if sr_name == "plus_times":
        return a @ b
    out = np.zeros((m, n), a.dtype)
    amask, bmask = a != 0, b != 0
    for i in range(m):
        for j in range(n):
            best = None
            for kk in range(k):
                if amask[i, kk] and bmask[kk, j]:
                    if sr_name == "min_plus":
                        v = a[i, kk] + b[kk, j]
                        best = v if best is None else min(best, v)
                    elif sr_name == "max_times":
                        v = a[i, kk] * b[kk, j]
                        best = v if best is None else max(best, v)
                    elif sr_name == "or_and":
                        best = 1.0
            out[i, j] = 0.0 if best is None else best
    return out


def test_plus_times_vs_dense():
    da = rand_sparse(17, 13, 0.4, seed=10)
    db = rand_sparse(13, 11, 0.4, seed=11)
    a, b = SpCOO.from_dense(da), SpCOO.from_dense(db)
    c = spgemm_auto(a, b)
    np.testing.assert_allclose(np.asarray(c.to_dense()), da @ db, rtol=1e-5, atol=1e-6)
    # output nnz matches the structural product
    assert int(c.nnz) == np.count_nonzero(
        ((da != 0).astype(int) @ (db != 0).astype(int))
    )


@pytest.mark.parametrize("sr,name", [(MIN_PLUS, "min_plus"), (MAX_TIMES, "max_times"),
                                     (OR_AND, "or_and")])
def test_semirings_vs_dense(sr, name):
    da = rand_sparse(9, 8, 0.5, seed=12)
    db = rand_sparse(8, 7, 0.5, seed=13)
    a, b = SpCOO.from_dense(da), SpCOO.from_dense(db)
    c = spgemm_auto(a, b, sr)
    expect = dense_semiring_matmul(da, db, name)
    np.testing.assert_allclose(np.asarray(c.to_dense()), expect, rtol=1e-5, atol=1e-6)


def test_flops_exact():
    da = rand_sparse(10, 10, 0.3, seed=14)
    db = rand_sparse(10, 10, 0.3, seed=15)
    a, b = SpCOO.from_dense(da), SpCOO.from_dense(db)
    # exact flop count: sum over k of nnz(A[:,k]) * nnz(B[k,:])
    expect = int(((da != 0).sum(axis=0) * (db != 0).sum(axis=1)).sum())
    assert int(spgemm_flops(a, b)) == expect


def test_rowchunked_matches_single_pass():
    da = rand_sparse(32, 24, 0.3, seed=16)
    db = rand_sparse(24, 20, 0.3, seed=17)
    a, b = SpCOO.from_dense(da), SpCOO.from_dense(db)
    fc, oc = spgemm_bounds(a, b)
    c1 = spgemm(a, b, flops_cap=fc, out_capacity=oc)
    for num_slabs in (2, 4, 7):
        slab_cap, slab_rows = _slab_bounds_host(a, b, num_slabs)
        c2 = spgemm_rowchunked(
            a, b,
            num_slabs=num_slabs, slab_rows=slab_rows,
            flops_cap=slab_cap, out_capacity=oc,
        )
        assert int(c1.nnz) == int(c2.nnz)
        np.testing.assert_allclose(
            np.asarray(c2.to_dense()), np.asarray(c1.to_dense()), rtol=1e-5
        )


def test_empty_operand():
    a = SpCOO.empty((5, 4))
    db = rand_sparse(4, 6, 0.5, seed=18)
    b = SpCOO.from_dense(db)
    c = spgemm_auto(a, b)
    assert int(c.nnz) == 0
    np.testing.assert_array_equal(np.asarray(c.to_dense()), np.zeros((5, 6)))


def test_sevenvertex_square():
    """Known-answer check on a small Matrix Market graph in the repo
    (tests/data/sevenvertex.mtx), against numpy on the file's triples."""
    import os

    from combblas_tpu.io.mtx import read_mtx

    path = os.path.join(os.path.dirname(__file__), "data", "sevenvertex.mtx")
    t = np.loadtxt(path, comments="%", skiprows=3)
    d = np.zeros((7, 7))
    d[t[:, 0].astype(int) - 1, t[:, 1].astype(int) - 1] = t[:, 2]
    a = read_mtx(path)
    c = spgemm_auto(a, a)
    np.testing.assert_allclose(np.asarray(c.to_dense()), d @ d, rtol=1e-5, atol=1e-6)
    assert int(c.nnz) == int(((d @ d) != 0).sum())


def test_sort_limit_guard():
    """Library-enforced 2^31 sort bound: a single-sort
    shape past the limit raises the named error at plan/trace time, and
    spgemm_auto auto-slabs instead of ever building such a sort."""
    import pytest as _pytest

    from combblas_tpu.ops.spgemm import (
        SORT_ELEM_LIMIT,
        SpGEMMSortLimitError,
        check_sort_limit,
        spgemm,
        spgemm_auto,
    )

    check_sort_limit(SORT_ELEM_LIMIT)  # at the bound: fine
    with _pytest.raises(SpGEMMSortLimitError):
        check_sort_limit(SORT_ELEM_LIMIT + 1)
    a = SpCOO.from_dense(rand_sparse(32, 32, 0.3, seed=3))
    with _pytest.raises(SpGEMMSortLimitError):
        spgemm(a, a, flops_cap=SORT_ELEM_LIMIT * 2, out_capacity=256)
    # spgemm_auto clamps a would-overflow budget and still computes
    d = np.asarray(a.to_dense())
    c = spgemm_auto(a, a, max_flops_cap=1 << 40)
    np.testing.assert_allclose(np.asarray(c.to_dense()), d @ d, rtol=1e-5,
                               atol=1e-6)


def test_spgemm_auto_plan_reuse():
    """A caller-held plan dict freezes the pipeline across iterated calls
    (the MCL steady state): same-capacity operands with fitting flops reuse
    the exact statics; a collapsed product forces one shrink replan."""
    from combblas_tpu.ops.spgemm import spgemm_auto

    a = SpCOO.from_dense(rand_sparse(48, 48, 0.15, seed=5))
    d = np.asarray(a.to_dense())
    plan: dict = {}
    c1 = spgemm_auto(a, a, plan=plan)
    frozen = dict(plan)
    np.testing.assert_allclose(np.asarray(c1.to_dense()), d @ d, rtol=1e-5,
                               atol=1e-6)
    # same operands: every frozen static must be byte-identical
    c2 = spgemm_auto(a, a, plan=plan)
    assert dict(plan) == frozen
    np.testing.assert_allclose(np.asarray(c2.to_dense()), d @ d, rtol=1e-5,
                               atol=1e-6)
    # slightly sparser same-capacity operand still fits the frozen plan
    d3 = d.copy()
    d3[d3 > 0.8] = 0.0
    a3 = SpCOO.from_dense(d3, capacity=a.capacity)
    c3 = spgemm_auto(a3, a3, plan=plan)
    assert dict(plan) == frozen
    np.testing.assert_allclose(np.asarray(c3.to_dense()), d3 @ d3, rtol=1e-5,
                               atol=1e-6)
