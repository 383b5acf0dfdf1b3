"""Staged SUMMA and phased memory-constrained SpGEMM vs the all-gather path —
the reference's cross-variant equivalence pattern (MultTest/MultTiming)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from combblas_tpu import SpCOO
from combblas_tpu.parallel.grid import ProcGrid
from combblas_tpu.parallel.dist import DistSpMat
from combblas_tpu.parallel.summa import summa_bounds, summa_spgemm
from combblas_tpu.parallel.memefficient import (
    calculate_phases,
    mem_efficient_spgemm,
    summa_spgemm_staged,
)
from tests.test_coo import rand_sparse


def grid22():
    return ProcGrid.make(2, 2, devices=jax.devices()[:4])


def test_staged_matches_allgather():
    da = rand_sparse(20, 16, 0.3, seed=100)
    db = rand_sparse(16, 18, 0.3, seed=101)
    g = grid22()
    A = DistSpMat.from_local(SpCOO.from_dense(da), g)
    B = DistSpMat.from_local(SpCOO.from_dense(db), g)
    fc, oc = summa_bounds(A, B)
    C1 = summa_spgemm(A, B, flops_cap=fc, out_capacity=oc)
    C2 = summa_spgemm_staged(A, B, stage_flops_cap=fc, out_capacity=oc)
    assert int(C1.total_nnz()) == int(C2.total_nnz())
    np.testing.assert_allclose(C2.to_dense(), C1.to_dense(), rtol=1e-5)
    np.testing.assert_allclose(C2.to_dense(), da @ db, rtol=1e-4, atol=1e-6)


def test_mem_efficient_phases():
    da = rand_sparse(16, 16, 0.35, seed=102)
    g = grid22()
    A = DistSpMat.from_local(SpCOO.from_dense(da), g)
    for phases in (1, 2, 4):
        C = mem_efficient_spgemm(A, A, phases=phases)
        np.testing.assert_allclose(C.to_dense(), da @ da, rtol=1e-4, atol=1e-6)


def test_mem_efficient_with_prune_hook():
    from combblas_tpu.parallel.elementwise import dist_prune

    da = rand_sparse(16, 16, 0.4, seed=103)
    g = grid22()
    A = DistSpMat.from_local(SpCOO.from_dense(da), g)

    def hook(c):
        return dist_prune(c, lambda v: v < 0.2)

    C = mem_efficient_spgemm(A, A, phases=2, phase_hook=hook)
    expect = da @ da
    expect = np.where(expect >= 0.2, expect, 0.0)
    np.testing.assert_allclose(C.to_dense(), expect, rtol=1e-4, atol=1e-6)


def test_calculate_phases_monotone():
    da = rand_sparse(16, 16, 0.4, seed=104)
    g = grid22()
    A = DistSpMat.from_local(SpCOO.from_dense(da), g)
    big = calculate_phases(A, A, per_device_mem_bytes=1e12)
    small = calculate_phases(A, A, per_device_mem_bytes=1e3)
    assert big == 1 and small > 1


def test_binary_roundtrip(tmp_path):
    from combblas_tpu.io.binary import (
        read_binary,
        read_vec_binary,
        write_binary,
        write_vec_binary,
    )
    from combblas_tpu.ops.spvec import SpVec

    d = rand_sparse(11, 7, 0.4, seed=105)
    a = SpCOO.from_dense(d)
    p = str(tmp_path / "m.bin")
    write_binary(p, a)
    b = read_binary(p)
    np.testing.assert_allclose(np.asarray(b.to_dense()), d, rtol=1e-6)
    v = SpVec.from_arrays([1, 5, 9], [2.0, 3.0, 4.0], 12)
    pv = str(tmp_path / "v.bin")
    write_vec_binary(pv, v)
    w = read_vec_binary(pv)
    np.testing.assert_allclose(np.asarray(w.to_dense()), np.asarray(v.to_dense()))


def test_col_slab_physically_shrinks():
    """ColSplit parity (`ParFriends.h:553`): each phase's B slab buffer is
    ~capacity/phases, so phasing cuts panel-gather bytes, not just the
    expansion buffer."""
    from combblas_tpu.parallel.memefficient import _col_slab, _col_slab_counts

    db = rand_sparse(16, 16, 0.5, seed=104)
    g = grid22()
    B = DistSpMat.from_local(SpCOO.from_dense(db), g)
    bounds = jnp.asarray([0, 3, 6, 8], jnp.int32)
    counts = np.asarray(_col_slab_counts(B, bounds))
    assert counts.sum() == int(B.total_nnz())
    for p in range(3):
        cap = max(int(counts[p].max()), 8)
        bp = _col_slab(B, int(bounds[p]), int(bounds[p + 1]), cap)
        assert bp.capacity == cap < B.capacity
        assert int(bp.total_nnz()) == int(counts[p].sum())


def test_block_spgemm_iterator():
    """BlockSpGEMM parity (BlockSpGEMM.h:16): the br x bc C blocks sum to
    the full product, and only one block is resident per step."""
    from combblas_tpu.parallel.memefficient import block_spgemm

    da = rand_sparse(16, 16, 0.3, seed=201)
    db = rand_sparse(16, 16, 0.3, seed=202)
    g = grid22()
    A = DistSpMat.from_local(SpCOO.from_dense(da), g)
    B = DistSpMat.from_local(SpCOO.from_dense(db), g)
    acc = np.zeros((16, 16), np.float32)
    seen = []
    for (i, j), cij in block_spgemm(A, B, 2, 2):
        seen.append((i, j))
        acc += np.asarray(cij.to_dense())
    assert seen == [(0, 0), (0, 1), (1, 0), (1, 1)]
    np.testing.assert_allclose(acc, da @ db, rtol=1e-5, atol=1e-6)


def test_phases_from_estimator_match_exact():
    """Cohen-estimator phase sizing stays within 2x of exact-output
    sizing (the estimator is on the hot path; ``ParFriends.h:733,2810``)."""
    import jax
    import numpy as np
    from combblas_tpu.ops.coo import SpCOO
    from combblas_tpu.parallel.dist import DistSpMat
    from combblas_tpu.parallel.grid import ProcGrid
    from combblas_tpu.parallel.spmv import est_nnz_spgemm_sampling

    rng = np.random.default_rng(0)
    n = 64
    ad = (rng.random((n, n)) < 0.12).astype(np.float32)
    grid = ProcGrid.make(2, 2, devices=jax.devices()[:4])
    a = DistSpMat.from_local(SpCOO.from_dense(ad), grid)
    exact_nnz = int((((ad @ ad) != 0)).sum())
    est = est_nnz_spgemm_sampling(a, a, jax.random.PRNGKey(1), rounds=32)
    assert 0.5 * exact_nnz <= est <= 2.0 * exact_nnz
    mem = 64_000.0
    p_est = calculate_phases(a, a, mem, est_c_nnz=est)
    p_exact = calculate_phases(a, a, mem, est_c_nnz=float(exact_nnz))
    assert max(p_est, p_exact) <= 2 * min(p_est, p_exact)
