"""Distributed SpRef / SpAsgn / matrix permutation on the 2D grid.

Counterparts of:

- ``SpParMat::SubsRef_SR`` (``SpParMat.cpp:2028-2250``) — "indexing *is*
  SpGEMM": boolean extraction matrices P (k1×m) and Q (n×k2) are built and
  C = P·A·Q.  Here the selectors are DistSpMats and the products ride the
  SUMMA path untouched (:func:`dist_spref`).
- ``SpParMat::SpAsgn`` (``SpParMat.cpp:2427``) — clear A's ri×ci block, embed
  B through the transposed selectors, add (:func:`dist_spasgn`).
- ``DistEdgeList::RenameVertices`` / MCL ``RandPermute`` (``MCL.cpp:497``,
  ``DistEdgeList.cpp:364``) — symmetric permutation A(p, p).  The selector
  route works, but a permutation is a bijection, so the fast path
  is ONE owner-exchange of the matrix entries (:func:`dist_permute`) instead
  of two SpGEMMs: relabel every local entry through the (replicated) row/col
  maps, bucket by destination block, one ``all_to_all`` over the whole mesh,
  local sort+compress — the same alltoallv the reference's SparseCommon
  shuffle uses (``SpParMat.cpp:2893``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from combblas_tpu.ops.coo import SpCOO, compress_sorted
from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.parallel.elementwise import dist_add
from combblas_tpu.parallel.summa import summa_spgemm_auto
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = [
    "dist_selector",
    "dist_spref",
    "dist_prune_block",
    "dist_spasgn",
    "dist_permute",
]

_SPEC = P("r", "c", None)
_NSPEC = P("r", "c")


def dist_selector(
    indices, n: int, grid, transpose: bool = False, capacity: int | None = None
) -> DistSpMat:
    """Distributed boolean extraction matrix: (k, n) with S[i, indices[i]] = 1
    (or its (n, k) transpose) — the P/Q builders of ``SpParMat.cpp:2060-2130``
    as one host layout pass + sharded device_put."""
    indices = np.asarray(indices, np.int64)
    k = indices.shape[0]
    rows = np.arange(k, dtype=np.int64)
    if transpose:
        return DistSpMat.from_coo_arrays(
            indices, rows, np.ones(k, np.float32), (n, k), grid,
            capacity=capacity,
        )
    return DistSpMat.from_coo_arrays(
        rows, indices, np.ones(k, np.float32), (k, n), grid, capacity=capacity
    )


def dist_spref(a: DistSpMat, ri, ci, sr: Semiring = PLUS_TIMES) -> DistSpMat:
    """A(ri, ci) = P·A·Q on the grid (``SpParMat.cpp:2028`` SubsRef_SR).
    Index vectors may repeat (matlab SpRef semantics)."""
    m, n = a.gshape
    p = dist_selector(ri, m, a.grid)
    q = dist_selector(ci, n, a.grid, transpose=True)
    pa = summa_spgemm_auto(p, a, sr)
    return summa_spgemm_auto(pa, q, sr)


def _space_masks(a: DistSpMat, ri, ci):
    """Replicated row/col-space membership masks (padded block lengths)."""
    mb, nb = block_dims(a.gshape, a.grid)
    rm = np.zeros(a.grid.pr * mb, bool)
    cm = np.zeros(a.grid.pc * nb, bool)
    rm[np.asarray(ri, np.int64)] = True
    cm[np.asarray(ci, np.int64)] = True
    return jnp.asarray(rm), jnp.asarray(cm)


@functools.partial(jax.jit, static_argnames=())
def _prune_block_jit(a: DistSpMat, rmask: jax.Array, cmask: jax.Array) -> DistSpMat:
    from combblas_tpu.ops.ewise import _compact

    mb, nb = block_dims(a.gshape, a.grid)

    def f(row, col, val, nnz, rm, cm):
        bi = jax.lax.axis_index("r").astype(jnp.int32)
        bj = jax.lax.axis_index("c").astype(jnp.int32)
        r = row.reshape(-1)
        c = col.reshape(-1)
        blk = SpCOO(row=r, col=c, val=val.reshape(-1), nnz=nnz.reshape(()),
                    shape=(mb, nb))
        gi = jnp.minimum(bi * mb + r, rm.shape[0] - 1)
        gj = jnp.minimum(bj * nb + c, cm.shape[0] - 1)
        hit = rm[gi] & cm[gj] & blk.mask()
        out = _compact(blk, ~hit, blk.capacity)
        return (out.row.reshape(1, 1, -1), out.col.reshape(1, 1, -1),
                out.val.reshape(1, 1, -1), out.nnz.reshape(1, 1))

    crow, ccol, cval, cnnz = shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(), P()),
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, rmask, cmask)
    return DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                     gshape=a.gshape, grid=a.grid)


def dist_prune_block(a: DistSpMat, ri, ci) -> DistSpMat:
    """Remove all entries in rows ri × cols ci (``SpParMat::Prune(ri,ci)``) —
    blockwise membership masks, no communication."""
    rmask, cmask = _space_masks(a, ri, ci)
    return _prune_block_jit(a, rmask, cmask)


def dist_spasgn(
    a: DistSpMat, ri, ci, b: DistSpMat, sr: Semiring = PLUS_TIMES
) -> DistSpMat:
    """A(ri, ci) = B (``SpParMat::SpAsgn``, ``SpParMat.cpp:2427``): prune the
    ri×ci block, embed B = Pᵀ·B·Qᵀ through transposed selectors (two SUMMA
    products, the reference's own formulation), then add."""
    m, n = a.gshape
    kb_r, kb_c = b.gshape
    assert len(np.asarray(ri)) == kb_r and len(np.asarray(ci)) == kb_c, (
        "DIMMISMATCH: SpAsgn index/operand size")
    cleared = dist_prune_block(a, ri, ci)
    pt = dist_selector(ri, m, a.grid, transpose=True)   # (m, k1)
    qt = dist_selector(ci, n, a.grid)                   # (k2, n)
    ptb = summa_spgemm_auto(pt, b, sr)
    emb = summa_spgemm_auto(ptb, qt, sr)
    return dist_add(cleared, emb,
                    out_capacity=cleared.capacity + emb.capacity)


@functools.partial(jax.jit, static_argnames=("sr", "out_capacity"))
def _permute_jit(
    a: DistSpMat,
    rmap: jax.Array,
    cmap: jax.Array,
    sr: Semiring,
    out_capacity: int,
) -> Tuple[DistSpMat, jax.Array]:
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pr, pc = grid.pr, grid.pc
    p = pr * pc
    cap = a.capacity
    m_pad, n_pad = pr * mb, pc * nb

    def f(row, col, val, nnz, rm, cm):
        bi = jax.lax.axis_index("r").astype(jnp.int32)
        bj = jax.lax.axis_index("c").astype(jnp.int32)
        me = bi * pc + bj
        r = row.reshape(-1)
        c = col.reshape(-1)
        v = val.reshape(-1)
        nz = nnz.reshape(())
        t = jnp.arange(cap, dtype=jnp.int32)
        valid = t < nz
        gi = jnp.minimum(bi * mb + r, m_pad - 1)
        gj = jnp.minimum(bj * nb + c, n_pad - 1)
        ni = rm[gi]
        nj = cm[gj]
        valid = valid & (ni >= 0) & (ni < m_pad) & (nj >= 0) & (nj < n_pad)
        ni = jnp.minimum(jnp.maximum(ni, 0), m_pad - 1)
        nj = jnp.minimum(jnp.maximum(nj, 0), n_pad - 1)
        dest = jnp.where(valid, (ni // mb) * pc + (nj // nb), p)
        # group by destination (stable sort), contiguous runs per dest
        d_s, ni_s, nj_s, v_s = jax.lax.sort((dest, ni, nj, v), num_keys=3)
        ids = jnp.arange(p, dtype=jnp.int32)
        starts = jnp.searchsorted(d_s, ids, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(d_s, ids, side="right").astype(jnp.int32)
        lens = ends - starts
        tt = jnp.arange(cap, dtype=jnp.int32)
        src_pos = jnp.minimum(starts[:, None] + tt[None, :], cap - 1)
        ok = tt[None, :] < lens[:, None]

        def xchg(arr, fill):
            buf = jnp.where(ok, arr[src_pos], fill)
            return jax.lax.all_to_all(buf, ("r", "c"), 0, 0)

        ri_r = xchg(ni_s, jnp.int32(-1)).reshape(-1)
        rj_r = xchg(nj_s, jnp.int32(-1)).reshape(-1)
        rv_r = xchg(v_s, jnp.zeros((), v_s.dtype)).reshape(-1)
        live = ri_r >= 0
        lr = jnp.where(live, ri_r - bi * mb, mb)
        lc = jnp.where(live, rj_r - bj * nb, nb)
        lv = jnp.where(live, rv_r, 0)
        lr, lc, lv = jax.lax.sort((lr, lc, lv), num_keys=2)
        nvalid = jnp.sum(live.astype(jnp.int32))
        out = compress_sorted(lr, lc, lv, nvalid, (mb, nb), sr=sr,
                              out_capacity=out_capacity)
        trunc = nvalid > out_capacity
        return (out.row.reshape(1, 1, -1), out.col.reshape(1, 1, -1),
                out.val.reshape(1, 1, -1), out.nnz.reshape(1, 1),
                trunc.reshape(1, 1))

    crow, ccol, cval, cnnz, trunc = shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(), P()),
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, rmap, cmap)
    return (
        DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                  gshape=a.gshape, grid=grid),
        jnp.any(trunc),
    )


def dist_permute(
    a: DistSpMat,
    row_map,
    col_map=None,
    sr: Semiring = PLUS_TIMES,
    out_capacity: int | None = None,
) -> DistSpMat:
    """A'(row_map[i], col_map[j]) = A(i, j): relabel + one owner all_to_all.

    The ``RandPermute``/``RenameVertices`` (``MCL.cpp:497``,
    ``DistEdgeList.cpp:364``): for bijective maps this moves each entry
    exactly once instead of forming two selector products.  ``row_map`` /
    ``col_map``: row/col-space maps, canonical padded length (device array or
    host); entries mapping to >= padded length are dropped; ``col_map``
    defaults to ``row_map`` (symmetric permutation) when shapes match.
    Retries with doubled block capacity if any destination block overflows.
    """
    mb, nb = block_dims(a.gshape, a.grid)
    m_pad, n_pad = a.grid.pr * mb, a.grid.pc * nb
    rm = jnp.asarray(np.asarray(row_map), jnp.int32)
    rm = jnp.concatenate(
        [rm, jnp.full((max(m_pad - rm.shape[0], 0),), m_pad, jnp.int32)]
    )[:m_pad]
    if col_map is None:
        assert a.gshape[0] == a.gshape[1] and m_pad == n_pad
        cm = rm
    else:
        cm = jnp.asarray(np.asarray(col_map), jnp.int32)
        cm = jnp.concatenate(
            [cm, jnp.full((max(n_pad - cm.shape[0], 0),), n_pad, jnp.int32)]
        )[:n_pad]
    cap = a.capacity if out_capacity is None else out_capacity
    while True:
        out, trunc = _permute_jit(a, rm, cm, sr, cap)
        if not bool(trunc):
            return out
        cap *= 2
