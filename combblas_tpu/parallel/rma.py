"""One-sided ring SUMMA — the ``ParFriendsExt`` counterpart.

The reference's one-sided SUMMA variants (``Mult_AnXBn_ActiveTarget``
``ParFriendsExt.h:58``, ``PassiveTarget`` ``:291``) replace the per-stage
MPI_Bcast with MPI_Win RMA so panels move without a collective rendezvous.
The analogue here is Cannon's ring schedule: after an initial skew (device
(i, j) holds A(i, (i+j) mod p) and B((i+j) mod p, j)), every stage
multiplies the resident panels locally and then shifts A one hop along mesh
axis 'c' and B one hop along axis 'r' with ``lax.ppermute`` — point-to-point
transfers to one neighbour, no collective rendezvous in the steady state.

Each stage moves each block exactly one hop, so total traffic is p-1
block-hops per operand (identical to the broadcast variants), with only
neighbour synchronization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from combblas_tpu.ops.coo import compress_sorted
from combblas_tpu.ops.spgemm import expand_products
from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = ["summa_spgemm_rma"]

_SPEC = P("r", "c", None)
_NSPEC = P("r", "c")


def _shift_block(row, col, val, nnz, axis: str):
    """Ring-shift one sparse block (capacity-padded triples + nnz scalar)
    one hop along ``axis``, wrapping."""
    size = jax.lax.axis_size(axis)
    perm = [(s, (s + 1) % size) for s in range(size)]

    def sh(x):
        return jax.lax.ppermute(x, axis, perm)

    return sh(row), sh(col), sh(val), sh(nnz)


def _rma_local(
    ar, ac, av, an, br, bc, bv, bn,
    *, sr, stage_flops_cap, out_capacity, mb, nb, kb_a, kb_b, stages,
):
    ar_, ac_, av_ = ar.reshape(-1), ac.reshape(-1), av.reshape(-1)
    br_, bc_, bv_ = br.reshape(-1), bc.reshape(-1), bv.reshape(-1)
    an_, bn_ = an.reshape(()), bn.reshape(())
    cap_a = ar_.shape[0]

    acc_row = jnp.full((out_capacity,), mb, jnp.int32)
    acc_col = jnp.full((out_capacity,), nb, jnp.int32)
    acc_val = jnp.zeros((out_capacity,), av_.dtype)
    acc_nnz = jnp.asarray(0, jnp.int32)

    pa = (ar_, ac_, av_, an_)
    pb = (br_, bc_, bv_, bn_)

    # Python stage loop: stage count == mesh axis size (static).
    for s in range(stages):
        par, pac, pav, pan = pa
        pbr, pbc, pbv, pbn = pb
        rp = jnp.searchsorted(
            pbr, jnp.arange(kb_b + 1, dtype=jnp.int32)).astype(jnp.int32)
        rp = jnp.minimum(rp, pbn)
        a_valid = jnp.arange(cap_a, dtype=jnp.int32) < pan
        i, j, v, total = expand_products(
            par, pac, pav, a_valid, pbc, pbv, rp[:-1], rp[1:],
            sr, stage_flops_cap, (mb, nb),
        )
        mrow = jnp.concatenate([acc_row, i])
        mcol = jnp.concatenate([acc_col, j])
        mval = jnp.concatenate([acc_val, v])
        mrow, mcol, mval = jax.lax.sort((mrow, mcol, mval), num_keys=2)
        merged = compress_sorted(
            mrow, mcol, mval, acc_nnz + total, (mb, nb), sr=sr,
            out_capacity=out_capacity,
        )
        acc_row, acc_col, acc_val, acc_nnz = (
            merged.row, merged.col, merged.val, merged.nnz)
        if s + 1 < stages:
            pa = _shift_block(par, pac, pav, pan, "c")
            pb = _shift_block(pbr, pbc, pbv, pbn, "r")

    return (
        acc_row.reshape(1, 1, -1),
        acc_col.reshape(1, 1, -1),
        acc_val.reshape(1, 1, -1),
        acc_nnz.reshape(1, 1),
    )


def _skew(x, grid, axis_of_shift: str):
    """Initial Cannon skew on the block grid: along 'c', device (i, j) takes
    the block from (i, (i+j) mod p); along 'r', from ((i+j) mod p, j).
    Expressed as a gather on the sharded global array (one-time relayout —
    XLA inserts the collective)."""
    p = grid.pr
    ii = jnp.arange(p, dtype=jnp.int32)[:, None]
    jj = jnp.arange(p, dtype=jnp.int32)[None, :]
    if axis_of_shift == "c":
        src = (ii + jj) % p
        return x[ii, src]
    src = (ii + jj) % p
    return x[src, jj]


@functools.partial(
    jax.jit,
    static_argnames=("sr", "stage_flops_cap", "out_capacity"),
)
def summa_spgemm_rma(
    a: DistSpMat,
    b: DistSpMat,
    sr: Semiring = PLUS_TIMES,
    *,
    stage_flops_cap: int,
    out_capacity: int,
) -> DistSpMat:
    """Cannon-schedule one-sided SUMMA (``ParFriendsExt.h:58,291`` parity).

    Per-stage panel movement is a single-hop ``ppermute`` to the mesh
    neighbour instead of a broadcast."""
    assert a.grid == b.grid and a.gshape[1] == b.gshape[0]
    grid = a.grid
    assert grid.pr == grid.pc, "ring SUMMA needs a square grid"
    mb, kb_a = block_dims(a.gshape, grid)
    kb_b, nb = block_dims(b.gshape, grid)
    ar = _skew(a.row, grid, "c")
    ac = _skew(a.col, grid, "c")
    av = _skew(a.val, grid, "c")
    an = _skew(a.nnz, grid, "c")
    br = _skew(b.row, grid, "r")
    bc = _skew(b.col, grid, "r")
    bv = _skew(b.val, grid, "r")
    bn = _skew(b.nnz, grid, "r")
    fn = functools.partial(
        _rma_local,
        sr=sr, stage_flops_cap=stage_flops_cap, out_capacity=out_capacity,
        mb=mb, nb=nb, kb_a=kb_a, kb_b=kb_b, stages=grid.pc,
    )
    crow, ccol, cval, cnnz = shard_map(
        fn,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC) * 2,
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(ar, ac, av, an, br, bc, bv, bn)
    return DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                     gshape=(a.gshape[0], b.gshape[1]), grid=grid)
