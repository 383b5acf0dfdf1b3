"""Distributed dense matrices and sparse×dense products on the mesh.

Counterpart of ``DenseParMat`` (``DenseParMat.h:49-116`` — 2D-grid
distributed dense matrix with ``Reduce`` and sparse accumulation ``+=``) and
of the distributed SpMM path the fork benchmarks (``Applications/SpMMError``
usage context, ``ReleaseTests/Roofline.cpp``).

A distributed dense matrix here is *just* a jax.Array with
``NamedSharding(mesh, P('r','c'))`` on its two leading dims — XLA's native
territory; helpers below only wrap placement, block access and the mixed
sparse/dense ops.  dist_spmm reuses the SpMV fan-out/fan-in skeleton with a
trailing feature dimension, keeping the gather on the interconnect and the merge inside a
reduce-scatter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.parallel.grid import ProcGrid
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = ["dense_put", "dense_to_host", "dist_spmm", "dense_add_sparse",
           "dense_reduce"]

_SPEC = P("r", "c", None)
_NSPEC = P("r", "c")


def dense_put(x: np.ndarray, grid: ProcGrid, gshape=None) -> jax.Array:
    """Place a host (m, n) dense matrix on the grid, padded to block multiples
    (``DenseParMat`` constructor)."""
    m, n = x.shape[:2]
    mb, nb = block_dims((m, n) if gshape is None else gshape, grid)
    pad = np.zeros((grid.pr * mb, grid.pc * nb) + x.shape[2:], x.dtype)
    pad[:m, :n] = x
    return jax.device_put(pad, NamedSharding(grid.mesh, P("r", "c")))


def dense_to_host(x: jax.Array, shape) -> np.ndarray:
    return np.asarray(x)[: shape[0], : shape[1]]


@functools.partial(jax.jit, static_argnames=("sr",))
def dist_spmm(a: DistSpMat, x: jax.Array, sr: Semiring = PLUS_TIMES) -> jax.Array:
    """Y = A ·_sr X with X dense (n_padded, d), rows sharded P(('c','r')).

    Returns Y (m_padded, d) sharded P(('r','c')) — the distributed analogue of
    :func:`combblas_tpu.ops.spmv.spmm`."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pc = grid.pc
    d = x.shape[1]
    need = pc * nb
    kx = min(x.shape[0], need)
    xp = jnp.zeros((need, d), x.dtype).at[:kx].set(x[:kx])

    def f(row, col, val, nnz, x_loc):
        x_blk = jax.lax.all_gather(x_loc, "r", tiled=True)  # (nb, d)
        cap = row.shape[-1]
        r = row.reshape(-1)
        c = col.reshape(-1)
        v = val.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        xg = x_blk[jnp.minimum(c, nb - 1)]
        prod = sr.mul(v[:, None], xg)
        zero = sr.zero(prod.dtype)
        prod = jnp.where(valid[:, None], prod, zero)
        seg = jnp.where(valid, r, mb)
        if sr.add_kind == "sum":
            y = jax.ops.segment_sum(prod, seg, num_segments=mb)
            return jax.lax.psum_scatter(y, "c", scatter_dimension=0, tiled=True)
        if sr.add_kind == "min":
            y = jax.ops.segment_min(prod, seg, num_segments=mb)
            red = jax.lax.pmin(y, "c")
        else:
            y = jax.ops.segment_max(prod, seg, num_segments=mb)
            red = jax.lax.pmax(y, "c")
        idx = jax.lax.axis_index("c")
        chunk = mb // jax.lax.axis_size("c")
        return jax.lax.dynamic_slice_in_dim(red, idx * chunk, chunk, axis=0)

    return shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(("c", "r"), None)),
        out_specs=P(("r", "c"), None),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, xp)


@jax.jit
def dense_add_sparse(x: jax.Array, a: DistSpMat) -> jax.Array:
    """Dense += sparse (``DenseParMat::operator+=(SpParMat)``,
    ``DenseParMat.cpp``): scatter each local block into the dense block."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)

    def f(xb, row, col, val, nnz):
        cap = row.shape[-1]
        r = row.reshape(-1)
        c = col.reshape(-1)
        v = val.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        rr = jnp.where(valid, r, mb)
        cc = jnp.where(valid, c, 0)
        vv = jnp.where(valid, v, 0)
        out = xb.reshape(mb, nb)
        pad = jnp.zeros((mb + 1, nb), out.dtype).at[rr, cc].add(vv)
        return out + pad[:mb]

    return shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(P("r", "c"), _SPEC, _SPEC, _SPEC, _NSPEC),
        out_specs=P("r", "c"),
        check_vma=False,
    )(x, a.row, a.col, a.val, a.nnz)


@functools.partial(jax.jit, static_argnames=("dim",))
def dense_reduce(x: jax.Array, dim: str) -> jax.Array:
    """Row/column sums of a grid-sharded dense matrix (``DenseParMat::Reduce``).
    Plain jnp — XLA inserts the cross-shard reduction."""
    return jnp.sum(x, axis=1 if dim == "row" else 0)
