"""Row/column reductions and related per-dimension statistics.

Counterpart of ``SpParMat::Reduce`` (``SpParMat.cpp:888-961``):
one unsorted segment reduction over the COO stream, no column walks.  Also
hosts ``nnz_per`` (per-row/col nonzero counts, the reference's
``Reduce(..., plus, 0, [](x){return 1;})`` idiom) and ``load_imbalance``
(``SpParMat.cpp:762``) for the local block case.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = ["reduce_dim", "nnz_per"]


@functools.partial(jax.jit, static_argnames=("dim", "sr", "premap"))
def reduce_dim(
    a: SpCOO,
    dim: str,
    sr: Semiring = PLUS_TIMES,
    premap: Callable | None = None,
) -> jax.Array:
    """Reduce along one dimension: dim='row' -> length-m vector of row
    reductions; dim='col' -> length-n vector of column reductions.

    ``premap`` optionally transforms each stored value before reduction
    (the reference's unary-op argument to Reduce).  Empty rows/cols get
    sr.zero (identity).
    """
    m, n = a.shape
    valid = a.mask()
    vals = premap(a.val) if premap is not None else a.val
    zero = sr.zero(vals.dtype)
    vals = jnp.where(valid, vals, zero)
    if dim == "row":
        seg, length = jnp.where(valid, a.row, m), m
    elif dim == "col":
        seg, length = jnp.where(valid, a.col, n), n
    else:
        raise ValueError(dim)
    if sr.add_kind == "sum":
        return jax.ops.segment_sum(vals, seg, num_segments=length)
    if sr.add_kind == "min":
        return jax.ops.segment_min(vals, seg, num_segments=length)
    return jax.ops.segment_max(vals, seg, num_segments=length)


@functools.partial(jax.jit, static_argnames=("dim",))
def nnz_per(a: SpCOO, dim: str) -> jax.Array:
    """Number of stored entries per row or column (int32 vector)."""
    m, n = a.shape
    valid = a.mask()
    if dim == "row":
        seg, length = jnp.where(valid, a.row, m), m
    else:
        seg, length = jnp.where(valid, a.col, n), n
    return jax.ops.segment_sum(valid.astype(jnp.int32), seg, num_segments=length)
