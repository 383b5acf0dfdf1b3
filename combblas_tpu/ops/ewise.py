"""Elementwise sparse ops: Apply / Prune / EWiseApply / EWiseMult / DimApply.

Counterparts of the reference's elementwise layer: ``SpParMat::Apply``
/ ``Prune`` / ``PruneI`` / ``PruneColumn`` (``SpParMat.cpp:2567``), ``DimApply``
(``SpParMat.cpp:801``), ``EWiseMult`` / ``SetDifference``
(``SpParMat.cpp:2781-2817``) and the generalized ``EWiseApply``
(``ParFriends.h:2230``).  Binary ops between two sparse matrices use one
tagged merge-sort over the concatenated triple streams; union / intersection /
difference semantics all fall out of per-segment presence flags — no hash
probes, no per-row scalar walks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp

from combblas_tpu.ops.coo import SpCOO

__all__ = [
    "apply_values",
    "prune",
    "dim_apply",
    "prune_column",
    "ewise_apply",
    "ewise_mult",
    "set_difference",
]


def apply_values(a: SpCOO, fn: Callable) -> SpCOO:
    """New matrix with fn applied to every stored value (``SpParMat::Apply``)."""
    val = jnp.where(a.mask(), fn(a.val), 0)
    return dataclasses.replace(a, val=val.astype(val.dtype))


def _compact(a: SpCOO, keep: jax.Array, out_capacity: int | None = None) -> SpCOO:
    """Drop entries where ``keep`` is False, preserving sorted order."""
    m, n = a.shape
    out_cap = a.capacity if out_capacity is None else out_capacity
    keep = keep & a.mask()
    dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
    nnz = jnp.maximum(dest[-1] + 1, 0) if a.capacity else jnp.asarray(0, jnp.int32)
    dest = jnp.where(keep, dest, out_cap)
    row = jnp.full((out_cap,), m, jnp.int32).at[dest].set(a.row, mode="drop")
    col = jnp.full((out_cap,), n, jnp.int32).at[dest].set(a.col, mode="drop")
    val = jnp.zeros((out_cap,), a.val.dtype).at[dest].set(a.val, mode="drop")
    return SpCOO(row=row, col=col, val=val, nnz=nnz.astype(jnp.int32), shape=a.shape)


def prune(a: SpCOO, pred: Callable, out_capacity: int | None = None) -> SpCOO:
    """Remove entries where pred(value) is True (``SpParMat::Prune``)."""
    return _compact(a, ~pred(a.val), out_capacity)


def prune_i(a: SpCOO, pred: Callable, out_capacity: int | None = None) -> SpCOO:
    """Remove entries where pred(row, col, value) is True (``PruneI``)."""
    return _compact(a, ~pred(a.row, a.col, a.val), out_capacity)


def dim_apply(a: SpCOO, x: jax.Array, dim: str, fn: Callable = jnp.multiply) -> SpCOO:
    """Combine each entry with the vector element of its row ('row') or column
    ('col'): A_ij = fn(A_ij, x_i or x_j).  (``SpParMat::DimApply``,
    ``SpParMat.cpp:801``; column scaling is how MCL makes columns stochastic.)
    """
    m, n = a.shape
    if dim == "row":
        g = x[jnp.minimum(a.row, m - 1)]
    elif dim == "col":
        g = x[jnp.minimum(a.col, n - 1)]
    else:
        raise ValueError(dim)
    val = jnp.where(a.mask(), fn(a.val, g), 0)
    return dataclasses.replace(a, val=val)


def prune_column(
    a: SpCOO, x: jax.Array, pred: Callable, out_capacity: int | None = None
) -> SpCOO:
    """Drop entry (i, j) when pred(A_ij, x_j) is True (``PruneColumn``,
    ``SpParMat.cpp:2567`` — used by MCL's threshold prune)."""
    n = a.shape[1]
    g = x[jnp.minimum(a.col, n - 1)]
    return _compact(a, ~pred(a.val, g), out_capacity)


@functools.partial(
    jax.jit,
    static_argnames=("fn", "a_present_only", "b_present_only", "mode", "out_capacity"),
)
def ewise_apply(
    a: SpCOO,
    b: SpCOO,
    fn: Callable,
    *,
    a_default=0.0,
    b_default=0.0,
    mode: str = "union",  # 'union' | 'intersect' | 'a_minus_b'
    out_capacity: int | None = None,
    a_present_only: bool = False,
    b_present_only: bool = False,
) -> SpCOO:
    """Generalized elementwise combine of two same-shape sparse matrices.

    ``mode='intersect'`` keeps entries present in both (EWiseMult),
    ``'a_minus_b'`` keeps entries of A absent from B (SetDifference /
    EWiseMult-exclude), ``'union'`` keeps either, substituting defaults for the
    missing side (EWiseApply with allowANulls/allowBNulls).
    """
    assert a.shape == b.shape, (a.shape, b.shape)
    m, n = a.shape
    cap = a.capacity + b.capacity
    out_cap = out_capacity if out_capacity is not None else cap
    vdt = jnp.result_type(a.val.dtype, b.val.dtype)
    row = jnp.concatenate([a.row, b.row])
    col = jnp.concatenate([a.col, b.col])
    tag = jnp.concatenate(
        [jnp.zeros((a.capacity,), jnp.int32), jnp.ones((b.capacity,), jnp.int32)]
    )
    val = jnp.concatenate([a.val.astype(vdt), b.val.astype(vdt)])
    row, col, tag, val = jax.lax.sort((row, col, tag, val), num_keys=3)
    nvalid = a.nnz + b.nnz
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < nvalid  # sentinels (row==m) sort last, so valid is a prefix
    nxt = jnp.minimum(idx + 1, cap - 1)
    same_next = (row == row[nxt]) & (col == col[nxt]) & (idx + 1 < nvalid)
    prv = jnp.maximum(idx - 1, 0)
    same_prev = (row == row[prv]) & (col == col[prv]) & (idx > 0)
    seg_start = valid & ~same_prev
    # At a segment start: tag==0 means the A entry leads; if a pair follows it
    # is the B entry (invariant: each matrix has unique keys).
    a_here = tag == 0
    b_next = same_next & (tag[nxt] == 1)
    a_val = jnp.where(a_here, val, jnp.asarray(a_default, vdt))
    b_val = jnp.where(
        a_here,
        jnp.where(b_next, val[nxt], jnp.asarray(b_default, vdt)),
        val,
    )
    b_here = (~a_here) | b_next
    if mode == "union":
        keep = seg_start
    elif mode == "intersect":
        keep = seg_start & a_here & b_here
    elif mode == "a_minus_b":
        keep = seg_start & a_here & ~b_here
    else:
        raise ValueError(mode)
    if a_present_only:
        keep = keep & a_here
    if b_present_only:
        keep = keep & b_here
    out_val = fn(a_val, b_val)
    dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
    nnz = jnp.maximum(dest[-1] + 1, 0)
    dest = jnp.where(keep, dest, out_cap)
    orow = jnp.full((out_cap,), m, jnp.int32).at[dest].set(row, mode="drop")
    ocol = jnp.full((out_cap,), n, jnp.int32).at[dest].set(col, mode="drop")
    oval = jnp.zeros((out_cap,), vdt).at[dest].set(out_val.astype(vdt), mode="drop")
    return SpCOO(row=orow, col=ocol, val=oval, nnz=nnz.astype(jnp.int32), shape=a.shape)


def _take_a(x, y):
    return x


def _hadamard(x, y):
    return x * y


def ewise_mult(a: SpCOO, b: SpCOO, exclude: bool = False,
               out_capacity: int | None = None) -> SpCOO:
    """``EWiseMult(A, B, exclude)`` (``SpParMat.cpp:2781``): Hadamard product on
    the intersection, or A restricted to B's structural complement."""
    if exclude:
        return ewise_apply(a, b, _take_a, mode="a_minus_b", out_capacity=out_capacity)
    return ewise_apply(a, b, _hadamard, mode="intersect", out_capacity=out_capacity)


def set_difference(a: SpCOO, b: SpCOO, out_capacity: int | None = None) -> SpCOO:
    """Entries of A whose positions are absent from B (``ParFriends.h:2157``)."""
    return ewise_mult(a, b, exclude=True, out_capacity=out_capacity)


def add(a: SpCOO, b: SpCOO, out_capacity: int | None = None) -> SpCOO:
    """Structural-union addition A + B (operator+ on SpParMat)."""
    return ewise_apply(a, b, jnp.add, mode="union", out_capacity=out_capacity)
