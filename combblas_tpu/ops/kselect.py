"""Per-column k-select and the MCL prune/select/recover primitive.

Counterpart of ``SpParMat::Kselect1`` (``SpParMat.cpp:1191``) and
``MCLPruneRecoverySelect`` (``ParFriends.h:186``).  The reference ships per
column candidate lists to column owners and runs serial selection; here a
single descending (col, -value) sort ranks every entry within its column in
one pass, and the k-th largest per column is a gather at rank k-1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.ewise import _compact

__all__ = ["kselect_col", "col_rank", "select_top_k_per_col"]


def _col_sorted_desc(a: SpCOO):
    """Sort entries by (col asc, val desc); sentinels stay last."""
    m, n = a.shape
    valid = a.mask()
    col = jnp.where(valid, a.col, n)
    negv = jnp.where(valid, -a.val, jnp.inf)
    col_s, negv_s, row_s, val_s = jax.lax.sort(
        (col, negv, a.row, a.val), num_keys=2
    )
    return col_s, row_s, val_s


@jax.jit
def col_rank(a: SpCOO) -> jax.Array:
    """Rank (0-based, by descending value) of each stored entry within its
    column, aligned with a's entry order."""
    m, n = a.shape
    valid = a.mask()
    col = jnp.where(valid, a.col, n)
    negv = jnp.where(valid, -a.val, jnp.inf)
    eid = jnp.arange(a.capacity, dtype=jnp.int32)
    col_s, _, eid_s = jax.lax.sort((col, negv, eid), num_keys=2)
    # position within column = global sorted position - column start
    col_start = jnp.searchsorted(col_s, jnp.arange(n + 1, dtype=jnp.int32)).astype(
        jnp.int32
    )
    pos = jnp.arange(a.capacity, dtype=jnp.int32) - col_start[
        jnp.minimum(col_s, n)
    ]
    rank = jnp.zeros((a.capacity,), jnp.int32).at[eid_s].set(pos)
    return rank


@functools.partial(jax.jit, static_argnames=())
def kselect_col(a: SpCOO, k: jax.Array) -> jax.Array:
    """Per-column k-th largest stored value (1-indexed k), -inf where the
    column has fewer than k entries.  k may be scalar or a length-n vector.
    """
    m, n = a.shape
    col_s, _, val_s = _col_sorted_desc(a)
    col_start = jnp.searchsorted(col_s, jnp.arange(n + 1, dtype=jnp.int32)).astype(
        jnp.int32
    )
    count = col_start[1:] - col_start[:-1]
    k = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (n,))
    idx = jnp.minimum(col_start[:-1] + k - 1, a.capacity - 1)
    kth = val_s[idx]
    return jnp.where((count >= k) & (k >= 1), kth, -jnp.inf)


def select_top_k_per_col(a: SpCOO, k, out_capacity: int | None = None) -> SpCOO:
    """Keep only the k largest entries of each column (ties broken by row
    order in the descending sort) — the 'select' step of MCL pruning."""
    n = a.shape[1]
    k = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (n,))
    rank = col_rank(a)
    keep = rank < k[jnp.minimum(a.col, n - 1)]
    return _compact(a, keep, out_capacity)
