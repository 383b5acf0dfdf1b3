"""Filtered (semantic-graph) traversals.

Counterpart of ``Applications/FilteredBFS.cpp:129`` /
``FilteredMIS.cpp:147`` and the ``SemanticGraph.h`` wrapper: graphs whose
edges carry attributes (``TwitterEdge.h:15`` — follower flag + retweet
timestamp) and whose algorithms traverse only edges passing a predicate.

The reference pushes the filter into the semiring multiply ("late filtering");
here the edge attribute lives in the value array and the filter is applied as
an edge mask fused into the traversal's gather pass — same asymptotics, one
extra vector compare per edge, no materialized subgraph (use
:func:`materialize_filtered` for repeated queries with one predicate).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import functools

import jax
import jax.numpy as jnp

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.ewise import _compact
from combblas_tpu.models.bfs import _BfsState, _advance, _init_state

__all__ = [
    "bfs_filtered",
    "bfs_filtered_dist",
    "materialize_filtered",
    "materialize_filtered_dist",
    "mis_filtered",
    "mis_filtered_dist",
]


def materialize_filtered(a: SpCOO, pred: Callable) -> SpCOO:
    """Materialize the subgraph of edges with pred(attribute) True."""
    return _compact(a, pred(a.val))


@jax.jit
def _bfs_filtered_run(a: SpCOO, edge_ok: jax.Array, root):
    n = a.shape[0]
    valid = a.mask() & edge_ok
    src = jnp.minimum(a.row, n - 1)
    dst = jnp.minimum(a.col, n - 1)

    def cond(s: _BfsState):
        return s.nfront > 0

    def body(s: _BfsState):
        active = valid & s.front_mask[src]
        cand = jnp.where(active, src + 1, 0)
        seg = jnp.where(active, dst, n)
        y = jax.ops.segment_max(cand, seg, num_segments=n)
        return _advance(s, y, y > 0, n)

    out = jax.lax.while_loop(cond, body, _init_state(n, root))
    return out.parents, out.levels


def bfs_filtered(a: SpCOO, root, pred: Callable):
    """BFS over edges passing pred(edge_value) — late filtering
    (``FilteredBFS.cpp`` semantics).  Returns (parents, levels)."""
    edge_ok = pred(a.val)
    return _bfs_filtered_run(a, edge_ok, root)


def mis_filtered(a: SpCOO, key: jax.Array, pred: Callable):
    """Luby MIS on the filtered subgraph (``FilteredMIS.cpp``)."""
    from combblas_tpu.models.mis import luby_mis

    return luby_mis(materialize_filtered(a, pred), key)


def materialize_filtered_dist(a, pred: Callable):
    """Distributed materialization of the semantic subgraph — blockwise
    prune, no communication (``SemanticGraph.h`` repeated-query path)."""
    from combblas_tpu.parallel.elementwise import dist_prune

    return dist_prune(a, _negate(pred))


def _negate(pred):
    def f(v):
        return ~pred(v)

    return f


@functools.partial(jax.jit, static_argnames=("pred",))
def _bfs_filtered_dist_run(a, root, pred):
    from combblas_tpu.parallel.dist import row_vec_len
    from combblas_tpu.parallel.spmv import dist_spmsv_masked
    from combblas_tpu.semiring import MAX_SECOND

    n_pad = row_vec_len(a.gshape, a.grid)

    def cond(s: _BfsState):
        return s.nfront > 0

    def body(s: _BfsState):
        y, ym = dist_spmsv_masked(
            a, s.front_val, s.front_mask, MAX_SECOND, transpose=True,
            edge_pred=pred,
        )
        return _advance(s, y, ym, n_pad)

    out = jax.lax.while_loop(cond, body, _init_state(n_pad, root))
    return out.parents, out.levels


def bfs_filtered_dist(a, root, pred: Callable):
    """Distributed filtered BFS (``FilteredBFS.cpp:129``): the edge predicate
    fuses into the mesh SpMSpV as one per-edge compare — late filtering, no
    materialized subgraph, same collectives as ``bfs_dist``.  ``a``:
    DistSpMat whose values are attribute codes."""
    return _bfs_filtered_dist_run(a, root, pred)


def mis_filtered_dist(a, key: jax.Array, pred: Callable):
    """Distributed FilteredMIS (``FilteredMIS.cpp:147``): Luby rounds with
    the predicate fused into every SpMV."""
    from combblas_tpu.models.mis import luby_mis_dist

    return luby_mis_dist(a, key, edge_pred=pred)
