"""Breadth-first search — top-down and direction-optimizing.

Counterpart of ``Applications/TopDownBFS.cpp`` (frontier SpMSpV over
``SelectMaxSRing`` with an EWiseMult visited-mask, loop at ``:437-443``) and
``Applications/DirOptBFS.cpp:135`` (Beamer direction-optimizing switch with
``BitMapCarousel``/``BitMapFringe`` bottom-up steps).

Design notes:
- The frontier is a masked dense vector (values = vertex id + 1).  The entire
  per-level step is one gather + segment-max + (distributed: one all_gather +
  one reduce-scatter) — the reference's OptBuf packing / carousel rotation
  machinery exists to sparsify communication on a cache machine; on a
  bandwidth machine the dense masked vector is the fast path.
- The level loop is a ``lax.while_loop`` (static shapes, data-dependent trip
  count), so the whole traversal jit-compiles to one XLA program.
- Bottom-up (pull) steps compute, for every unvisited vertex, the max frontier
  in-neighbor via a boolean-masked segment reduction — the moral equivalent of
  ``BottomUpStep`` (``BFSFriends.h:458``) without the bitmap ring shifts.
  Direction choice follows Beamer's frontier-size heuristic
  (``DirOptBFS.cpp:388-398``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.spgemm import expand_products
from combblas_tpu.ops.spmv import spmsv_masked
from combblas_tpu.parallel.dist import DistSpMat, row_vec_len
from combblas_tpu.parallel.spmv import dist_spmsv_masked
from combblas_tpu.semiring import MAX_SECOND

__all__ = ["bfs_local", "bfs_dist", "bfs_dir_opt_local", "bfs_dir_opt_dist",
           "bfs_push_local", "bfs_push_prepare", "bfs_batch_pull",
           "bfs_batch_prepare"]


class _BfsState(NamedTuple):
    parents: jax.Array  # int32[n], -1 = unvisited
    levels: jax.Array  # int32[n], -1 = unvisited
    front_val: jax.Array  # float32/int32[n]: vertex id + 1 where frontier
    front_mask: jax.Array  # bool[n]
    depth: jax.Array  # int32 scalar
    nfront: jax.Array  # int32 scalar


def _init_state(n: int, root) -> _BfsState:
    parents = jnp.full((n,), -1, jnp.int32).at[root].set(root)
    levels = jnp.full((n,), -1, jnp.int32).at[root].set(0)
    fv = jnp.zeros((n,), jnp.int32).at[root].set(root + 1)
    fm = jnp.zeros((n,), jnp.bool_).at[root].set(True)
    return _BfsState(parents, levels, fv, fm,
                     jnp.asarray(0, jnp.int32), jnp.asarray(1, jnp.int32))


def _advance(state: _BfsState, y, ym, n: int) -> _BfsState:
    """Fold one level's candidate parents into the BFS state."""
    new = ym & (state.parents < 0)
    parents = jnp.where(new, y.astype(jnp.int32) - 1, state.parents)
    levels = jnp.where(new, state.depth + 1, state.levels)
    ids = jnp.arange(state.parents.shape[0], dtype=jnp.int32)
    fv = jnp.where(new, ids + 1, 0)
    return _BfsState(
        parents, levels, fv, new, state.depth + 1,
        jnp.sum(new.astype(jnp.int32)),
    )


@jax.jit
def bfs_local(a: SpCOO, root) -> Tuple[jax.Array, jax.Array]:
    """Single-device BFS.  Edge (u, v) = stored entry at (row=u, col=v);
    traversal follows out-edges (the reference BFS multiplies Aᵀ by the
    frontier, ``TopDownBFS.cpp:440``).  Returns (parents, levels)."""
    n = a.shape[0]

    def cond(s: _BfsState):
        return s.nfront > 0

    def body(s: _BfsState):
        y, ym = spmsv_masked(
            a, s.front_val, s.front_mask, MAX_SECOND, transpose=True
        )
        return _advance(s, y, ym, n)

    out = jax.lax.while_loop(cond, body, _init_state(n, root))
    return out.parents, out.levels


@jax.jit
def bfs_dist(a: DistSpMat, root) -> Tuple[jax.Array, jax.Array]:
    """Distributed BFS over the 2D grid.  Vectors are padded FullyDist arrays
    (padding vertices have no edges, so they are never visited).  Each level is
    one all_gather + one reduce-scatter — the fan-out/fan-in of
    ``ParFriends.h:1725`` with the merge fused into the collective."""
    assert a.gshape[0] == a.gshape[1], "BFS needs a square adjacency matrix"
    n_pad = row_vec_len(a.gshape, a.grid)

    def cond(s: _BfsState):
        return s.nfront > 0

    def body(s: _BfsState):
        y, ym = dist_spmsv_masked(
            a, s.front_val, s.front_mask, MAX_SECOND, transpose=True
        )
        return _advance(s, y, ym, n_pad)

    out = jax.lax.while_loop(cond, body, _init_state(n_pad, root))
    return out.parents, out.levels


@jax.jit
def bfs_dir_opt_local(a: SpCOO, root) -> Tuple[jax.Array, jax.Array]:
    """Direction-optimizing BFS (Beamer; ``DirOptBFS.cpp:135``).

    Top-down: masked push over frontier out-edges (values carry parent ids).
    Bottom-up: every *unvisited* vertex pulls the max parent among frontier
    in-neighbors — one boolean gather + segment-max, no parent values in
    flight (the role of the reference's ``BitMapCarousel`` word-bitmaps,
    ``BFSFriends.h:458``).  The switch follows the frontier-edge heuristic
    (``DirOptBFS.cpp:388-398``): pull when the frontier covers more than
    1/BETA of the graph's vertices.

    Both directions stream all nnz, so the win is reduced word traffic
    (bool vs id+mask), not asymptotic work; both paths share the state fold
    for cross-validation.
    """
    n = a.shape[0]
    m = a.shape[0]
    BETA = 8  # pull when frontier > n / BETA

    valid = a.mask()
    src = jnp.minimum(a.row, n - 1)
    dst = jnp.minimum(a.col, n - 1)

    def cond(s: _BfsState):
        return s.nfront > 0

    def push(s: _BfsState):
        y, ym = spmsv_masked(a, s.front_val, s.front_mask, MAX_SECOND,
                             transpose=True)
        return y, ym

    def pull(s: _BfsState):
        # for each edge (u, v): u in frontier contributes parent u+1 to v
        active = valid & s.front_mask[src]
        cand = jnp.where(active, src + 1, 0)
        seg = jnp.where(active, dst, n)
        y = jax.ops.segment_max(cand, seg, num_segments=n)
        return y, y > 0

    def body(s: _BfsState):
        y, ym = jax.lax.cond(s.nfront * BETA > n, pull, push, s)
        return _advance(s, y, ym, n)

    out = jax.lax.while_loop(cond, body, _init_state(n, root))
    return out.parents, out.levels


@jax.jit
def bfs_dir_opt_dist(a: DistSpMat, root) -> Tuple[jax.Array, jax.Array]:
    """Distributed direction-optimizing BFS (``DirOptBFS.cpp:398`` +
    ``BFSFriends.h:458``): top-down levels run the masked SpMSpV fan-out/
    fan-in; once the frontier passes n/BETA the level switches to the pull
    step (:func:`combblas_tpu.parallel.spmv.dist_bfs_pull_masked`), which
    moves only two bitmaps across the mesh — the reference's
    ``BitMapCarousel`` word-bitmap saving as two bool all_gathers.  Both
    directions share the state fold, so levels/parents match ``bfs_dist``
    exactly."""
    from combblas_tpu.parallel.spmv import dist_bfs_pull_masked

    assert a.gshape[0] == a.gshape[1], "BFS needs a square adjacency matrix"
    n_pad = row_vec_len(a.gshape, a.grid)
    BETA = 8

    def cond(s: _BfsState):
        return s.nfront > 0

    def push(s: _BfsState):
        return dist_spmsv_masked(
            a, s.front_val, s.front_mask, MAX_SECOND, transpose=True
        )

    def pull(s: _BfsState):
        y, ym = dist_bfs_pull_masked(a, s.front_mask, s.parents < 0)
        return y.astype(s.front_val.dtype), ym

    def body(s: _BfsState):
        y, ym = jax.lax.cond(s.nfront * BETA > n_pad, pull, push, s)
        return _advance(s, y, ym, n_pad)

    out = jax.lax.while_loop(cond, body, _init_state(n_pad, root))
    return out.parents, out.levels


# ---------------------------------------------------------------------------
# Push BFS on the SpGEMM expansion — frontier work only
# ---------------------------------------------------------------------------
#
# The while_loop BFS above streams ALL nnz per level (a full masked SpMV),
# so an L-level traversal does L x nnz work.  The reference's answer is true
# SpMSpV: touch only the frontier's edges (``BFSFriends.h:328`` + OptBuf
# bucketing).  Gathering the frontier's adjacency lists is exactly the
# SpGEMM expansion (:func:`combblas_tpu.ops.spgemm.expand_products`):
# frontier vertices are 'A entries', the adjacency row-pointer map is 'B',
# and each frontier row's neighbour segment lands in one compacted stream
# whose row field carries the parent id.  Each edge is touched exactly once
# over the whole traversal (when its source leaves the frontier), restoring
# the O(m + n) BFS work bound — the property the reference gets from its
# sparse fringe.


def bfs_push_prepare(a: SpCOO):
    """Host-hoistable state for :func:`bfs_push_local`: the row-pointer map
    and the adjacency column stream."""
    return a.row_ptr(), a.col


@functools.partial(jax.jit, static_argnames=("n", "fr_cap", "stream_cap"))
def _bfs_push_level(
    rp, col, fr_ids, nfront, parents, levels, depth,
    *, n: int, fr_cap: int, stream_cap: int,
):
    """One push level: expand the frontier's adjacency segments into a
    compacted (parent, neighbour) stream, fold with one scatter-max, compact
    the next frontier.  Returns (parents, levels, next_ids, stats) where
    ``stats`` stacks the two loop-control scalars [next_count,
    next_edges] so the host pulls one array per level."""
    from combblas_tpu.semiring import PLUS_TIMES

    fr = jax.lax.dynamic_slice(fr_ids, (0,), (fr_cap,))
    valid = jnp.arange(fr_cap, dtype=jnp.int32) < nfront
    fr = jnp.where(valid, fr, n)
    ones = jnp.ones((fr_cap,), jnp.int32)
    par, nbr, _, total = expand_products(
        fr, jnp.minimum(fr, n - 1), ones, valid, col,
        jnp.ones(col.shape, jnp.int32), rp[:-1], rp[1:], PLUS_TIMES,
        stream_cap, (n, n))
    live = jnp.arange(stream_cap, dtype=jnp.int32) < total
    tgt = jnp.where(live, jnp.minimum(nbr, n), n)
    cand = jnp.zeros((n + 1,), jnp.int32).at[tgt].max(
        jnp.where(live, par + 1, 0))[:n]
    new = (cand > 0) & (parents < 0)
    parents = jnp.where(new, cand - 1, parents)
    levels = jnp.where(new, depth + 1, levels)
    ids = jnp.sort(jnp.where(new, jnp.arange(n, dtype=jnp.int32), n))
    nf = jnp.sum(new.astype(jnp.int32))
    deg = rp[1:] - rp[:-1]
    nedges = jnp.sum(jnp.where(new, deg[:n], 0))
    # one host pull per level: stack the loop-control scalars
    return parents, levels, ids, jnp.stack([nf, nedges])


def _pow2(x: int, lo: int) -> int:
    import math

    return max(1 << int(math.ceil(math.log2(max(x, 1)))), lo)


def bfs_push_local(a: SpCOO, root: int, prep=None):
    """Host-driven push BFS (``TopDownBFS.cpp:437-443`` semantics, frontier
    work only).  Per level one device step with pow2-quantized static caps
    (frontier size / edge-stream length), so a handful of compiled shapes
    cover every level and every root.  Returns (parents, levels) device
    arrays."""
    n = a.shape[0]
    if prep is None:
        prep = bfs_push_prepare(a)
    rp, col = prep
    deg_host = np.asarray(rp[1:] - rp[:-1])
    parents = jnp.full((n,), -1, jnp.int32).at[root].set(root)
    levels = jnp.full((n,), -1, jnp.int32).at[root].set(0)
    fr_ids = jnp.full((n,), n, jnp.int32).at[0].set(root)
    k = 1
    edges = int(deg_host[root])
    depth = 0
    while k > 0:
        # clamp to the vertex count: fr_ids is (n,), so a pow2-quantized
        # cap above n would make the frontier dynamic_slice ill-formed
        fr_cap = min(_pow2(k, 1024), n)
        stream_cap = _pow2(edges, 8192)
        parents, levels, fr_ids, stats = _bfs_push_level(
            rp, col, fr_ids, jnp.asarray(k, jnp.int32), parents, levels,
            jnp.asarray(depth, jnp.int32),
            n=n, fr_cap=fr_cap, stream_cap=stream_cap,
        )
        k, edges = (int(v) for v in np.asarray(stats))
        depth += 1
    return parents, levels


# ---------------------------------------------------------------------------
# Device-resident batched pull BFS — the single-device performance path
# ---------------------------------------------------------------------------
#
# The push pipeline above is host-driven: one device dispatch and one host
# pull per level.  This path keeps the ENTIRE multi-root traversal in one
# XLA dispatch:
#
# - the level sweep is a ``lax.while_loop``; each level is a *pull* step
#   over every edge (``BottomUpStep``/Beamer bottom-up, ``BFSFriends.h:458``):
#   frontier membership is gathered at edge targets and folded per source
#   row WITHOUT any scatter or sort — an int32 cumsum over the CSR-ordered
#   edge stream plus two row-pointer boundary gathers gives exact per-row
#   hit counts (int32 wraparound keeps boundary differences exact even
#   past 2^31 cumulative);
# - all R roots ride one batch dimension: the edge gather/cumsum cost is
#   shared, so per-root cost falls ~Rx for the same HBM traffic pattern;
# - parents are recovered AFTER the level loop in one more scan: the first
#   edge of each row whose target sits one level up is located with the
#   same cumsum-of-indicator trick (first-match has cumulative count =
#   preceding-count + 1), and its id is extracted by a value cumsum whose
#   per-row boundary difference is exact (<= one nonzero per row).
#
# Work is O(levels * m_edges) per batch — the price of pull — but every
# pass is a dense streamed gather/cumsum with zero per-level host
# synchronization.


def bfs_batch_prepare(a: SpCOO):
    """Device state for :func:`bfs_batch_pull`: CSR row pointers, the
    edge-target stream, per-entry source rows, and the live-entry mask."""
    n = a.shape[0]
    rp = a.row_ptr()
    live = a.mask()
    col = jnp.where(live, jnp.minimum(a.col, n - 1), 0)
    row = jnp.where(live, jnp.minimum(a.row, n - 1), 0)
    return rp, col, row, live


@functools.partial(jax.jit, static_argnames=("n",))
def _bfs_batch_pull(rp, col, row, live, roots, *, n: int):
    R = roots.shape[0]
    levels = jnp.full((R, n), -1, jnp.int32)
    levels = levels.at[jnp.arange(R), roots].set(0)
    z1 = jnp.zeros((R, 1), jnp.int32)

    def seg_rowsum(stream):
        """Per-row sums of an (R, E) int32 edge stream via wrapping cumsum
        + boundary gathers (exact mod 2^32; true row sums < 2^31)."""
        c0 = jnp.concatenate([z1, jnp.cumsum(stream, axis=1)], axis=1)
        return c0[:, rp[1:]] - c0[:, rp[:-1]], c0

    def cond(c):
        _, _, changed = c
        return changed

    def body(c):
        levels, depth, _ = c
        f = jnp.take_along_axis(
            levels, jnp.broadcast_to(col, (R, col.shape[0])), axis=1,
        ) == depth
        hit = (f & live).astype(jnp.int32)
        rowhit, _ = seg_rowsum(hit)
        new = (rowhit > 0) & (levels < 0)
        return (jnp.where(new, depth + 1, levels), depth + 1,
                jnp.any(new))

    levels, _, _ = jax.lax.while_loop(
        cond, body, (levels, jnp.int32(0), jnp.asarray(True)))

    # ---- parents in one post-hoc scan ----
    colb = jnp.broadcast_to(col, (R, col.shape[0]))
    pl = jnp.take_along_axis(levels, colb, axis=1)
    rl = jnp.take_along_axis(
        levels, jnp.broadcast_to(row, (R, row.shape[0])), axis=1)
    ind = (pl == rl - 1) & (rl > 0) & live
    cnt, c0 = seg_rowsum(ind.astype(jnp.int32))
    # first match of each row: its cumulative count exceeds the count at
    # the row start by exactly one
    start_cnt = jnp.take_along_axis(
        c0, jnp.broadcast_to(rp[:-1][row], (R, row.shape[0])), axis=1)
    c_at = c0[:, 1:]
    first = ind & (c_at == start_cnt + 1)
    pv = jnp.where(first, colb + 1, 0).astype(jnp.int32)
    psum, _ = seg_rowsum(pv)  # <= one nonzero per row: boundary diff exact
    parents = jnp.where(levels > 0, psum - 1, -1)
    parents = parents.at[jnp.arange(R), roots].set(roots)
    return parents, levels


def bfs_batch_pull(a: SpCOO, roots, prep=None):
    """Multi-root BFS in ONE device dispatch (``TopDownBFS.cpp:437-443``
    semantics, Beamer pull formulation).  ``a`` must be symmetric (the
    bench symmetrizes; for directed traversal pass ``a.transpose()``'s
    CSR).  Returns (parents, levels) as (R, n) device arrays."""
    if prep is None:
        prep = bfs_batch_prepare(a)
    rp, col, row, live = prep
    roots = jnp.asarray(np.asarray(roots), jnp.int32)
    return _bfs_batch_pull(rp, col, row, live, roots, n=a.shape[0])


def validate_bfs(a_dense, root: int, parents, levels) -> bool:
    """Host-side Graph500-style validation (``TopDownBFS.cpp:448-457``):
    every visited vertex's parent edge exists and levels are consistent."""
    import numpy as np

    a_dense = np.asarray(a_dense)
    parents = np.asarray(parents)
    levels = np.asarray(levels)
    n = a_dense.shape[0]
    if parents[root] != root or levels[root] != 0:
        return False
    for v in range(n):
        p = parents[v]
        if p < 0:
            continue
        if v == root:
            continue
        if a_dense[p, v] == 0:
            return False
        if levels[v] != levels[p] + 1:
            return False
    return True
