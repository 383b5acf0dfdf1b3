"""Distributed bipartite matchings on the 2D grid.

Counterparts of ``Applications/BipartiteMatchings/``:

- :func:`dist_bp_maximal` — greedy maximal matching
  (``BPMaximalMatching.h:24``): propose/accept rounds, each one blockwise
  segment-min + axis reduce (the fan-in of the reference's SpMV-based
  proposals) + two owner routings (the alltoallv "Set" of mate vectors).
- :func:`dist_bp_maximum` — maximum-cardinality matching
  (``BPMaximumMatching.cpp:207``): alternating-path BFS levels as distributed
  frontier steps (O(levels) device syncs per phase — one liveness pull per
  level, the reference's per-level MPI allreduce).  The parent/free vectors
  are pulled to the host ONCE per phase, and the vertex-disjoint
  augmentation walks run entirely on those host copies (pure numpy, zero
  device round-trips), with one upload of the updated mate vectors per
  phase — the reference's augment is likewise a serial pointer walk over
  gathered vectors.
- :func:`dist_awpm` — approximate-weight matching
  (``ApproxWeightPerfectMatching.h:792``): locally-dominant rounds (Preis /
  Manne–Bisseling) with the dominance handshake routed through vertex owners.

Vertex vectors: mate_row is a row-space FullyDist vector, mate_col col-space;
cross-space handoffs ride :func:`combblas_tpu.parallel.vector.dist_route`
(flat-index semantics make resharding between the two layouts free-form).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.parallel.vector import dist_route

__all__ = ["dist_bp_maximal", "dist_bp_maximum", "dist_awpm"]

_SPEC = P("r", "c", None)
_NSPEC = P("r", "c")


def _pad_to(x, n, fill):
    k = min(x.shape[0], n)
    return jnp.full((n,), fill, x.dtype).at[:k].set(x[:k])


@jax.jit
def _dist_propose(a: DistSpMat, mate_row, mate_col):
    """Rows propose their min open neighbor column: one blockwise segment-min
    + min reduce-scatter along 'c'.  Returns prop (row-space, n = no
    proposal)."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pr, pc = grid.pr, grid.pc
    n_pad = pc * nb
    mr = _pad_to(mate_row, pr * mb, jnp.int32(0))
    mc = _pad_to(mate_col, n_pad, jnp.int32(0))

    def f(row, col, val, nnz, mr_loc, mc_loc):
        cap = row.shape[-1]
        r = row.reshape(-1)
        c = col.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        mr_blk = jax.lax.all_gather(mr_loc, "c", tiled=True)  # (mb,)
        mc_blk = jax.lax.all_gather(mc_loc, "r", tiled=True)  # (nb,)
        rr = jnp.minimum(r, mb - 1)
        cc = jnp.minimum(c, nb - 1)
        open_e = valid & (mr_blk[rr] < 0) & (mc_blk[cc] < 0)
        bj = jax.lax.axis_index("c").astype(jnp.int32)
        prop_part = jax.ops.segment_min(
            jnp.where(open_e, bj * nb + cc, n_pad),
            jnp.where(valid, rr, mb),
            num_segments=mb,
        )
        red = jax.lax.pmin(prop_part, "c")
        me = jax.lax.axis_index("c")
        chunk = mb // pc
        return jax.lax.dynamic_slice_in_dim(red, me * chunk, chunk, axis=0)

    return shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(("r", "c")), P(("c", "r"))),
        out_specs=P(("r", "c")),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, mr, mc)


def _propose_accept_round(a: DistSpMat, mate_row, mate_col):
    """One distributed propose/accept round (see local
    ``models/matching.py:_propose_accept``)."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    n_pad = grid.pc * nb
    m_pad = grid.pr * mb
    prop = _dist_propose(a, mate_row, mate_col)
    has = prop < n_pad
    rows = jnp.arange(m_pad, dtype=jnp.int32)
    # columns accept the min proposing row (owner routing, combine=min)
    acc0 = jnp.full((n_pad,), m_pad, jnp.int32)
    acc, hit = dist_route(prop, rows, has, acc0, grid, combine="min")
    # winners: column c accepted row acc[c]; notify rows (route back) and
    # update both mate vectors
    cols = jnp.arange(n_pad, dtype=jnp.int32)
    won_c = hit & (acc < m_pad)
    new_mate_col = jnp.where(won_c, acc, mate_col)
    notice0 = jnp.full((m_pad,), -1, jnp.int32)
    notice, _ = dist_route(
        jnp.where(won_c, acc, m_pad), cols, won_c, notice0, grid, combine="max"
    )
    new_mate_row = jnp.where(notice >= 0, notice, mate_row)
    progressed = bool(jnp.any(won_c))
    return new_mate_row, new_mate_col, progressed


def dist_bp_maximal(a: DistSpMat) -> Tuple[jax.Array, jax.Array]:
    """Greedy maximal matching on the grid (``BPMaximalMatching.h:24``).
    Returns (mate_row [row-space], mate_col [col-space]), -1 = unmatched;
    padding slots stay -1 (no edges)."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    mate_row = jnp.full((grid.pr * mb,), -1, jnp.int32)
    mate_col = jnp.full((grid.pc * nb,), -1, jnp.int32)
    while True:
        mate_row, mate_col, progressed = _propose_accept_round(
            a, mate_row, mate_col
        )
        if not progressed:
            return mate_row, mate_col


@jax.jit
def _dist_alt_level(a: DistSpMat, frontier, visited_col):
    """One alternating-BFS level: frontier rows discover unvisited columns
    (blockwise segment-max + pmax over 'r')."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pr, pc = grid.pr, grid.pc
    fm = _pad_to(frontier, pr * mb, jnp.asarray(False))
    vc = _pad_to(visited_col, pc * nb, jnp.asarray(False))

    def f(row, col, val, nnz, fm_loc, vc_loc):
        cap = row.shape[-1]
        r = row.reshape(-1)
        c = col.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        fm_blk = jax.lax.all_gather(fm_loc, "c", tiled=True)
        vc_blk = jax.lax.all_gather(vc_loc, "r", tiled=True)
        rr = jnp.minimum(r, mb - 1)
        cc = jnp.minimum(c, nb - 1)
        active = valid & fm_blk[rr] & ~vc_blk[cc]
        bi = jax.lax.axis_index("r").astype(jnp.int32)
        disc_part = jax.ops.segment_max(
            jnp.where(active, bi * mb + rr, -1),
            jnp.where(active, cc, nb),
            num_segments=nb,
        )
        red = jax.lax.pmax(disc_part, "r")
        me = jax.lax.axis_index("r")
        chunk = nb // pr
        return jax.lax.dynamic_slice_in_dim(red, me * chunk, chunk, axis=0)

    return shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(("r", "c")), P(("c", "r"))),
        out_specs=P(("c", "r")),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, fm, vc)


def _dist_alt_bfs(a: DistSpMat, mate_row, mate_col):
    """Alternating-path BFS from all unmatched rows (one Hopcroft-Karp
    phase, distributed).  Returns (parent_col, free_cols) host arrays."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    m_pad, n_pad = grid.pr * mb, grid.pc * nb
    # row padding slots have no edges, but mate_row padding is -1 ("free"):
    # restrict the seed frontier to true rows
    m_true = a.gshape[0]
    rows = jnp.arange(m_pad, dtype=jnp.int32)
    frontier = (mate_row < 0) & (rows < m_true)
    parent_col = jnp.full((n_pad,), -1, jnp.int32)
    visited = jnp.zeros((n_pad,), jnp.bool_)
    while True:
        disc = _dist_alt_level(a, frontier, visited)
        newly = disc >= 0
        if not bool(jnp.any(newly)):
            break
        parent_col = jnp.where(newly & (parent_col < 0), disc, parent_col)
        visited = visited | newly
        # advance through matched edges: frontier = mates of newly discovered
        # matched columns (owner routing col -> row space)
        nxt = jnp.where(newly, mate_col, -1)
        f0 = jnp.zeros((m_pad,), jnp.int32)
        f1, _ = dist_route(
            jnp.where(nxt >= 0, nxt, m_pad),
            jnp.ones((n_pad,), jnp.int32),
            nxt >= 0, f0, grid, combine="max",
        )
        frontier = f1 > 0
    free_cols = visited & (mate_col < 0)
    return np.asarray(parent_col), np.asarray(free_cols)


def dist_bp_maximum(a: DistSpMat, init=None) -> Tuple[jax.Array, jax.Array]:
    """Maximum-cardinality matching on the grid
    (``BPMaximumMatching.cpp:207``): distributed greedy init (or a
    caller-provided matching, e.g. AWPM's weighted one) + phases of
    distributed alternating BFS, host augmentation of vertex-disjoint
    paths."""
    mate_row, mate_col = dist_bp_maximal(a) if init is None else init
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    m_pad, n_pad = grid.pr * mb, grid.pc * nb
    mr = np.asarray(mate_row).copy()
    mc = np.asarray(mate_col).copy()
    while True:
        parent_col, free_cols = _dist_alt_bfs(
            a, jnp.asarray(mr), jnp.asarray(mc)
        )
        free = np.nonzero(free_cols)[0]
        if free.size == 0:
            break
        used_row = np.zeros(m_pad, bool)
        used_col = np.zeros(n_pad, bool)
        augmented = 0
        for c0 in free:
            path = []
            c = int(c0)
            ok = True
            while True:
                r = int(parent_col[c])
                if r < 0 or used_row[r] or used_col[c]:
                    ok = False
                    break
                path.append((r, c))
                prev_c = int(mr[r])
                if prev_c < 0:
                    break
                c = prev_c
            if not ok or not path:
                continue
            for r, c in path:
                used_row[r] = True
                used_col[c] = True
            for r, c in path:
                mr[r] = c
                mc[c] = r
            augmented += 1
        if augmented == 0:
            break
    return jnp.asarray(mr), jnp.asarray(mc)


@jax.jit
def _dist_dominant(a: DistSpMat, mate_row, mate_col):
    """Locally-dominant weighted round, distributed: per-edge dominance check
    against row/col maxima, handshake via chosen-col / chosen-row vectors.
    Returns (chosen_c row-space, chosen_r col-space)."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pr, pc = grid.pr, grid.pc
    m_pad, n_pad = pr * mb, pc * nb
    mr = _pad_to(mate_row, m_pad, jnp.int32(0))
    mc = _pad_to(mate_col, n_pad, jnp.int32(0))

    def f(row, col, val, nnz, mr_loc, mc_loc):
        cap = row.shape[-1]
        r = row.reshape(-1)
        c = col.reshape(-1)
        v = val.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        mr_blk = jax.lax.all_gather(mr_loc, "c", tiled=True)
        mc_blk = jax.lax.all_gather(mc_loc, "r", tiled=True)
        rr = jnp.minimum(r, mb - 1)
        cc = jnp.minimum(c, nb - 1)
        open_e = valid & (mr_blk[rr] < 0) & (mc_blk[cc] < 0)
        neg = jnp.float32(-jnp.inf)
        w = jnp.where(open_e, v.astype(jnp.float32), neg)
        rmax_p = jax.ops.segment_max(w, jnp.where(valid, rr, mb),
                                     num_segments=mb)
        cmax_p = jax.ops.segment_max(w, jnp.where(valid, cc, nb),
                                     num_segments=nb)
        rmax = jax.lax.pmax(rmax_p, "c")  # (mb,) row maxima
        cmax = jax.lax.pmax(cmax_p, "r")  # (nb,) col maxima
        is_best = open_e & (w == rmax[rr]) & (w == cmax[cc])
        bi = jax.lax.axis_index("r").astype(jnp.int32)
        bj = jax.lax.axis_index("c").astype(jnp.int32)
        ch_c_p = jax.ops.segment_min(
            jnp.where(is_best, bj * nb + cc, n_pad),
            jnp.where(valid, rr, mb), num_segments=mb,
        )
        ch_r_p = jax.ops.segment_min(
            jnp.where(is_best, bi * mb + rr, m_pad),
            jnp.where(valid, cc, nb), num_segments=nb,
        )
        ch_c = jax.lax.pmin(ch_c_p, "c")
        ch_r = jax.lax.pmin(ch_r_p, "r")
        me_c = jax.lax.axis_index("c")
        me_r = jax.lax.axis_index("r")
        out_c = jax.lax.dynamic_slice_in_dim(
            ch_c, me_c * (mb // pc), mb // pc, axis=0
        )
        out_r = jax.lax.dynamic_slice_in_dim(
            ch_r, me_r * (nb // pr), nb // pr, axis=0
        )
        return out_c, out_r

    return shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(("r", "c")), P(("c", "r"))),
        out_specs=(P(("r", "c")), P(("c", "r"))),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, mr, mc)


def dist_awpm(a: DistSpMat, complete: bool = True):
    """Approximate-weight (perfect) matching on the grid
    (``ApproxWeightPerfectMatching.h:792,1144``): locally-dominant rounds
    (½-approx of max weight), optionally completed to maximum cardinality on
    the unmatched residual via :func:`dist_bp_maximum`."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    m_pad, n_pad = grid.pr * mb, grid.pc * nb
    mate_row = jnp.full((m_pad,), -1, jnp.int32)
    mate_col = jnp.full((n_pad,), -1, jnp.int32)
    rows = jnp.arange(m_pad, dtype=jnp.int32)
    while True:
        ch_c, ch_r = _dist_dominant(a, mate_row, mate_col)
        # handshake: row r and col c agree iff ch_c[r] == c and ch_r[c] == r.
        # route col-side picks to rows, compare.
        pc2_0 = jnp.full((m_pad,), n_pad, jnp.int32)
        cols = jnp.arange(n_pad, dtype=jnp.int32)
        has_r = ch_r < m_pad
        pc2, _ = dist_route(
            jnp.where(has_r, ch_r, m_pad), cols, has_r, pc2_0, grid,
            combine="min",
        )
        agree = (ch_c < n_pad) & (pc2 == ch_c)
        if not bool(jnp.any(agree)):
            break
        mate_row = jnp.where(agree, ch_c, mate_row)
        mc_upd0 = jnp.full((n_pad,), -1, jnp.int32)
        mc_upd, _ = dist_route(
            jnp.where(agree, ch_c, n_pad), rows, agree, mc_upd0, grid,
            combine="max",
        )
        mate_col = jnp.where(mc_upd >= 0, mc_upd, mate_col)
    if complete:
        # cardinality completion: augmenting phases on the FULL graph seeded
        # with the weighted matching (augmentation re-pairs along alternating
        # paths, so every matched vertex stays matched — the reference's
        # maximal+augment composition, ApproxWeightPerfectMatching.h:1144)
        return dist_bp_maximum(a, init=(mate_row, mate_col))
    return mate_row, mate_col


