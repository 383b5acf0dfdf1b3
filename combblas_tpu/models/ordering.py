"""Matrix orderings — Reverse Cuthill-McKee (RCM).

Counterpart of ``Applications/Ordering/RCM.cpp:610``: the reference
finds a pseudo-peripheral vertex by repeated BFS (``:332``), then labels
vertices level by level via ``SpMV<SelectMinSR>`` with an SPA (``:361``),
ordering within a level by (parent order, degree).

Here levels come from the jitted BFS; the canonical within-level order is
computed with one global lexicographic sort on (level, parent order, degree,
vertex id) — replacing the reference's per-level SpMV labeling loop with a
single device sort, which is the data-parallel formulation.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.reduce import nnz_per
from combblas_tpu.models.bfs import bfs_local

__all__ = ["pseudo_peripheral_vertex", "rcm_order", "rcm_order_dist",
           "md_order", "md_order_dist"]


def pseudo_peripheral_vertex(a: SpCOO, start: int = 0, max_rounds: int = 8):
    """Repeated-BFS pseudo-peripheral vertex search (``RCM.cpp:332``): BFS,
    jump to a minimum-degree vertex of the last level, repeat until the
    eccentricity stops growing."""
    deg = np.asarray(nnz_per(a, "row"))
    v = start
    last_ecc = -1
    for _ in range(max_rounds):
        _, levels = bfs_local(a, v)
        lv = np.asarray(levels)
        ecc = int(lv.max())
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        far = np.nonzero(lv == ecc)[0]
        v = int(far[np.argmin(deg[far])])
    return v, last_ecc


def rcm_order(a: SpCOO, start: int | None = None) -> jax.Array:
    """RCM permutation: order[i] = i-th vertex in the reverse Cuthill-McKee
    ordering.  Disconnected components are ordered after the start component
    (each by its own BFS), matching standard RCM practice."""
    n = a.shape[0]
    deg = nnz_per(a, "row")
    degn = np.asarray(deg)
    visited = np.zeros(n, bool)
    pieces = []
    while not visited.all():
        if start is None or pieces:
            cand = np.nonzero(~visited)[0]
            s = int(cand[np.argmin(degn[cand])])
            s, _ = pseudo_peripheral_vertex(a, s)
            # pseudo-peripheral search could land in a visited component only
            # if the graph were modified concurrently; s stays in cand's comp.
        else:
            s = start
        parents, levels = bfs_local(a, s)
        lv = np.asarray(levels)
        comp = lv >= 0
        order_piece = _cm_order_component(a, parents, levels, degn)
        pieces.append(order_piece)
        visited |= comp
        start = None
    order = np.concatenate(pieces)
    return jnp.asarray(order[::-1].copy())  # reverse (the R in RCM)


def rcm_order_dist(a, start: int | None = None) -> np.ndarray:
    """Distributed RCM on the 2D grid — the reference's own formulation
    (``Applications/Ordering/RCM.cpp:332,361``): pseudo-peripheral vertex by
    repeated distributed BFS, then level-by-level Cuthill-McKee labeling
    where each level's "parent order" comes from one ``SpMV<SelectMinSR>``
    (here :func:`dist_spmsv_masked` with MIN_SECOND) and the within-level
    rank from TWO mesh-wide stable sorts (by (degree, id), then by parent
    order with position tiebreak) — no per-component host walk.

    ``a``: DistSpMat (square, symmetric structure).  Returns the RCM order as
    a host int array (order[i] = i-th vertex)."""
    import jax.numpy as jnp

    from combblas_tpu.models.bfs import bfs_dist
    from combblas_tpu.parallel.dist import DistSpMat, row_vec_len
    from combblas_tpu.parallel.elementwise import dist_reduce
    from combblas_tpu.parallel.spmv import dist_spmsv_masked
    from combblas_tpu.parallel.vector import (
        dist_apply_perm,
        dist_route,
        dist_sort_auto,
    )
    from combblas_tpu.semiring import MIN_SECOND, PLUS_TIMES

    n = a.gshape[0]
    n_pad = row_vec_len(a.gshape, a.grid)
    grid = a.grid
    deg = dist_reduce(a, "row", PLUS_TIMES, premap=lambda v: 1.0 + 0.0 * v)
    degh = np.asarray(deg)[:n].astype(np.int64)
    visited = np.zeros(n, bool)
    label = np.full(n_pad, -1, np.int64)
    counter = 0
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    while not visited.all():
        if start is None:
            cand = np.nonzero(~visited)[0]
            s = int(cand[np.argmin(degh[cand])])
        else:
            s, start = start, None
        # pseudo-peripheral: repeated distributed BFS
        last_ecc = -1
        for _ in range(8):
            _, levels = bfs_dist(a, s)
            lv = np.asarray(levels)[:n]
            ecc = int(lv.max())
            if ecc <= last_ecc:
                break
            last_ecc = ecc
            far = np.nonzero(lv == ecc)[0]
            s = int(far[np.argmin(degh[far])])
        _, levels = bfs_dist(a, s)
        lvh = np.asarray(levels)[:n]
        comp = lvh >= 0
        label[s] = counter
        counter += 1
        lab_dev = jnp.asarray(
            np.concatenate([label[:n], np.full(n_pad - n, -1)]).astype(
                np.int32
            )
        )
        lv_dev = levels
        maxlev = int(lvh.max())
        for l in range(1, maxlev + 1):
            # parent order = min previous-level label among neighbors
            prev_mask = (lv_dev == l - 1) & (lab_dev >= 0)
            pord, _ = dist_spmsv_masked(
                a, lab_dev.astype(jnp.float32) + 1.0, prev_mask,
                MIN_SECOND, transpose=True,
            )
            members = lv_dev == l
            nmem = int(jnp.sum(members))
            # rank 1: stable by (degree, id) -> permutation r1
            degkey = jnp.where(members, deg.astype(jnp.float32), jnp.inf)
            _, vid1 = dist_sort_auto(degkey, grid, ids)
            # arrange parent-order values in r1 order (position = r1 rank),
            # then sort by parent order with position tiebreak = stable
            rank1 = jnp.zeros((n_pad,), jnp.int32)
            rank1, _ = dist_route(
                vid1, ids, vid1 < n_pad, rank1, grid, combine="set"
            )  # rank1[vertex] = its (deg,id) rank
            pkey = jnp.where(members, pord, jnp.inf)
            pkey_arranged = dist_apply_perm(
                jnp.where(jnp.isfinite(pkey), pkey, jnp.inf), rank1, grid
            )
            vid_arranged = dist_apply_perm(
                jnp.where(members, ids, n_pad), rank1, grid
            )
            # out-of-component slots got 0.0 from the perm scatter: re-mask
            pkey_arranged = jnp.where(vid_arranged < n_pad, pkey_arranged,
                                      jnp.inf)
            _, vid2 = dist_sort_auto(pkey_arranged, grid,
                                      vid_arranged)
            # final label: counter + position in sorted order
            newlab = jnp.zeros((n_pad,), jnp.int32)
            pos = jnp.arange(n_pad, dtype=jnp.int32) + counter
            newlab, hit = dist_route(
                vid2, pos, (vid2 < n_pad) & (ids < nmem),
                newlab, grid, combine="set",
            )
            lab_dev = jnp.where(hit, newlab, lab_dev)
            counter += nmem
        lab_h = np.asarray(lab_dev)[:n]
        label[:n] = np.where(comp, lab_h, label[:n])
        visited |= comp
    order = np.argsort(label[:n])
    return order[::-1].copy()  # reverse (the R in RCM)


def md_order(a: SpCOO) -> jax.Array:
    """Minimum-degree ordering (``Applications/Ordering/MD.cpp`` counterpart).

    Greedy elimination with exact fill-in on a host adjacency-set quotient
    graph — ordering is a one-shot preprocessing step, so, like the
    reference's driver, it favors fidelity over device parallelism (ties
    broken by vertex id for determinism)."""
    n = a.shape[0]
    nnz = int(a.nnz)
    r = np.asarray(a.row)[:nnz]
    c = np.asarray(a.col)[:nnz]
    adj = [set() for _ in range(n)]
    for u, v in zip(r, c):
        if u != v:
            adj[u].add(int(v))
            adj[v].add(int(u))
    eliminated = np.zeros(n, bool)
    order = []
    for _ in range(n):
        best, best_deg = -1, None
        for v in range(n):
            if not eliminated[v]:
                d = len(adj[v])
                if best_deg is None or d < best_deg:
                    best, best_deg = v, d
        order.append(best)
        eliminated[best] = True
        nbrs = [u for u in adj[best] if not eliminated[u]]
        for u in nbrs:  # clique fill-in among remaining neighbors
            adj[u].discard(best)
            for w in nbrs:
                if w != u:
                    adj[u].add(w)
    return jnp.asarray(np.asarray(order, np.int32))


def _cm_order_component(a: SpCOO, parents, levels, degn) -> np.ndarray:
    """Cuthill-McKee order of one BFS component via iterative level sorting:
    within level l, sort by (position of parent in level l-1, degree)."""
    lv = np.asarray(levels)
    par = np.asarray(parents)
    n = lv.shape[0]
    maxlev = int(lv.max())
    pos = np.full(n, -1, np.int64)  # position in the CM order
    out = []
    counter = 0
    for l in range(maxlev + 1):
        members = np.nonzero(lv == l)[0]
        if l == 0:
            members = members  # the single root
            key = np.zeros(members.size)
            order = members
        else:
            parent_pos = pos[par[members]]
            sortidx = np.lexsort((members, degn[members], parent_pos))
            order = members[sortidx]
        pos[order] = counter + np.arange(order.size)
        counter += order.size
        out.append(order)
    return np.concatenate(out)


def md_order_dist(a) -> jax.Array:
    """Distributed minimum-degree ordering — ``Applications/Ordering/MD.cpp``
    (main loop ``:290-346``): per step, pick the global min-degree vertex
    (the reference's ``degrees.MinElement()`` allreduce), mark it eliminated,
    compute its reach set by a distributed BFS that traverses only
    eliminated vertices (``getReach``), and recompute the reach vertices'
    quotient-graph degrees with ONE multi-source BFS whose frontier is a
    dense n x k 0/1 matrix pushed through ``dist_spmm`` —
    ``getReachesSPMM``'s n x k SpGEMM frontier, matrix-unit-shaped (dense frontier
    beats a sparse one on the device for the k-source sweep).  Host-paced n-step
    loop, like the reference's.

    ``a``: symmetric DistSpMat (no self-loop requirement).  Ties break by
    vertex id, matching :func:`md_order` — the orders are identical."""
    import jax.numpy as jnp

    from combblas_tpu.parallel.dense import dist_spmm
    from combblas_tpu.parallel.elementwise import dist_reduce
    from combblas_tpu.parallel.spmv import dist_spmv
    from combblas_tpu.semiring import PLUS_TIMES

    n = a.gshape[0]

    @jax.jit
    def neighbor_mask(mask):
        """Bool (n_pad,) -> neighbors of any masked vertex (pattern SpMV)."""
        y = dist_spmv(a, mask.astype(jnp.float32), PLUS_TIMES)
        return y > 0

    @jax.jit
    def spmm_step(x, en_col):
        """One multi-source frontier hop restricted to eliminated vertices
        on the propagation side: Y = pattern(A) · X, X (n_pad, k)."""
        y = dist_spmm(a, x, PLUS_TIMES)
        return (y > 0).astype(jnp.float32) * 1.0

    # external degree = off-diagonal entries per row (pattern count)
    ones = dist_reduce(a, "row", premap=lambda v: (v != 0).astype(v.dtype))
    deg = np.asarray(ones)[:n].astype(np.int64)
    # subtract self-loops if present
    loc = a.to_local()
    nnzl = int(loc.nnz)
    rr = np.asarray(loc.row)[:nnzl]
    cc = np.asarray(loc.col)[:nnzl]
    deg -= np.bincount(rr[rr == cc], minlength=n)[:n]

    enodes = np.zeros(n, bool)
    order = []
    n_pad = None
    for _ in range(n):
        live_deg = np.where(enodes, n + 1, deg)
        s = int(np.argmin(live_deg))
        order.append(s)
        enodes[s] = True

        # --- getReach(s): BFS from s through eliminated vertices only ----
        en_d = jnp.asarray(enodes)
        f = np.zeros(n, bool)
        f[s] = True
        visited = f.copy()
        reach = np.zeros(n, bool)
        while f.any():
            nb = np.asarray(neighbor_mask(jnp.asarray(f)))[:n]
            nb = nb & ~visited
            if not nb.any():
                break
            visited |= nb
            reach |= nb & ~enodes
            f = nb & enodes  # keep traversing through enodes only
        srcs = np.nonzero(reach)[0]
        if srcs.size == 0:
            continue

        # --- getReachesSPMM: k-source BFS with a dense frontier ----------
        k = int(srcs.size)
        k_pad = max(8, 1 << int(np.ceil(np.log2(k))))
        X = np.zeros((n, k_pad), np.float32)
        X[srcs, np.arange(k)] = 1.0
        Xd = jnp.asarray(X)
        Vis = Xd
        while True:
            Y = spmm_step(Xd, en_d)[:n]
            Y = jnp.where(Vis[: Y.shape[0]] > 0, 0.0, Y)
            if not bool(jnp.any(Y > 0)):
                break
            Vis = jnp.maximum(Vis[: Y.shape[0]], Y)
            Xd = Y * en_d[: Y.shape[0], None]  # continue through enodes
            if not bool(jnp.any(Xd > 0)):
                break
        nen = ~enodes
        newdeg = np.asarray(
            jnp.sum(Vis[:n] * jnp.asarray(nen, jnp.float32)[:, None], axis=0)
        )[:k] - 1  # exclude the source itself
        deg[srcs] = newdeg.astype(np.int64)
    return jnp.asarray(np.asarray(order, np.int32))
