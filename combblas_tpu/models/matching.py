"""Bipartite matchings — greedy maximal and augmenting-path maximum.

Counterpart of ``Applications/BipartiteMatchings/``:
``BPMaximalMatching.h:24`` (greedy/Karp-Sipser maximal matching via
SpMV-style propose/accept rounds) and ``BPMaximumMatching.cpp:207``
(Hopcroft-Karp-style maximum matching: BFS forests from unmatched rows over
alternating paths via ``SpMV``, then augmentation).

Rows and columns of the (m, n) sparse matrix are the two vertex classes.
Propose/accept rounds are segment-min reductions over the edge list (one vector
pass each).  The maximum-matching BFS phases are jitted; path augmentation
walks the discovered parent pointers (host loop, path-length bounded — the
reference's augment step is likewise a pointer walk, ``BPMaximumMatching.cpp``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO

__all__ = [
    "bp_maximal_matching",
    "bp_maximum_matching",
    "awpm",
    "matching_weight",
    "is_valid_matching",
]


@jax.jit
def _propose_accept(a: SpCOO, mate_row, mate_col):
    """One round: each unmatched row proposes its min unmatched neighbor
    column; each column accepts its min proposing row.  Returns updated
    (mate_row, mate_col, progressed)."""
    m, n = a.shape
    valid = a.mask()
    r = jnp.minimum(a.row, m - 1)
    c = jnp.minimum(a.col, n - 1)
    open_edge = valid & (mate_row[r] < 0) & (mate_col[c] < 0)
    # row -> min open neighbor col
    prop = jax.ops.segment_min(
        jnp.where(open_edge, c, n), jnp.where(valid, a.row, m), num_segments=m
    )
    has_prop = prop < n
    # col <- min proposing row
    prop_c = jnp.where(has_prop, prop, n)
    acc = jax.ops.segment_min(
        jnp.where(has_prop, jnp.arange(m, dtype=jnp.int32), m),
        prop_c,
        num_segments=n + 1,
    )[:n]
    rows_idx = jnp.arange(m, dtype=jnp.int32)
    won = has_prop & (acc[jnp.minimum(prop, n - 1)] == rows_idx)
    new_mate_row = jnp.where(won, prop, mate_row)
    new_mate_col = mate_col.at[jnp.where(won, prop, n)].set(
        jnp.where(won, rows_idx, -1), mode="drop"
    )
    return new_mate_row, new_mate_col, jnp.any(won)


def bp_maximal_matching(a: SpCOO) -> Tuple[jax.Array, jax.Array]:
    """Greedy maximal matching: (mate_row[m], mate_col[n]), -1 = unmatched.
    Equivalent to the reference's ``MaximalMatching`` greedy init
    (``BPMaximalMatching.h:24``)."""
    m, n = a.shape
    mate_row = jnp.full((m,), -1, jnp.int32)
    mate_col = jnp.full((n,), -1, jnp.int32)
    while True:
        mate_row, mate_col, progressed = _propose_accept(a, mate_row, mate_col)
        if not bool(progressed):
            break
    return mate_row, mate_col


@jax.jit
def _alt_bfs(a: SpCOO, mate_row, mate_col):
    """Alternating-path BFS from all unmatched rows (one Hopcroft-Karp phase).

    Returns (parent_col[n]: discovering row or -1, reachable free cols mask).
    Row layers advance through matched-column edges only, so every discovered
    column lies on an alternating path from a free row.
    """
    m, n = a.shape
    valid = a.mask()
    r = jnp.minimum(a.row, m - 1)
    c = jnp.minimum(a.col, n - 1)

    def cond(s):
        frontier, parent_col, visited_col, progressed = s
        return progressed

    def body(s):
        frontier, parent_col, visited_col, _ = s
        active = valid & frontier[r] & ~visited_col[c]
        # each newly reached col records one discovering row (max wins; any is fine)
        disc = jax.ops.segment_max(
            jnp.where(active, a.row, -1), jnp.where(active, a.col, n),
            num_segments=n + 1,
        )[:n]
        newly = disc >= 0
        parent_col = jnp.where(newly & (parent_col < 0), disc, parent_col)
        visited_col = visited_col | newly
        # advance through matched edges: next row frontier = mates of newly
        # discovered *matched* columns
        next_rows = jnp.where(newly, mate_col, -1)
        frontier2 = jnp.zeros((m,), jnp.bool_).at[
            jnp.where(next_rows >= 0, next_rows, m)
        ].set(next_rows >= 0, mode="drop")
        return frontier2, parent_col, visited_col, jnp.any(newly)

    frontier0 = mate_row < 0
    parent0 = jnp.full((n,), -1, jnp.int32)
    visited0 = jnp.zeros((n,), jnp.bool_)
    _, parent_col, visited_col, _ = jax.lax.while_loop(
        cond, body, (frontier0, parent0, visited0, jnp.asarray(True))
    )
    free_cols = visited_col & (mate_col < 0)
    return parent_col, free_cols


def bp_maximum_matching(a: SpCOO, init=None) -> Tuple[jax.Array, jax.Array]:
    """Maximum-cardinality matching: greedy init (or caller-provided
    matching) + augmenting phases (``BPMaximumMatching.cpp:207`` pattern).
    Each phase runs one jitted alternating BFS and augments a vertex-disjoint
    set of the discovered paths."""
    mate_row, mate_col = bp_maximal_matching(a) if init is None else init
    m, n = a.shape
    mate_row = np.asarray(mate_row).copy()
    mate_col = np.asarray(mate_col).copy()
    # host copies of parent structure per phase
    while True:
        parent_col, free_cols = _alt_bfs(
            a, jnp.asarray(mate_row), jnp.asarray(mate_col)
        )
        parent_col = np.asarray(parent_col)
        free = np.nonzero(np.asarray(free_cols))[0]
        if free.size == 0:
            break
        # row -> discovering col (for walking back through matched edges)
        used_row = np.zeros(m, bool)
        used_col = np.zeros(n, bool)
        augmented = 0
        for c0 in free:
            # walk the path first to check disjointness
            path = []
            c = int(c0)
            ok = True
            while True:
                r = int(parent_col[c])
                if r < 0 or used_row[r] or used_col[c]:
                    ok = False
                    break
                path.append((r, c))
                prev_c = int(mate_row[r])
                if prev_c < 0:
                    break
                c = prev_c
            if not ok or not path:
                continue
            for r, c in path:
                used_row[r] = True
                used_col[c] = True
            for r, c in path:
                mate_row[r] = c
                mate_col[c] = r
            augmented += 1
        if augmented == 0:
            break
    return jnp.asarray(mate_row), jnp.asarray(mate_col)


@jax.jit
def _dominant_round(a: SpCOO, mate_row, mate_col):
    """One locally-dominant round: match edges that are the heaviest incident
    edge for BOTH endpoints (Preis / Manne–Bisseling ½-approx step — the
    engine of the reference's approximate weight matching,
    ``ApproxWeightPerfectMatching.h:792``)."""
    m, n = a.shape
    valid = a.mask()
    r = jnp.minimum(a.row, m - 1)
    c = jnp.minimum(a.col, n - 1)
    open_e = valid & (mate_row[r] < 0) & (mate_col[c] < 0)
    neg = jnp.float32(-jnp.inf)
    w = jnp.where(open_e, a.val, neg)
    rmax = jax.ops.segment_max(w, jnp.where(valid, a.row, m), num_segments=m)
    cmax = jax.ops.segment_max(w, jnp.where(valid, a.col, n), num_segments=n)
    # dominant edge: achieves both endpoint maxima (ties broken by min col
    # then min row so each vertex picks one edge deterministically)
    is_best = open_e & (w == rmax[r]) & (w == cmax[c])
    # row's chosen col among its best edges
    chosen_c = jax.ops.segment_min(
        jnp.where(is_best, c, n), jnp.where(valid, a.row, m), num_segments=m
    )
    chosen_r = jax.ops.segment_min(
        jnp.where(is_best, r, m), jnp.where(valid, a.col, n), num_segments=n
    )
    rows_idx = jnp.arange(m, dtype=jnp.int32)
    agree = (chosen_c < n) & (
        chosen_r[jnp.minimum(chosen_c, n - 1)] == rows_idx
    )
    new_mate_row = jnp.where(agree, chosen_c, mate_row)
    new_mate_col = mate_col.at[jnp.where(agree, chosen_c, n)].set(
        jnp.where(agree, rows_idx, -1), mode="drop"
    )
    return new_mate_row, new_mate_col, jnp.any(agree)


def awpm(a: SpCOO, complete: bool = True):
    """Approximate-weight (perfect) matching
    (``ApproxWeightPerfectMatching.h:792,1144``): locally-dominant weighted
    rounds give a ½-approximation of the maximum weight; ``complete=True``
    then augments cardinality on the unmatched residual (weight-oblivious) so
    the matching is perfect whenever one exists, mirroring the reference's
    maximal+augment composition."""
    m, n = a.shape
    mate_row = jnp.full((m,), -1, jnp.int32)
    mate_col = jnp.full((n,), -1, jnp.int32)
    while True:
        mate_row, mate_col, progressed = _dominant_round(a, mate_row, mate_col)
        if not bool(progressed):
            break
    if complete:
        # cardinality completion: augment on the FULL graph seeded with the
        # weighted matching — alternating-path augmentation keeps every
        # matched vertex matched, so weight survives while cardinality
        # reaches maximum (ApproxWeightPerfectMatching.h:1144 composition).
        mate_row, mate_col = bp_maximum_matching(
            a, init=(mate_row, mate_col)
        )
    return mate_row, mate_col


def matching_weight(a_dense, mate_row) -> float:
    import numpy as _np

    a_dense = _np.asarray(a_dense)
    mr = _np.asarray(mate_row)
    return float(sum(a_dense[r, c] for r, c in enumerate(mr) if c >= 0))


def is_valid_matching(a_dense, mate_row, mate_col) -> bool:
    """Host check: mates are consistent, edges exist."""
    a_dense = np.asarray(a_dense)
    mate_row = np.asarray(mate_row)
    mate_col = np.asarray(mate_col)
    for r, c in enumerate(mate_row):
        if c >= 0:
            if a_dense[r, c] == 0 or mate_col[c] != r:
                return False
    for c, r in enumerate(mate_col):
        if r >= 0 and mate_row[r] != c:
            return False
    return True
