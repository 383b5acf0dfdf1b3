"""Algebraic-multigrid restriction: MIS-2 coarsening and Galerkin products.

Counterpart of ``3DSpGEMM/RestrictionOp.h`` (MIS-2 at ``:118``,
restriction triple product R·A·Rᵀ at ``:197``) and the Galerkin test drivers
(``ReleaseTests/Galerkin.cpp``, ``GalerkinNew.cpp:105-112`` — S·A·Sᵀ with
permutations).

MIS-2 is Luby over the distance-2 neighborhood: a vertex wins when its random
priority beats every vertex within two hops — two chained (max, select2nd)
SpMV passes per round.  The restriction matrix maps every vertex to its
nearest MIS-2 coarse vertex; the coarse operator is two semiring SpGEMMs.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.spgemm import spgemm_auto
from combblas_tpu.ops.spmv import spmv
from combblas_tpu.semiring import MAX_SECOND, PLUS_TIMES

__all__ = [
    "mis2", "restriction_op", "galerkin",
    "mis2_dist", "mis2_verify_dist", "restriction_op_dist", "galerkin_dist",
]


@jax.jit
def mis2(a: SpCOO, key: jax.Array) -> jax.Array:
    """Maximal independent set in the distance-2 graph (``RestrictionOp.h:118``)."""
    n = a.shape[0]

    def two_hop_max(x):
        h1 = spmv(a, x, MAX_SECOND)
        h1 = jnp.maximum(jnp.where(jnp.isfinite(h1), h1, 0.0), x)
        h2 = spmv(a, h1, MAX_SECOND)
        return jnp.maximum(jnp.where(jnp.isfinite(h2), h2, 0.0), h1)

    def cond(c):
        _, live, _ = c
        return jnp.any(live)

    def body(c):
        in_set, live, k = c
        k, sub = jax.random.split(k)
        pri = jnp.where(live, jax.random.uniform(sub, (n,)) + 1.0, 0.0)
        nbr2 = two_hop_max(pri)
        winners = live & (pri >= nbr2) & (pri > 0)
        # winners remove their distance-2 neighborhood from the live set
        w = winners.astype(jnp.float32)
        h1 = spmv(a, w, MAX_SECOND)
        h1 = jnp.maximum(jnp.where(jnp.isfinite(h1), h1, 0.0), w)
        h2 = spmv(a, h1, MAX_SECOND)
        hit = (jnp.maximum(jnp.where(jnp.isfinite(h2), h2, 0.0), h1)) > 0
        return in_set | winners, live & ~hit, k

    in_set, _, _ = jax.lax.while_loop(
        cond, body, (jnp.zeros((n,), jnp.bool_), jnp.ones((n,), jnp.bool_), key)
    )
    return in_set


def restriction_op(a: SpCOO, key: jax.Array) -> SpCOO:
    """Build the (ncoarse, n) restriction matrix: coarse vertices are the
    MIS-2 set; every fine vertex attaches to one adjacent coarse vertex (or
    itself).  (``RestrictionOp.h:197`` construction.)"""
    n = a.shape[0]
    in_set = np.asarray(mis2(a, key))
    coarse = np.nonzero(in_set)[0]
    cid = np.full(n, -1, np.int64)
    cid[coarse] = np.arange(coarse.size)
    # nearest coarse neighbor: one hop, else two hops, else self-coarse
    nnz = int(a.nnz)
    r = np.asarray(a.row)[:nnz]
    c = np.asarray(a.col)[:nnz]
    attach = np.full(n, -1, np.int64)
    attach[coarse] = coarse
    # one-hop attachment (min coarse neighbor id for determinism)
    for u, v in zip(r, c):
        if attach[u] < 0 and in_set[v]:
            attach[u] = v if attach[u] < 0 else min(attach[u], v)
        if attach[v] < 0 and in_set[u]:
            attach[v] = u if attach[v] < 0 else min(attach[v], u)
    # two-hop: attach to the attachment of any attached neighbor
    for _ in range(2):
        for u, v in zip(r, c):
            if attach[u] < 0 and attach[v] >= 0:
                attach[u] = attach[v]
            if attach[v] < 0 and attach[u] >= 0:
                attach[v] = attach[u]
    # isolated leftovers become their own coarse points
    left = np.nonzero(attach < 0)[0]
    if left.size:
        extra = np.arange(coarse.size, coarse.size + left.size)
        cid[left] = extra
        attach[left] = left
        coarse = np.concatenate([coarse, left])
    rows = cid[attach]
    return SpCOO.from_arrays(
        rows, np.arange(n), np.ones(n, np.float32), (coarse.size, n)
    )


def galerkin(r: SpCOO, a: SpCOO) -> SpCOO:
    """Coarse operator R·A·Rᵀ (``RestrictionOp.h:197``; test drivers
    ``ReleaseTests/GalerkinNew.cpp:105-112``)."""
    ra = spgemm_auto(r, a)
    return spgemm_auto(ra, r.transpose())


# ---------------------------------------------------------------------------
# Distributed RestrictionOp (RestrictionOp.h:118 MIS-2, :197 R and R·A·Rᵀ)
# ---------------------------------------------------------------------------

def _dist_two_hop_max(a, x):
    """max over the distance-<=2 neighborhood (incl. self) of x, distributed:
    two chained (max, select2nd) SpMVs — the reference's
    ``SpMV<Select2ndMinSR>`` loop shape (RestrictionOp.h:118)."""
    from combblas_tpu.parallel.spmv import dist_spmv

    h1 = dist_spmv(a, x, MAX_SECOND)
    xp = jnp.zeros((h1.shape[0],), x.dtype).at[: x.shape[0]].set(
        x[: h1.shape[0]])
    h1 = jnp.maximum(jnp.where(jnp.isfinite(h1), h1, 0.0), xp)
    h2 = dist_spmv(a, h1, MAX_SECOND)
    return jnp.maximum(jnp.where(jnp.isfinite(h2), h2, 0.0), h1)


def mis2_dist(a, key: jax.Array) -> np.ndarray:
    """Distributed MIS-2 (``RestrictionOp.h:118``): Luby rounds over the
    distance-2 neighborhood on the 2D mesh.  Host-paced round loop with one
    scalar liveness pull per round — the reference's ``while
    (cntUnfinished > 0)`` with its MPI allreduce.  ``a``: symmetric
    DistSpMat.  Returns a host bool array of length a.gshape[0]."""
    n = a.gshape[0]
    probe = _dist_two_hop_max(a, jnp.zeros((n,), jnp.float32))
    npad = probe.shape[0]

    @jax.jit
    def round_(in_set, live, key):
        key, sub = jax.random.split(key)
        pri = jnp.where(live, jax.random.uniform(sub, (npad,)) + 1.0, 0.0)
        nbr2 = _dist_two_hop_max(a, pri)
        winners = live & (pri >= nbr2) & (pri > 0)
        hit = _dist_two_hop_max(a, winners.astype(jnp.float32)) > 0
        return in_set | winners, live & ~hit, key

    in_set = jnp.zeros((npad,), jnp.bool_)
    live = (jnp.arange(npad) < n)
    while bool(jnp.any(live)):
        in_set, live, key = round_(in_set, live, key)
    return np.asarray(in_set)[:n]


def mis2_verify_dist(a, in_set) -> bool:
    """MIS-2 verification (the reference's ``SpMV<MIS2verifySR>`` check):
    independence — no two set vertices within distance 2 — and maximality —
    every vertex is within distance 2 of the set."""
    from combblas_tpu.parallel.spmv import dist_spmv

    n = a.gshape[0]
    s = jnp.zeros((n,), jnp.float32).at[:n].set(
        jnp.asarray(in_set, jnp.float32)[:n])
    m1 = dist_spmv(a, s, PLUS_TIMES)          # MIS neighbors per vertex
    m1 = jnp.where(jnp.isfinite(m1), m1, 0.0)
    sp = jnp.asarray(in_set)[: m1.shape[0]]
    # distance-1 violation: a set vertex with a set neighbor;
    # distance-2 violation: any vertex adjacent to >= 2 set vertices
    independent = (~jnp.any(sp & (m1[: sp.shape[0]] > 0))
                   & ~jnp.any(m1 >= 2))
    cover = _dist_two_hop_max(a, s)
    maximal = jnp.all((cover[: n] > 0) | sp[:n].astype(jnp.bool_)[: n])
    return bool(independent & maximal)


def restriction_op_dist(a, key: jax.Array):
    """Distributed restriction matrix (``RestrictionOp.h:197``): coarse
    vertices are the distributed MIS-2; every fine vertex attaches to its
    minimum-id coarse vertex within distance <= 2 (two min-select2nd SpMV
    passes on the mesh), leftovers self-coarsen.  R is assembled with the
    same one-host-layout-pass + sharded device_put as the reference's
    SpParMat ctor from distributed vectors (the ``dist_selector`` pattern,
    ``SpParMat.cpp:2060``)."""
    from combblas_tpu.parallel.dist import DistSpMat
    from combblas_tpu.parallel.spmv import dist_spmv
    from combblas_tpu.semiring import MIN_SECOND

    n = a.gshape[0]
    in_set = mis2_dist(a, key)  # host bool (n,)
    in_set_d = jnp.asarray(in_set)

    @jax.jit
    def attach_pass(in_set_d):
        inf = jnp.float32(jnp.inf)
        ids = jnp.arange(n, dtype=jnp.float32)
        x1 = jnp.where(in_set_d, ids, inf)
        att1 = dist_spmv(a, x1, MIN_SECOND)[:n]       # nearest 1-hop coarse
        att1 = jnp.where(in_set_d, ids, att1)          # coarse -> itself
        x2 = jnp.where(jnp.isfinite(att1), att1, inf)
        att2 = dist_spmv(a, x2, MIN_SECOND)[:n]       # 2-hop via attached
        return jnp.where(jnp.isfinite(att1), att1, att2)

    att = np.asarray(attach_pass(in_set_d))
    attach = np.where(np.isfinite(att), att, -1).astype(np.int64)
    # coarse ids: MIS vertices first, then self-coarsened leftovers
    cid = np.full(n, -1, np.int64)
    coarse = np.nonzero(in_set)[0]
    cid[coarse] = np.arange(coarse.size)
    left = np.nonzero(attach < 0)[0]
    if left.size:
        cid[left] = coarse.size + np.arange(left.size)
        attach[left] = left
    ncoarse = coarse.size + left.size
    rows = np.where(attach >= 0, cid[np.maximum(attach, 0)], -1)
    # vertices attached to a non-coarse vertex cannot happen (att2 values are
    # coarse ids); guard anyway
    assert (rows >= 0).all()
    return DistSpMat.from_coo_arrays(
        rows, np.arange(n), np.ones(n, np.float32), (int(ncoarse), n),
        a.grid,
    )


def galerkin_dist(r, a):
    """Distributed coarse operator R·A·Rᵀ — two SUMMA SpGEMMs + one
    distributed transpose (``RestrictionOp.h:197``,
    ``ReleaseTests/GalerkinNew.cpp:105-112``)."""
    from combblas_tpu.parallel.elementwise import dist_transpose
    from combblas_tpu.parallel.summa import summa_spgemm_auto

    ra = summa_spgemm_auto(r, a)
    return summa_spgemm_auto(ra, dist_transpose(r))
