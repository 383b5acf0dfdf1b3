"""Betweenness centrality — batched Brandes.

Counterpart of ``Applications/BetwCent.cpp:61-237``: the reference
processes batches of source vertices, doing the forward BFS wave by SpGEMM of
a boolean fringe (``:185``) and the dependency back-propagation with
``DenseParMat``.  Here the wavefronts are dense (n, batch) matrices, so the
per-level step is a single sparse×dense SpMM that lands on the
gather/segment-sum bandwidth path (and on the matrix units when lowered densely) —
exactly the shape the hardware wants.

Forward pass records each level's fringe; the level loop is host-driven (trip
count = graph diameter, data-dependent and small) with all per-level math
jitted.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.spmv import spmm
from combblas_tpu.semiring import PLUS_TIMES

__all__ = ["betweenness_centrality", "betweenness_centrality_dist"]


@jax.jit
def _forward_step(at: SpCOO, fringe, nsp):
    """One BFS wave: paths arriving at new vertices via current fringe."""
    new = spmm(at, fringe)  # (n, b) path counts pushed one step
    new = jnp.where(nsp > 0, 0.0, new)  # only undiscovered vertices
    return new, nsp + new


@jax.jit
def _backward_step(a: SpCOO, fringe_prev, fringe_d, nsp, bcu):
    """Brandes dependency accumulation for one level (deepest first).

    bcu tracks 1 + delta.  For every BFS-DAG edge (v, w) — v at level d-1,
    w at level d — delta[v] += nsp[v]/nsp[w] * bcu[w]; the level masks make
    exactly the level-(d-1) -> level-d edges contribute.
    """
    w_term = jnp.where(fringe_d > 0, bcu / jnp.maximum(nsp, 1e-30), 0.0)
    pulled = spmm(a, w_term)  # sum over out-neighbors w at level d
    return bcu + jnp.where(fringe_prev > 0, pulled * nsp, 0.0)


def betweenness_centrality(
    a: SpCOO,
    batch_size: int = 32,
    sources: Optional[np.ndarray] = None,
    normalize: bool = False,
) -> np.ndarray:
    """Approximate (sampled) or exact BC scores.

    ``sources=None`` uses every vertex (exact BC); otherwise the given sample
    (the reference's ``BetwCent 〈file〉 〈batches〉`` sampling mode).
    """
    n = a.shape[0]
    at = a.transpose()
    if sources is None:
        sources = np.arange(n)
    sources = np.asarray(sources)
    bc = np.zeros(n, np.float64)

    for lo in range(0, len(sources), batch_size):
        batch = sources[lo : lo + batch_size]
        b = len(batch)
        fringe = np.zeros((n, b), np.float32)
        fringe[batch, np.arange(b)] = 1.0
        fringe = jnp.asarray(fringe)
        nsp = fringe
        fringes = [fringe]
        # forward: expand until no new vertices are reached
        while True:
            fringe, nsp = _forward_step(at, fringe, nsp)
            if float(jnp.sum(fringe)) == 0.0:
                break
            fringes.append(fringe)
        # backward: deepest level first
        bcu = jnp.ones((n, b), jnp.float32)
        for depth in range(len(fringes) - 1, 0, -1):
            bcu = _backward_step(a, fringes[depth - 1], fringes[depth], nsp, bcu)
        # accumulate (exclude the +1 self term and source columns)
        contrib = np.asarray((bcu - 1.0) * (nsp > 0), np.float64).sum(axis=1)
        contrib[batch] -= np.asarray(
            ((bcu - 1.0) * (nsp > 0))[batch, np.arange(b)]
        )
        bc += contrib
    if normalize and n > 2:
        bc /= (n - 1) * (n - 2)
    return bc


def betweenness_centrality_dist(
    a, batch_size: int = 32, sources: Optional[np.ndarray] = None
) -> np.ndarray:
    """Distributed batched Brandes: wavefronts are (n_padded, batch) dense
    matrices sharded over the grid, each level one ``dist_spmm``
    (``BetwCent.cpp:179``'s PSpGEMM fringe becomes sparse×dense on the mesh,
    the back-propagation a second dist_spmm).  ``a``: DistSpMat, symmetric."""
    import jax.numpy as jnp

    from combblas_tpu.parallel.dense import dist_spmm
    from combblas_tpu.parallel.dist import col_vec_len, row_vec_len
    from combblas_tpu.parallel.elementwise import dist_transpose

    n = a.gshape[0]
    at = dist_transpose(a)
    n_pad = col_vec_len(a.gshape, a.grid)
    if sources is None:
        sources = np.arange(n)
    sources = np.asarray(sources)
    bc = np.zeros(n, np.float64)
    for lo in range(0, len(sources), batch_size):
        batch = sources[lo : lo + batch_size]
        b = len(batch)
        fr = np.zeros((n_pad, b), np.float32)
        fr[batch, np.arange(b)] = 1.0
        fringe = jnp.asarray(fr)
        nsp = fringe
        fringes = [fringe]
        while True:
            new = dist_spmm(at, fringe)[:n_pad]
            new = jnp.where(nsp > 0, 0.0, new)
            if float(jnp.sum(new)) == 0.0:
                break
            nsp = nsp + new
            fringe = new
            fringes.append(fringe)
        bcu = jnp.ones((n_pad, b), jnp.float32)
        for d in range(len(fringes) - 1, 0, -1):
            w_term = jnp.where(
                fringes[d] > 0, bcu / jnp.maximum(nsp, 1e-30), 0.0
            )
            pulled = dist_spmm(a, w_term)[:n_pad]
            bcu = bcu + jnp.where(fringes[d - 1] > 0, pulled * nsp, 0.0)
        contrib = np.asarray((bcu - 1.0) * (nsp > 0), np.float64)[:n].sum(axis=1)
        dd = np.asarray((bcu - 1.0) * (nsp > 0))
        contrib[batch] -= dd[batch, np.arange(b)]
        bc += contrib
    return bc
