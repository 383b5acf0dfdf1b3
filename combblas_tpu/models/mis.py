"""Maximal independent set — Luby's algorithm.

Counterpart of ``Applications/FilteredMIS.cpp:147`` (Luby's MIS via
SpMV rounds over candidate random values).  Dense-vector formulation: each
round draws random priorities for live vertices, a vertex joins the MIS when
its priority beats every live neighbor's (one (max, select2nd)-style SpMV),
then winners' neighborhoods are removed.  Expected O(log n) rounds, each a
single segment-max pass — no sparse-vector machinery needed at device bandwidth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.spmv import spmv
from combblas_tpu.semiring import MAX_SECOND

__all__ = ["luby_mis", "luby_mis_dist"]


@jax.jit
def luby_mis(a: SpCOO, key: jax.Array) -> jax.Array:
    """Boolean MIS membership for a symmetric graph with empty diagonal."""
    n = a.shape[0]

    def cond(c):
        _, live, _ = c
        return jnp.any(live)

    def body(c):
        in_set, live, k = c
        k, sub = jax.random.split(k)
        pri = jax.random.uniform(sub, (n,), jnp.float32) + 1.0
        pri = jnp.where(live, pri, 0.0)  # dead vertices never win/block
        nbr_best = spmv(a, pri, MAX_SECOND)  # max priority among neighbors
        nbr_best = jnp.where(jnp.isfinite(nbr_best), nbr_best, 0.0)
        winners = live & (pri > nbr_best)
        # remove winners and their neighborhoods from the live set
        hit = spmv(a, winners.astype(jnp.float32), MAX_SECOND)
        hit = jnp.where(jnp.isfinite(hit), hit, 0.0) > 0
        live = live & ~winners & ~hit
        return in_set | winners, live, k

    in_set0 = jnp.zeros((n,), jnp.bool_)
    live0 = jnp.ones((n,), jnp.bool_)
    in_set, _, _ = jax.lax.while_loop(cond, body, (in_set0, live0, key))
    return in_set


def luby_mis_dist(a, key: jax.Array, edge_pred=None) -> jax.Array:
    """Distributed Luby MIS on the 2D grid (``FilteredMIS.cpp:147``): each
    round is two masked SpMV fan-out/fan-ins over the mesh.  ``edge_pred``
    restricts the graph to edges passing the predicate (late filtering) —
    the distributed FilteredMIS.  Returns the boolean membership vector
    (row-space layout; padding vertices join the MIS trivially and are
    sliced off by callers)."""
    from combblas_tpu.parallel.dist import row_vec_len
    from combblas_tpu.parallel.spmv import dist_spmsv_masked

    n = a.gshape[0]
    n_pad = row_vec_len(a.gshape, a.grid)
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    real = ids < n
    in_set = jnp.zeros((n_pad,), jnp.bool_)
    live = real
    rounds = 0
    while bool(jnp.any(live)) and rounds < 4 * int(
        np.ceil(np.log2(max(n, 2))) + 4
    ):
        rounds += 1
        key, sub = jax.random.split(key)
        pri = jax.random.uniform(sub, (n_pad,), jnp.float32) + 1.0
        pri = jnp.where(live, pri, 0.0)
        nbr_best, hit0 = dist_spmsv_masked(
            a, pri, live, MAX_SECOND, transpose=False, edge_pred=edge_pred
        )
        nbr_best = jnp.where(hit0, nbr_best, 0.0)
        winners = live & (pri > nbr_best)
        blocked, hitw = dist_spmsv_masked(
            a, winners.astype(jnp.float32), winners, MAX_SECOND,
            transpose=False, edge_pred=edge_pred,
        )
        dead = hitw & (blocked > 0)
        in_set = in_set | winners
        live = live & ~winners & ~dead
    return in_set
