"""Connected components — FastSV (and the LACC-style star hooks).

Counterpart of ``Applications/FastSV.h`` (grandparent shortcutting
via ``SpMV<Select2ndMinSR>``, hooks at ``FastSV.h:347-365``, scatter ``Assign``
at ``:133``) and the driver ``FastSV.cpp:70``.  The parent vector is a dense
int32 array; one iteration is:

    gf   = f[f]                                   (grandparent gather)
    y[u] = min over neighbors v of gf[v]          (SpMV over (min, select2nd))
    f[f[u]] <- min(f[f[u]], y[u])                 (stochastic hooking, scatter-min)
    f[u]    <- min(f[u],    y[u])                 (aggressive hooking)
    f       <- f[f]                               (shortcutting)

converging when f stops changing — all gathers/scatters/segment ops, no
pointer chasing.  Works identically on a local SpCOO (jnp ops) and a
DistSpMat (dist_spmv + global scatter, vectors replicated per device — at
graph scales a length-n int32 vector is small against HBM).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.spmv import spmv
from combblas_tpu.parallel.dist import DistSpMat, col_vec_len
from combblas_tpu.parallel.spmv import dist_spmv
from combblas_tpu.semiring import MIN_SECOND

__all__ = ["fastsv_local", "fastsv_dist", "count_components"]


def _fastsv_body(f, y):
    """Shared hook/shortcut step given the neighbor-grandparent minima y."""
    y = jnp.minimum(y, f[f])  # never regress; empty rows carry +inf identity
    f = f.at[f].min(y)  # stochastic hooking onto parents
    f = jnp.minimum(f, y)  # aggressive hooking onto self
    f = f[f]  # shortcutting
    return f


@jax.jit
def fastsv_local(a: SpCOO) -> jax.Array:
    """Component labels (min vertex id per component) for a symmetric graph."""
    n = a.shape[0]
    f0 = jnp.arange(n, dtype=jnp.int32)

    def cond(c):
        f, changed = c
        return changed

    def body(c):
        f, _ = c
        gf = f[f]
        y = spmv(a, gf, MIN_SECOND)  # min over neighbors' grandparents
        fn = _fastsv_body(f, y)
        return fn, jnp.any(fn != f)

    f, _ = jax.lax.while_loop(cond, body, (f0, jnp.asarray(True)))
    return f


@jax.jit
def fastsv_dist(a: DistSpMat) -> jax.Array:
    """Distributed FastSV: the neighbor-min SpMV runs over the mesh; the parent
    vector lives in the FullyDist layout and hooks via global scatter-min
    (XLA lowers cross-shard scatters to collectives)."""
    assert a.gshape[0] == a.gshape[1]
    n_pad = col_vec_len(a.gshape, a.grid)
    f0 = jnp.arange(n_pad, dtype=jnp.int32)

    def cond(c):
        f, changed = c
        return changed

    def body(c):
        f, _ = c
        gf = f[f]
        y = dist_spmv(a, gf, MIN_SECOND)
        fn = _fastsv_body(f, y[:n_pad])
        return fn, jnp.any(fn != f)

    f, _ = jax.lax.while_loop(cond, body, (f0, jnp.asarray(True)))
    return f


def count_components(labels, n: int | None = None) -> int:
    """Host helper: number of distinct component labels among the first n
    vertices (padding vertices are their own singleton labels)."""
    import numpy as np

    labels = np.asarray(labels)
    if n is not None:
        labels = labels[:n]
    return int(np.unique(labels).size)
