"""LACC — linear-algebraic connected components (Awerbuch–Shiloach).

Counterpart of ``Applications/CC.h`` (LACC, IPDPS'19):
``StarCheck`` (``CC.h:1070,1126``), ``ConditionalHook`` (``:1195``),
``UnconditionalHook2`` (``:1243``), shortcutting, driver ``CC()``
(``CC.h:1405``).  The parent vector is dense int32; every hook is a
segment-min over the edge stream plus a scatter-min, and star membership is
two gathers — the same vectorization strategy as FastSV
(:mod:`combblas_tpu.models.cc`), kept as a separate algorithm for parity and
cross-validation (the reference ships both)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.spmv import spmv
from combblas_tpu.semiring import MIN_SECOND

__all__ = ["lacc_local", "lacc_dist"]


def _star_check(f):
    """star[v] = v belongs to a star (its tree is depth <= 1) — ``CC.h:1070``."""
    n = f.shape[0]
    gf = f[f]
    star = gf == f
    # non-star roots poison their trees: if gf != f, neither v, f[v] nor gf[v]
    # head a star
    bad = gf != f
    star = star.at[jnp.where(bad, f, n)].set(False, mode="drop")
    star = star.at[jnp.where(bad, gf, n)].set(False, mode="drop")
    # inherit star status from parent (depth-1 vertices)
    return star[f]


@jax.jit
def lacc_local(a: SpCOO) -> jax.Array:
    """Component labels for a symmetric graph (min vertex id per component)."""
    n = a.shape[0]
    f0 = jnp.arange(n, dtype=jnp.int32)

    def cond(c):
        _, changed = c
        return changed

    def body(c):
        f, _ = c
        star = _star_check(f)
        # neighbor-parent minima: y[u] = min over neighbors v of f[v];
        # empty rows carry the int32 max identity, neutral under min below
        y = spmv(a, f, MIN_SECOND)
        y = jnp.minimum(y, f)
        # conditional hooking (CC.h:1195): star vertices hook their root onto
        # a strictly smaller neighbouring parent
        hook_to = jnp.where(star & (y < f), y, jnp.iinfo(jnp.int32).max)
        f1 = f.at[f].min(hook_to)
        # unconditional hooking (CC.h:1243): remaining stars hook onto any
        # neighbour parent (ties by min), even equal trees — guarantees progress
        star2 = _star_check(f1)
        hook2 = jnp.where(star2 & (y != f1), y, jnp.iinfo(jnp.int32).max)
        f2 = f1.at[f1].min(hook2)
        # shortcut
        f3 = jnp.minimum(f2[f2], f2)
        return f3, jnp.any(f3 != f)

    f, _ = jax.lax.while_loop(cond, body, (f0, jnp.asarray(True)))
    return f


@jax.jit
def lacc_dist(a) -> jax.Array:
    """Distributed LACC: neighbor-parent minima via the mesh SpMV pipeline,
    hooks on the FullyDist parent vector (``CC()`` driver, ``CC.h:1405``)."""
    from combblas_tpu.parallel.dist import col_vec_len
    from combblas_tpu.parallel.spmv import dist_spmv

    n_pad = col_vec_len(a.gshape, a.grid)
    f0 = jnp.arange(n_pad, dtype=jnp.int32)

    def cond(c):
        _, changed = c
        return changed

    def body(c):
        f, _ = c
        star = _star_check(f)
        y = dist_spmv(a, f, MIN_SECOND)[:n_pad]
        y = jnp.minimum(y, f)
        hook_to = jnp.where(star & (y < f), y, jnp.iinfo(jnp.int32).max)
        f1 = f.at[f].min(hook_to)
        star2 = _star_check(f1)
        hook2 = jnp.where(star2 & (y != f1), y, jnp.iinfo(jnp.int32).max)
        f2 = f1.at[f1].min(hook2)
        f3 = jnp.minimum(f2[f2], f2)
        return f3, jnp.any(f3 != f)

    f, _ = jax.lax.while_loop(cond, body, (f0, jnp.asarray(True)))
    return f
