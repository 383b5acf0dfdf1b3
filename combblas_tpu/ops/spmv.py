"""Local SpMV / SpMSpV / SpMM kernels over semirings.

Replacements for the reference's local matrix-vector family:
``Friends.h:64`` (``dcsc_gespmv`` dense-x SpMV), ``SpImpl.cpp:57-701``
(SpMSpV kernels with SPA/bucket/heapsort accumulation) and the dense-output
SpMM used by ``Applications/SpMMError.cpp`` / ``ReleaseTests/Roofline.cpp``.

On a data-parallel device the natural formulation of all of these is gather +
segment reduction over the COO triple stream — no per-column heaps, no SPAs:
the entire matrix's products are formed in one vector pass and reduced with
the semiring add.  Sparse vectors are represented *densely* (value vector +
validity mask), which is idiomatic for a high-bandwidth memory: the
reference's elaborate sparse frontier machinery (``OptBuf.h``,
``BitMapFringe.h``) exists to avoid touching O(n) data per BFS step on a cache
machine; here a masked dense vector compiles to regular code.  A true
index-list SpVec type lives in :mod:`combblas_tpu.ops.spvec` for API parity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = ["spmv", "spmv_transpose", "spmsv_masked", "spmm"]


def _segment_reduce(vals, seg, num_segments, sr: Semiring, out_dtype):
    if sr.add_kind == "sum":
        return jax.ops.segment_sum(vals, seg, num_segments=num_segments)
    if sr.add_kind == "min":
        out = jax.ops.segment_min(vals, seg, num_segments=num_segments)
    else:
        out = jax.ops.segment_max(vals, seg, num_segments=num_segments)
    return out


@functools.partial(jax.jit, static_argnames=("sr",))
def spmv(a: SpCOO, x: jax.Array, sr: Semiring = PLUS_TIMES) -> jax.Array:
    """y = A ·_sr x with dense x (len n) -> dense y (len m).

    y_i = add_k sr.mul(A_ik, x_k).  Rows with no nonzeros get sr.zero.
    Mirrors ``dcsc_gespmv`` (``Friends.h:64``).
    """
    m, n = a.shape
    valid = a.mask()
    prod = sr.mul(a.val, x[jnp.minimum(a.col, n - 1)])
    zero = sr.zero(prod.dtype)
    prod = jnp.where(valid, prod, zero)
    seg = jnp.where(valid, a.row, m)
    y = _segment_reduce(prod, seg, m, sr, prod.dtype)
    return y


@functools.partial(jax.jit, static_argnames=("sr",))
def spmv_transpose(a: SpCOO, x: jax.Array, sr: Semiring = PLUS_TIMES) -> jax.Array:
    """y = Aᵀ ·_sr x: y_j = add_i sr.mul(A_ij, x_i); dense x (len m) -> y (len n)."""
    m, n = a.shape
    valid = a.mask()
    prod = sr.mul(a.val, x[jnp.minimum(a.row, m - 1)])
    zero = sr.zero(prod.dtype)
    prod = jnp.where(valid, prod, zero)
    seg = jnp.where(valid, a.col, n)
    return _segment_reduce(prod, seg, n, sr, prod.dtype)


@functools.partial(jax.jit, static_argnames=("sr", "transpose"))
def spmsv_masked(
    a: SpCOO,
    x_val: jax.Array,
    x_mask: jax.Array,
    sr: Semiring = PLUS_TIMES,
    transpose: bool = False,
):
    """Masked-dense SpMSpV: sparse vector as (values, bool mask).

    Returns (y_val, y_mask): y has an entry where at least one product with an
    active x entry landed; inactive outputs hold sr.zero.  This is the
    counterpart of the reference's SpMXSpV kernels (``SpImpl.cpp:345,390``) —
    the mask replaces the SPA bitmap.
    """
    m, n = a.shape
    valid = a.mask()
    if transpose:
        src, dst, out_len, src_len = a.row, a.col, n, m
    else:
        src, dst, out_len, src_len = a.col, a.row, m, n
    src_c = jnp.minimum(src, src_len - 1)
    active = valid & x_mask[src_c]
    prod = sr.mul(a.val, x_val[src_c])
    zero = sr.zero(prod.dtype)
    prod = jnp.where(active, prod, zero)
    seg = jnp.where(active, dst, out_len)
    y = _segment_reduce(prod, seg, out_len, sr, prod.dtype)
    y_mask = (
        jax.ops.segment_max(
            active.astype(jnp.int32), seg, num_segments=out_len
        )
        > 0
    )
    y = jnp.where(y_mask, y, zero)
    return y, y_mask


@functools.partial(jax.jit, static_argnames=("sr",))
def spmm(a: SpCOO, x: jax.Array, sr: Semiring = PLUS_TIMES) -> jax.Array:
    """Sparse (m, n) × tall-dense (n, d) -> dense (m, d).

    Gather rows of X at a.col, combine with vals, segment-reduce by row."""
    m, n = a.shape
    valid = a.mask()
    xg = x[jnp.minimum(a.col, n - 1)]  # (cap, d)
    prod = sr.mul(a.val[:, None], xg)
    zero = sr.zero(prod.dtype)
    prod = jnp.where(valid[:, None], prod, zero)
    seg = jnp.where(valid, a.row, m)
    return _segment_reduce(prod, seg, m, sr, prod.dtype)
