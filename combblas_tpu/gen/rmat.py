"""R-MAT (Kronecker) and Erdős–Rényi edge generators, pure JAX.

Counterpart of the reference's vendored Graph500 generator
(``RefGen21.h:88-323`` -> ``graph500-1.2/generator``: MRG splittable RNG +
recursive quadrant descent + vertex scramble) and of
``DistEdgeList::GenGraph500Data`` (``DistEdgeList.cpp:223``).  Instead of a
counter-splittable MRG stream we use JAX's threefry, which is the idiomatic
stateless parallel RNG on an accelerator: every edge's quadrant path is generated in one
(scale, nedges) batch of uniforms, fully on device, identical across runs for a
given key.  The reference's ``RenameVertices`` scramble (``DistEdgeList.cpp:364``
— load-balances the power-law degree tail across the process grid) becomes a
random permutation applied as a gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO, compress_sorted

__all__ = ["rmat_edges", "er_edges", "edges_to_coo", "rmat_matrix"]

#: Graph500 quadrant probabilities (a, b, c, d) = (.57, .19, .19, .05).
G500_PROBS = (0.57, 0.19, 0.19, 0.05)


@functools.partial(jax.jit, static_argnames=("scale", "nedges", "probs", "scramble"))
def rmat_edges(
    key: jax.Array,
    scale: int,
    nedges: int,
    probs=G500_PROBS,
    scramble: bool = True,
):
    """Generate ``nedges`` R-MAT edges over 2**scale vertices.

    Returns (rows, cols) int32 arrays.  May contain self loops and duplicates,
    exactly like the reference generator — downstream assembly dedups.
    """
    a, b, c, d = probs
    kq, kp = jax.random.split(key)
    u = jax.random.uniform(kq, (scale, nedges), jnp.float32)
    row_bit = (u >= a + b).astype(jnp.int32)
    col_bit = (
        ((u >= a) & (u < a + b)) | (u >= a + b + c)
    ).astype(jnp.int32)
    weights = (1 << jnp.arange(scale - 1, -1, -1, dtype=jnp.int32))[:, None]
    rows = jnp.sum(row_bit * weights, axis=0, dtype=jnp.int32)
    cols = jnp.sum(col_bit * weights, axis=0, dtype=jnp.int32)
    if scramble:
        n = 1 << scale
        perm = jax.random.permutation(kp, n).astype(jnp.int32)
        rows, cols = perm[rows], perm[cols]
    return rows, cols


@functools.partial(jax.jit, static_argnames=("scale", "nedges"))
def er_edges(key: jax.Array, scale: int, nedges: int):
    """Uniform Erdős–Rényi edges (reference's ER input class,
    ``3DSpGEMM/mpipspgemm.cpp``)."""
    n = 1 << scale
    k1, k2 = jax.random.split(key)
    rows = jax.random.randint(k1, (nedges,), 0, n, jnp.int32)
    cols = jax.random.randint(k2, (nedges,), 0, n, jnp.int32)
    return rows, cols


@functools.partial(
    jax.jit,
    static_argnames=("shape", "out_capacity", "remove_self_loops", "symmetrize"),
)
def edges_to_coo(
    rows: jax.Array,
    cols: jax.Array,
    shape,
    out_capacity: int,
    vals: jax.Array | None = None,
    remove_self_loops: bool = False,
    symmetrize: bool = False,
) -> SpCOO:
    """Assemble an edge list into a deduplicated sorted SpCOO — fully on
    device.  The distributed-assembly counterpart of ``SparseCommon``
    (``SpParMat.cpp:2893``); duplicate edges are summed.
    """
    m, n = shape
    if vals is None:
        vals = jnp.ones(rows.shape, jnp.float32)
    if symmetrize:
        rows, cols = jnp.concatenate([rows, cols]), jnp.concatenate([cols, rows])
        vals = jnp.concatenate([vals, vals])
    valid = jnp.ones(rows.shape, jnp.bool_)
    if remove_self_loops:
        valid = rows != cols
    r = jnp.where(valid, rows, m)
    c = jnp.where(valid, cols, n)
    v = jnp.where(valid, vals, 0)
    # Move invalid entries to the end by sorting on validity first.
    r, c, v = jax.lax.sort((r, c, v), num_keys=2)
    nvalid = jnp.sum(valid.astype(jnp.int32))
    return compress_sorted(r, c, v, nvalid, (m, n), out_capacity=out_capacity)


def rmat_matrix(
    key: jax.Array,
    scale: int,
    edgefactor: int = 16,
    symmetrize: bool = False,
    remove_self_loops: bool = False,
    probs=G500_PROBS,
) -> SpCOO:
    """Host convenience: R-MAT adjacency matrix as SpCOO with unit values."""
    n = 1 << scale
    nedges = edgefactor * n
    rows, cols = rmat_edges(key, scale, nedges, probs)
    cap_mult = 4 if symmetrize else 2
    out_cap = max(8, 1 << int(np.ceil(np.log2(nedges * (2 if symmetrize else 1)))))
    return edges_to_coo(
        rows,
        cols,
        (n, n),
        out_cap,
        remove_self_loops=remove_self_loops,
        symmetrize=symmetrize,
    )
