"""SpRef / SpAsgn — matlab-style submatrix extraction and assignment.

Counterpart of ``SpParMat::SubsRef_SR`` (``SpParMat.cpp:2028-2250``,
where indexing *is* SpGEMM: extraction matrices P (|ri|×m) and Q (n×|ci|) are
built and the result is P·A·Q) and ``SpAsgn`` (``SpParMat.cpp:2427``).

Both formulations are kept: :func:`spref` uses the selector-SpGEMM route
(exactly the reference's algorithm — it composes with the distributed SUMMA
untouched), and :func:`spref_gather`/:func:`spasgn` use direct index
translation (cheaper locally: membership masks + gathers, no products).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO, compress_sorted, sort_coo
from combblas_tpu.ops.ewise import _compact
from combblas_tpu.ops.spgemm import spgemm_auto
from combblas_tpu.semiring import PLUS_TIMES

__all__ = [
    "make_selector",
    "spref",
    "spref_gather",
    "spasgn",
    "prune_block",
    "induced_subgraph",
    "remove_loops",
    "add_loops",
    "prune_ktips",
]


def make_selector(indices, n: int, transpose: bool = False) -> SpCOO:
    """Boolean extraction matrix: (k, n) with S[i, indices[i]] = 1, or its
    (n, k) transpose.  The reference builds these with alltoalls along the
    processor row (``SpParMat.cpp:2060-2130``); here it is a host/device
    constructor."""
    indices = np.asarray(indices, np.int64)
    k = indices.shape[0]
    rows = np.arange(k, dtype=np.int64)
    if transpose:
        return SpCOO.from_arrays(indices, rows, np.ones(k, np.float32), (n, k))
    return SpCOO.from_arrays(rows, indices, np.ones(k, np.float32), (k, n))


def spref(a: SpCOO, ri, ci) -> SpCOO:
    """A(ri, ci) via P·A·Q — the reference's algorithm (``SpParMat.cpp:2028``).
    Index vectors may repeat (rows/cols are then replicated), exactly like
    matlab/SpRef semantics."""
    m, n = a.shape
    p = make_selector(ri, m)
    q = make_selector(ci, n, transpose=True)
    pa = spgemm_auto(p, a)
    return spgemm_auto(pa, q)


@functools.partial(jax.jit, static_argnames=("out_rows", "out_cols", "out_capacity"))
def spref_gather(
    a: SpCOO,
    ri: jax.Array,
    ci: jax.Array,
    *,
    out_rows: int,
    out_cols: int,
    out_capacity: int | None = None,
) -> SpCOO:
    """A(ri, ci) by direct index translation (jittable; requires ri/ci to be
    duplicate-free — the common permutation/subselection case)."""
    m, n = a.shape
    # inverse maps: old index -> new position or -1
    rinv = jnp.full((m,), -1, jnp.int32).at[ri].set(
        jnp.arange(out_rows, dtype=jnp.int32)
    )
    cinv = jnp.full((n,), -1, jnp.int32).at[ci].set(
        jnp.arange(out_cols, dtype=jnp.int32)
    )
    nr = rinv[jnp.minimum(a.row, m - 1)]
    nc = cinv[jnp.minimum(a.col, n - 1)]
    keep = a.mask() & (nr >= 0) & (nc >= 0)
    cap = a.capacity if out_capacity is None else out_capacity
    r = jnp.where(keep, nr, out_rows)
    c = jnp.where(keep, nc, out_cols)
    v = jnp.where(keep, a.val, 0)
    r, c, v = jax.lax.sort((r, c, v), num_keys=2)
    nvalid = jnp.sum(keep.astype(jnp.int32))
    return compress_sorted(r, c, v, nvalid, (out_rows, out_cols),
                           out_capacity=cap)


def prune_block(a: SpCOO, ri, ci, out_capacity: int | None = None) -> SpCOO:
    """Remove all entries in rows ri × cols ci (``SpParMat::Prune(ri,ci)``)."""
    m, n = a.shape
    ri = jnp.asarray(ri, jnp.int32)
    ci = jnp.asarray(ci, jnp.int32)
    in_r = jnp.zeros((m,), jnp.bool_).at[ri].set(True)
    in_c = jnp.zeros((n,), jnp.bool_).at[ci].set(True)
    hit = in_r[jnp.minimum(a.row, m - 1)] & in_c[jnp.minimum(a.col, n - 1)]
    return _compact(a, ~hit, out_capacity)


def induced_subgraph(a: SpCOO, vertices) -> SpCOO:
    """Subgraph induced by a vertex set (``InducedSubgraphs2Procs``,
    ``SpParMat.h:108``): A(v, v) by index translation."""
    vertices = np.asarray(vertices)
    k = vertices.shape[0]
    import jax.numpy as _jnp

    return spref_gather(
        a, _jnp.asarray(vertices), _jnp.asarray(vertices),
        out_rows=int(k), out_cols=int(k),
    )


def remove_loops(a: SpCOO) -> SpCOO:
    """Drop diagonal entries (``SpParMat::RemoveLoops``, ``SpParMat.cpp:3257``)."""
    return _compact(a, a.row != a.col)


def add_loops(a: SpCOO, value=1.0, out_capacity: int | None = None) -> SpCOO:
    """Set diagonal entries to ``value`` where absent
    (``SpParMat::AddLoops``, ``SpParMat.cpp:3294``)."""
    from combblas_tpu.ops.coo import merge
    from combblas_tpu.ops.ewise import ewise_apply

    n = min(a.shape)
    eye = SpCOO.from_arrays(
        np.arange(n), np.arange(n),
        np.full(n, value, np.asarray(a.val).dtype), a.shape,
    )
    # union, keeping A's value where the diagonal already exists
    return ewise_apply(
        a, eye, _keep_a_else_b, mode="union",
        out_capacity=out_capacity or (a.capacity + eye.capacity),
    )


def _keep_a_else_b(x, y):
    import jax.numpy as _jnp

    return _jnp.where(x != 0, x, y)


def prune_ktips(a: SpCOO, k: int = 1, rounds: int | None = None) -> SpCOO:
    """Iteratively remove "tip" vertices of degree <= k (genome-assembly
    k-tips pruning, ``ReleaseTests/KTipsTest``): drop all edges incident to
    low-degree vertices until fixpoint (or ``rounds`` iterations)."""
    from combblas_tpu.ops.reduce import nnz_per
    import jax.numpy as _jnp

    rounds = rounds if rounds is not None else a.shape[0]
    cur = a
    for _ in range(rounds):
        deg = nnz_per(cur, "row") + nnz_per(cur, "col")
        tip = deg <= k
        m, n = cur.shape
        hit = tip[_jnp.minimum(cur.row, m - 1)] | tip[_jnp.minimum(cur.col, n - 1)]
        hit = hit & cur.mask()
        if int(_jnp.sum(hit)) == 0:
            break
        nxt = _compact(cur, ~hit)
        cur = nxt
    return cur


def spasgn(a: SpCOO, ri, ci, b: SpCOO, out_capacity: int | None = None) -> SpCOO:
    """A(ri, ci) = B (``SpParMat::SpAsgn``, ``SpParMat.cpp:2427``): clear the
    ri×ci block of A, then splice B's entries translated through ri/ci."""
    m, n = a.shape
    ri = jnp.asarray(ri, jnp.int32)
    ci = jnp.asarray(ci, jnp.int32)
    cleared = prune_block(a, ri, ci, out_capacity=a.capacity)
    # translate B entries: (i, j) -> (ri[i], ci[j])
    kb_r, kb_c = b.shape
    br = ri[jnp.minimum(b.row, kb_r - 1)]
    bc = ci[jnp.minimum(b.col, kb_c - 1)]
    valid = b.mask()
    emb = SpCOO(
        row=jnp.where(valid, br, m),
        col=jnp.where(valid, bc, n),
        val=jnp.where(valid, b.val, 0),
        nnz=b.nnz,
        shape=(m, n),
    )
    emb = sort_coo(emb)
    from combblas_tpu.ops.coo import merge

    cap = out_capacity if out_capacity is not None else a.capacity + b.capacity
    return merge(cleared, emb, PLUS_TIMES, out_capacity=cap)
