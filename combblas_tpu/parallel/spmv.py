"""Distributed SpMV / SpMSpV over the 2D grid.

Re-design of the reference's fan-out/fan-in vector pipeline
(``ParFriends.h:1388-1881``: TransposeVector -> AllGatherVector(col world) ->
LocalSpMV -> Alltoallv(row world) -> MergeContributions).  With vectors in the
FullyDist layout (flat length-N array sharded ``P(('r','c'))``) the whole
pipeline becomes three mesh operations, each of which XLA maps to a single
collective:

  1. relayout to ``P(('c','r'))``      — the TransposeVector pair exchange
  2. ``all_gather`` over mesh axis 'r' — the column-world fan-out: afterwards
     device (i, j) holds exactly x[j·nb : (j+1)·nb], its block's column range
  3. local gather+segment-reduce SpMV  — LocalSpMV
  4. ``psum_scatter`` over axis 'c'    — the row-world fan-in *and* the merge:
     the semiring-add reduction happens inside the collective, and the
     scattered result lands exactly in FullyDist layout again.

Dense and masked-sparse (BFS frontier) variants share this skeleton; the
masked variant also reduces the output mask, mirroring ``MergeContributions``'s
index dedup (``ParFriends.h:1629``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.semiring import MAX_FIRST, PLUS_TIMES, Semiring

__all__ = ["dist_spmv", "dist_spmsv_masked", "dist_bfs_pull_masked",
           "est_nnz_spgemm_sampling"]


def _axis_reduce(x, axis: str, sr: Semiring):
    if sr.add_kind == "sum":
        return jax.lax.psum(x, axis)
    if sr.add_kind == "min":
        return jax.lax.pmin(x, axis)
    return jax.lax.pmax(x, axis)


def _axis_reduce_scatter(x, axis: str, sr: Semiring):
    """reduce_scatter with the semiring add; min/max fall back to
    psum-of-onehot-free pmax/pmin + local slice (XLA has no min/max scatter)."""
    if sr.add_kind == "sum":
        return jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)
    red = _axis_reduce(x, axis, sr)
    n_ax = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    chunk = x.shape[0] // n_ax
    return jax.lax.dynamic_slice_in_dim(red, idx * chunk, chunk, axis=0)


def _local_spmv(row, col, val, nnz, x_blk, sr: Semiring, mb: int, nb: int):
    """Per-device SpMV of the local block against its column slice of x."""
    cap = row.shape[-1]
    r = row.reshape(-1)
    c = col.reshape(-1)
    v = val.reshape(-1)
    valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
    prod = sr.mul(v, x_blk[jnp.minimum(c, nb - 1)])
    zero = sr.zero(prod.dtype)
    prod = jnp.where(valid, prod, zero)
    seg = jnp.where(valid, r, mb)
    if sr.add_kind == "sum":
        return jax.ops.segment_sum(prod, seg, num_segments=mb)
    if sr.add_kind == "min":
        return jax.ops.segment_min(prod, seg, num_segments=mb)
    return jax.ops.segment_max(prod, seg, num_segments=mb)


@functools.partial(jax.jit, static_argnames=("sr",))
def dist_spmv(a: DistSpMat, x: jax.Array, sr: Semiring = PLUS_TIMES) -> jax.Array:
    """y = A ·_sr x.  ``x``: padded global length pr*pc*ceil(n/(pr*pc))... —
    any flat array reshapable to column panels; canonical layout from
    ``dist_vec``.  Returns y in the same FullyDist layout (padded length
    pr*pc*chunk over rows)."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pr, pc = grid.pr, grid.pc
    # x padded to pc*nb so each column block is a contiguous slice.
    kx = min(x.shape[0], pc * nb)
    xp = jnp.zeros((pc * nb,), x.dtype).at[:kx].set(x[:kx])
    spec = P("r", "c", None)
    nspec = P("r", "c")

    def f(row, col, val, nnz, x_loc):
        # x_loc: this device's 1/(pr*pc) slice, laid out so that gathering over
        # 'r' yields this device column's contiguous block range.
        x_blk = jax.lax.all_gather(x_loc, "r", tiled=True)  # (nb,)
        y_part = _local_spmv(row, col, val, nnz, x_blk, sr, mb, nb)
        y_loc = _axis_reduce_scatter(y_part, "c", sr)  # (mb/pc,)
        return y_loc

    y = shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(spec, spec, spec, nspec, P(("c", "r"))),
        out_specs=P(("r", "c")),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, xp)
    return y


@functools.partial(jax.jit, static_argnames=("sr", "transpose", "edge_pred"))
def dist_spmsv_masked(
    a: DistSpMat,
    x_val: jax.Array,
    x_mask: jax.Array,
    sr: Semiring = PLUS_TIMES,
    transpose: bool = False,
    edge_pred=None,
):
    """Masked-sparse distributed SpMV: (values, mask) in, (values, mask) out.

    ``transpose=True`` computes Aᵀ ·_sr x (the BFS direction).  The active-set
    mask replaces the reference's sparse index lists + OptBuf packing
    (``OptBuf.h:43``, ``BFSFriends.h:184``)."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pr, pc = grid.pr, grid.pc
    spec = P("r", "c", None)
    nspec = P("r", "c")

    if transpose:
        in_len, out_blocks, out_b = pr * mb, pc, nb
    else:
        in_len, out_blocks, out_b = pc * nb, pr, mb

    kx = min(x_val.shape[0], in_len)
    xv = jnp.zeros((in_len,), x_val.dtype).at[:kx].set(x_val[:kx])
    xm = jnp.zeros((in_len,), jnp.bool_).at[:kx].set(x_mask[:kx])

    def f(row, col, val, nnz, xv_loc, xm_loc):
        cap = row.shape[-1]
        r = row.reshape(-1)
        c = col.reshape(-1)
        v = val.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        if transpose:
            # x indexed by rows (gather over 'c'); output over columns.
            x_blk = jax.lax.all_gather(xv_loc, "c", tiled=True)  # (mb,)
            m_blk = jax.lax.all_gather(xm_loc, "c", tiled=True)
            src, dst, src_n, dst_n, red_ax = r, c, mb, nb, "r"
        else:
            x_blk = jax.lax.all_gather(xv_loc, "r", tiled=True)  # (nb,)
            m_blk = jax.lax.all_gather(xm_loc, "r", tiled=True)
            src, dst, src_n, dst_n, red_ax = c, r, nb, mb, "c"
        srcc = jnp.minimum(src, src_n - 1)
        active = valid & m_blk[srcc]
        if edge_pred is not None:
            # late filtering (SemanticGraph / FilteredBFS.cpp:129): the edge
            # predicate fuses into the traversal as one vector compare per edge
            active = active & edge_pred(v)
        prod = sr.mul(v, x_blk[srcc])
        zero = sr.zero(prod.dtype)
        prod = jnp.where(active, prod, zero)
        seg = jnp.where(active, dst, dst_n)
        if sr.add_kind == "sum":
            y_part = jax.ops.segment_sum(prod, seg, num_segments=dst_n)
        elif sr.add_kind == "min":
            y_part = jax.ops.segment_min(prod, seg, num_segments=dst_n)
        else:
            y_part = jax.ops.segment_max(prod, seg, num_segments=dst_n)
        hit = jax.ops.segment_max(
            active.astype(jnp.int32), seg, num_segments=dst_n
        )
        y_loc = _axis_reduce_scatter(y_part, red_ax, sr)
        hit_loc = _axis_reduce_scatter(hit, red_ax, MAX_FIRST)
        y_loc = jnp.where(hit_loc > 0, y_loc, zero)
        return y_loc, hit_loc > 0

    in_vec_spec = P(("c", "r")) if not transpose else P(("r", "c"))
    out_vec_spec = P(("r", "c")) if not transpose else P(("c", "r"))
    y, ym = shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(spec, spec, spec, nspec, in_vec_spec, in_vec_spec),
        out_specs=(out_vec_spec, out_vec_spec),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, xv, xm)
    return y, ym


@jax.jit
def dist_bfs_pull_masked(a: DistSpMat, front_mask: jax.Array,
                         unvisited: jax.Array):
    """Distributed bottom-up (pull) BFS step — the ``BottomUpStep`` /
    ``BitMapCarousel`` counterpart (``BFSFriends.h:458``,
    ``BitMapCarousel.h:141``).

    Every *unvisited* vertex v pulls the max frontier in-neighbor over edges
    (u, v).  Only two BITMAPS travel the mesh (frontier along 'c', unvisited
    along 'r') — the same word-granularity saving the reference's carousel
    ring buys, expressed as two bool all_gathers + one pmax reduce-scatter.
    Returns (parent_candidates + 1, hit_mask) in the column-space layout
    (same as ``dist_spmsv_masked(transpose=True)``).
    """
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pr, pc = grid.pr, grid.pc
    spec = P("r", "c", None)
    nspec = P("r", "c")
    fm = jnp.zeros((pr * mb,), jnp.bool_).at[: front_mask.shape[0]].set(
        front_mask[: pr * mb]
    )
    uv = jnp.zeros((pc * nb,), jnp.bool_).at[: unvisited.shape[0]].set(
        unvisited[: pc * nb]
    )

    def f(row, col, val, nnz, fm_loc, uv_loc):
        cap = row.shape[-1]
        r = row.reshape(-1)
        c = col.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        fm_blk = jax.lax.all_gather(fm_loc, "c", tiled=True)  # (mb,) bools
        uv_blk = jax.lax.all_gather(uv_loc, "r", tiled=True)  # (nb,) bools
        rr = jnp.minimum(r, mb - 1)
        cc = jnp.minimum(c, nb - 1)
        active = valid & fm_blk[rr] & uv_blk[cc]
        bi = jax.lax.axis_index("r").astype(jnp.int32)
        cand = jnp.where(active, bi * mb + rr + 1, 0)
        seg = jnp.where(active, cc, nb)
        y_part = jax.ops.segment_max(cand, seg, num_segments=nb)
        y_loc = _axis_reduce_scatter(y_part, "r", MAX_FIRST)
        return y_loc, y_loc > 0

    return shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(spec, spec, spec, nspec, P(("r", "c")), P(("c", "r"))),
        out_specs=(P(("c", "r")), P(("c", "r"))),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, fm, uv)


def est_nnz_spgemm_sampling(a: DistSpMat, b: DistSpMat, key,
                            rounds: int = 16) -> float:
    """Sampling-based estimate of nnz(A·B) — ``EstPerProcessNnzSpMV``
    (``ParFriends.h:2810``): Cohen's min-propagation estimator.  Per round,
    draw x[j] ~ Exp(1) over B's columns, min-propagate through B then A with
    (min, select2nd) SpMVs (the reference's ``SelectMinxSR`` chains, done on
    its transposes because its SpMV is xᵀA; ours multiplies from the right
    so no transposes are needed):

        m[k] = min over j with B[k,j] != 0 of x[j]
        f[i] = min over k with A[i,k] != 0 of m[k]

    nnz of C's row i is then ~ (R-1) / sum_r f_r[i]; the total is the sum
    over rows (the reference's allreduce).  Cost: 2*R distributed SpMVs —
    independent of the product size, the point of the estimator."""
    import jax.numpy as jnp

    from combblas_tpu.semiring import MIN_SECOND

    n = b.gshape[1]
    acc = None
    for r in range(rounds):
        sub = jax.random.fold_in(key, r)
        x = jax.random.exponential(sub, (n,), jnp.float32)
        m = dist_spmv(b, x, MIN_SECOND)
        m = jnp.where(jnp.isfinite(m), m, jnp.inf)
        f = dist_spmv(a, m, MIN_SECOND)
        f = jnp.where(jnp.isfinite(f), f, jnp.inf)
        acc = f if acc is None else acc[: f.shape[0]] + f
    m_rows = a.gshape[0]
    acc = acc[:m_rows]
    per_row = jnp.where(
        jnp.isfinite(acc) & (acc > 0), (rounds - 1) / acc, 0.0)
    return float(jnp.sum(per_row))
