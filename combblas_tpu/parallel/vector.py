"""Distributed dense/sparse vector machinery: sort, RandPerm, routing, Uniq.

Counterpart of the reference's distributed vector layer:

- ``FullyDistVec::RandPerm`` (``FullyDistVec.cpp``) — random permutation by
  sorting random keys, here threefry keys + :func:`dist_sort`.
- ``FullyDistSpVec::sort`` (``FullyDistSpVec.cpp:712``, usort
  ``par::sampleSort`` at ``:859``) — here a mesh-wide sample sort built from
  three XLA collectives per round (all_gather of splitter samples, one
  all_to_all bucket exchange, one all_to_all rebalance).
- the alltoallv "SparseCommon" shuffle that delivers (index, value) pairs to
  their owners (``SpParMat.cpp:2893``, ``FullyDistSpVec.cpp:511`` SetElement)
  — here :func:`dist_route`.
- ``FullyDistSpVec::Invert`` (``FullyDistSpVec.h:89``) and ``Uniq``
  (``FullyDistSpVec.cpp:1029``) built on the two primitives above.

Vectors ride the canonical FullyDist layout (flat padded length-N array
sharded ``P(('r','c'))``, chunk = N/p per device); sparse vectors are the
masked-dense pair (values, bool mask) in that layout, the library-wide
convention (see ``ops/spmv.py``).

Design notes (why this shape):

* Sample sort keeps collective rounds O(1) regardless of mesh size — the
  alternative mesh bitonic/odd-even sorts cost log²p/p ppermute rounds.
* All shapes are static: the bucket exchange uses per-(src,dst) capacity =
  chunk, the provably-never-truncating bound (a source holds only chunk
  elements), so correctness never depends on splitter balance.  The
  (p, chunk) = N-per-device exchange buffer is the price; sample-balanced
  splitters keep the *work* O(N/p) even though the buffer is O(N).
* Ties are broken by global index (lexicographic (key, gidx) order), which
  makes every key unique — sample-sort balance guarantees then hold even for
  constant inputs, and the sort is stable.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from combblas_tpu.parallel.grid import ProcGrid

__all__ = [
    "dist_sort",
    "dist_sort_auto",
    "dist_rand_perm",
    "dist_route",
    "dist_gather",
    "dist_apply_perm",
    "dist_invert",
    "dist_uniq",
]

_AX = ("r", "c")  # the flattened vector axis


def _axes(grid: ProcGrid):
    return ("l",) + _AX if grid.is3d else _AX


def _sortable_u32(x: jax.Array) -> jax.Array:
    """Order-preserving map to uint32 (total order; NaNs sort last)."""
    if jnp.issubdtype(x.dtype, jnp.floating):
        b = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
        sign = (b >> 31).astype(jnp.bool_)
        return jnp.where(sign, ~b, b | jnp.uint32(0x80000000))
    if x.dtype == jnp.uint32:
        return x
    return (x.astype(jnp.int32).view(jnp.uint32)) ^ jnp.uint32(0x80000000)


def _lex_lt(k1, i1, k2, i2):
    return (k1 < k2) | ((k1 == k2) & (i1 < i2))


@functools.partial(
    jax.jit, static_argnames=("grid", "length", "descending", "oversample")
)
def dist_sort(
    x: jax.Array,
    grid: ProcGrid,
    *payloads: jax.Array,
    length: int | None = None,
    descending: bool = False,
    oversample: int = 32,
):
    """Mesh-wide sample sort of a canonical-layout vector.

    ``x``: padded flat array sharded P(('r','c')) with true prefix ``length``
    (defaults to the padded size); padding sorts to the tail.  ``payloads``
    ride along.  Returns (sorted_x, *sorted_payloads) in the same layout.

    Counterpart of ``par::sampleSort`` (usort, via ``FullyDistSpVec::sort``
    ``FullyDistSpVec.cpp:859`` and ``SpParHelper::MemoryEfficientPSort``).
    """
    p = grid.nprocs
    n_pad = x.shape[0]
    assert n_pad % p == 0, (n_pad, p)
    chunk = n_pad // p
    n = n_pad if length is None else length
    axes = _axes(grid)
    vspec = P(axes)

    def f(x_loc, *pl_loc):
        me = jax.lax.axis_index(axes)
        t = jnp.arange(chunk, dtype=jnp.int32)
        gidx = me.astype(jnp.int32) * chunk + t
        key = _sortable_u32(x_loc)
        if descending:
            key = ~key
        key = jnp.where(gidx < n, key, jnp.uint32(0xFFFFFFFF))
        # 1. local sort (key, gidx) carrying original value + payloads
        ops = jax.lax.sort((key, gidx, x_loc) + pl_loc, num_keys=2)
        key_s, gidx_s = ops[0], ops[1]
        carried = ops[2:]
        # 2. splitters: oversampled evenly-spaced local keys, all-gathered
        s = min(oversample, chunk)
        samp_pos = (jnp.arange(s, dtype=jnp.int32) * chunk) // s
        samp_k = key_s[samp_pos]
        samp_i = gidx_s[samp_pos]
        all_k = jax.lax.all_gather(samp_k, axes, tiled=True)  # (p*s,)
        all_i = jax.lax.all_gather(samp_i, axes, tiled=True)
        all_k, all_i = jax.lax.sort((all_k, all_i), num_keys=2)
        spl_pos = (jnp.arange(1, p, dtype=jnp.int32) * (p * s)) // p
        spl_k = all_k[spl_pos]  # (p-1,)
        spl_i = all_i[spl_pos]
        # 3. destination bucket per element: count of splitters <= element
        # (lexicographic on (key, gidx)); monotone in sorted order, so each
        # bucket is a contiguous run.
        ge = ~_lex_lt(
            key_s[:, None], gidx_s[:, None], spl_k[None, :], spl_i[None, :]
        )  # (chunk, p-1)
        dest = jnp.sum(ge.astype(jnp.int32), axis=1)  # in [0, p)
        starts = jnp.searchsorted(
            dest, jnp.arange(p, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        ends = jnp.concatenate(
            [starts[1:], jnp.full((1,), chunk, jnp.int32)]
        )
        # 4. bucket exchange: send[(dst, t)] = element starts[dst]+t
        src_pos = jnp.minimum(starts[:, None] + t[None, :], chunk - 1)
        lens = ends - starts
        ok = t[None, :] < lens[:, None]

        def send_recv(arr, fill):
            buf = jnp.where(ok, arr[src_pos], fill)
            return jax.lax.all_to_all(buf, axes, 0, 0)

        rk = send_recv(key_s, jnp.uint32(0xFFFFFFFF))
        ri = send_recv(gidx_s, jnp.int32(-1))
        rc = tuple(send_recv(c, jnp.zeros((), c.dtype)) for c in carried)
        rlen = jax.lax.all_to_all(
            jnp.broadcast_to(lens[:, None], (p, 1)), axes, 0, 0
        ).reshape(p)
        mine = jnp.sum(rlen)
        # mask out the pad slots of each received bucket, then local sort
        rok = t[None, :] < rlen[:, None]
        rk = jnp.where(rok, rk, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        ri = jnp.where(rok, ri, jnp.int32(0x7FFFFFFF)).reshape(-1)
        merged = jax.lax.sort(
            (rk, ri) + tuple(c.reshape(-1) for c in rc), num_keys=2
        )
        mk, mi = merged[0], merged[1]
        mc = merged[2:]
        # 5. rebalance to even chunks: my elements own global positions
        # [pref, pref+mine); slot t of device o is filled from local index
        # o*chunk + t - pref when in range.
        counts = jax.lax.all_gather(mine, axes, tiled=False)  # (p,)
        pref_all = jnp.concatenate(
            [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)]
        )
        pref = pref_all[me]
        gpos = jnp.arange(p, dtype=jnp.int32)[:, None] * chunk + t[None, :]
        loc = gpos - pref
        in_range = (loc >= 0) & (loc < mine)
        loc = jnp.clip(loc, 0, p * chunk - 1)

        def send_recv2(arr, fill):
            buf = jnp.where(in_range, arr[loc], fill)
            return jax.lax.all_to_all(buf, axes, 0, 0)

        r2v = tuple(send_recv2(c, jnp.zeros((), c.dtype)) for c in mc)
        # exactly one source covers each of my slots: source of global
        # position g is the device whose [pref_s, pref_s+count_s) contains g
        # (empty devices share prefix values; side='right' - 1 lands on the
        # unique non-empty owner).
        mypos = me.astype(pref_all.dtype) * chunk + t
        src = (
            jnp.searchsorted(pref_all, mypos, side="right").astype(jnp.int32)
            - 1
        )
        src = jnp.clip(src, 0, p - 1)
        return tuple(v[src, t] for v in r2v)

    out = shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(vspec,) * (1 + len(payloads)),
        out_specs=(vspec,) * (1 + len(payloads)),
        check_vma=False,
    )(x, *payloads)
    return out if len(out) > 1 else out[0]


@functools.partial(
    jax.jit, static_argnames=("grid", "length", "descending", "oversample")
)
def _sort_plan(x, grid: ProcGrid, length=None, descending=False,
               oversample=32):
    """Planning pass for :func:`dist_sort_auto`: the global max per-(src,
    dst) bucket count (1,) and the per-device received totals (p,), both
    REPLICATED, under the same splitters :func:`dist_sort` would pick — the
    symbolic pass that lets the host size the exchange buffers to the
    ACTUAL max bucket (usort's alltoallv counts, ``par::sampleSort``).
    Replication makes the plan readable from every controller of a
    multi-process pod."""
    p = grid.nprocs
    n_pad = x.shape[0]
    chunk = n_pad // p
    n = n_pad if length is None else length
    axes = _axes(grid)

    def f(x_loc):
        me = jax.lax.axis_index(axes)
        t = jnp.arange(chunk, dtype=jnp.int32)
        gidx = me.astype(jnp.int32) * chunk + t
        key = _sortable_u32(x_loc)
        if descending:
            key = ~key
        key = jnp.where(gidx < n, key, jnp.uint32(0xFFFFFFFF))
        key_s, gidx_s = jax.lax.sort((key, gidx), num_keys=2)
        s = min(oversample, chunk)
        samp_pos = (jnp.arange(s, dtype=jnp.int32) * chunk) // s
        all_k = jax.lax.all_gather(key_s[samp_pos], axes, tiled=True)
        all_i = jax.lax.all_gather(gidx_s[samp_pos], axes, tiled=True)
        all_k, all_i = jax.lax.sort((all_k, all_i), num_keys=2)
        spl_pos = (jnp.arange(1, p, dtype=jnp.int32) * (p * s)) // p
        spl_k, spl_i = all_k[spl_pos], all_i[spl_pos]
        ge = ~_lex_lt(
            key_s[:, None], gidx_s[:, None], spl_k[None, :], spl_i[None, :]
        )
        dest = jnp.sum(ge.astype(jnp.int32), axis=1)
        lens = jax.ops.segment_sum(
            jnp.ones((chunk,), jnp.int32), dest, num_segments=p)
        # received total = sum over sources of their count for me
        recv = jax.lax.all_to_all(lens[:, None], axes, 0, 0).reshape(p)
        # REPLICATED outputs: multi-controller hosts must be able to read
        # the plan without owning every shard (tests/_multihost_worker.py)
        lens_max = jax.lax.pmax(jnp.max(lens), axes)
        mine_all = jax.lax.all_gather(
            jnp.sum(recv)[None], axes, tiled=True)
        return lens_max[None], mine_all

    lens_max, mine = shard_map(
        f, mesh=grid.mesh, in_specs=(P(axes),),
        out_specs=(P(), P()),
        check_vma=False,
    )(x)
    return lens_max, mine


def dist_sort_auto(x, grid: ProcGrid, *payloads, length=None,
                   descending=False, oversample=32):
    """Scale-safe mesh sample sort: a planning pass sizes the bucket
    exchange to the ACTUAL max per-pair count (VERDICT r2 item 8 — the
    (p, chunk) = O(N)-per-device buffer of :func:`dist_sort` becomes
    O(max_bucket)), and the rebalance runs as ppermute shifts over the
    exact device-offset span instead of a full (p, chunk) all_to_all.
    Host-driven (two jitted passes), so use it from host-paced callers;
    jit-embedded callers keep :func:`dist_sort`'s static-safe bound."""
    p = grid.nprocs
    n_pad = x.shape[0]
    chunk = n_pad // p
    lens_max, mine = _sort_plan(x, grid, length=length,
                                descending=descending,
                                oversample=oversample)
    mine = np.asarray(mine)
    bucket_cap = max(int(np.asarray(lens_max).max()), 1)
    bucket_cap = min(-(-bucket_cap // 8) * 8, chunk)
    # device-offset span of the rebalance: device d's sorted run covers
    # global [pref[d], pref[d]+mine[d]) and must land on even chunks
    pref = np.concatenate([[0], np.cumsum(mine)])[:-1]
    d_lo = pref // max(chunk, 1) - np.arange(p)
    d_hi = (np.maximum(pref + mine, pref + 1) - 1) // max(chunk, 1) \
        - np.arange(p)
    o_lo = int(min(d_lo.min(), 0))
    o_hi = int(max(d_hi.max(), 0))
    return _dist_sort_bounded(
        x, grid, *payloads, length=length, descending=descending,
        oversample=oversample, bucket_cap=bucket_cap, o_lo=o_lo, o_hi=o_hi,
    )


@functools.partial(
    jax.jit,
    static_argnames=("grid", "length", "descending", "oversample",
                     "bucket_cap", "o_lo", "o_hi"),
)
def _dist_sort_bounded(
    x, grid: ProcGrid, *payloads, length=None, descending=False,
    oversample=32, bucket_cap: int, o_lo: int, o_hi: int,
):
    """Sample sort with host-sized exchange buffers (see
    :func:`dist_sort_auto`).  ``bucket_cap``: max per-(src,dst) bucket
    count; ``o_lo``/``o_hi``: rebalance device-offset span."""
    p = grid.nprocs
    n_pad = x.shape[0]
    chunk = n_pad // p
    n = n_pad if length is None else length
    axes = _axes(grid)
    vspec = P(axes)

    def f(x_loc, *pl_loc):
        me = jax.lax.axis_index(axes).astype(jnp.int32)
        t = jnp.arange(chunk, dtype=jnp.int32)
        t2 = jnp.arange(bucket_cap, dtype=jnp.int32)
        gidx = me * chunk + t
        key = _sortable_u32(x_loc)
        if descending:
            key = ~key
        key = jnp.where(gidx < n, key, jnp.uint32(0xFFFFFFFF))
        ops = jax.lax.sort((key, gidx, x_loc) + pl_loc, num_keys=2)
        key_s, gidx_s = ops[0], ops[1]
        carried = ops[2:]
        s = min(oversample, chunk)
        samp_pos = (jnp.arange(s, dtype=jnp.int32) * chunk) // s
        all_k = jax.lax.all_gather(key_s[samp_pos], axes, tiled=True)
        all_i = jax.lax.all_gather(gidx_s[samp_pos], axes, tiled=True)
        all_k, all_i = jax.lax.sort((all_k, all_i), num_keys=2)
        spl_pos = (jnp.arange(1, p, dtype=jnp.int32) * (p * s)) // p
        spl_k, spl_i = all_k[spl_pos], all_i[spl_pos]
        ge = ~_lex_lt(
            key_s[:, None], gidx_s[:, None], spl_k[None, :], spl_i[None, :]
        )
        dest = jnp.sum(ge.astype(jnp.int32), axis=1)
        starts = jnp.searchsorted(
            dest, jnp.arange(p, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        ends = jnp.concatenate([starts[1:], jnp.full((1,), chunk, jnp.int32)])
        lens = ends - starts
        # bounded bucket exchange: (p, bucket_cap) instead of (p, chunk)
        src_pos = jnp.minimum(starts[:, None] + t2[None, :], chunk - 1)
        ok = t2[None, :] < lens[:, None]

        def send_recv(arr, fill):
            buf = jnp.where(ok, arr[src_pos], fill)
            return jax.lax.all_to_all(buf, axes, 0, 0)

        rk = send_recv(key_s, jnp.uint32(0xFFFFFFFF))
        ri = send_recv(gidx_s, jnp.int32(-1))
        rc = tuple(send_recv(c, jnp.zeros((), c.dtype)) for c in carried)
        rlen = jax.lax.all_to_all(
            jnp.broadcast_to(lens[:, None], (p, 1)), axes, 0, 0
        ).reshape(p)
        mine = jnp.sum(rlen)
        rok = t2[None, :] < rlen[:, None]
        rk = jnp.where(rok, rk, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        ri = jnp.where(rok, ri, jnp.int32(0x7FFFFFFF)).reshape(-1)
        merged = jax.lax.sort(
            (rk, ri) + tuple(c.reshape(-1) for c in rc), num_keys=2
        )
        mc = merged[2:]
        # rebalance via ppermute shifts over [o_lo, o_hi]: my run owns
        # global [pref, pref+mine); destination d takes its overlap.
        counts = jax.lax.all_gather(mine, axes, tiled=False)
        pref_all = jnp.concatenate(
            [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)]
        )
        pref = pref_all[me]
        outs = tuple(jnp.zeros((chunk,), c.dtype) for c in mc)
        for o in range(o_lo, o_hi + 1):
            d = me + o
            g = jnp.clip(d, 0, p - 1) * chunk + t
            li = jnp.clip(g - pref, 0, mc[0].shape[0] - 1)
            valid = ((d >= 0) & (d < p)
                     & (g >= pref) & (g < pref + mine))
            perm = [(j, j + o) for j in range(p) if 0 <= j + o < p]
            if not perm:
                continue
            flag = jax.lax.ppermute(valid, axes, perm)
            bufs = tuple(
                jax.lax.ppermute(
                    jnp.where(valid, c[li], jnp.zeros((), c.dtype)),
                    axes, perm)
                for c in mc
            )
            outs = tuple(
                jnp.where(flag, b, out) for out, b in zip(outs, bufs)
            )
        return outs

    out = shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(vspec,) * (1 + len(payloads)),
        out_specs=(vspec,) * (1 + len(payloads)),
        check_vma=False,
    )(x, *payloads)
    return out if len(out) > 1 else out[0]


@functools.partial(jax.jit, static_argnames=("grid", "n"))
def dist_rand_perm(key: jax.Array, n: int, grid: ProcGrid) -> jax.Array:
    """Random permutation of [0, n) in canonical layout (padding = n sentinel).

    ``FullyDistVec::RandPerm`` re-designed: threefry keys sorted mesh-wide
    with the identity as payload — the sorted payload *is* the permutation.
    """
    p = grid.nprocs
    n_pad = -(-n // p) * p
    axes = _axes(grid)
    vspec = P(axes)

    def gen():
        me = jax.lax.axis_index(axes)
        chunk = n_pad // p
        t = jnp.arange(chunk, dtype=jnp.int32)
        gidx = me.astype(jnp.int32) * chunk + t
        k = jax.random.fold_in(key, me)
        r = jax.random.bits(k, (chunk,), jnp.uint32)
        return r, gidx

    rnd, iota = shard_map(
        gen, mesh=grid.mesh, in_specs=(), out_specs=(vspec, vspec),
        check_vma=False,
    )()
    _, perm = dist_sort(rnd, grid, iota, length=n)
    pad_spec = P(axes)
    mark = shard_map(
        lambda q: jnp.where(
            jax.lax.axis_index(axes).astype(jnp.int32) * (n_pad // p)
            + jnp.arange(n_pad // p, dtype=jnp.int32) < n,
            q,
            n,
        ),
        mesh=grid.mesh, in_specs=(pad_spec,), out_specs=pad_spec,
        check_vma=False,
    )(perm)
    return mark


@functools.partial(jax.jit, static_argnames=("grid", "combine", "n_out"))
def dist_route(
    idx: jax.Array,
    val: jax.Array,
    mask: jax.Array,
    init: jax.Array,
    grid: ProcGrid,
    *,
    combine: str = "set",
    n_out: int | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Deliver (idx, val) pairs to the canonical owner of each index.

    The alltoallv owner shuffle underlying the reference's SparseCommon
    (``SpParMat.cpp:2893``) and vector SetElement/Assign paths, as one static
    all_to_all.  ``idx/val/mask``: canonical-layout arrays (mask selects live
    pairs).  ``init``: the canonical-layout output vector to update (its
    padded length defines the index space).  Returns (out, out_mask) where
    out_mask marks slots hit by at least one pair.  ``combine``: 'set' (last
    writer in (device, slot) order wins), 'sum', 'min', or 'max'.
    """
    p = grid.nprocs
    n_pad = init.shape[0]
    assert n_pad % p == 0
    chunk_out = n_pad // p
    chunk_in = idx.shape[0] // p
    axes = _axes(grid)
    vspec = P(axes)

    def f(i_loc, v_loc, m_loc, o_loc):
        t_in = jnp.arange(chunk_in, dtype=jnp.int32)
        dest = jnp.where(
            m_loc, jnp.clip(i_loc.astype(jnp.int32) // chunk_out, 0, p - 1), p
        )
        # group pairs by destination: stable local sort on dest
        d_s, i_s, v_s = jax.lax.sort(
            (dest, i_loc.astype(jnp.int32), v_loc), num_keys=1
        )
        starts = jnp.searchsorted(
            d_s, jnp.arange(p, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        ends = jnp.searchsorted(
            d_s, jnp.arange(p, dtype=jnp.int32), side="right"
        ).astype(jnp.int32)
        lens = ends - starts
        src_pos = jnp.minimum(starts[:, None] + t_in[None, :], chunk_in - 1)
        ok = t_in[None, :] < lens[:, None]
        si = jnp.where(ok, i_s[src_pos], -1)
        sv = jnp.where(ok, v_s[src_pos], jnp.zeros((), v_s.dtype))
        ri = jax.lax.all_to_all(si, axes, 0, 0).reshape(-1)
        rv = jax.lax.all_to_all(sv, axes, 0, 0).reshape(-1)
        live = ri >= 0
        slot = jnp.where(
            live, ri - jax.lax.axis_index(axes).astype(jnp.int32) * chunk_out,
            chunk_out,
        )
        hit = (
            jnp.zeros((chunk_out,), jnp.bool_)
            .at[slot]
            .set(True, mode="drop")
        )
        if combine == "set":
            out = o_loc.at[slot].set(rv, mode="drop")
        elif combine == "sum":
            out = o_loc.at[slot].add(jnp.where(live, rv, 0), mode="drop")
        elif combine == "min":
            out = o_loc.at[slot].min(rv, mode="drop")
        else:
            out = o_loc.at[slot].max(rv, mode="drop")
        return out, hit

    return shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(vspec, vspec, vspec, vspec),
        out_specs=(vspec, vspec),
        check_vma=False,
    )(idx, val, mask, init)


@functools.partial(jax.jit, static_argnames=("grid",))
def dist_gather(x: jax.Array, idx: jax.Array, grid: ProcGrid) -> jax.Array:
    """Distributed gather: out[i] = x[idx[i]] — the vector SubsRef /
    ``FullyDistVec::operator()(FullyDistVec)`` (``FullyDistVec.cpp``)
    counterpart.  Two owner exchanges: requests travel to the index's owner,
    answers travel back to the requester.  Out-of-range indices return 0."""
    p = grid.nprocs
    n_x = x.shape[0]
    n_i = idx.shape[0]
    assert n_x % p == 0 and n_i % p == 0
    cx = n_x // p
    ci = n_i // p
    axes = _axes(grid)
    vspec = P(axes)

    def f(x_loc, i_loc):
        me = jax.lax.axis_index(axes).astype(jnp.int32)
        t = jnp.arange(ci, dtype=jnp.int32)
        ok = (i_loc >= 0) & (i_loc < n_x)
        dest = jnp.where(ok, jnp.clip(i_loc // cx, 0, p - 1), p)
        # group requests by owner; remember the requester's slot
        d_s, q_s, slot_s = jax.lax.sort(
            (dest, i_loc.astype(jnp.int32), t), num_keys=1
        )
        ids = jnp.arange(p, dtype=jnp.int32)
        starts = jnp.searchsorted(d_s, ids, side="left").astype(jnp.int32)
        lens = (
            jnp.searchsorted(d_s, ids, side="right").astype(jnp.int32)
            - starts
        )
        pos = jnp.minimum(starts[:, None] + t[None, :], ci - 1)
        okk = t[None, :] < lens[:, None]
        sq = jnp.where(okk, q_s[pos], -1)
        ss = jnp.where(okk, slot_s[pos], -1)
        rq = jax.lax.all_to_all(sq, axes, 0, 0)   # requests for my slice
        rs = jax.lax.all_to_all(ss, axes, 0, 0)
        live = rq >= 0
        ans = jnp.where(
            live, x_loc[jnp.clip(rq - me * cx, 0, cx - 1)],
            jnp.zeros((), x_loc.dtype),
        )
        # answers go straight back: the exchange is symmetric, so a second
        # all_to_all returns each answer to its requesting device
        back_a = jax.lax.all_to_all(ans, axes, 0, 0)
        back_s = jax.lax.all_to_all(rs, axes, 0, 0)
        out = jnp.zeros((ci,), x_loc.dtype)
        slot = jnp.where(back_s >= 0, back_s, ci).reshape(-1)
        return out.at[slot].set(back_a.reshape(-1), mode="drop")

    return shard_map(
        f, mesh=grid.mesh, in_specs=(vspec, vspec), out_specs=vspec,
        check_vma=False,
    )(x, idx)


@functools.partial(jax.jit, static_argnames=("grid",))
def dist_apply_perm(
    x: jax.Array, perm: jax.Array, grid: ProcGrid
) -> jax.Array:
    """y[perm[i]] = x[i] — scatter a vector through a permutation
    (``FullyDistVec`` operator() composition used by RandPermute paths).
    Padding slots (perm == len) are dropped."""
    n_pad = x.shape[0]
    mask = perm < n_pad
    out, _ = dist_route(perm, x, mask, jnp.zeros_like(x), grid, combine="set")
    return out


@functools.partial(jax.jit, static_argnames=("grid", "n_range"))
def dist_invert(
    val: jax.Array, mask: jax.Array, grid: ProcGrid, *, n_range: int | None = None
):
    """Sparse-vector Invert (``FullyDistSpVec.h:89``): out[val[i]] = i for
    live entries.  Values must be a valid index set; duplicate values keep the
    largest index (deterministic).  Returns (out_idx_vector, out_mask)."""
    n_pad = val.shape[0]
    p = grid.nprocs
    chunk = n_pad // p
    axes = _axes(grid)
    vspec = P(axes)

    def iota():
        me = jax.lax.axis_index(axes)
        return me.astype(jnp.int32) * chunk + jnp.arange(chunk, dtype=jnp.int32)

    gidx = shard_map(iota, mesh=grid.mesh, in_specs=(), out_specs=vspec,
                     check_vma=False)()
    init = jnp.full((n_pad,), -1, jnp.int32)
    out, hit = dist_route(
        val.astype(jnp.int32), gidx, mask, init, grid, combine="max"
    )
    return out, hit


@functools.partial(jax.jit, static_argnames=("grid",))
def dist_uniq(val: jax.Array, mask: jax.Array, grid: ProcGrid):
    """Uniq (``FullyDistSpVec.cpp:1029``): keep one entry (the smallest index)
    per distinct value of a masked-dense sparse vector; result stays at the
    surviving entries' original indices.  sort-by-(value, index) mesh-wide,
    keep run heads, route survivors home."""
    n_pad = val.shape[0]
    p = grid.nprocs
    chunk = n_pad // p
    axes = _axes(grid)
    vspec = P(axes)

    def tag(v_loc, m_loc):
        me = jax.lax.axis_index(axes)
        gidx = me.astype(jnp.int32) * chunk + jnp.arange(chunk, dtype=jnp.int32)
        key = jnp.where(m_loc, _sortable_u32(v_loc), jnp.uint32(0xFFFFFFFF))
        live = jnp.where(m_loc, gidx, jnp.int32(0x7FFFFFFF))
        return key, live

    key, gidx = shard_map(
        tag, mesh=grid.mesh, in_specs=(vspec, vspec), out_specs=(vspec, vspec),
        check_vma=False,
    )(val, mask)
    # global sort by (key, gidx): equal values adjacent, smallest index first
    ks, is_, vs, ms = dist_sort(
        key, grid, gidx, val, mask.astype(jnp.int32)
    )

    def heads(k_loc, i_loc, v_loc, m_loc):
        me = jax.lax.axis_index(axes)
        # previous element across the shard boundary: gather last elements
        lastk = jax.lax.all_gather(k_loc[-1], axes, tiled=False)
        prevk = jnp.where(me > 0, lastk[jnp.maximum(me - 1, 0)],
                          jnp.uint32(0xFFFFFFFF))
        pk = jnp.concatenate([prevk[None], k_loc[:-1]])
        first = (k_loc != pk) | ((me == 0) & (jnp.arange(chunk) == 0))
        keep = first & (m_loc > 0)
        return keep

    keep = shard_map(
        heads,
        mesh=grid.mesh,
        in_specs=(vspec,) * 4,
        out_specs=vspec,
        check_vma=False,
    )(ks, is_, vs, ms)
    out, hit = dist_route(
        is_, vs, keep, jnp.zeros_like(val), grid, combine="set"
    )
    return out, hit
