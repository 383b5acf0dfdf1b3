"""Benchmark harness — prints ONE JSON line per metric, cheap lines first.

Every line names the device it ran on (``platform``, ``device_kind``,
``device_count``).  Without an accelerator the harness stops, unless the
caller asked for the CPU explicitly with ``JAX_PLATFORMS=cpu`` (the smoke
test does); such lines name ``cpu``.

Headline (last line): R-MAT **scale-22** A² semiring SpGEMM on one device,
at the scale of the reference's SCALE22RMATRMAT MultTime benchmark, with the
reference's SpGEMM-benchmark generator settings
(``3DSpGEMM/mpipspgemm.cpp:135-141``: R-MAT initiator (.6, .4/3, .4/3,
.4/3), edgefactor 8) drawn by this repo's own generator (``gen/rmat.py``).
The scale-22 product exceeds one device's memory, so every row slab's C
block is fully formed, merged, and compacted on device, folded into (nnz,
checksum), and released (``ops/spgemm_seg.py``, the reference's
``MemEfficientSpGEMM`` phasing).  All products are formed and all
duplicates merged — nothing is skipped.  The headline runs under a
wall-clock budget (``--budget``) and reports partial slabs/s if the budget
expires mid-stream.

Timing: every timed region ends with a scalar device->host pull that
data-depends on the result.
"""

import argparse
import json
import os
import time

import numpy as np

SSCA = (0.6, 0.4 / 3, 0.4 / 3, 0.4 / 3)


def _device_fields() -> dict:
    import jax

    d = jax.devices()[0]
    return dict(platform=d.platform, device_kind=d.device_kind,
                device_count=len(jax.devices()))


def bench_spgemm22(scale: int, max_flops_cap: int,
                   deadline: float | None = None, max_widths: int = 20):
    """Headline: A² of an SSCA-initiator R-MAT (edgefactor 8) at ``scale``
    through the sorted-row uniform-width streamed pipeline (seg2: every
    product formed + merged; output digested per slab).

    ``deadline`` is an absolute ``time.perf_counter()`` wall-clock cutoff:
    the slab loop syncs per slab and stops when it would overrun, reporting
    partial slabs/s."""
    import jax
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.ops.spgemm import spgemm_flops
    from combblas_tpu.ops.spgemm_seg import (
        seg2_prepare,
        seg2_step,
        seg_zero_state,
    )
    from combblas_tpu.semiring import PLUS_TIMES

    t_gen = time.perf_counter()
    a = rmat_matrix(jax.random.PRNGKey(42), scale=scale, edgefactor=8,
                    probs=SSCA)
    gen_secs = time.perf_counter() - t_gen
    t_plan = time.perf_counter()
    flops = int(spgemm_flops(a, a))
    prep = seg2_prepare(a, a, flops_cap=max_flops_cap,
                        max_widths=max_widths)
    cfg = prep[1]
    num_slabs = len(cfg["slabs"])
    plan_secs = time.perf_counter() - t_plan

    def step(s, state):
        return seg2_step(a, prep, s, state, PLUS_TIMES)

    zero = seg_zero_state()
    # warm every distinct compiled shape BEFORE timing (digest state
    # discarded), so the timed pass compiles nothing.  Deadline-aware: if
    # the budget runs short, remaining shapes compile inside the timed
    # loop (slower but still correct + reported).
    seen = {}
    for s, sl in enumerate(cfg["slabs"]):
        seen.setdefault((sl["w"], sl["s_pad"], sl["nnz_cap"], sl["flat"],
                         sl["flat_stream_cap"]), s)
    t_warm = time.perf_counter()
    for s in seen.values():
        int(step(s, zero)[0])  # hard sync via scalar pull
        if deadline is not None and time.perf_counter() > deadline - 180:
            break
    warm_secs = time.perf_counter() - t_warm
    slab_secs = []
    state = zero
    done = 0
    flops_done = 0
    t0 = time.perf_counter()
    for s in range(num_slabs):
        ts = time.perf_counter()
        state = step(s, state)
        int(state[0])
        slab_secs.append(time.perf_counter() - ts)
        flops_done += cfg["slabs"][s]["flops"]
        done = s + 1
        if deadline is not None and done < num_slabs:
            mean = sum(slab_secs) / len(slab_secs)
            if time.perf_counter() + mean > deadline:
                break
    dt = time.perf_counter() - t0
    total_lo, total_hi, checksum, truncated = state
    partial = done < num_slabs
    out = dict(
        scale=scale,
        workload="rmat_ssca_ef8_A2_streamed_seg2",
        nnz_a=int(a.nnz),
        flops=flops,
        max_widths=max_widths,
        pad_ratio=round(cfg["pad_ratio"], 3),
        slabs_done=done,
        slabs=num_slabs,
        shapes=len(seen),
        partial=partial,
        truncated=bool(truncated),
        gen_secs=round(gen_secs, 1),
        plan_secs=round(plan_secs, 1),
        warm_secs=round(warm_secs, 1),
        secs=round(dt, 3),
        est_full_secs=round(dt * flops / max(flops_done, 1), 3),
        products_per_s=flops_done / dt,
    )
    if not partial:
        out["nnz_c"] = int(total_lo) + (int(total_hi) << 16)
        out["checksum"] = float(checksum)
    return out


def bench_spgemm(scale: int, edgefactor: int, iters: int, max_flops_cap: int):
    """Materialized G500-ef16 A² (round-over-round comparable line)."""
    import jax
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.ops.spgemm import (
        _slab_bounds_host,
        spgemm,
        spgemm_auto,
        spgemm_bounds,
        spgemm_flops,
        spgemm_rowchunked,
        round_capacity_frac,
    )

    key = jax.random.PRNGKey(42)
    a = rmat_matrix(key, scale=scale, edgefactor=edgefactor)
    flops = int(spgemm_flops(a, a))
    fc, oc = spgemm_bounds(a, a)
    # symbolic-style output sizing: discover true nnz once (estimate-and-retry
    # inside spgemm_auto), then time with tight buffers — the steady state of
    # every iterated workload (MCL), and what the reference's symbolic pass
    # buys it.
    c0 = spgemm_auto(a, a, max_flops_cap=max_flops_cap)
    tight = round_capacity_frac(int(c0.nnz))
    if fc <= max_flops_cap:
        def run():
            return spgemm(a, a, flops_cap=fc, out_capacity=tight)
    else:
        num_slabs = -(-fc // max_flops_cap)
        slab_cap, slab_rows = _slab_bounds_host(a, a, num_slabs)
        def run():
            return spgemm_rowchunked(
                a, a, num_slabs=num_slabs, slab_rows=slab_rows,
                flops_cap=slab_cap, out_capacity=tight,
            )

    nnz_c = int(run().nnz)  # compile + warmup, hard sync
    t0 = time.perf_counter()
    for _ in range(iters):
        nnz_c = int(run().nnz)  # scalar pull forces execution
    dt = (time.perf_counter() - t0) / iters
    return dict(
        scale=scale,
        nnz_a=int(a.nnz),
        flops=flops,
        nnz_c=nnz_c,
        secs=round(dt, 4),
        products_per_s=flops / dt,
    )


def bench_spmm(scale: int, d: int, iters: int):
    """Sparse×tall-dense (SpMMError/Roofline path): GB/s streamed."""
    import jax
    import jax.numpy as jnp
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.ops.spmv import spmm

    a = rmat_matrix(jax.random.PRNGKey(7), scale=scale, edgefactor=16)
    n = a.shape[1]
    x = jax.random.uniform(jax.random.PRNGKey(8), (n, d), jnp.float32)
    nnz = int(a.nnz)
    bytes_moved = nnz * (4 + 4 + 4) + nnz * d * 4 * 2  # gather + accumulate
    # ``inner`` repeats ride INSIDE one jit (carry-fed so XLA cannot elide
    # them), so per-dispatch overhead does not swamp a millisecond kernel
    inner = 10

    @jax.jit
    def many(x):
        def body(i, acc):
            y = spmm(a, x + acc * 0)
            return acc + y[0, 0]
        return jax.lax.fori_loop(0, inner, body, jnp.float32(0))

    float(many(x))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(max(iters, 3)):
        float(many(x))
    dt = (time.perf_counter() - t0) / (max(iters, 3) * inner)
    return dict(scale=scale, d=d, secs=round(dt, 6),
                gb_per_s=bytes_moved / dt / 1e9,
                gflops=2 * nnz * d / dt / 1e9)


def bench_bfs(scale: int, iters: int, nroots: int = 64, validate: int = 4):
    """BFS TEPS on a symmetrized R-MAT graph (``TopDownBFS.cpp:437-443``).

    Graph500-style methodology: 64 search keys sampled among vertices with
    degree >= 1 (the spec's key count); traversed edges counted as the sum
    of degrees of visited vertices / 2 (each undirected edge twice in the
    symmetrized adjacency); parents validated post-timing against the edge
    list for ``validate`` roots (``TopDownBFS.cpp:448-457``).  Runs the
    device-resident batched pull pipeline (``models/bfs.py:
    bfs_batch_pull``): ALL roots traverse in ONE dispatch, zero per-level
    host round trips.  Timing syncs on a scalar; the (R, n) result arrays
    stay on device (Graph500 likewise leaves kernel-2 output
    distributed)."""
    import jax
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.models.bfs import bfs_batch_prepare, bfs_batch_pull

    a = rmat_matrix(jax.random.PRNGKey(9), scale=scale, edgefactor=16,
                    symmetrize=True, remove_self_loops=True)
    nnz = int(a.nnz)
    prep = bfs_batch_prepare(a)
    rp = np.asarray(a.row_ptr())
    deg = rp[1:] - rp[:-1]
    cand = np.flatnonzero(deg > 0)
    rng = np.random.default_rng(1)
    roots = rng.choice(cand, size=min(nroots, len(cand)), replace=False)
    P, L = bfs_batch_pull(a, roots, prep=prep)  # compile + warm
    _ = int(jax.device_get(L[0, 0]))
    times = []
    for _ in range(max(iters, 2)):
        t0 = time.perf_counter()
        P, L = bfs_batch_pull(a, roots, prep=prep)
        _ = int(jax.device_get(L[0, 0]))  # data-dependent scalar sync
        times.append(time.perf_counter() - t0)
    batch_secs = min(times)
    per_root = batch_secs / len(roots)
    lv = np.asarray(L)
    vis = lv >= 0
    visited = int(vis[0].sum())
    edges = [int(deg[v].sum()) // 2 for v in vis]
    teps = [e / per_root for e in edges]
    hmean = len(teps) / sum(1.0 / t for t in teps if t > 0)
    ok = True
    arow, acol = np.asarray(a.row)[:nnz], np.asarray(a.col)[:nnz]
    ekeys = arow.astype(np.int64) * a.shape[1] + acol
    ekeys.sort()
    Ph = np.asarray(P)
    for i, r in enumerate(roots[:validate]):
        p, l = Ph[i], lv[i]
        visr = np.flatnonzero((l > 0))
        pe = p[visr].astype(np.int64) * a.shape[1] + visr
        found = np.searchsorted(ekeys, pe)
        ok &= bool(np.all(ekeys[np.minimum(found, len(ekeys) - 1)] == pe))
        ok &= bool(np.all(l[visr] == l[p[visr]] + 1))
        ok &= bool(p[r] == r and l[r] == 0)
    return dict(scale=scale, nnz=nnz, visited=visited, roots=len(roots),
                validated=bool(ok),
                batch_secs=round(batch_secs, 4),
                mean_secs=round(per_root, 4),
                gteps=hmean / 1e9)


def bench_spmsv(scale: int, iters: int, frontier_frac: float = 0.01):
    """Masked SpMSpV step timing (SpMSpV-IPDPS2017/SpMSpVBench counterpart):
    one frontier push on an R-MAT graph with a sparse frontier."""
    import jax
    import jax.numpy as jnp
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.ops.spmv import spmsv_masked
    from combblas_tpu.semiring import MAX_SECOND

    a = rmat_matrix(jax.random.PRNGKey(11), scale=scale, edgefactor=16,
                    symmetrize=True)
    n = a.shape[0]
    k = max(1, int(n * frontier_frac))
    mask = jnp.zeros((n,), jnp.bool_).at[
        jax.random.choice(jax.random.PRNGKey(12), n, (k,), replace=False)
    ].set(True)
    vals = jnp.arange(1, n + 1, dtype=jnp.int32)
    # inner repeats ride one jit (mask fed forward so XLA cannot elide
    # them): a single SpMSpV step is shorter than one dispatch
    inner = 16

    @jax.jit
    def many(mask):
        def body(i, m):
            y, ym = spmsv_masked(a, vals, m, MAX_SECOND, transpose=True)
            return jnp.where(i < 0, ym, m) | (jnp.sum(ym) < 0)
        return jax.lax.fori_loop(0, inner, body, mask)

    y, ym = spmsv_masked(a, vals, mask, MAX_SECOND, transpose=True)
    touched = int(jnp.sum(ym))
    _ = bool(jax.device_get(many(mask)[0]))
    t0 = time.perf_counter()
    for _ in range(max(iters, 2)):
        _ = bool(jax.device_get(many(mask)[0]))
    dt = (time.perf_counter() - t0) / (max(iters, 2) * inner)
    return dict(scale=scale, frontier=k, reached=touched, secs=round(dt, 5),
                edges_per_s=int(int(a.nnz) / dt))


def bench_mcl(scale: int, max_secs: float = 150.0):
    """MCL (HipMCL) on one device — the flagship application the
    phased/pruned SpGEMM machinery exists for (``Applications/MCL.cpp:515-686``,
    the IPDPS'20 HipMCL loop).  Times every iteration of the full pipeline
    (expansion SpGEMM + prune/select/recover + inflation + column
    renormalization + chaos) on an SSCA-style R-MAT under a wall-clock cap.
    Reports steady-state secs/iter (median of iterations >= 3 —
    iterations 1-2 carry the two compile generations of the frozen-plan
    discipline) separately from first-iteration compile time."""
    import jax
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.models.mcl import MCLParams, mcl_local

    a0 = rmat_matrix(jax.random.PRNGKey(21), scale=scale, edgefactor=8,
                     probs=SSCA, symmetrize=True, remove_self_loops=True)
    # bounded selection: HipMCL's protein-network default (select=1100)
    # makes the expansion's product count scale as n*select^2 — beyond the
    # 2^31 sort limit at bench scales.  select=64 keeps the same
    # prune/select/recover machinery on a bench-sized budget
    # (-select/-recover_num are runtime params in the reference too,
    # MCL.cpp:233-371).
    p = MCLParams(select=64, recover_num=80)
    iter_secs, chaos_tail = [], []

    def on_iter(it, ch, secs, _a):
        iter_secs.append(secs)
        chaos_tail.append(round(ch, 5))

    t0 = time.perf_counter()
    labels, iters = mcl_local(a0, p, on_iter=on_iter,
                              deadline=t0 + max_secs)
    total = time.perf_counter() - t0
    nclusters = int(len(np.unique(np.asarray(labels))))
    steady = sorted(iter_secs[2:] or iter_secs)
    steady = steady[len(steady) // 2]
    converged = chaos_tail[-1] < p.eps if chaos_tail else False
    return dict(scale=scale, nnz=int(a0.nnz), iters=int(iters),
                converged=bool(converged),
                first_iter_secs=round(iter_secs[0], 3) if iter_secs else None,
                steady_secs_per_iter=round(steady, 3),
                total_secs=round(total, 2), clusters=nclusters)


def bench_ewise(iters: int, inner: int = 256):
    """EWiseApply roofline sweep (``ReleaseTests/Roofline.cpp:69-81``).

    ``inner`` repeats ride INSIDE one jit (a fori_loop whose carry feeds
    the next apply) so per-dispatch latency is amortized — one dispatch per
    timed sample, as the reference's tight in-process loop has no per-op
    launch either.

    Each inner apply multiplies the carry by a FRESH slice of a 256 MB
    buffer (larger than any on-chip cache), so the per-apply operand read
    streams from device memory, like the reference's memory-streaming
    roofline.  Per element-op traffic: 1 fresh operand read + carry
    read/write."""
    import jax
    import jax.numpy as jnp

    big_len = 1 << 26  # 256 MB of f32
    big = jax.random.uniform(jax.random.PRNGKey(3), (big_len,), jnp.float32)
    best = 0.0
    detail = {}
    for ln in (1 << 15, 1 << 20, 1 << 24):
        x = jax.random.uniform(jax.random.PRNGKey(1), (ln,), jnp.float32)
        nslices = big_len // ln

        @jax.jit
        def ew(x, big):
            def body(i, c):
                off = (i % nslices) * ln
                sl = jax.lax.dynamic_slice(big, (off,), (ln,))
                return c * sl + 1e-7
            return jnp.sum(jax.lax.fori_loop(0, inner, body, x))

        s = float(ew(x, big))
        t0 = time.perf_counter()
        for _ in range(iters):
            s = float(ew(x, big))
        dt = (time.perf_counter() - t0) / (iters * inner)
        detail[f"len_{ln}"] = round(ln / dt / 1e9, 2)
        best = max(best, ln / dt)
    return dict(gteps=best / 1e9, per_len_gteps=detail,
                hbm_gbps_lower_bound=round(best * 4 / 1e9, 1))


def main():
    import jax

    from combblas_tpu.utils.compile_cache import enable_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22,
                    help="headline scale (reference log exists for 21/22/23)")
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--max-flops-cap", type=int, default=1 << 28)
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("BENCH_BUDGET_SECS", 1500)),
                    help="total wall-clock budget (s); the scale-22 headline "
                         "stops mid-stream and reports partial slabs/s "
                         "rather than overrun it")
    ap.add_argument("--quick", action="store_true",
                    help="G500 scale-14 A² line only")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scale-12 line, 1 iter")
    ap.add_argument("--headline-only", action="store_true",
                    help="skip fast lines; run only the budgeted headline")
    args = ap.parse_args()
    if (jax.devices()[0].platform == "cpu"
            and os.environ.get("JAX_PLATFORMS", "").strip() != "cpu"):
        raise SystemExit("bench.py: no accelerator found (set "
                         "JAX_PLATFORMS=cpu to run on the CPU on purpose)")
    enable_compile_cache()
    dev = _device_fields()
    t_start = time.perf_counter()

    def emit(line):
        print(json.dumps({**line, **dev}), flush=True)

    def first_line(scale, iters):
        # materialized cheap lines keep the 2^27 slab budget: they hold the
        # full C plus slab buffers at once
        r = bench_spgemm(scale, args.edgefactor, iters,
                         min(args.max_flops_cap, 1 << 27))
        emit({
            "metric": f"rmat_scale{scale}_A2_spgemm_products_per_s",
            "value": round(r["products_per_s"] / 1e6, 2),
            "unit": "Mproducts/s",
            "detail": {k: v for k, v in r.items() if k != "products_per_s"},
        })

    if args.smoke:
        first_line(12, 1)
        return
    if args.quick:
        first_line(14, args.iters)
        return

    # ---- cheap, round-over-round-comparable lines FIRST ----
    if not args.headline_only:
        first_line(14, args.iters)
        for name, fn, kw in (
            ("rmat_scale16_A2_spgemm", bench_spgemm,
             dict(scale=16, edgefactor=16, iters=args.iters,
                  max_flops_cap=min(args.max_flops_cap, 1 << 27))),
            ("spmm_gbps", bench_spmm, dict(scale=16, d=128,
                                           iters=args.iters)),
            ("bfs_gteps", bench_bfs, dict(scale=18, iters=1)),
            ("spmsv", bench_spmsv, dict(scale=14, iters=args.iters)),
            ("mcl", bench_mcl, dict(scale=14)),
            ("ewise_gteps", bench_ewise, dict(iters=args.iters)),
        ):
            try:
                rr = fn(**kw)
                if "products_per_s" in rr:
                    rr["Mproducts_per_s"] = round(
                        rr.pop("products_per_s") / 1e6, 2)
                emit({"metric": name, "detail": rr})
            except Exception as e:  # secondary benches must not kill line 1
                emit({"metric": name, "error": repr(e)})

    # ---- budgeted scale-22 headline LAST ----
    remaining = args.budget - (time.perf_counter() - t_start)
    metric = f"rmat_scale{args.scale}_A2_spgemm_products_per_s"
    if remaining < 240:  # not even one slab + compile would land
        emit({"metric": metric, "skipped": "budget",
              "remaining_secs": round(remaining, 1)})
        return
    try:
        r = bench_spgemm22(args.scale, args.max_flops_cap,
                           deadline=t_start + args.budget)
    except Exception as e:
        emit({"metric": metric, "error": repr(e)})
        return
    emit({
        "metric": metric,
        "value": round(r["products_per_s"] / 1e6, 2),
        "unit": "Mproducts/s",
        "detail": {k: v for k, v in r.items() if k != "products_per_s"},
    })


if __name__ == "__main__":
    main()
