"""Command-line drivers — the counterpart of the reference's L4 executables.

The reference ships each application as an MPI main (``Applications/``,
``ReleaseTests/`` — SURVEY.md §1 L4); here one entry point exposes them as
subcommands over shared I/O and grid setup:

    python -m combblas_tpu.cli bfs      graph.mtx --root 0
    python -m combblas_tpu.cli cc       graph.mtx [--algo fastsv|lacc]
    python -m combblas_tpu.cli mcl      graph.mtx --inflation 2
    python -m combblas_tpu.cli bc       graph.mtx --batch 32
    python -m combblas_tpu.cli spgemm   A.mtx B.mtx -o C.mtx
    python -m combblas_tpu.cli gen      --scale 14 -o rmat.mtx
    python -m combblas_tpu.cli convert  A.mtx -o A.bin
    python -m combblas_tpu.cli match    bipartite.mtx [--max|--awpm]
    python -m combblas_tpu.cli rcm      graph.mtx

``--dist`` runs the distributed variant over all visible devices.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _load(path, symmetrize=False):
    from combblas_tpu.io.binary import read_binary
    from combblas_tpu.io.mtx import read_mtx
    from combblas_tpu.ops.coo import merge

    a = read_binary(path) if path.endswith(".bin") else read_mtx(path)
    if symmetrize:
        a = merge(a, a.transpose())
    return a


def _save(path, a):
    from combblas_tpu.io.binary import write_binary
    from combblas_tpu.io.mtx import write_mtx

    (write_binary if path.endswith(".bin") else write_mtx)(path, a)


def cmd_bfs(args):
    a = _load(args.matrix, symmetrize=args.symmetrize)
    if args.dist:
        from combblas_tpu.parallel.dist import DistSpMat
        from combblas_tpu.parallel.grid import default_grid
        from combblas_tpu.models.bfs import bfs_dist

        A = DistSpMat.from_local(a, default_grid())
        t0 = time.perf_counter()
        parents, levels = bfs_dist(A, args.root)
    else:
        from combblas_tpu.models.bfs import bfs_dir_opt_local, bfs_local

        fn = bfs_dir_opt_local if args.dir_opt else bfs_local
        t0 = time.perf_counter()
        parents, levels = fn(a, args.root)
    lv = np.asarray(levels)
    visited = int((lv >= 0).sum())
    print(f"bfs: visited {visited} vertices, max level {int(lv.max())}, "
          f"{time.perf_counter() - t0:.3f}s")


def cmd_cc(args):
    a = _load(args.matrix, symmetrize=True)
    from combblas_tpu.models.cc import count_components, fastsv_local
    from combblas_tpu.models.lacc import lacc_local

    if args.dist:
        from combblas_tpu.parallel.dist import DistSpMat
        from combblas_tpu.parallel.grid import default_grid
        from combblas_tpu.models.cc import fastsv_dist

        labels = fastsv_dist(DistSpMat.from_local(a, default_grid()))
        n = a.shape[0]
    else:
        fn = lacc_local if args.algo == "lacc" else fastsv_local
        labels = fn(a)
        n = None
    print(f"cc[{args.algo}]: {count_components(labels, n)} components")


def cmd_mcl(args):
    from combblas_tpu.models.mcl import MCLParams, mcl_dist, mcl_local

    a = _load(args.matrix)
    p = MCLParams(inflation=args.inflation, select=args.select,
                  max_iters=args.max_iters)
    if args.dist:
        from combblas_tpu.parallel.dist import DistSpMat
        from combblas_tpu.parallel.grid import default_grid

        labels, iters = mcl_dist(DistSpMat.from_local(a, default_grid()), p,
                                 phases=args.phases, verbose=args.verbose)
    else:
        labels, iters = mcl_local(a, p, verbose=args.verbose)
    lab = np.asarray(labels)[: a.shape[0]]
    print(f"mcl: {len(np.unique(lab))} clusters in {iters} iterations")


def cmd_bc(args):
    from combblas_tpu.models.bc import betweenness_centrality

    a = _load(args.matrix, symmetrize=args.symmetrize)
    n = a.shape[0]
    sources = None if args.batches is None else np.arange(
        min(n, args.batches * args.batch)
    )
    bc = betweenness_centrality(a, batch_size=args.batch, sources=sources)
    top = np.argsort(bc)[::-1][:5]
    print("bc top5:", [(int(v), round(float(bc[v]), 2)) for v in top])


def cmd_spgemm(args):
    from combblas_tpu.ops.spgemm import spgemm_auto
    from combblas_tpu.semiring import get_semiring

    a = _load(args.a)
    b = _load(args.b) if args.b else a
    t0 = time.perf_counter()
    c = spgemm_auto(a, b, get_semiring(args.semiring))
    nnz = int(c.nnz)
    print(f"spgemm: C {c.shape} nnz {nnz} in {time.perf_counter() - t0:.3f}s")
    if args.output:
        _save(args.output, c)


def cmd_galerkin(args):
    """Galerkin coarse-operator driver (``ReleaseTests/GalerkinNew.cpp:105``):
    MIS-2 restriction R then R·A·Rᵀ."""
    import jax
    from combblas_tpu.models.multigrid import galerkin, restriction_op

    a = _load(args.matrix)
    t0 = time.perf_counter()
    r = restriction_op(a, jax.random.PRNGKey(args.seed))
    c = galerkin(r, a)
    print(f"galerkin: coarse {c.shape} nnz {int(c.nnz)} "
          f"(R {r.shape}) in {time.perf_counter() - t0:.3f}s")
    if args.output:
        _save(args.output, c)


def cmd_gen(args):
    import jax
    from combblas_tpu.gen.rmat import rmat_matrix

    a = rmat_matrix(jax.random.PRNGKey(args.seed), scale=args.scale,
                    edgefactor=args.edgefactor, symmetrize=args.symmetrize)
    print(f"gen: rmat scale {args.scale}, nnz {int(a.nnz)}")
    if args.output:
        _save(args.output, a)


def cmd_convert(args):
    _save(args.output, _load(args.matrix))
    print(f"convert: {args.matrix} -> {args.output}")


def cmd_match(args):
    from combblas_tpu.models.matching import (
        awpm,
        bp_maximal_matching,
        bp_maximum_matching,
    )

    a = _load(args.matrix)
    if args.awpm:
        mr, mc = awpm(a)
        kind = "awpm"
    elif args.max:
        mr, mc = bp_maximum_matching(a)
        kind = "maximum"
    else:
        mr, mc = bp_maximal_matching(a)
        kind = "maximal"
    print(f"match[{kind}]: cardinality {int((np.asarray(mr) >= 0).sum())}")


def cmd_rcm(args):
    from combblas_tpu.models.ordering import rcm_order

    a = _load(args.matrix, symmetrize=True)
    order = np.asarray(rcm_order(a))
    print("rcm:", " ".join(map(str, order[: min(20, len(order))])),
          "..." if len(order) > 20 else "")


def cmd_md(args):
    from combblas_tpu.models.ordering import md_order

    a = _load(args.matrix, symmetrize=True)
    order = np.asarray(md_order(a))
    print("md:", " ".join(map(str, order[: min(20, len(order))])),
          "..." if len(order) > 20 else "")


def cmd_fbfs(args):
    """Filtered BFS with a value-window predicate (``FilteredBFS.cpp``) —
    edge values outside [--begin, --end] are skipped during traversal."""
    from combblas_tpu.models.filtered import bfs_filtered

    a = _load(args.matrix, symmetrize=args.symmetrize)
    lo, hi = args.begin, args.end
    t0 = time.perf_counter()
    parents, levels = bfs_filtered(a, args.root,
                                   lambda v: (v >= lo) & (v <= hi))
    lv = np.asarray(levels)
    print(f"fbfs: visited {(lv >= 0).sum()} / {a.shape[0]} "
          f"depth {lv.max()} in {time.perf_counter() - t0:.3f}s")


def cmd_fmis(args):
    """Filtered maximal independent set (``FilteredMIS.cpp``)."""
    import jax

    from combblas_tpu.models.filtered import mis_filtered

    a = _load(args.matrix, symmetrize=True)
    lo, hi = args.begin, args.end
    t0 = time.perf_counter()
    in_set = np.asarray(mis_filtered(a, jax.random.PRNGKey(args.seed),
                                     lambda v: (v >= lo) & (v <= hi)))
    print(f"fmis: |MIS| {int(in_set.sum())} / {a.shape[0]} "
          f"in {time.perf_counter() - t0:.3f}s")


def cmd_spgemm3d(args):
    """3D split-layer SpGEMM driver (``3DSpGEMM/mpipspgemm.cpp`` /
    ``Applications/SpGEMM3D.cpp``): A^2 on an (layers, r, c) mesh."""
    import jax

    from combblas_tpu.parallel.dist import DistSpMat
    from combblas_tpu.parallel.grid import ProcGrid
    from combblas_tpu.parallel.summa3d import Dist3DSpMat, summa3d_spgemm

    a = _load(args.matrix)
    n_dev = len(jax.devices())
    layers = args.layers
    side = int((n_dev // layers) ** 0.5)
    assert layers * side * side <= n_dev, (layers, n_dev)
    grid = ProcGrid.make(side, side, layers=layers,
                         devices=jax.devices()[: layers * side * side])
    A = Dist3DSpMat.from_local(a, grid)
    t0 = time.perf_counter()
    c = summa3d_spgemm(A, A)
    nnz = int(c.total_nnz())
    print(f"spgemm3d[layers={layers}]: nnz {nnz} "
          f"in {time.perf_counter() - t0:.3f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="combblas_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--dist", action="store_true",
                       help="run distributed over all devices")

    p = sub.add_parser("bfs"); p.add_argument("matrix"); common(p)
    p.add_argument("--root", type=int, default=0)
    p.add_argument("--dir-opt", action="store_true")
    p.add_argument("--symmetrize", action="store_true")
    p.set_defaults(fn=cmd_bfs)

    p = sub.add_parser("cc"); p.add_argument("matrix"); common(p)
    p.add_argument("--algo", choices=["fastsv", "lacc"], default="fastsv")
    p.set_defaults(fn=cmd_cc)

    p = sub.add_parser("mcl"); p.add_argument("matrix"); common(p)
    p.add_argument("--inflation", type=float, default=2.0)
    p.add_argument("--select", type=int, default=1100)
    p.add_argument("--phases", type=int, default=1)
    p.add_argument("--max-iters", type=int, default=100)
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_mcl)

    p = sub.add_parser("bc"); p.add_argument("matrix")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--batches", type=int, default=None)
    p.add_argument("--symmetrize", action="store_true")
    p.set_defaults(fn=cmd_bc)

    p = sub.add_parser("spgemm"); p.add_argument("a"); p.add_argument("b", nargs="?")
    p.add_argument("-o", "--output")
    p.add_argument("--semiring", default="plus_times")
    p.set_defaults(fn=cmd_spgemm)

    p = sub.add_parser("gen")
    p.add_argument("--scale", type=int, default=14)
    p.add_argument("--edgefactor", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--symmetrize", action="store_true")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_gen)

    p = sub.add_parser("convert"); p.add_argument("matrix")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("match"); p.add_argument("matrix")
    p.add_argument("--max", action="store_true")
    p.add_argument("--awpm", action="store_true")
    p.set_defaults(fn=cmd_match)

    p = sub.add_parser("rcm"); p.add_argument("matrix")
    p.set_defaults(fn=cmd_rcm)

    p = sub.add_parser("galerkin"); p.add_argument("matrix")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output")
    p.set_defaults(fn=cmd_galerkin)

    args = ap.parse_args(argv)
    from combblas_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
