"""Distributed parallel matrix write/read — ParallelWriteMM /
ParallelBinaryWrite counterparts (``SpParMat.cpp:4120`` and ``:620``).

The reference writes one file cooperatively: every rank formats its local
tuples, an exscan of byte counts yields each rank's file offset, and
MPI-IO writes land disjointly (``SpParMat.cpp:4162-4210``).  This build
does the same with the process grid: every *process* formats the blocks it
actually holds (``addressable_shards`` — no cross-host gather, unlike
``DistSpMat.to_local``), byte counts are allgathered (one tiny host
collective), and each process ``pwrite``s at its disjoint offset into the
shared file.  Single-process runs degenerate to sequential block-streamed
writes — still never materializing the assembled matrix, which is the point
at scale (a scale-22 product does not fit one host buffer comfortably).

Reads: :func:`parallel_read_mtx` byte-range-splits the file across processes
(the ``ParallelReadMM`` split, ``SpParMat.cpp:3980``), each parses its range
(via the native mmparse when available), and tuples route to their 2D block
owners through the standard constructor.
"""

from __future__ import annotations

import io
import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from combblas_tpu.parallel.dist import DistSpMat

__all__ = [
    "parallel_write_mtx",
    "parallel_write_binary",
    "parallel_read_mtx",
]


def _my_blocks(a: "DistSpMat"):
    """Yield (i, j, row, col, val, nnz) for every block THIS process holds,
    in block-raster order, pulling one block at a time (no full gather)."""
    import jax

    pr, pc = a.grid.pr, a.grid.pc
    nnz_host = np.asarray(a.nnz)  # (pr, pc) — tiny, replicated
    shards = {s.index: s for s in a.row.addressable_shards}
    col_shards = {s.index: s for s in a.col.addressable_shards}
    val_shards = {s.index: s for s in a.val.addressable_shards}
    for idx in sorted(shards, key=lambda ix: (ix[0].start or 0,
                                              ix[1].start or 0)):
        i = idx[0].start or 0
        j = idx[1].start or 0
        k = int(nnz_host[i, j])
        r = np.asarray(shards[idx].data).reshape(-1)[:k]
        c = np.asarray(col_shards[idx].data).reshape(-1)[:k]
        v = np.asarray(val_shards[idx].data).reshape(-1)[:k]
        yield i, j, r, c, v, k


def _allgather_host(values: np.ndarray) -> np.ndarray:
    """Allgather small host arrays across processes ((nprocs, ...) result);
    identity when single-process."""
    import jax

    if jax.process_count() <= 1:
        return values[None]
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(values))


def parallel_write_mtx(path: str, a: "DistSpMat", comment: str = "") -> None:
    """Cooperative Matrix Market write (``ParallelWriteMM``,
    ``SpParMat.cpp:4120``): blocks stream to disk at disjoint offsets; the
    assembled matrix never exists in memory."""
    import jax

    mb, nb = a.block_shape()
    pr, pc = a.grid.pr, a.grid.pc
    m, n = a.gshape
    total = int(np.asarray(a.nnz).sum())
    header = "%%MatrixMarket matrix coordinate real general\n"
    if comment:
        header += "".join(f"%{line}\n" for line in comment.splitlines())
    header += f"{m} {n} {total}\n"

    # format local blocks (1-indexed global coordinates, like the reference)
    chunks = []
    for i, j, r, c, v, k in _my_blocks(a):
        buf = io.StringIO()
        gr = r.astype(np.int64) + i * mb + 1
        gc = c.astype(np.int64) + j * nb + 1
        np.savetxt(buf, np.column_stack([gr, gc, v.astype(np.float64)]),
                   fmt="%d %d %.9g")
        chunks.append(buf.getvalue().encode())
    mine = b"".join(chunks)

    sizes = _allgather_host(np.asarray([len(mine)], np.int64))[:, 0]
    rank = jax.process_index()
    offset = len(header.encode()) + int(sizes[:rank].sum())
    total_bytes = len(header.encode()) + int(sizes.sum())
    if rank == 0:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.truncate(total_bytes)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("parallel_write_mtx_header")
    fd = os.open(path, os.O_WRONLY)
    try:
        os.pwrite(fd, mine, offset)
    finally:
        os.close(fd)


def parallel_write_binary(path: str, a: "DistSpMat") -> None:
    """Cooperative binary write (``ParallelBinaryWrite``,
    ``SpParMat.cpp:620``): fixed-size records make offsets a prefix sum of
    block nnz — no byte-count exchange beyond the (pr, pc) nnz array every
    process already holds.  Record layout matches ``io/binary.py``
    (CBTPU1: header, then int32 rows, int32 cols, values — each section
    laid out in block-raster order)."""
    import struct

    import jax

    from combblas_tpu.io.binary import _DTAGS, _MAGIC

    mb, nb = a.block_shape()
    pr, pc = a.grid.pr, a.grid.pc
    m, n = a.gshape
    nnz_host = np.asarray(a.nnz).astype(np.int64)
    total = int(nnz_host.sum())
    dt = np.dtype(a.val.dtype)
    head = _MAGIC + struct.pack("<qqqq", m, n, total, _DTAGS[np.dtype(dt)])
    h = len(head)
    # element offset of each block in the raster order
    flat = nnz_host.reshape(-1)
    starts = np.concatenate([[0], np.cumsum(flat)[:-1]]).reshape(pr, pc)
    rank = jax.process_index()
    if rank == 0:
        with open(path, "wb") as f:
            f.write(head)
            f.truncate(h + total * (4 + 4 + dt.itemsize))
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("parallel_write_bin_header")
    fd = os.open(path, os.O_WRONLY)
    try:
        for i, j, r, c, v, k in _my_blocks(a):
            e = int(starts[i, j])
            os.pwrite(fd, (r.astype("<i4") + i * mb).tobytes(), h + 4 * e)
            os.pwrite(fd, (c.astype("<i4") + j * nb).tobytes(),
                      h + 4 * total + 4 * e)
            os.pwrite(fd, v.astype(dt).tobytes(),
                      h + 8 * total + dt.itemsize * e)
    finally:
        os.close(fd)


def parallel_read_mtx(path: str, grid, capacity: int | None = None):
    """Byte-range-split Matrix Market read onto the grid
    (``ParallelReadMM``, ``SpParMat.cpp:3980``): each process parses its
    slice of the file (extended to line boundaries) and its tuples route to
    their 2D block owners.  Single-process: the whole file, parsed by the
    native multithreaded scanner when available."""
    import jax

    from combblas_tpu.parallel.dist import DistSpMat

    nproc = jax.process_count()
    if nproc <= 1:
        from combblas_tpu.io.mtx import read_mtx_arrays

        row, col, val, shape = read_mtx_arrays(path)
        return DistSpMat.from_coo_arrays(row, col, val, shape, grid,
                                         capacity=capacity)
    # multi-process: split the body after the header
    rank = jax.process_index()
    with open(path, "rb") as f:
        header_lines = []
        while True:
            pos = f.tell()
            line = f.readline()
            if line.startswith(b"%"):
                continue
            header_lines.append(line)
            break
        m, n, total = (int(x) for x in line.split()[:3])
        body_start = f.tell()
        f.seek(0, 2)
        end = f.tell()
        span = end - body_start
        lo = body_start + rank * span // nproc
        hi = body_start + (rank + 1) * span // nproc
        f.seek(lo)
        if rank > 0:
            f.readline()  # skip partial line (owned by the previous rank)
            lo = f.tell()
        data = f.read(hi - lo)
        if hi < end:  # finish the line that straddles the boundary
            f.seek(hi)
            data += f.readline()
    arr = np.loadtxt(io.BytesIO(data),
                     dtype=np.float64, ndmin=2) if data.strip() else \
        np.zeros((0, 3))
    row = arr[:, 0].astype(np.int64) - 1
    col = arr[:, 1].astype(np.int64) - 1
    val = arr[:, 2] if arr.shape[1] > 2 else np.ones(len(row))
    # route tuples to block owners: sizes exchange + padded allgather (the
    # reference's MPI_Alltoallv shuffle, SpParMat.cpp:2893; allgather is the
    # jax-native host exchange — each process then keeps only its blocks via
    # make_array_from_callback inside the constructor)
    from jax.experimental import multihost_utils

    sz = _allgather_host(np.asarray([len(row)], np.int64))[:, 0]
    mx = int(sz.max())

    def pad(x, fill):
        out = np.full((mx,), fill, x.dtype)
        out[: len(x)] = x
        return out

    rows_g = np.asarray(multihost_utils.process_allgather(pad(row, 0)))
    cols_g = np.asarray(multihost_utils.process_allgather(pad(col, 0)))
    vals_g = np.asarray(multihost_utils.process_allgather(pad(val, 0.0)))
    keep = np.concatenate([np.arange(mx) < s for s in sz])
    return DistSpMat.from_coo_arrays(
        rows_g.reshape(-1)[keep], cols_g.reshape(-1)[keep],
        vals_g.reshape(-1)[keep], (m, n), grid, capacity=capacity)
