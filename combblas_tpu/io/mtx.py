"""Matrix Market I/O.

Counterpart of the reference's ``mmio.c`` + ``SpParMat::ParallelReadMM``
(``SpParMat.cpp:3980``) / ``ParallelWriteMM`` (``SpParMat.cpp:4120``).  The
reference splits the file into per-rank byte ranges with MPI-IO; on one host
the file lives on one host filesystem, so reading is a host-side parse followed
by device placement (and, for distributed matrices, a single sharded
device_put — the 2D "shuffle" is a layout computation, not communication).

A native C++ parser (csrc/mmparse.cpp, loaded via ctypes) is used when built —
text parsing is the one genuinely host-CPU-bound step — with a numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from combblas_tpu.ops.coo import SpCOO

__all__ = ["read_mtx", "read_mtx_arrays", "write_mtx"]

_NATIVE: Optional[ctypes.CDLL] = None
_NATIVE_TRIED = False


def _native_lib() -> Optional[ctypes.CDLL]:
    """Load the C++ fast parser if it has been built (see csrc/)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "csrc", "libmmparse.so"),
        os.path.join(os.path.dirname(__file__), "libmmparse.so"),
    ):
        if os.path.exists(cand):
            lib = ctypes.CDLL(cand)
            lib.mm_parse.restype = ctypes.c_longlong
            lib.mm_parse.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_longlong),  # m
                ctypes.POINTER(ctypes.c_longlong),  # n
                ctypes.POINTER(ctypes.c_longlong),  # nnz (entries incl. sym)
                ctypes.POINTER(ctypes.c_int),       # flags: 1=pattern 2=symmetric
                np.ctypeslib.ndpointer(np.int32),
                np.ctypeslib.ndpointer(np.int32),
                np.ctypeslib.ndpointer(np.float32),
                ctypes.c_longlong,                  # capacity of out arrays
            ]
            lib.mm_count.restype = ctypes.c_longlong
            lib.mm_count.argtypes = [ctypes.c_char_p]
            _NATIVE = lib
            break
    return _NATIVE


def read_mtx_arrays(path: str):
    """Parse a Matrix Market coordinate file to host numpy (row, col, val, shape).

    Handles ``general``/``symmetric`` symmetry and ``pattern``/``real``/
    ``integer`` fields, 1-based -> 0-based conversion (``mmio.c`` semantics).
    """
    lib = _native_lib()
    if lib is not None:
        cap = int(lib.mm_count(path.encode()))
        if cap >= 0:
            m = ctypes.c_longlong()
            n = ctypes.c_longlong()
            nnz = ctypes.c_longlong()
            flags = ctypes.c_int()
            row = np.empty(max(cap, 1), np.int32)
            col = np.empty(max(cap, 1), np.int32)
            val = np.empty(max(cap, 1), np.float32)
            got = int(
                lib.mm_parse(
                    path.encode(),
                    ctypes.byref(m),
                    ctypes.byref(n),
                    ctypes.byref(nnz),
                    ctypes.byref(flags),
                    row,
                    col,
                    val,
                    cap,
                )
            )
            if got >= 0:
                return row[:got], col[:got], val[:got], (m.value, n.value)
    return _read_mtx_numpy(path)


def _read_mtx_numpy(path: str):
    with open(path, "rb") as f:
        first = f.readline().decode()
        header = first.strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            # headerless triple file ("m n nnz" first line) — the reference's
            # ReadDistribute accepts these (e.g. ReleaseTests/small_nonsym.mtx)
            try:
                m, n, nnz = (int(t) for t in first.split())
            except Exception:
                raise ValueError(f"not a MatrixMarket file: {path}")
            data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
            row = data[:, 0].astype(np.int32) - 1
            col = data[:, 1].astype(np.int32) - 1
            val = (
                data[:, 2].astype(np.float32)
                if data.shape[1] > 2
                else np.ones(row.shape[0], np.float32)
            )
            return row, col, val, (m, n)
        _, obj, fmt, field, symmetry = header[:5]
        if fmt != "coordinate":
            raise ValueError("only coordinate format supported")
        pattern = field == "pattern"
        line = f.readline().decode()
        while line.startswith("%") or not line.strip():
            line = f.readline().decode()
        parts = line.split()
        m, n, nnz = int(parts[0]), int(parts[1]), int(parts[2])
        data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
    if nnz and data.shape[0] != nnz:
        raise ValueError(f"expected {nnz} entries, got {data.shape[0]}")
    row = data[:, 0].astype(np.int32) - 1
    col = data[:, 1].astype(np.int32) - 1
    if pattern or data.shape[1] < 3:
        val = np.ones(row.shape[0], np.float32)
    else:
        val = data[:, 2].astype(np.float32)
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = row != col
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        row = np.concatenate([row, col[off]])
        col2 = np.concatenate([col, data[:, 0].astype(np.int32)[off] - 1])
        val = np.concatenate([val, sign * val[off]])
        col = col2
    return row, col, val, (m, n)


def read_mtx(path: str, capacity: int | None = None, dtype=None) -> SpCOO:
    """Read a Matrix Market file into a local SpCOO."""
    row, col, val, shape = read_mtx_arrays(path)
    return SpCOO.from_arrays(row, col, val, shape, capacity=capacity, dtype=dtype)


def write_mtx(path: str, a: SpCOO, comment: str = "") -> None:
    """Write a local SpCOO as 1-based Matrix Market coordinate real general
    (``ParallelWriteMM`` output format, ``SpParMat.cpp:4120``)."""
    nnz = int(a.nnz)
    row = np.asarray(a.row)[:nnz] + 1
    col = np.asarray(a.col)[:nnz] + 1
    val = np.asarray(a.val)[:nnz]
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            f.write(f"%{comment}\n")
        f.write(f"{a.shape[0]}\t{a.shape[1]}\t{nnz}\n")
        for r, c, v in zip(row, col, val):
            f.write(f"{r}\t{c}\t{v:.9g}\n")
