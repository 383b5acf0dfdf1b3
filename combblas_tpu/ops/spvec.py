"""SpVec — capacity-padded sparse vector (index/value pairs).

Counterpart of ``FullyDistSpVec`` (``FullyDistSpVec.h:73-331``) at
the *local* level: a sorted, deduplicated (index, value) list with static
capacity and traced nnz.  On the device most algorithms prefer the masked-dense view
(values + bool mask) because O(n) streaming is cheap; SpVec exists for API
parity, for genuinely hypersparse vectors, and for the set ops the reference
offers (Invert, Uniq, Select, SetMinus, sort).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SpVec"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpVec:
    """Padded sparse vector: first nnz of (idx, val) are real, rest sentinel
    (idx == length)."""

    idx: jax.Array  # int32[capacity], sorted ascending
    val: jax.Array  # dtype[capacity]
    nnz: jax.Array  # int32 scalar
    length: int = dataclasses.field(metadata=dict(static=True))

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]

    def mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_arrays(idx, val, length: int, capacity: int | None = None) -> "SpVec":
        idx = np.asarray(idx, np.int32)
        val = np.asarray(val)
        if val.dtype == np.float64:
            val = val.astype(np.float32)
        order = np.argsort(idx, kind="stable")
        idx, val = idx[order], val[order]
        nnz = idx.size
        cap = capacity or max(8, 1 << int(np.ceil(np.log2(max(nnz, 1)))))
        pidx = np.full(cap, length, np.int32)
        pval = np.zeros(cap, val.dtype)
        pidx[:nnz], pval[:nnz] = idx, val
        return SpVec(jnp.asarray(pidx), jnp.asarray(pval),
                     jnp.asarray(nnz, jnp.int32), int(length))

    @staticmethod
    def from_dense_mask(val: jax.Array, mask: jax.Array,
                        capacity: int | None = None) -> "SpVec":
        """Jittable: compact a masked-dense vector into index/value form."""
        n = val.shape[0]
        cap = capacity or n
        dest = jnp.cumsum(mask.astype(jnp.int32)) - 1
        nnz = jnp.maximum(dest[-1] + 1, 0)
        dest = jnp.where(mask, dest, cap)
        ar = jnp.arange(n, dtype=jnp.int32)
        idx = jnp.full((cap,), n, jnp.int32).at[dest].set(ar, mode="drop")
        v = jnp.zeros((cap,), val.dtype).at[dest].set(val, mode="drop")
        return SpVec(idx, v, nnz.astype(jnp.int32), n)

    # -- conversions ------------------------------------------------------
    def to_dense(self, fill=0) -> jax.Array:
        out = jnp.full((self.length + 1,), fill, self.val.dtype)
        out = out.at[jnp.minimum(self.idx, self.length)].set(
            jnp.where(self.mask(), self.val, fill)
        )
        return out[: self.length]

    def to_dense_mask(self) -> Tuple[jax.Array, jax.Array]:
        n = self.length
        dm = jnp.zeros((n + 1,), jnp.bool_).at[jnp.minimum(self.idx, n)].set(
            self.mask()
        )[:n]
        return self.to_dense(), dm

    # -- FullyDistSpVec-parity ops ---------------------------------------
    def invert(self, new_length: int, capacity: int | None = None) -> "SpVec":
        """Value <-> index swap (``FullyDistSpVec::Invert``, ``.h:89``).
        Values must be integral and unique; duplicates keep an arbitrary one."""
        cap = capacity or self.capacity
        nidx = jnp.where(self.mask(), self.val.astype(jnp.int32), new_length)
        nval = jnp.where(self.mask(), self.idx, 0).astype(self.val.dtype)
        nidx_s, nval_s = jax.lax.sort((nidx, nval), num_keys=1)
        out = SpVec(nidx_s[:cap], nval_s[:cap], self.nnz, int(new_length))
        return out

    def select(self, pred) -> "SpVec":
        """Keep entries whose value satisfies pred (``FilterByVal`` family)."""
        keep = self.mask() & pred(self.val)
        dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
        nnz = jnp.maximum(dest[-1] + 1, 0)
        dest = jnp.where(keep, dest, self.capacity)
        idx = jnp.full((self.capacity,), self.length, jnp.int32).at[dest].set(
            self.idx, mode="drop"
        )
        val = jnp.zeros((self.capacity,), self.val.dtype).at[dest].set(
            self.val, mode="drop"
        )
        return SpVec(idx, val, nnz.astype(jnp.int32), self.length)

    def set_minus(self, other: "SpVec") -> "SpVec":
        """Entries of self at indices not present in other (``SetMinus``)."""
        present = jnp.zeros((self.length + 1,), jnp.bool_).at[
            jnp.minimum(other.idx, other.length)
        ].set(other.mask())
        keep_idx = ~present[jnp.minimum(self.idx, self.length)]
        return self.select_by_mask(keep_idx)

    def select_by_mask(self, keep: jax.Array) -> "SpVec":
        keep = keep & self.mask()
        dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
        nnz = jnp.maximum(dest[-1] + 1, 0)
        dest = jnp.where(keep, dest, self.capacity)
        idx = jnp.full((self.capacity,), self.length, jnp.int32).at[dest].set(
            self.idx, mode="drop"
        )
        val = jnp.zeros((self.capacity,), self.val.dtype).at[dest].set(
            self.val, mode="drop"
        )
        return SpVec(idx, val, nnz.astype(jnp.int32), self.length)

    def sort_by_value(self) -> "SpVec":
        """Sort entries by value (``FullyDistSpVec::sort``, ``.cpp:712``);
        returns a vector whose idx order follows ascending value."""
        v = jnp.where(self.mask(), self.val, jnp.inf if
                      jnp.issubdtype(self.val.dtype, jnp.floating)
                      else jnp.iinfo(self.val.dtype).max)
        val_s, idx_s = jax.lax.sort((v, self.idx), num_keys=1)
        val_s = jnp.where(jnp.arange(self.capacity) < self.nnz, val_s, 0)
        return SpVec(idx_s, val_s.astype(self.val.dtype), self.nnz, self.length)
