"""Semantic (attributed-edge) graphs — the TwitterEdge / SemanticGraph parity.

The reference's ``TwitterEdge`` (``Applications/TwitterEdge.h:15``) carries
(count: short, follower: bool, latest: time_t) per edge and FilteredBFS
(``FilteredBFS.cpp:129``) traverses only edges passing a time-window
predicate; ``SemanticGraph.h`` is the generic wrapper.

Design: attributes pack into the f32 value lanes of a standard
:class:`SpCOO` — (follower flag, retweet count, latest timestamp) become a
single non-negative code, so the attributed graph IS a sparse matrix and
every structural op (transpose, SpGEMM, SpRef, ...) applies unchanged.
Predicates (:func:`tweet_within_interval`, ...) decode the packed code
vectorized, and :func:`combblas_tpu.models.filtered.bfs_filtered` fuses them
into the traversal — the reference's "late filtering" without per-edge
virtual calls.

Packing: code = follower + 2*count + 2*COUNT_LIM*quantized_time, exact in
f32 while code < 2^24 (~86 retweets x 48k time buckets; matching the
reference's demo data scale — assert-guarded).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.models.filtered import bfs_filtered, materialize_filtered
from combblas_tpu.ops.coo import SpCOO

__all__ = [
    "TwitterGraph",
    "pack_twitter",
    "unpack_twitter",
    "tweet_within_interval",
    "tweet_since",
    "is_follower",
]

_COUNT_LIM = 128          # retweet count saturates here
_TIME_LIM = (1 << 24) // (2 * _COUNT_LIM)  # quantized-time buckets


def pack_twitter(follower, count, latest) -> np.ndarray:
    """Pack (follower bool, retweet count, latest time-bucket) into f32-exact
    codes (``TwitterEdge(mycount, myfollow, mylatest)``,
    ``TwitterEdge.h:22``)."""
    follower = np.asarray(follower).astype(np.int64)
    count = np.minimum(np.asarray(count).astype(np.int64), _COUNT_LIM - 1)
    latest = np.asarray(latest).astype(np.int64)
    assert (latest < _TIME_LIM).all() and (latest >= 0).all(), (
        "time bucket out of range; rescale timestamps")
    code = follower + 2 * count + 2 * _COUNT_LIM * latest
    # the all-zero attribute would collide with SpCOO's structural zero, so
    # shift by 1 (decoded transparently)
    return (code + 1).astype(np.float32)


def unpack_twitter(code: jax.Array):
    """Inverse of :func:`pack_twitter` (vectorized, jit-safe)."""
    c = code.astype(jnp.int32) - 1
    follower = (c & 1) > 0
    count = (c >> 1) % _COUNT_LIM
    latest = c // (2 * _COUNT_LIM)
    present = code != 0
    return follower & present, jnp.where(present, count, 0), \
        jnp.where(present, latest, 0)


def is_follower(code: jax.Array) -> jax.Array:
    """``TwitterEdge::isFollower`` (``TwitterEdge.h:23``)."""
    f, _, _ = unpack_twitter(code)
    return f


def tweet_since(begin: int) -> Callable:
    """Predicate factory: ``TweetSince`` (``TwitterEdge.h:26``)."""

    def pred(code):
        _, cnt, latest = unpack_twitter(code)
        return (cnt > 0) & (latest >= begin)

    return pred


def tweet_within_interval(begin: int, end: int) -> Callable:
    """Predicate factory: ``TweetWithinInterval`` (``TwitterEdge.h:25``) —
    the FilteredBFS traversal filter (``FilteredBFS.cpp:259`` builds the
    same time-window functor)."""

    def pred(code):
        _, cnt, latest = unpack_twitter(code)
        return (cnt > 0) & (latest >= begin) & (latest <= end)

    return pred


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TwitterGraph:
    """SemanticGraph over Twitter-style edges: an :class:`SpCOO` whose values
    are packed attribute codes."""

    mat: SpCOO

    @staticmethod
    def build(src, dst, follower, count, latest, n: int) -> "TwitterGraph":
        codes = pack_twitter(follower, count, latest)
        return TwitterGraph(
            SpCOO.from_arrays(src, dst, codes, (n, n), sum_duplicates=False)
        )

    def bfs_within(self, root: int, begin: int, end: int):
        """Filtered BFS traversing only retweet edges inside [begin, end] —
        the FilteredBFS driver loop (``FilteredBFS.cpp:129``)."""
        return bfs_filtered(self.mat, root, tweet_within_interval(begin, end))

    def subgraph_within(self, begin: int, end: int) -> SpCOO:
        """Materialized semantic subgraph (repeated-query path)."""
        return materialize_filtered(
            self.mat, tweet_within_interval(begin, end))

    def distribute(self, grid):
        """Place the semantic graph on a 2D grid: a DistSpMat whose values
        are the packed codes.  Drive with
        :func:`combblas_tpu.models.filtered.bfs_filtered_dist` /
        ``mis_filtered_dist`` — the distributed FilteredBFS/FilteredMIS."""
        from combblas_tpu.parallel.dist import DistSpMat

        return DistSpMat.from_local(self.mat, grid)

    def bfs_within_dist(self, grid_or_mat, root: int, begin: int, end: int):
        """Distributed filtered BFS (``FilteredBFS.cpp:129`` on the mesh)."""
        from combblas_tpu.models.filtered import bfs_filtered_dist
        from combblas_tpu.parallel.dist import DistSpMat

        mat = (grid_or_mat if isinstance(grid_or_mat, DistSpMat)
               else self.distribute(grid_or_mat))
        return bfs_filtered_dist(mat, root, tweet_within_interval(begin, end))
