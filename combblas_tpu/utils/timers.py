"""Phase timers and profiling helpers.

Counterpart of the reference's global phase timers
(``cblas_alltoalltime``/``cblas_allgathertime``/``cblas_localspmvtime``/... —
``CombBLAS.h:76-102``, accumulated under ``#ifdef TIMING`` in
``ParFriends.h:1747-1879``) and its per-run comm/comp breakdowns
(``3DSpGEMM/Multiplier.h:50-58``).

On the device, fine-grained phase attribution inside one jitted program belongs to
the XLA profiler (wrap a region with :func:`trace` and inspect in xprof); the
wall-clock :class:`PhaseTimers` covers the host-driven loops (MCL iterations,
BFS levels when run unjitted, I/O) the same way the reference's counters do.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import jax

__all__ = ["PhaseTimers", "trace"]


class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name.

    with timers.phase("expand"):     # blocks until device work completes
        c = spgemm(...)
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name:24s} {self.totals[name]:10.4f}s  ({self.counts[name]}x)"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(name: str):
    """Named region for the JAX/XLA profiler (xprof timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def device_memory_report() -> str:
    """Per-device memory usage summary (the reference's SHOW_MEMORY_USAGE
    per-phase prints, ``ParFriends.h:643-717``)."""
    lines = []
    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        used = stats.get("bytes_in_use", 0)
        peak = stats.get("peak_bytes_in_use", 0)
        limit = stats.get("bytes_limit", 0)
        lines.append(
            f"{d}: in_use={used/1e9:.2f}GB peak={peak/1e9:.2f}GB "
            f"limit={limit/1e9:.2f}GB"
        )
    return "\n".join(lines)
