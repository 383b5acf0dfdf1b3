"""Multi-host (pod) launch scaffolding.

The reference's hybrid launch model is "one MPI rank per socket/NUMA domain,
OpenMP threads inside" (``README.md`` install notes, ``CMakeLists.txt:43``).
The counterpart here is one *process per host*, all of its GPUs in that process, with
``jax.distributed.initialize`` wiring the processes into one global device
mesh — after which every collective in this library (all_gather/psum_scatter
inside ``shard_map``) spans the pod exactly as it spans a single chip's
virtual mesh, because mesh axes are global.

Single-process runs (including the CPU virtual meshes used in tests) are the
degenerate case: :func:`initialize_multihost` is a no-op, :func:`pod_grid`
equals ``default_grid``.

Layout guidance (how the shardings ride the interconnect): inside one host
every GPU reaches every other at the same rate, so the 2D grid axes
('r', 'c') follow the algorithm alone; across hosts the 3D replication axis
'l' is the natural inter-host axis (per-layer SUMMA confines row/col
collectives inside a host, and only the fiber all_to_all crosses hosts — the
communication-avoiding property of ``ParFriends.h:2919`` maps onto the
slower link tier for free).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from combblas_tpu.parallel.grid import ProcGrid

__all__ = [
    "initialize_multihost",
    "pod_grid",
    "is_coordinator",
    "global_put",
]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the process group (``jax.distributed.initialize``); returns the
    process count.  No-op when single-process (nothing configured and no
    cluster env), or when already initialized — so library code can call it
    unconditionally."""
    # IMPORTANT: do not touch jax.process_count()/jax.devices() before
    # distributed.initialize — reading them initializes the local backend
    # and initialize() then refuses ("must be called before any JAX
    # computations").  Probe the coordination client state instead.
    try:
        already = jax.distributed.global_state.client is not None
    except Exception:
        already = False
    if already:
        return jax.process_count()
    env_says_multi = any(
        os.environ.get(k)
        for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                  "MEGASCALE_COORDINATOR_ADDRESS")
    )
    if coordinator_address is None and num_processes is None \
            and not env_says_multi:
        return 1  # single-process degenerate case
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count()


def is_coordinator() -> bool:
    """Rank-0 check — the ``SpParHelper::Print`` gate."""
    return jax.process_index() == 0


def pod_grid(layers: int = 1, pr: Optional[int] = None,
             pc: Optional[int] = None) -> ProcGrid:
    """Grid over ALL devices in the (possibly multi-process) job — the
    COMM_WORLD grid.  ``jax.devices()`` is global across processes, so this
    is exactly ``ProcGrid.make`` with the full device list; the helper exists
    so call sites read as 'the pod grid' and to assert the job is uniform."""
    devices = jax.devices()
    assert len(devices) % max(jax.process_count(), 1) == 0, (
        "uneven device counts across processes"
    )
    return ProcGrid.make(pr=pr, pc=pc, layers=layers, devices=devices)


def global_put(x: np.ndarray, sharding) -> jax.Array:
    """Place a host array into a (global) sharding in a way that works both
    single-process (plain device_put) and multi-process (every process
    provides its addressable shards via ``make_array_from_callback``) — the
    multi-host generalization of the library's host constructors."""
    x = np.asarray(x)
    if jax.process_count() <= 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
