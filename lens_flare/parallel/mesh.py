"""Device mesh + sharding helpers.

The reference's entire "distributed backend" is a pthread pool pulling 32x32
film tiles from a mutex-guarded queue (``util/work_queue.h:11-51``,
``raytraced_renderer.cpp:681-715``).  The equivalent here: a 1-D
``jax.sharding.Mesh`` over the ray/film batch axis — film pixels are the
embarrassingly parallel axis (the analogue of tiles), the scene/BVH/material
tables are replicated (they are read-only), and reductions that the reference
did via shared memory (film accumulation, counters, loss gradients) become
XLA collectives inserted by pjit.

Multi-host: call :func:`init_distributed` first (``jax.distributed``), then
the same mesh spans all hosts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Multi-host initialization (no-op on a single host)."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator, num_processes, process_id)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the batch (film/ray) axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (BATCH_AXIS,))


def shard_batch(mesh: Mesh) -> NamedSharding:
    """Shard the leading axis across the mesh."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad the leading axis so it divides evenly across devices."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, 0
    pad_widths = [(0, 0)] * arr.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(arr, pad_widths, mode="edge"), rem
