"""Multi-host (multi-process) mesh construction over DCN.

The reference is a single-process shared-memory system (SURVEY.md §2.3:
mutexes only, "distributed anything: absent"); its scale ceiling is one
machine. The scale-out story splits traffic in two:

- device links: collectives inside the sharded solvers
  (parallel/sharded_ba.py psums the reduced camera system; frontend_dp
  shards bulk extraction). These are mesh-axis collectives — they work
  identically whether the mesh spans one host or many.
- DCN: host-level control plane. `jax.distributed.initialize` brings up
  the cross-process runtime so `jax.devices()` is the GLOBAL device list
  and a `Mesh` can span hosts; XLA then routes collectives over the
  cards' links within a host and the network across hosts, with no code
  change in the solvers.

Usage (one call per process, before any jax computation):

    from monoorbslam3_tpu.parallel import multihost
    multihost.initialize(coordinator="10.0.0.1:8476",
                         num_processes=4, process_id=rank)
    mesh = multihost.global_mesh(("dp",))
    system = System(..., mesh=mesh)   # window BAs now solve across hosts

Pass the coordinator, process count and rank explicitly: a GPU or CPU
cluster has no environment JAX can read them from (tests/test_multihost.py
spawns two localhost processes this way).
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> bool:
    """Bring up the cross-process runtime (DCN control plane).

    Returns True when a multi-process runtime was started, False when the
    call is a single-process no-op (num_processes in (None, 1) with no
    coordinator — the laptop/single-host path, so callers can
    unconditionally initialize)."""
    import jax

    if coordinator is None and (num_processes is None or num_processes == 1):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def global_mesh(axis_names=("dp",), shape=None):
    """Mesh over the GLOBAL device list (all processes' devices).

    `shape`: optional axis sizes (defaults to all devices on the first
    axis). With multiple axes, devices are laid out host-major so the
    FASTEST-varying axis stays within a host — collectives along it ride
    the cards' links, while only the slowest axis crosses the network."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devs)}")
    arr = np.array(devs[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def process_info() -> dict:
    """Rank/size/local-device census for logging and sharding decisions."""
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
