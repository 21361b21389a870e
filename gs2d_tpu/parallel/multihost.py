"""Multi-host (multi-process) runtime setup.

One JAX process per host; `jax.distributed.initialize` wires the cluster,
after which `jax.devices()` spans all hosts and the (data, tile, splat) mesh
of `parallel/mesh.py` works unchanged -- shard_map inserts the
collectives across hosts and within a host automatically. The mesh follows
the algorithm: per-image populations (the **data** axis) never
communicate; the **tile** axis's gradient psum is one all-reduce of ~36*N
bytes per step; the **splat** axis carries the ordered-monoid combine.

This module is exercised on single-host virtual meshes in CI; real
multi-host runs need only `initialize_cluster()` before building the mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from gs2d_tpu.parallel.mesh import make_mesh


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or standard env vars
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process (no coordinator given).

    Must run before anything touches the XLA backend (jax.devices etc.) --
    so the already-initialized check uses jax.distributed.is_initialized,
    NOT jax.process_count (which initializes the backend)."""
    if jax.distributed.is_initialized():
        return  # already initialized by the runtime
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and num_processes is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes
        or int(os.environ.get("NUM_PROCESSES", "1")),
        process_id=process_id or int(os.environ.get("PROCESS_ID", "0")),
    )


def put_global(tree, shardings):
    """Place a host-local pytree onto (possibly process-spanning) shardings.

    ``jax.device_put`` requires fully-addressable shardings, so it breaks
    under multi-controller runs; this builds each global jax.Array from the
    host value via ``make_array_from_callback`` (every process must hold the
    same full value -- true for deterministic init and broadcast-identical
    inputs). Works single-process too (then it is just device_put)."""
    import numpy as np

    def put(x, s):
        arr = np.asarray(x)
        return jax.make_array_from_callback(arr.shape, s,
                                            lambda idx: arr[idx])

    return jax.tree.map(put, tree, shardings)


def fetch_replicated(x):
    """Host value of a (possibly non-addressable) global array.

    Fully-addressable arrays convert directly; process-spanning ones are
    allgathered (every process gets the full value)."""
    import numpy as np

    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def default_pod_mesh(data: int = 1, tile: Optional[int] = None,
                     splat: Optional[int] = None):
    """A sensible mesh over every device in the cluster: splat innermost,
    then tile, data outermost."""
    n = jax.device_count()
    if tile is None and splat is None:
        # default: no data parallelism, split the rest tile x splat evenly
        splat = 1
        while splat * splat * data <= n and n % (splat * 2 * data) == 0:
            splat *= 2
        tile = n // (data * splat)
    elif splat is None:
        splat = n // (data * tile)
    elif tile is None:
        tile = n // (data * splat)
    return make_mesh(data=data, tile=tile, splat=splat)
