"""Multi-host initialization for pod-scale runs.

The reference spans hosts with MPI ranks (modmpi.f90 initmpi); the JAX
equivalent is one `jax.distributed` process group per host with a single
global Mesh over all devices.
Nothing else in the framework changes: the same `make_mesh` + `shard_state`
path works because GSPMD sees one global device list.

Single-chip and single-host runs never need this module.
"""
from __future__ import annotations

import os


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize the JAX process group (call ONCE, before any jax op).

    Explicit values mirror `jax.distributed.initialize`'s arguments; GPU
    hosts need all three (or JAX_COORDINATOR_ADDRESS plus the others),
    since nothing discovers the cluster for them.
    Returns (process_index, process_count)."""
    import jax
    if num_processes is not None and num_processes > 1 \
            or coordinator_address is not None \
            or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_index(), jax.process_count()


def global_mesh(nprocx: int | None = None, nprocy: int | None = None):
    """A 2-D ('x','y') mesh over ALL global devices (every process sees
    the same mesh; data placement follows the usual shard_state specs).

    Defaults to the most-square factorization of the global device count
    with nprocx >= nprocy — the same heuristic the reference suggests for
    nprocx/nprocy (docs/udales-2decomp.md)."""
    import numpy as np
    import jax
    from .mesh import make_mesh
    n = len(jax.devices())
    if nprocx is None or nprocy is None:
        nprocy = int(np.floor(np.sqrt(n)))
        while n % nprocy != 0:
            nprocy -= 1
        nprocx = n // nprocy
    return make_mesh(nprocx, nprocy)


def shard_state_global(state, mesh):
    """Multi-process-safe variant of `mesh.shard_state`: every process holds
    the same global (host) State and contributes only its addressable
    shards (`jax.make_array_from_callback`), which is the supported path
    when the mesh spans devices of several processes.  Works identically in
    single-process runs."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    from .mesh import _leaf_spec

    def put(path, leaf):
        if leaf is None:
            return None
        arr = np.asarray(leaf)
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, _leaf_spec(path, leaf)),
            lambda idx: arr[idx])
    return jax.tree_util.tree_map_with_path(put, state)
