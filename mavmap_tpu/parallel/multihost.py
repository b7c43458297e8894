"""Multi-host execution: jax.distributed bring-up + global mesh helpers.

The reference is a single process (SURVEY §5.8 — its only parallelism is
OpenMP); here "scale beyond one machine" is jax.distributed across hosts,
with XLA collectives over NVLink between the cards of a host and over the
network between hosts. This module owns the bring-up and the mesh
construction used by the distributed BA / matching paths:

  - `init_multihost()`: idempotent jax.distributed.initialize wrapper;
    the caller passes the coordinator address ("host:port"), the process
    count and this process's id.
  - `global_mesh(axis)`: flat 1-D mesh over ALL devices of all processes
    (the cards of a host are all-to-all, so no device topology shapes
    it), the shape dist_bundle_adjust / dist_match_pairs consume.
  - `host_local_to_global(mesh, arrs)`: assemble a global sharded array
    from per-host shards (jax.make_array_from_process_local_data), so each
    host feeds only its own observation shards to the BA without ever
    materializing the full problem anywhere.

Single-host fallback everywhere: with one process these helpers reduce to
the plain local-device mesh used by the tests and the dryrun entry point.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, local_device_ids=None):
    """Initialize jax.distributed (idempotent; no-op for single process).

    Pass coordinator_address ("host:port"), num_processes and process_id
    explicitly. Returns (process_index, process_count).
    """
    global _initialized
    if not _initialized and (coordinator_address is not None
                             or num_processes not in (None, 1)):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
        _initialized = True
    return jax.process_index(), jax.process_count()


def global_mesh(axis="obs", devices=None):
    """1-D mesh over all (global) devices, ordered process-major so each
    host owns a contiguous block of the sharded axis."""
    if devices is None:
        devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devices), (axis,))


def process_shard_bounds(n_items, mesh):
    """[lo, hi) of the global item range owned by THIS process when
    `n_items` are split equally over the mesh's devices (items must be
    pre-padded to a multiple of the device count, as partition_problem
    does)."""
    n_dev = mesh.devices.size
    per = n_items // n_dev
    locals_ = [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    ids = sorted(np.where(np.isin(mesh.devices.flatten(), locals_))[0])
    return ids[0] * per, (ids[-1] + 1) * per


def host_local_to_global(mesh, arr, axis="obs"):
    """Assemble a globally-sharded jax.Array from this process's local
    block of `arr` (leading axis = the sharded axis). Single-process: a
    plain device_put with the mesh sharding."""
    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_process_local_data(sharding, arr)
