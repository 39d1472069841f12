"""Multi-host runtime: process bring-up + global site mesh + global-array
placement.

The reference has no distributed layer at all — RAxML-NG scales libpll-2
by giving each MPI rank its own partition over a site slice and
all-reducing per-site sums outside the library (SURVEY.md §2.6).  Here the
runtime is first-class: `initialize()` brings up the JAX distributed
service (one process per host, coordinator given explicitly),
`global_site_mesh()` spans ALL hosts' devices with the 'sites' axis, and
`make_global_site_array()` builds a jax.Array whose site axis is sharded
across every host while each host materializes only its addressable
shards.

Because logL / (d1, d2) are weighted per-site sums, the jitted engine
functions run unchanged on globally-sharded inputs: XLA inserts psums
(NCCL all-reduces between GPUs).  Single-process runs (and the CI
virtual CPU mesh) degenerate to the same code path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import SITES_AXIS, site_sharding


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> int:
    """Bring up the multi-host runtime; returns the process count.

    Pass the coordinator (`host:port`), the process count and this
    process's id.  Idempotent: a second call (or a run without a
    coordinator, on any backend) is a no-op that stays single-process.
    """
    # do NOT call jax.process_count()/jax.devices() before the init: that
    # would instantiate the single-process backend and make the
    # distributed init below a silent no-op (its RuntimeError is swallowed)
    if jax.distributed.is_initialized():
        return jax.process_count()
    if coordinator_address is None:
        return 1
    kwargs = {"coordinator_address": coordinator_address}
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        # "backend already initialized" — keep whatever topology exists
        pass
    return jax.process_count()


def global_site_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D 'sites' mesh over every device of every process."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (SITES_AXIS,))


def make_global_site_array(mesh: Mesh, global_array: np.ndarray):
    """Build a process-global jax.Array, site axis (innermost) sharded.

    Each process materializes only its addressable shards from the host
    copy of `global_array` — the way multi-host inputs must be built (a
    plain device_put would require every host to hold every shard).
    """
    sharding = site_sharding(mesh, np.ndim(global_array))

    def cb(index):
        return global_array[index]

    return jax.make_array_from_callback(global_array.shape, sharding, cb)


def shard_engine_inputs(mesh: Mesh, tipchars, pattern_weights, invariant):
    """Place the engine's site-indexed inputs globally sharded; the model,
    tree program and branch lengths stay host-replicated (tiny)."""
    return (make_global_site_array(mesh, np.asarray(tipchars)),
            make_global_site_array(mesh, np.asarray(pattern_weights)),
            make_global_site_array(mesh, np.asarray(invariant)))


def process_site_slice(cfg_sites_padded: int, mesh: Mesh) -> slice:
    """The half-open site range this process owns under the 1-D mesh
    (useful for building per-host inputs without a global alignment)."""
    n = mesh.devices.size
    per = cfg_sites_padded // n
    flat = list(mesh.devices.flat)
    idx = [i for i, d in enumerate(flat)
           if d.process_index == jax.process_index()]
    if not idx:
        return slice(0, 0)
    return slice(min(idx) * per, (max(idx) + 1) * per)
