"""Multi-chip execution: shard alignment sites across a device mesh.

The reference library is single-threaded; its clients (RAxML-NG) scale by
giving each MPI rank a site slice and all-reducing per-site logL /
derivative sums (SURVEY.md §2.6).  The equivalent is first-class here: the
site axis (innermost on every site-indexed tensor) is sharded over a 1-D
`jax.sharding.Mesh`; tree program, P-matrices and model parameters are
replicated; the weighted per-site reductions become XLA psums (all-reduces
over NVLink between GPUs).  Trace engine calls on site-sharded arrays
inside `jax.set_mesh(mesh)`, so the fused Pallas sweep runs per shard
(ops/partials_pallas_tree.sweep); on the GPU, without the mesh in context
such a call raises when it compiles.

Because log-likelihood and (d1, d2) are exact per-site weighted sums, site
sharding changes nothing numerically (up to reduction order).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SITES_AXIS = "sites"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'sites'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (SITES_AXIS,))


def site_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding that splits the innermost (site) axis of an ndim tensor."""
    spec = [None] * (ndim - 1) + [SITES_AXIS]
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_site_arrays(mesh: Mesh, *arrays):
    """Place arrays with the site axis innermost onto the mesh, sharded."""
    out = []
    for a in arrays:
        out.append(jax.device_put(a, site_sharding(mesh, np.ndim(a))))
    return tuple(out) if len(out) > 1 else out[0]


def pad_sites_to_mesh(cfg_site_block: int, n_devices: int) -> int:
    """Site padding granularity so each shard keeps lane alignment."""
    return cfg_site_block * n_devices
