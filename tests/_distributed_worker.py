"""Subprocess worker for the REAL multi-process distributed test.

Launched by tests/test_distributed.py with an explicit coordinator; each
process owns 2 virtual CPU devices, so 2 processes form a 4-device global
'sites' mesh.  Runs the engine logL + all-branch (d1, d2) through
parallel/distributed.py's actual multi-host code path (distributed init,
pod-global mesh, per-host shard materialization) and saves the results
for the parent to compare — SURVEY.md §2.6's contract exercised across a
true process boundary (the axis RAxML-NG covers with MPI ranks).

Usage: python tests/_distributed_worker.py <pid> <nproc> <port> <out.npz>
"""
import os
import sys

pid, nproc, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import libpll2_jax as pll  # noqa: E402
from libpll2_jax import engine  # noqa: E402
from libpll2_jax import tree as T  # noqa: E402
from libpll2_jax.config import PartitionConfig  # noqa: E402
from libpll2_jax.parallel import distributed as D  # noqa: E402

from tests.test_parity_tree import random_newick, random_seqs  # noqa: E402

n = D.initialize(coordinator_address=f"127.0.0.1:{port}",
                 num_processes=nproc, process_id=pid)
assert n == nproc, (n, nproc)
assert jax.process_count() == nproc
assert len(jax.local_devices()) == 2
assert len(jax.devices()) == 2 * nproc

# deterministic problem, identical on every process (the global alignment;
# make_global_site_array materializes only this host's shards from it)
rng = np.random.default_rng(31)
n_tips, sites = 12, 2 * nproc * 128          # one site block per device
tree = T.parse_newick_string(random_newick(n_tips, rng))
seqs = random_seqs(n_tips, sites, rng)
cfg = PartitionConfig(
    tips=n_tips, clv_buffers=tree.inner_count, states=4, sites=sites,
    rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
    scale_buffers=tree.inner_count, dtype=jnp.float64)
program = engine.compile_tree(tree, cfg)
full = engine.compile_tree_full(tree, cfg)
model = engine.make_model(
    [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
    pll.compute_gamma_cats(0.8, 4), dtype=jnp.float64)
raw = np.zeros((n_tips, cfg.sites), dtype=np.uint64)
for i, s in enumerate(seqs):
    raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
tipchars = engine.pad_tipchars(raw, cfg)
pw = np.zeros(cfg.sites_padded)
pw[:sites] = 1.0
inv = np.full(cfg.sites_padded, -1, np.int32)
bl = jnp.asarray(program.default_branch_lengths, jnp.float64)

mesh = D.global_site_mesh()
assert mesh.devices.size == 2 * nproc

# per-process site ownership must tile the global site axis
sl = D.process_site_slice(cfg.sites_padded, mesh)
assert (sl.stop - sl.start) * nproc == cfg.sites_padded, sl

tc_g, pw_g, inv_g = D.shard_engine_inputs(mesh, tipchars, pw, inv)
for g in (tc_g, pw_g, inv_g):
    local = sum(s.data.shape[-1] for s in g.addressable_shards)
    assert local == cfg.sites_padded // nproc, (local, cfg.sites_padded)

logl = engine.loglikelihood(program, cfg, model, bl, tc_g, pw_g, inv_g)
d1, d2 = engine.branch_derivatives(full, cfg, model,
                                   jnp.asarray(full.default_branch_lengths,
                                               jnp.float64),
                                   tc_g, pw_g, inv_g)

np.savez(out_path, logl=np.float64(logl), d1=np.asarray(d1),
         d2=np.asarray(d2), slice_start=sl.start, slice_stop=sl.stop)
print(f"WORKER_OK {pid} {float(logl)!r}", flush=True)
jax.distributed.shutdown()
os._exit(0)
