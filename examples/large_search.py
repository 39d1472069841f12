"""Production-scale ML tree inference pipeline, end to end on one device.

The workflow the reference library exists to power (RAxML-NG style):

  1. simulate / load an alignment                 (tree/generate.py, io/)
  2. parsimony stepwise-addition starting tree    (parsimony/stepwise.py,
                                                   stepwise.c semantics)
  3. ML SPR hill-climb with radius-limited exact scoring, batched Newton
     branch smoothing between rounds              (search_fast.py)

Every device program in step 3 has shapes fixed by (tip count, radius),
so the whole search compiles a handful of XLA programs total, no matter
how many topologies it visits.

Usage:
  python examples/large_search.py [tips] [sites] [radius] [max_rounds]

Defaults: 256 tips x 4096 sites, radius 5, on the default JAX backend
(run with EXAMPLES_GPU=1 on a GPU; CPU works too, slower).  f32 on the
GPU, f64 on the CPU.
"""
import sys
import time

import _common  # noqa: F401
import numpy as np

import jax.numpy as jnp

import libpll2_jax as pll
from libpll2_jax import engine, search_fast
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.parsimony import fastparsimony_stepwise
from libpll2_jax.tree.generate import random_newick, simulate_alignment

TIPS = int(sys.argv[1]) if len(sys.argv) > 1 else 256
SITES = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
RADIUS = int(sys.argv[3]) if len(sys.argv) > 3 else 5
ROUNDS = int(sys.argv[4]) if len(sys.argv) > 4 else 12

SUBST = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0]
FREQS = [0.28, 0.24, 0.22, 0.26]
ALPHA = 0.9

rng = np.random.default_rng(20260820)
rates = pll.compute_gamma_cats(ALPHA, 4)

t0 = time.time()
true_tree = T.parse_newick_string(
    random_newick(TIPS, rng, min_bl=0.02, max_bl=0.35))
chars = simulate_alignment(true_tree, SITES, rng, SUBST, FREQS, rates)
labels = sorted(chars)
print(f"simulated {TIPS} taxa x {SITES} sites  ({time.time()-t0:.1f}s)")

# ---- parsimony starting tree (stepwise.c:585-729 semantics) -------------
# Pinned to the host CPU backend: stepwise addition dispatches many tiny
# popcount programs, where per-dispatch latency on an accelerator
# dominates.
import contextlib

import jax

t0 = time.time()
try:
    cpu0 = jax.devices("cpu")[0]
    pars_dev = jax.default_device(cpu0)
except RuntimeError:
    pars_dev = contextlib.nullcontext()
with pars_dev:
    partition = pll.Partition(TIPS, TIPS - 2, 4, SITES, 1, 2 * TIPS - 3, 1,
                              TIPS - 2)
    code_of = {1: "A", 2: "C", 4: "G", 8: "T"}
    for i, lab in enumerate(labels):
        partition.set_tip_states(
            i, pll.MAP_NT, "".join(code_of[int(c)] for c in chars[lab]))
    fp = pll.FastParsimony(partition)
    start, pars_cost = fastparsimony_stepwise([fp], labels, seed=42)
for n in start.nodes:
    if n.next is None:
        n.length = n.back.length = 0.1
    else:
        for h in n.roundabout():
            h.length = h.back.length = 0.1
# normalize to template indexing (search_fast expects parser layout)
start = T.parse_newick_string(
    T.export_newick(start.vroot, precision=6))
print(f"stepwise parsimony start: cost {pars_cost}  "
      f"({time.time()-t0:.1f}s)")

# ---- ML hill-climb -------------------------------------------------------
# one fused device program per round (base sweep + logl0 + all ball
# groups); chip_smoke.py reports the steady round time on the GPU
dtype = jnp.float32 if jax.default_backend() != "cpu" else jnp.float64
cfg = PartitionConfig(
    tips=TIPS, clv_buffers=start.inner_count, states=4, sites=SITES,
    rate_matrices=1, prob_matrices=2 * TIPS - 3, rate_cats=4,
    scale_buffers=start.inner_count, dtype=dtype)
model = engine.make_model([SUBST], [FREQS], rates, dtype=dtype)

t0 = time.time()
tree, logl, stats = search_fast.hill_climb(
    start, cfg, model, chars, max_rounds=ROUNDS, radius=RADIUS,
    smooth_every=2)
wall = time.time() - t0
trace = stats["logl_trace"]
rs = stats["round_secs"]
steady = f", steady-state {np.median(rs[1:]):.1f}s/round" if len(rs) > 1 \
    else ""
print(f"hill-climb: {stats['rounds']} rounds, {stats['moves']} moves, "
      f"{wall:.1f}s total (first round incl. compile {rs[0]:.1f}s"
      f"{steady})")
for i, tm in enumerate(stats["phase_timings"]):
    ph = {k: round(v, 2) for k, v in tm.items()
          if isinstance(v, float)}
    print(f"  round {i}: {ph} shapes={tm.get('shapes')} "
          f"lops={tm.get('lops')} cfg={tm.get('cfg_hash')} "
          f"cache={tm.get('cache')}")
print("logL trace:", " ".join(f"{x:.1f}" for x in trace))
assert all(b >= a - 1e-3 for a, b in zip(trace, trace[1:])), "not monotone"
assert np.isfinite(logl)
print(f"final logL: {logl:.3f}")
print(T.export_newick(tree.vroot, precision=6)[:120], "...")
