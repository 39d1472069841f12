"""One-call ML tree inference: raw sequences in, fitted tree out.

The complete client workflow the reference leaves to RAxML-NG — site
compression, parsimony starting tree, gradient model fit, SPR search —
as a single framework call (libpll2_jax.infer_ml_tree).

Usage: python infer_demo.py [tips] [sites]
"""
import _common  # noqa: F401
import sys

import numpy as np

from libpll2_jax import infer_ml_tree
from libpll2_jax import tree as T
from libpll2_jax.models.gamma import compute_gamma_cats
from libpll2_jax.tree.compare import rf_distance_normalized
from libpll2_jax.tree.generate import random_newick, simulate_alignment

TIPS = int(sys.argv[1]) if len(sys.argv) > 1 else 16
SITES = int(sys.argv[2]) if len(sys.argv) > 2 else 500
NT = {1: "A", 2: "C", 4: "G", 8: "T"}

rng = np.random.default_rng(11)
truth = T.parse_newick_string(
    random_newick(TIPS, rng, min_bl=0.05, max_bl=0.4))
codes = simulate_alignment(truth, SITES, rng,
                           [1.5, 3.0, 0.8, 1.2, 2.5, 1.0],
                           [0.32, 0.18, 0.24, 0.26],
                           compute_gamma_cats(0.7, 4))
seqs = {lab: "".join(NT[int(c)] for c in cs) for lab, cs in codes.items()}

res = infer_ml_tree(seqs, max_rounds=12, warmup_rounds=3, fit_steps=120)

s = res.stats
print(f"{TIPS} taxa x {SITES} sites -> {s['sites_patterns']} patterns")
print(f"parsimony start: cost {s['parsimony_cost']} "
      f"({s['parsimony_secs']:.1f}s)")
print(f"model fit: alpha={res.alpha:.3f} freqs={np.round(res.frequencies, 3)}")
print(f"           rates={np.round(res.subst_params, 2)}")
print(f"search: {s['search']['rounds']} rounds, {s['search']['moves']} moves "
      f"({s['search_secs']:.1f}s)")
print(f"final logL: {res.logl:.3f}")
print(f"RF distance to simulation truth: "
      f"{rf_distance_normalized(res.tree, truth):.3f}")
