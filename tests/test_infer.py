"""One-call ML inference driver (infer.infer_ml_tree): the full user
journey — encode, compress, parsimony start, model fit, SPR search —
must recover a simulated truth topology and its model parameters."""
import numpy as np

from libpll2_jax import infer_ml_tree
from libpll2_jax import tree as T
from libpll2_jax.models.gamma import compute_gamma_cats
from libpll2_jax.tree.compare import rf_distance_normalized
from libpll2_jax.tree.generate import random_newick, simulate_alignment

NT = {1: "A", 2: "C", 4: "G", 8: "T"}


def test_infer_recovers_truth():
    tips, sites = 24, 600
    rng = np.random.default_rng(5)
    rates = compute_gamma_cats(0.7, 4)
    subst = [1.5, 3.0, 0.8, 1.2, 2.5, 1.0]
    freqs = [0.32, 0.18, 0.24, 0.26]
    truth = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.05, max_bl=0.4))
    codes = simulate_alignment(truth, sites, rng, subst, freqs, rates)
    seqs = {lab: "".join(NT[int(c)] for c in cs)
            for lab, cs in codes.items()}

    res = infer_ml_tree(seqs, max_rounds=12, warmup_rounds=3,
                        fit_steps=120, radius=5, seed=7)

    # topology recovered
    rf = rf_distance_normalized(res.tree, truth)
    assert rf <= 0.15, rf
    # compression bookkeeping
    assert res.stats["sites_patterns"] <= res.stats["sites_raw"] == sites
    # the model fit moved toward the truth
    assert 0.3 < res.alpha < 2.5, res.alpha
    assert abs(res.frequencies[0] - 0.32) < 0.08
    # strongest exchangeability (AG=3.0) identified as the largest
    assert int(np.argmax(res.subst_params[:5])) == 1
    # monotone search trace under the fitted model
    tr = res.stats["logl_trace"]
    assert all(b >= a - 1e-6 for a, b in zip(tr, tr[1:]))
    assert np.isfinite(res.logl)
    # newick roundtrips
    t2 = T.parse_newick_string(res.newick)
    assert rf_distance_normalized(t2, res.tree) == 0
