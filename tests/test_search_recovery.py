"""Search-quality recovery tests: the hill-climb must recover a simulated
truth topology, not merely improve logL (the library's purpose —
reference README.md:5-11; RAxML-style evaluation).

Production-scale (by CI budget) cases on the CPU f64 parity path:
  * 64 taxa x 512 sites, run to convergence: essentially full recovery
    (normalized RF <= 0.1) and logL within a few units of the truth tree.
  * 128 taxa x 512 sites, 6 rounds: bounded-work progress threshold —
    the aggressive verified move batching must cut RF from ~1.0 to
    <= 0.8 in 6 rounds (it reaches ~0.66 as of round 5; the bound has
    slack for RNG drift across platforms).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from libpll2_jax import engine, search_fast
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.models.gamma import compute_gamma_cats
from libpll2_jax.tree.compare import rf_distance_normalized
from libpll2_jax.tree.generate import random_newick, simulate_alignment


def _sim(tips, sites, seed=11):
    rng = np.random.default_rng(seed)
    rates = compute_gamma_cats(1.0, 4)
    subst = [1, 2, 1, 1, 2, 1]
    freqs = [0.25] * 4
    truth = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.05, max_bl=0.3))
    chars = simulate_alignment(truth, sites, rng, subst, freqs, rates)
    start = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.05, max_bl=0.3))
    ren = dict(zip(sorted(n.label for n in start.nodes[:tips]),
                   sorted(chars)))
    for n in start.nodes[:tips]:
        n.label = ren[n.label]
    cfg = PartitionConfig(
        tips=tips, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=jnp.float64)
    model = engine.make_model([subst], [freqs], rates, dtype=jnp.float64)
    return truth, start, chars, cfg, model


def test_recovery_64_taxa_to_convergence():
    truth, start, chars, cfg, model = _sim(64, 512)
    final, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=20, radius=5, smooth_every=2)
    tr = stats["logl_trace"]
    assert all(b >= a - 1e-6 for a, b in zip(tr, tr[1:]))
    rf = rf_distance_normalized(final, truth)
    assert rf <= 0.1, f"failed to recover the truth topology: RF={rf}"
    logl_true, _ = search_fast.evaluate_tree(truth, cfg, model, chars)
    assert logl >= logl_true - 10.0, (logl, logl_true)


def test_recovery_128_taxa_bounded_rounds():
    truth, start, chars, cfg, model = _sim(128, 512)
    rf0 = rf_distance_normalized(start, truth)
    assert rf0 > 0.9                      # random start: maximally wrong
    final, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=6, radius=5, smooth_every=2)
    tr = stats["logl_trace"]
    assert all(b >= a - 1e-6 for a, b in zip(tr, tr[1:]))
    rf = rf_distance_normalized(final, truth)
    assert rf <= 0.8, f"6-round progress too weak: RF {rf0} -> {rf}"
    # the aggressive verified batches should land ~30+ moves per round
    assert stats["moves"] >= 6 * 20, stats["moves"]
