"""Bidirectional message passing + batched branch-length optimization.

The directional-message sweep (engine.compile_tree_full) must make the
likelihood computable across ANY edge with one identical result — the
likelihood's edge-invariance covers every one of the 3*(n-2) messages.
optimize_branch_lengths must reach a stationary point (d1 ~ 0 per branch)
of the same -lnL whose per-branch (d1, d2) already match the reference
oracle (tests/test_parity_derivatives.py)."""
import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig

from .test_parity_tree import random_newick, random_seqs


def setup(n_tips=12, sites=256, seed=3):
    rng = np.random.default_rng(seed)
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
    raw = np.zeros((n_tips, cfg.sites_alloc), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
    bl = jnp.asarray(full.default_branch_lengths, jnp.float64)
    return tree, cfg, program, full, model, tipchars, \
        jnp.asarray(pw, jnp.float64), inv, bl


def test_edge_invariance_and_parity():
    tree, cfg, program, full, model, tipchars, pw, inv, bl = setup()
    per_edge = np.asarray(engine.all_edge_loglikelihoods(
        full, cfg, model, bl, tipchars, pw, inv))
    # one likelihood, every edge
    np.testing.assert_allclose(per_edge, per_edge[0], rtol=1e-12)
    # and it is THE likelihood (standard one-direction engine)
    direct = float(engine.loglikelihood(program, cfg, model, bl, tipchars,
                                        pw, inv))
    np.testing.assert_allclose(per_edge[0], direct, rtol=1e-12)


def test_branch_derivatives_match_single_edge_machinery():
    tree, cfg, program, full, model, tipchars, pw, inv, bl = setup()
    d1, d2 = engine.branch_derivatives(full, cfg, model, bl, tipchars,
                                       pw, inv)
    assert d1.shape == bl.shape and d2.shape == bl.shape
    # the root branch's derivatives must agree with the single-branch path
    # used by optimize_root_branch (same sumtable machinery on the standard
    # sweep's root rows)
    from libpll2_jax.ops import derivatives as derivatives_ops
    view, pmatrix = engine._sweep(program, cfg, model, bl, tipchars, pw)
    sp = jnp.zeros((cfg.rate_cats, 1), jnp.int32)
    st = derivatives_ops.update_sumtable(
        view.clv_row(program.root_clv), view.clv_row(program.root_back_clv),
        sp, sp, model.eigenvecs[model.params_indices],
        model.inv_eigenvecs[model.params_indices], model.cat_freqs, cfg)
    root_pos = int(np.nonzero(
        full.pmatrix_indices == program.root_pmatrix)[0][0])
    rd1, rd2 = derivatives_ops.likelihood_derivatives(
        st, bl[root_pos], model.rates,
        model.eigenvals[model.params_indices], model.cat_pinv,
        model.rate_weights, model.cat_freqs, inv, pw, cfg)
    np.testing.assert_allclose(float(d1[root_pos]), float(rd1), rtol=1e-9)
    np.testing.assert_allclose(float(d2[root_pos]), float(rd2), rtol=1e-9)


def test_optimize_branch_lengths_converges():
    tree, cfg, program, full, model, tipchars, pw, inv, bl = setup()
    # perturb the starting lengths so there is real work to do
    bl0 = bl * 3.0 + 0.05
    logl0 = float(engine.loglikelihood(program, cfg, model, bl0, tipchars,
                                       pw, inv))
    new_bl, logl1 = engine.optimize_branch_lengths(
        full, cfg, model, bl0, tipchars, pw, inv, rounds=32,
        newton_iters=20)
    logl1 = float(logl1)
    assert logl1 > logl0 + 1.0, (logl0, logl1)
    # KKT stationarity of -lnL: interior branches have (near-)zero
    # gradient; branches pinned at the lower bound must have d1 >= 0
    # (the likelihood wants them shorter still)
    d1, d2 = engine.branch_derivatives(full, cfg, model, new_bl, tipchars,
                                       pw, inv)
    d1, d2 = np.asarray(d1), np.asarray(d2)
    interior = (np.asarray(new_bl) > 2e-8) & (np.asarray(new_bl) < 99.0)
    scale = np.abs(d2[interior]) + 1.0
    assert np.all(np.abs(d1[interior]) / scale < 1e-3), \
        (d1[interior], d2[interior])
    assert np.all(d1[~interior] > -1e-4), d1[~interior]
    # the optimum must also beat the true generating lengths' logL or match
    logl_true = float(engine.loglikelihood(program, cfg, model, bl,
                                           tipchars, pw, inv))
    assert logl1 >= logl_true - 1e-6
