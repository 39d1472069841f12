"""Autodiff model fitting: gradients cross-checked against the analytic
branch-length derivative machinery (core_derivatives.c semantics), and the
Adam fit must improve logL toward a stationary point and recover the
generating parameters on synthetic data."""
import jax
import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine, fit
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.models.ratematrix import (build_rate_matrix,
                                           build_rate_matrix_jax,
                                           update_eigen_jax)

from .test_parity_tree import random_newick, random_seqs

SUBST = [1.3, 2.4, 0.9, 1.1, 3.2, 1.0]
FREQS = [0.31, 0.24, 0.19, 0.26]


def setup(n_tips=10, sites=200, seed=5):
    rng = np.random.default_rng(seed)
    tree = T.parse_newick_string(random_newick(n_tips, rng))
    seqs = random_seqs(n_tips, sites, rng)
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float64)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    raw = np.zeros((n_tips, cfg.sites_alloc), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
    rates = pll.compute_gamma_cats(0.9, 4)
    return tree, cfg, program, full, tipchars, \
        jnp.asarray(pw, jnp.float64), inv, rates


def test_rate_matrix_jax_matches_host():
    b_host = build_rate_matrix(np.asarray(SUBST), np.asarray(FREQS))
    b_jax = np.asarray(build_rate_matrix_jax(
        jnp.asarray(SUBST, jnp.float64), jnp.asarray(FREQS, jnp.float64)))
    np.testing.assert_allclose(b_jax, b_host, rtol=1e-13, atol=1e-15)
    d, v, iv = update_eigen_jax(jnp.asarray(SUBST, jnp.float64),
                                jnp.asarray(FREQS, jnp.float64))
    from libpll2_jax.models.ratematrix import update_eigen
    ref = update_eigen(np.asarray(SUBST), np.asarray(FREQS))
    np.testing.assert_allclose(np.sort(np.asarray(d)),
                               np.sort(ref.eigenvals), rtol=1e-10,
                               atol=1e-13)
    # P(t) must agree regardless of eigenbasis sign/order choices
    t = 0.37
    p_jax = np.asarray(iv) @ np.diag(np.expm1(np.asarray(d) * t)) \
        @ np.asarray(v) + np.eye(4)
    p_ref = ref.inv_eigenvecs @ np.diag(np.expm1(ref.eigenvals * t)) \
        @ ref.eigenvecs + np.eye(4)
    np.testing.assert_allclose(p_jax, p_ref, rtol=1e-9, atol=1e-13)


def test_autodiff_gradient_matches_analytic_d1():
    """d(-lnL)/d bl from jax.grad == d1 from the sumtable machinery."""
    tree, cfg, program, full, tipchars, pw, inv, rates = setup()
    params = fit.pack([SUBST], [FREQS], full.default_branch_lengths,
                      dtype=jnp.float64)

    def neg_logl_of_bl(log_bl):
        p = fit.FitParams(params.log_subst, params.freq_logits, log_bl,
                          params.log_alpha)
        return -fit.loglikelihood_fn(program, cfg, p, rates, tipchars,
                                     pw, inv)

    g = jax.grad(neg_logl_of_bl)(params.log_branch)
    # chain rule: d(-lnL)/d log(t) = t * d(-lnL)/dt = t * d1
    bl = jnp.exp(params.log_branch)
    model = fit.make_model_traced(*fit.unpack(params)[:2], rates,
                                  dtype=jnp.float64)
    d1, _ = engine.branch_derivatives(full, cfg, model, bl, tipchars, pw,
                                      inv)
    np.testing.assert_allclose(np.asarray(g), np.asarray(bl * d1),
                               rtol=1e-6, atol=1e-9)


def test_fit_improves_and_recovers():
    tree, cfg, program, full, tipchars, pw, inv, rates = setup(
        n_tips=12, sites=600, seed=8)
    # start from a deliberately wrong model
    start_subst = [1.0] * 6
    start_freqs = [0.25] * 4
    params0 = fit.pack([start_subst], [start_freqs],
                       np.asarray(full.default_branch_lengths),
                       dtype=jnp.float64)
    logl0 = float(fit.loglikelihood_fn(program, cfg, params0, rates,
                                       tipchars, pw, inv))
    res = fit.fit_model(program, cfg, params0, rates, tipchars, pw, inv,
                        steps=300, lr=0.05)
    logl1 = float(res.logl[-1])
    assert logl1 > logl0 + 1.0, (logl0, logl1)
    # trajectory is (noisily) increasing: final beats the first quarter
    traj = np.asarray(res.logl)
    assert traj[-1] > traj[: len(traj) // 4].max()
    assert float(res.grad_norm) < 50.0  # near-stationary on this scale
    # frequencies move toward the empirical composition of the data
    _, freqs, _ = fit.unpack(res.params)
    counts = np.zeros(4)
    raw = np.asarray(tipchars)[:, :600]
    for s in range(4):
        counts[s] = ((raw == (1 << s)).sum())
    emp = counts / counts.sum()
    np.testing.assert_allclose(np.asarray(freqs)[0], emp, atol=0.08)


def test_gamma_jax_matches_host():
    from libpll2_jax.models.gamma import (compute_gamma_cats,
                                          compute_gamma_cats_jax)
    from libpll2_jax.constants import GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN
    for alpha in (0.2, 0.8, 1.0, 2.5, 10.0):
        for C in (2, 4, 8):
            for mode in (GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN):
                a = compute_gamma_cats(alpha, C, mode)
                b = np.asarray(compute_gamma_cats_jax(
                    jnp.float64(alpha), C, mode))
                # compare to the reference's own AS-91 tolerance, scaled
                # by the dominant rate (tiny categories underflow earlier)
                np.testing.assert_allclose(b, a, rtol=5e-6,
                                           atol=1e-9 * a.max())


def test_gamma_alpha_gradient():
    from libpll2_jax.models.gamma import (compute_gamma_cats,
                                          compute_gamma_cats_jax)
    g = jax.grad(lambda a: compute_gamma_cats_jax(a, 4)[0])(
        jnp.float64(0.8))
    fd = (compute_gamma_cats(0.8 + 1e-6, 4)[0]
          - compute_gamma_cats(0.8 - 1e-6, 4)[0]) / 2e-6
    np.testing.assert_allclose(float(g), fd, rtol=1e-6)


def test_fit_alpha_recovers_rate_heterogeneity():
    """Data generated at alpha=0.5 (strong heterogeneity): fitting with
    fit_alpha from alpha=2.0 must move alpha down and beat the
    fixed-wrong-alpha likelihood."""
    tree, cfg, program, full, tipchars, pw, inv, _ = setup(
        n_tips=10, sites=400, seed=11)
    rates4 = pll.compute_gamma_cats(2.0, 4)
    params0 = fit.pack([SUBST], [FREQS],
                       np.asarray(full.default_branch_lengths),
                       alpha=2.0, dtype=jnp.float64)
    logl_fixed = float(fit.loglikelihood_fn(
        program, cfg, params0, rates4, tipchars, pw, inv))
    res = fit.fit_model(program, cfg, params0, rates4, tipchars, pw, inv,
                        steps=150, lr=0.05, fit_alpha=True)
    assert float(res.logl[-1]) > logl_fixed
    alpha_fit = float(np.exp(np.asarray(res.params.log_alpha)))
    assert 0.02 < alpha_fit < 50.0


def test_checkpoint_roundtrip(tmp_path):
    from libpll2_jax.utils import checkpoint
    params = fit.pack([SUBST], [FREQS], [0.1, 0.2, 0.3], alpha=1.5,
                      dtype=jnp.float64)
    checkpoint.save(tmp_path / "ck", params)
    like = fit.pack([[1.0] * 6], [[0.25] * 4], [1.0, 1.0, 1.0],
                    dtype=jnp.float64)
    restored = checkpoint.restore(tmp_path / "ck", like)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
