"""Analytic (message-based) reverse pass vs. XLA autodiff.

engine.loglikelihood_analytic registers a custom VJP built on the
belief-propagation identity (one directional-message sweep gives
dlogL/dP_e for every edge); its gradients must match jax.grad of the
plain XLA-path likelihood to f64 tolerance for every differentiable
input — branch lengths, eigen factors, frequencies, rate weights,
prop_invar, rates, and pattern weights — including under active
numerical scaling and +I."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig

from .test_parity_tree import random_newick, random_seqs


def _setup(n_tips, sites, seed, scale_heavy=False, pinv=0.0,
           asc_bias=0, per_rate=False):
    rng = np.random.default_rng(seed)
    newick = random_newick(n_tips, rng)
    tree = T.parse_newick_string(newick)
    seqs = random_seqs(n_tips, sites, rng)
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float64,
        asc_bias=asc_bias, asc_bias_flag=bool(asc_bias),
        per_rate_scalers=per_rate)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    model = engine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(0.8, 4),
        prop_invar=[pinv] if pinv else None, dtype=jnp.float64)

    raw = np.zeros((n_tips, sites), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    if asc_bias:
        pw[sites:sites + 4] = [2.0, 1.0, 1.0, 3.0]
    pw = jnp.asarray(pw, cfg.dtype)
    if pinv:
        from libpll2_jax.partition import Partition
        part = Partition(n_tips, tree.inner_count, 4, sites, 1,
                         2 * n_tips - 3, 4, tree.inner_count,
                         dtype=jnp.float64)
        for i, s in enumerate(seqs):
            part.set_tip_states(i, pll.MAP_NT, s)
        part.update_invariant_sites()
        inv = jnp.asarray(np.asarray(part.invariant)[:cfg.sites_padded])
    else:
        inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
    bl = jnp.asarray(program.default_branch_lengths, cfg.dtype)
    if scale_heavy:
        bl = bl * 25.0
    return program, full, cfg, model, bl, tipchars, pw, inv


def _check_grads(program, full, cfg, model, bl, tipchars, pw, inv):
    def f_ref(model_, bl_, pw_):
        return engine.loglikelihood(program, cfg, model_, bl_, tipchars,
                                    pw_, inv)

    def f_ana(model_, bl_, pw_):
        return engine.loglikelihood_analytic(program, full, cfg, model_,
                                             bl_, tipchars, pw_, inv)

    v_ref = float(f_ref(model, bl, pw))
    v_ana = float(f_ana(model, bl, pw))
    assert abs(v_ref - v_ana) < 1e-9 * abs(v_ref)

    g_ref = jax.grad(f_ref, argnums=(0, 1, 2), allow_int=True)(model, bl,
                                                               pw)
    g_ana = jax.grad(f_ana, argnums=(0, 1, 2), allow_int=True)(model, bl,
                                                               pw)

    leaves_ref, tdef_ref = jax.tree_util.tree_flatten(g_ref)
    leaves_ana, tdef_ana = jax.tree_util.tree_flatten(g_ana)
    assert tdef_ref == tdef_ana
    real_ref = [x for x in leaves_ref if x.dtype != jax.dtypes.float0]
    real_ana = [x for x in leaves_ana if x.dtype != jax.dtypes.float0]
    assert len(real_ref) == len(real_ana) == len(leaves_ref) - 1
    scale = max(float(jnp.max(jnp.abs(x))) for x in real_ref) + 1.0
    for a, b in zip(real_ref, real_ana):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-7, atol=1e-8 * scale)


@pytest.mark.parametrize("n_tips,seed,heavy,pinv", [
    (10, 3, False, 0.0),
    (32, 5, True, 0.0),     # scalers fire
    (12, 7, False, 0.25),   # +I mixing
])
def test_analytic_vjp_matches_xla_grad(n_tips, seed, heavy, pinv):
    program, full, cfg, model, bl, tipchars, pw, inv = _setup(
        n_tips, 192, seed, scale_heavy=heavy, pinv=pinv)
    _check_grads(program, full, cfg, model, bl, tipchars, pw, inv)


@pytest.mark.parametrize("asc,per_rate,heavy", [
    (pll.AB_LEWIS, False, False),
    (pll.AB_LEWIS, False, True),          # asc with active scaling
    (pll.AB_FELSENSTEIN, False, True),
    (pll.AB_STAMATAKIS, False, True),
    (0, True, True),                      # per-rate scalers, capped undo
    (pll.AB_LEWIS, True, True),           # both at once
])
def test_analytic_vjp_asc_and_per_rate(asc, per_rate, heavy):
    """The reverse pass differentiates the per-edge reduction tail by
    autodiff, so ascertainment-bias corrections (likelihood.c:24-120) and
    the capped per-rate scaler undo (core_likelihood.c:1388-1414) must
    come out identical to XLA autodiff of the whole forward program."""
    program, full, cfg, model, bl, tipchars, pw, inv = _setup(
        20, 160, 13, scale_heavy=heavy, asc_bias=asc, per_rate=per_rate)
    _check_grads(program, full, cfg, model, bl, tipchars, pw, inv)


def test_analytic_vjp_in_fit_loss():
    """End-to-end: grad of a fit-style loss through the analytic path
    matches the XLA path (eigendecomposition inside the trace)."""
    from libpll2_jax import fit
    program, full, cfg, model, bl, tipchars, pw, inv = _setup(8, 128, 11)
    params = fit.pack([[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]],
                      [[0.3, 0.25, 0.2, 0.25]], np.asarray(bl),
                      dtype=jnp.float64)
    rates = pll.compute_gamma_cats(0.8, 4)

    def loss(p, use_analytic):
        subst, freqs, bl_ = fit.unpack(p)
        m = fit.make_model_traced(subst, freqs, jnp.asarray(rates,
                                                            cfg.dtype),
                                  dtype=cfg.dtype)
        if use_analytic:
            return -engine.loglikelihood_analytic(
                program, full, cfg, m, bl_, tipchars, pw, inv)
        return -engine.loglikelihood(program, cfg, m, bl_, tipchars, pw,
                                     inv)

    g_ref = jax.grad(lambda p: loss(p, False))(params)
    g_ana = jax.grad(lambda p: loss(p, True))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_ref),
                    jax.tree_util.tree_leaves(g_ana)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-6, atol=1e-9)


def test_fit_model_analytic_path_matches():
    """fit_model with full_program (analytic VJP) reaches the same logL
    trajectory as the XLA-autodiff path."""
    from libpll2_jax import fit
    program, full, cfg, model, bl, tipchars, pw, inv = _setup(8, 128, 11)
    params = fit.pack([[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]],
                      [[0.3, 0.25, 0.2, 0.25]], np.asarray(bl),
                      dtype=jnp.float64)
    rates = jnp.asarray(pll.compute_gamma_cats(0.8, 4), cfg.dtype)
    r_ref = fit.fit_model(program, cfg, params, rates, tipchars, pw, inv,
                          steps=25, lr=0.05)
    r_ana = fit.fit_model(program, cfg, params, rates, tipchars, pw, inv,
                          steps=25, lr=0.05, full_program=full)
    np.testing.assert_allclose(np.asarray(r_ana.logl),
                               np.asarray(r_ref.logl), rtol=1e-8)
