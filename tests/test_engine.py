"""Fused engine: agreement with the partition API, sharded execution, and
on-device Newton optimization."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.parallel import sharding

from .test_parity_tree import random_newick, random_seqs


def build_case(n_tips=24, sites=101, rate_cats=4, seed=3,
               site_block=128):
    rng = np.random.default_rng(seed)
    newick = random_newick(n_tips, rng)
    seqs = random_seqs(n_tips, sites, rng)
    tree = T.parse_newick_string(newick)
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=rate_cats,
        scale_buffers=tree.inner_count, site_block=site_block)
    program = engine.compile_tree(tree, cfg)
    model = engine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(0.8, rate_cats))

    raw = np.zeros((n_tips, cfg.sites_alloc), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = engine.pad_tipchars(raw, cfg)

    pattern_weights = np.zeros(cfg.sites_padded)
    pattern_weights[:sites] = 1.0
    invariant = np.full(cfg.sites_padded, -1, dtype=np.int32)
    return (tree, cfg, program, model, seqs, tipchars, pattern_weights,
            invariant)


def partition_logl(tree, seqs, sites, rate_cats, branch_lengths, pmat_idx):
    p = pll.Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                      2 * tree.tip_count - 3, rate_cats, tree.inner_count)
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.8)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    trav = T.traverse(tree.vroot)
    ops, branches, _ = T.create_operations(trav)
    p.update_prob_matrices([0] * rate_cats, pmat_idx, branch_lengths)
    p.update_partials(ops)
    root = tree.vroot
    return p.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * rate_cats)


def test_engine_matches_partition_api():
    (tree, cfg, program, model, seqs, tipchars, pattern_weights,
     invariant) = build_case()
    bl = jnp.asarray(program.default_branch_lengths)
    logl = engine.loglikelihood(program, cfg, model, bl,
                                jnp.asarray(tipchars),
                                jnp.asarray(pattern_weights),
                                jnp.asarray(invariant))
    ref = partition_logl(tree, seqs, cfg.sites, cfg.rate_cats,
                         program.default_branch_lengths,
                         list(program.pmatrix_indices))
    np.testing.assert_allclose(float(logl), ref, rtol=1e-12)


def test_engine_sharded_8dev():
    (tree, cfg, program, model, seqs, tipchars, pattern_weights,
     invariant) = build_case(sites=173, site_block=16)
    # site_block 16 x 8 devices: each shard gets lane-aligned columns
    assert cfg.sites_padded % 8 == 0
    mesh = sharding.make_mesh()
    assert len(mesh.devices.ravel()) == 8
    bl = jnp.asarray(program.default_branch_lengths)

    logl_plain = engine.loglikelihood(
        program, cfg, model, bl, jnp.asarray(tipchars),
        jnp.asarray(pattern_weights), jnp.asarray(invariant))

    tip_s, pw_s, inv_s = sharding.shard_site_arrays(
        mesh, jnp.asarray(tipchars), jnp.asarray(pattern_weights),
        jnp.asarray(invariant))
    logl_sharded = engine.loglikelihood(program, cfg, model, bl, tip_s,
                                        pw_s, inv_s)
    np.testing.assert_allclose(float(logl_sharded), float(logl_plain),
                               rtol=1e-12)


def test_newton_step_improves_logl():
    (tree, cfg, program, model, seqs, tipchars, pattern_weights,
     invariant) = build_case()
    bl = jnp.asarray(program.default_branch_lengths) * 3.0  # detuned
    args = (jnp.asarray(tipchars), jnp.asarray(pattern_weights),
            jnp.asarray(invariant))
    logl0 = engine.loglikelihood(program, cfg, model, bl, *args)
    new_bl, _ = engine.optimize_root_branch(program, cfg, model, bl, *args)
    logl1 = engine.loglikelihood(program, cfg, model, new_bl, *args)
    assert float(logl1) >= float(logl0) - 1e-9


def test_gradients_flow():
    """Branch lengths are differentiable through the whole engine."""
    (tree, cfg, program, model, seqs, tipchars, pattern_weights,
     invariant) = build_case(n_tips=10, sites=40)
    args = (jnp.asarray(tipchars), jnp.asarray(pattern_weights),
            jnp.asarray(invariant))

    def f(bl):
        return engine.loglikelihood(program, cfg, model, bl, *args)

    bl = jnp.asarray(program.default_branch_lengths)
    g = jax.grad(f)(bl)
    assert np.all(np.isfinite(np.asarray(g)))
    # compare against finite differences on a few branches
    for i in [0, len(bl) // 2, len(bl) - 1]:
        eps = 1e-6
        fd = (f(bl.at[i].add(eps)) - f(bl.at[i].add(-eps))) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("per_rate", [False, True])
def test_f32_gradients_finite_under_scaling(per_rate):
    """Where f32 rescaling fires, the site-logL cases that a site does not
    take must not poison the gradient (an unused log 0 gives NaN under
    autodiff); the f32 gradient follows the f64 one."""
    tree, cfg, _, model, _, tipchars, pw, inv = build_case(n_tips=64,
                                                           sites=64)
    grads = {}
    for dtype in (jnp.float32, jnp.float64):
        cfg_d = dataclasses.replace(cfg, dtype=dtype,
                                    per_rate_scalers=per_rate)
        program = engine.compile_tree(tree, cfg_d)
        model_d = jax.tree_util.tree_map(
            lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
            else x, model)
        args = (jnp.asarray(tipchars), jnp.asarray(pw, dtype),
                jnp.asarray(inv))
        bl = jnp.asarray(program.default_branch_lengths * 3.0, dtype)
        if dtype == jnp.float32:
            view, _ = engine._sweep(program, cfg_d, model_d, bl, args[0],
                                    args[1])
            assert int(jnp.max(view.scaler_row(program.root_scaler))) > 0
        grads[dtype] = np.asarray(jax.grad(
            lambda b: engine.loglikelihood(program, cfg_d, model_d, b,
                                           *args))(bl), np.float64)
    assert np.all(np.isfinite(grads[jnp.float32]))
    np.testing.assert_allclose(grads[jnp.float32], grads[jnp.float64],
                               rtol=2e-3, atol=1e-3)


def test_batched_optimizer_sharded_8dev():
    """The directional-message sweep, all-branch derivatives and batched
    Newton smoothing must produce identical results when the site axis is
    sharded across the 8-device mesh (per-site weighted sums are exact
    under sharding; XLA inserts the psum)."""
    (tree, cfg, program, model, seqs, tipchars, pattern_weights,
     invariant) = build_case(n_tips=10, sites=120, site_block=16)
    assert cfg.sites_padded % 8 == 0
    full = engine.compile_tree_full(tree, cfg)
    mesh = sharding.make_mesh()
    bl = jnp.asarray(full.default_branch_lengths) * 2.0

    d1_p, d2_p = engine.branch_derivatives(
        full, cfg, model, bl, jnp.asarray(tipchars),
        jnp.asarray(pattern_weights), jnp.asarray(invariant))
    bl_p, logl_p = engine.optimize_branch_lengths(
        full, cfg, model, bl, jnp.asarray(tipchars),
        jnp.asarray(pattern_weights), jnp.asarray(invariant), rounds=3)

    tip_s, pw_s, inv_s = sharding.shard_site_arrays(
        mesh, jnp.asarray(tipchars), jnp.asarray(pattern_weights),
        jnp.asarray(invariant))
    d1_s, d2_s = engine.branch_derivatives(full, cfg, model, bl, tip_s,
                                           pw_s, inv_s)
    bl_s, logl_s = engine.optimize_branch_lengths(
        full, cfg, model, bl, tip_s, pw_s, inv_s, rounds=3)

    np.testing.assert_allclose(np.asarray(d1_s), np.asarray(d1_p),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(d2_s), np.asarray(d2_p),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(bl_s), np.asarray(bl_p),
                               rtol=1e-10)
    np.testing.assert_allclose(float(logl_s), float(logl_p), rtol=1e-12)


@pytest.mark.parametrize("compiled_for", ["float32", "float64"])
def test_full_program_serves_any_dtype(compiled_for):
    """A FullTreeProgram fixes the message-row layout only: smoothing in
    f64 with a program compiled under an f32 config rescues at the f64
    threshold, so it gives the f64 program's answer, and the logL it
    returns is the tree's logL at the branch lengths it returns."""
    tree, cfg, program, model, _, tipchars, pw, inv = build_case(n_tips=64,
                                                                 sites=64)
    assert cfg.dtype == jnp.float64
    args = (jnp.asarray(tipchars), jnp.asarray(pw), jnp.asarray(inv))
    bl0 = jnp.asarray(program.default_branch_lengths * 3.0)
    out = {}
    for name in {"float64", compiled_for}:
        full = engine.compile_tree_full(
            tree, dataclasses.replace(cfg, dtype=jnp.dtype(name)))
        out[name] = engine.optimize_branch_lengths(full, cfg, model, bl0,
                                                   *args, rounds=1)
    bl, logl = out[compiled_for]
    np.testing.assert_allclose(float(logl), float(out["float64"][1]),
                               rtol=1e-12)
    np.testing.assert_allclose(
        float(logl), float(engine.loglikelihood(program, cfg, model, bl,
                                                *args)), rtol=1e-10)
