"""PLL_ATTRIB_RATE_SCALERS parity (pll.h:130) on the XLA engine paths.

The reference supports per-rate scaling in every kernel family
(core_likelihood.c:445-491, core_derivatives.c:403-437).  These tests pin:

  * scaler-count equality vs the oracle (attrib = 512) on a deep
    caterpillar tree where scaling actually triggers;
  * edge logL parity at 1e-9 through engine.loglikelihood;
  * edge-invariance of the directional-message sweep (FullTreeProgram)
    under per-rate scalers — the round-1 crash regression;
  * (d1, d2) parity vs the oracle sumtable+derivatives for the root edge
    through the batched branch_derivatives path;
  * optimize_branch_lengths running (not crashing) and improving logL.
"""
import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig

from .oracle import run_oracle
from .test_parity_tree import random_newick, random_seqs

ATTRIB_RATE_SCALERS = 1 << 9  # PLL_ATTRIB_RATE_SCALERS (pll.h:130)


def setup_caterpillar(n=250, sites=23, rate_cats=4, alpha=0.8, seed=7):
    rng = np.random.default_rng(seed)
    newick = random_newick(n, rng, caterpillar=True)
    seqs = random_seqs(n, sites, rng)
    tree = T.parse_newick_string(newick)
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    root = tree.vroot

    lines = [
        f"create {n} {tree.inner_count} 4 {sites} 1 "
        f"{2 * n - 3} {rate_cats} {tree.inner_count} {ATTRIB_RATE_SCALERS}",
        "map nt",
        "freqs 0 0.3 0.25 0.2 0.25",
        "subst 0 1.2 2.1 0.7 1.3 2.5 1.0",
        f"gamma {alpha} {rate_cats} mean",
    ]
    for i, s in enumerate(seqs):
        lines.append(f"tip {i} {s}")
    lines.append(f"pmatrices {len(branches)} " + " ".join(["0"] * rate_cats))
    for b, m in zip(branches, pmat_idx):
        lines.append(f"{m} {b}")
    for op in ops:
        lines.append(
            f"op {op.parent_clv_index} {op.child1_clv_index} "
            f"{op.child2_clv_index} {op.child1_matrix_index} "
            f"{op.child2_matrix_index} {op.parent_scaler_index} "
            f"{op.child1_scaler_index} {op.child2_scaler_index}")
    lines.append("partials")
    lines.append("edge {} {} {} {} {}".format(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index))
    lines.append(f"print_scaler {root.scaler_index}")
    # root-edge sumtable + derivative grid
    lines.append(f"sumtable {root.clv_index} {root.scaler_index} "
                 f"{root.back.clv_index} {root.back.scaler_index}")
    for blen in (0.05, 0.3, 1.5):
        lines.append(f"derivatives {blen}")
    golden = run_oracle("\n".join(lines) + "\n")

    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=rate_cats,
        scale_buffers=tree.inner_count, per_rate_scalers=True,
        dtype=jnp.float64)
    model = engine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(alpha, rate_cats), dtype=jnp.float64)
    raw = np.zeros((n, cfg.sites_alloc), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    pw = jnp.asarray(pw, jnp.float64)
    inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
    return golden, tree, cfg, model, tipchars, pw, inv, branches, root


def test_per_rate_logl_and_scaler_parity():
    golden, tree, cfg, model, tipchars, pw, inv, branches, root = \
        setup_caterpillar()
    program = engine.compile_tree(tree, cfg)
    bl = jnp.asarray(branches, jnp.float64)
    logl = float(engine.loglikelihood(program, cfg, model, bl, tipchars,
                                      pw, inv))
    ref = golden["edge_logl"][0]
    assert abs(logl - ref) < 1e-9 * abs(ref), (logl, ref)

    # per-rate scaler counts: reference layout is site-major
    # (scaler[site*rate_cats + rate], core_likelihood.c:480); ours [R, T]
    ref_scaler = golden["scaler"][root.scaler_index].reshape(
        cfg.sites, cfg.rate_cats).T
    assert ref_scaler.max() > 0  # scaling must actually trigger
    # per-rate counts must DIFFER across rates somewhere, else the test
    # could not distinguish per-rate from per-site mode
    assert (ref_scaler.max(axis=0) != ref_scaler.min(axis=0)).any()
    view, _ = engine._sweep(program, cfg, model, bl, tipchars, pw)
    ours = np.asarray(view.scaler_row(root.scaler_index))[:, :cfg.sites]
    np.testing.assert_array_equal(ours, ref_scaler)


def test_per_rate_full_tree_program_edge_invariance():
    """Round-1 regression: every FullTreeProgram consumer crashed under
    per_rate_scalers=True (engine.py hardcoded the per-site scaler shape)."""
    golden, tree, cfg, model, tipchars, pw, inv, branches, root = \
        setup_caterpillar()
    full = engine.compile_tree_full(tree, cfg)
    bl = jnp.asarray(full.default_branch_lengths, jnp.float64)
    per_edge = np.asarray(engine.all_edge_loglikelihoods(
        full, cfg, model, bl, tipchars, pw, inv))
    ref = golden["edge_logl"][0]
    np.testing.assert_allclose(per_edge, ref, rtol=1e-9)


def test_per_rate_branch_derivatives_vs_oracle():
    golden, tree, cfg, model, tipchars, pw, inv, branches, root = \
        setup_caterpillar()
    full = engine.compile_tree_full(tree, cfg)
    bl = np.asarray(full.default_branch_lengths)
    root_pos = int(np.nonzero(
        full.pmatrix_indices == root.pmatrix_index)[0][0])
    for ref_blen, ref_d1, ref_d2 in golden["derivatives"]:
        bl2 = jnp.asarray(bl, jnp.float64).at[root_pos].set(ref_blen)
        d1, d2 = engine.branch_derivatives(full, cfg, model, bl2, tipchars,
                                           pw, inv)
        # 250 levels of f64 accumulation in batched (vs serial) order:
        # ~5e-9 relative, same as the caterpillar per-site logL tolerance
        # (test_parity_tree.py).  A semantic mismatch in the capped undo
        # (thresh^rel, thresh = 2^-256) would be off by ~1e77.
        np.testing.assert_allclose(float(d1[root_pos]), ref_d1, rtol=3e-8, atol=1e-8)
        np.testing.assert_allclose(float(d2[root_pos]), ref_d2,
                                   rtol=3e-8, atol=1e-8)


def test_per_rate_optimize_branch_lengths():
    golden, tree, cfg, model, tipchars, pw, inv, branches, root = \
        setup_caterpillar(n=60, sites=31)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    bl0 = jnp.asarray(full.default_branch_lengths, jnp.float64) * 2.5 + 0.02
    logl0 = float(engine.loglikelihood(program, cfg, model, bl0, tipchars,
                                       pw, inv))
    new_bl, logl1 = engine.optimize_branch_lengths(
        full, cfg, model, bl0, tipchars, pw, inv, rounds=8, newton_iters=12)
    assert float(logl1) > logl0, (logl0, float(logl1))
    # the reported logL must equal a fresh standard-path evaluation
    check = float(engine.loglikelihood(program, cfg, model, new_bl,
                                       tipchars, pw, inv))
    np.testing.assert_allclose(float(logl1), check, rtol=1e-11)
