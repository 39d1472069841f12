"""End-to-end parity on whole trees: our newick parser + operations compiler
drive both the reference oracle and the JAX engine with identical operation
arrays; log-likelihoods, per-site values, and scaler counts must agree.

The caterpillar case is deep enough to trigger the 2^-256 counter-based
scaling protocol (scaling.c test analog).
"""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import tree as T

from .oracle import run_oracle

BASES = "ACGT"


def random_newick(n_tips, rng, caterpillar=False):
    labels = [f"t{i}" for i in range(n_tips)]
    if caterpillar:
        s = labels[0] + ":0.05"
        for lab in labels[1:-2]:
            s = f"({lab}:0.05,{s}):0.05"
        return f"({labels[-2]}:0.05,{labels[-1]}:0.05,{s});"
    items = [f"{lab}:{rng.uniform(0.01, 0.5):.6f}" for lab in labels]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        merged = (f"({items[i]},{items[j]}):{rng.uniform(0.01, 0.5):.6f}")
        items = [x for k, x in enumerate(items) if k not in (i, j)]
        items.append(merged)
    return f"({items[0]},{items[1]},{items[2]});"


def random_seqs(n_tips, sites, rng):
    return ["".join(BASES[b] for b in rng.integers(0, 4, sites))
            for _ in range(n_tips)]


def run_both(newick, seqs, sites, rate_cats=4, alpha=0.8):
    tree = T.parse_newick_string(newick)
    tips = tree.tip_count
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)

    root = tree.vroot
    edge_args = (root.clv_index, root.scaler_index, root.back.clv_index,
                 root.back.scaler_index, root.pmatrix_index)

    # --- oracle ---
    lines = [
        f"create {tips} {tree.inner_count} 4 {sites} 1 "
        f"{2 * tips - 3} {rate_cats} {tree.inner_count} 0",
        "map nt",
        "freqs 0 0.3 0.25 0.2 0.25",
        "subst 0 1.2 2.1 0.7 1.3 2.5 1.0",
        f"gamma {alpha} {rate_cats} mean",
    ]
    for i, s in enumerate(seqs):
        lines.append(f"tip {i} {s}")
    lines.append(f"pmatrices {len(branches)} "
                 + " ".join(["0"] * rate_cats))
    for b, m in zip(branches, pmat_idx):
        lines.append(f"{m} {b}")
    for op in ops:
        lines.append(
            f"op {op.parent_clv_index} {op.child1_clv_index} "
            f"{op.child2_clv_index} {op.child1_matrix_index} "
            f"{op.child2_matrix_index} {op.parent_scaler_index} "
            f"{op.child1_scaler_index} {op.child2_scaler_index}")
    lines.append("partials")
    lines.append("edge {} {} {} {} {}".format(*edge_args))
    lines.append(f"print_scaler {root.scaler_index}")
    golden = run_oracle("\n".join(lines) + "\n")

    # --- JAX engine ---
    p = pll.Partition(tips, tree.inner_count, 4, sites, 1, 2 * tips - 3,
                      rate_cats, tree.inner_count)
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(alpha)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    p.update_prob_matrices([0] * rate_cats, pmat_idx, branches)
    p.update_partials(ops)
    logl, persite = p.compute_edge_loglikelihood(
        *edge_args, [0] * rate_cats, return_persite=True)
    return golden, p, logl, persite, root


def test_random_tree_20():
    rng = np.random.default_rng(42)
    sites = 57
    newick = random_newick(20, rng)
    seqs = random_seqs(20, sites, rng)
    golden, p, logl, persite, root = run_both(newick, seqs, sites)
    ref = golden["edge_logl"][0]
    assert abs(logl - ref) < 1e-9 * abs(ref)
    np.testing.assert_allclose(persite, golden["persite"], rtol=1e-9)


def test_caterpillar_scaling():
    rng = np.random.default_rng(7)
    n = 250
    sites = 23
    newick = random_newick(n, rng, caterpillar=True)
    seqs = random_seqs(n, sites, rng)
    golden, p, logl, persite, root = run_both(newick, seqs, sites)
    ref = golden["edge_logl"][0]
    # scaling must actually trigger for this test to mean anything
    ref_scaler = golden["scaler"][root.scaler_index]
    assert ref_scaler.max() > 0
    ours = p.get_scaler(root.scaler_index)
    np.testing.assert_array_equal(ours, ref_scaler)
    assert abs(logl - ref) < 1e-9 * abs(ref)
    # 250 levels of f64 accumulation in a different (batched) order than the
    # reference's serial loops: per-site values agree to ~1e-9 relative
    np.testing.assert_allclose(persite, golden["persite"], rtol=5e-9)
