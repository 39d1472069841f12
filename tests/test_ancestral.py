"""Marginal ancestral state probabilities vs. the reference oracle
(pll_compute_node_ancestral, likelihood.c:639-823).

Tolerance note: posteriors inherit eigen-solver differences (jnp.linalg.eigh
vs. the reference's tred2/tqli) at ~1e-8 relative in small P entries, so
these tests use 1e-6 — logL parity stays at 1e-9 because its sum is
dominated by the well-conditioned large terms.
"""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import tree as T

from .oracle import run_oracle
from .test_parity_tree import random_newick, random_seqs


def _both(newick, seqs, sites, rate_cats=4, alpha=0.8, caterpillar=False):
    tree = T.parse_newick_string(newick)
    tips = tree.tip_count
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    root = tree.vroot

    # node = vroot (inner), other = vroot.back (inner on random trees),
    # plus an inner/tip pair
    pairs = [(root.clv_index, root.scaler_index, root.back.clv_index,
              root.back.scaler_index, root.pmatrix_index)]
    for node in trav:
        if node.next is None:  # tip: other=tip across the tip's edge
            b = node.back
            pairs.append((b.clv_index, b.scaler_index, node.clv_index,
                          pll.SCALE_BUFFER_NONE, node.pmatrix_index))
            break

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
    goldens = []
    for pr in pairs:
        g = run_oracle("\n".join(lines + ["ancestral {} {} {} {} {}"
                                          .format(*pr)]) + "\n")
        goldens.append(g["ancestral"].reshape(sites, 4))

    p = pll.Partition(tips, tree.inner_count, 4, sites, 1, 2 * tips - 3,
                      rate_cats, tree.inner_count)
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_category_rates(pll.compute_gamma_cats(alpha, rate_cats))
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    p.update_prob_matrices([0] * rate_cats, pmat_idx, branches)
    p.update_partials(ops)
    ours = [p.compute_node_ancestral(*pr, [0] * rate_cats) for pr in pairs]
    return goldens, ours


def test_ancestral_random_tree():
    rng = np.random.default_rng(3)
    newick = random_newick(10, rng)
    seqs = random_seqs(10, 29, rng)
    goldens, ours = _both(newick, seqs, 29)
    for g, o in zip(goldens, ours):
        np.testing.assert_allclose(o, g, rtol=1e-6, atol=1e-10)


def test_ancestral_deep_caterpillar_scaled():
    rng = np.random.default_rng(41)
    n = 60
    newick = random_newick(n, rng, caterpillar=True)
    seqs = random_seqs(n, 17, rng)
    goldens, ours = _both(newick, seqs, 17)
    for g, o in zip(goldens, ours):
        np.testing.assert_allclose(o, g, rtol=1e-6, atol=1e-10)
