"""Site repeats (C7) parity: class-indexed CLV path vs. dense path vs. the
reference oracle run with PLL_ATTRIB_SITE_REPEATS.

Key invariant (repeats.c): repeats change where CLV entries are stored,
never a computed value — the repeats path must match the dense path
bit-for-bit, and both must match the reference.
"""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import tree as T
from libpll2_jax.repeats import Repeats, first_occurrence_classes

from .oracle import run_oracle
from .test_parity_tree import random_newick

ATTRIB_SITE_REPEATS = 1 << 10  # PLL_ATTRIB_SITE_REPEATS (pll.h:135)
BASES = "ACGT"


def repetitive_seqs(n_tips, sites, n_patterns, rng):
    """Alignments dominated by repeated columns — the repeats sweet spot."""
    cols = rng.integers(0, 4, size=(n_patterns, n_tips))
    picks = rng.integers(0, n_patterns, size=sites)
    mat = cols[picks]                      # [sites, tips]
    return ["".join(BASES[b] for b in mat[:, i]) for i in range(n_tips)]


def _run(newick, seqs, sites, site_repeats, rate_cats=4, alpha=0.8):
    tree = T.parse_newick_string(newick)
    tips = tree.tip_count
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    root = tree.vroot

    p = pll.Partition(tips, tree.inner_count, 4, sites, 1, 2 * tips - 3,
                      rate_cats, tree.inner_count,
                      site_repeats=site_repeats)
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_category_rates(pll.compute_gamma_cats(alpha, rate_cats))
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    p.update_prob_matrices([0] * rate_cats, pmat_idx, branches)
    p.update_partials(ops)
    logl, persite = p.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * rate_cats,
        return_persite=True)
    sumtable = p.update_sumtable(root.clv_index, root.back.clv_index,
                                 root.scaler_index, root.back.scaler_index,
                                 [0] * rate_cats)
    d1, d2 = p.compute_likelihood_derivatives(
        sumtable, float(root.length), [0] * rate_cats)
    return p, logl, persite, (d1, d2)


def _oracle(newick, seqs, sites, attrib, rate_cats=4, alpha=0.8):
    tree = T.parse_newick_string(newick)
    tips = tree.tip_count
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    root = tree.vroot
    lines = [
        f"create {tips} {tree.inner_count} 4 {sites} 1 "
        f"{2 * tips - 3} {rate_cats} {tree.inner_count} {attrib}",
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
    lines.append("edge {} {} {} {} {}".format(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index))
    lines.append("sumtable {} {} {} {}".format(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index))
    lines.append(f"derivatives {root.length}")
    return run_oracle("\n".join(lines) + "\n")


def test_first_occurrence_classes():
    site_id, id_site, ids = first_occurrence_classes(
        np.array([7, 3, 7, 9, 3, 7]))
    assert ids == 3
    assert list(site_id) == [0, 1, 0, 2, 1, 0]
    assert list(id_site) == [0, 1, 3]


def test_repeats_matches_dense_and_oracle():
    rng = np.random.default_rng(29)
    sites = 64
    newick = random_newick(12, rng)
    seqs = repetitive_seqs(12, sites, 7, rng)

    p_rep, logl_r, persite_r, d_r = _run(newick, seqs, sites, True)
    p_den, logl_d, persite_d, d_d = _run(newick, seqs, sites, False)

    # repeats actually engaged?
    assert int(np.count_nonzero(p_rep.repeats.pernode_ids)) > 0

    # bit-parity with the dense path (repeats.c invariant)
    assert logl_r == logl_d
    np.testing.assert_array_equal(persite_r, persite_d)
    np.testing.assert_array_equal(d_r, d_d)

    golden = _oracle(newick, seqs, sites, ATTRIB_SITE_REPEATS)
    assert logl_r == pytest.approx(golden["edge_logl"][0], rel=1e-9)
    np.testing.assert_allclose(persite_r, golden["persite"][:sites],
                               rtol=1e-9, atol=1e-300)
    d1, d2 = golden["derivatives"][0][1:3]
    assert d_r[0] == pytest.approx(d1, rel=1e-6)
    assert d_r[1] == pytest.approx(d2, rel=1e-6)


def test_repeats_deep_tree_scaling():
    """Deep caterpillar: the 2^-256 scaling protocol must survive the
    class-indexed scaler storage."""
    rng = np.random.default_rng(31)
    sites = 40
    n = 50
    newick = random_newick(n, rng, caterpillar=True)
    seqs = repetitive_seqs(n, sites, 5, rng)

    p_rep, logl_r, persite_r, _ = _run(newick, seqs, sites, True)
    p_den, logl_d, persite_d, _ = _run(newick, seqs, sites, False)
    assert int(np.count_nonzero(p_rep.repeats.pernode_ids)) > 0
    assert logl_r == logl_d
    np.testing.assert_array_equal(persite_r, persite_d)

    golden = _oracle(newick, seqs, sites, ATTRIB_SITE_REPEATS)
    assert logl_r == pytest.approx(golden["edge_logl"][0], rel=1e-9)


def test_repeats_random_seqs_heuristic():
    """High-entropy alignments: the enable heuristic should mostly fall
    back to dense, and results must still agree."""
    rng = np.random.default_rng(37)
    from .test_parity_tree import random_seqs
    sites = 32
    newick = random_newick(10, rng)
    seqs = random_seqs(10, sites, rng)
    p_rep, logl_r, persite_r, _ = _run(newick, seqs, sites, True)
    p_den, logl_d, persite_d, _ = _run(newick, seqs, sites, False)
    assert logl_r == logl_d
    np.testing.assert_array_equal(persite_r, persite_d)


def test_repeats_class_counts_match_reference_rules():
    """Structural checks on the host-side class machinery."""
    rep = Repeats(nodes=6, scale_buffers=2, sites=8, additional_sites=0,
                  lookup_size=100)
    # two tips with three/two distinct codes
    rep.update_tip(0, np.array([1, 2, 1, 4, 2, 1, 1, 4], dtype=np.uint64))
    rep.update_tip(1, np.array([8, 8, 1, 1, 8, 8, 1, 1], dtype=np.uint64))
    assert rep.pernode_ids[0] == 3
    assert rep.pernode_ids[1] == 2
    assert rep.sites_number(0) == 3
    # parent classes = unique (left, right) pairs
    rep.update(4, 0, 1, parent_scaler=0)
    keys = rep.pernode_site_id[0, :8] + rep.pernode_site_id[1, :8] * 3
    assert rep.pernode_ids[4] == len(set(keys.tolist()))
    # a child exceeding sites/2 classes disables repeats
    rep2 = Repeats(nodes=4, scale_buffers=1, sites=8, additional_sites=0)
    rep2.update_tip(0, np.array([1, 2, 4, 8, 3, 5, 6, 7], dtype=np.uint64))
    rep2.update_tip(1, np.array([1, 1, 1, 1, 2, 2, 2, 2], dtype=np.uint64))
    assert not rep2.enable(0, 1)   # 8 > 8//2
    rep2.update(2, 0, 1, parent_scaler=0)
    assert rep2.pernode_ids[2] == 0
