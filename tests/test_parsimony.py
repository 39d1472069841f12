"""Parsimony parity vs. the reference oracle.

Covers the Sankoff (weighted, parsimony.c) and Fitch (fast_parsimony.c)
subsystems: build scores, per-node scores, ancestral reconstructions,
informative-site filtering, and edge/root Fitch scores on random trees.
"""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import tree as T

from .oracle import run_oracle
from .test_parity_tree import random_newick, random_seqs

BASES = "ACGT"


def random_rooted_newick(n_tips, rng):
    items = [f"t{i}:{rng.uniform(0.01, 0.5):.4f}" for i in range(n_tips)]
    while len(items) > 1:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        merged = f"({items[i]},{items[j]}):{rng.uniform(0.01, 0.5):.4f}"
        items = [x for k, x in enumerate(items) if k not in (i, j)]
        items.append(merged)
    return items[0][: items[0].rfind(":")] + ";"


# --------------------------------------------------------------------------
# Sankoff (weighted) parsimony
# --------------------------------------------------------------------------

def _sankoff_both(newick, seqs, score_matrix, states=4, map_name="nt",
                  reconstruct=True):
    rt = T.parse_rtree_string(newick)
    tips = rt.tip_count
    sites = len(seqs[0])
    trav = T.rtree_traverse(rt.root)
    build_ops = T.rtree_create_pars_buildops(trav)
    pre = T.rtree_traverse(rt.root, order=pll.constants.TRAVERSE_PREORDER)
    rec_ops = T.rtree_create_pars_recops(pre)
    root_idx = rt.root.clv_index

    sm_flat = " ".join(f"{v:.17g}" for v in
                       np.asarray(score_matrix).reshape(-1))
    lines = [f"pars_create {tips} {states} {sites} {tips - 1} {tips - 1}",
             sm_flat, f"map {map_name}"]
    for i, s in enumerate(seqs):
        lines.append(f"pars_tip {i} {s}")
    for op in build_ops:
        lines.append(f"pars_op {op.parent_score_index} "
                     f"{op.child1_score_index} {op.child2_score_index}")
    lines.append("pars_build")
    for op in build_ops:
        lines.append(f"pars_score {op.parent_score_index}")
    if reconstruct:
        for op in rec_ops:
            lines.append(f"pars_recop {op.node_score_index} "
                         f"{op.node_ancestral_index} "
                         f"{op.parent_score_index} "
                         f"{op.parent_ancestral_index}")
        lines.append("pars_reconstruct")
    golden = run_oracle("\n".join(lines) + "\n")

    cmap = pll.MAPS[map_name]
    pars = pll.Parsimony(tips, states, sites, score_matrix,
                         score_buffers=tips - 1, ancestral_buffers=tips - 1)
    for i, s in enumerate(seqs):
        pars.set_tip_states(i, cmap, s)
    score = pars.build(build_ops)
    if reconstruct:
        pars.reconstruct(cmap, rec_ops)
    return golden, pars, build_ops, rec_ops, root_idx, score


def test_sankoff_unit_matrix_dna():
    rng = np.random.default_rng(11)
    newick = random_rooted_newick(8, rng)
    seqs = random_seqs(8, 37, rng)
    sm = 1.0 - np.eye(4)
    golden, pars, build_ops, rec_ops, root, score = _sankoff_both(
        newick, seqs, sm)
    assert score == pytest.approx(golden["pars_build_score"])
    # run_oracle keeps only the last 'pars_score' (the root's, since the
    # root op is last in post-order)
    assert pars.score(root) == pytest.approx(golden["pars_score"])
    for idx, anc in golden["pars_anc"].items():
        assert pars.get_ancestral(idx) == anc


def test_sankoff_weighted_matrix_dna():
    rng = np.random.default_rng(23)
    newick = random_rooted_newick(10, rng)
    seqs = random_seqs(10, 53, rng)
    # asymmetric transition/transversion-style costs
    sm = np.array([[0, 2.5, 1.0, 2.5],
                   [2.5, 0, 2.5, 1.0],
                   [1.0, 2.5, 0, 2.5],
                   [2.5, 1.0, 2.5, 0]], dtype=float)
    golden, pars, build_ops, rec_ops, root, score = _sankoff_both(
        newick, seqs, sm)
    assert score == pytest.approx(golden["pars_build_score"])
    for idx, anc in golden["pars_anc"].items():
        assert pars.get_ancestral(idx) == anc


def test_sankoff_ambiguity_and_gaps():
    rng = np.random.default_rng(5)
    newick = random_rooted_newick(6, rng)
    seqs = random_seqs(6, 31, rng)
    # sprinkle ambiguity codes and gaps
    chars = "RYSWKMBDHVN-"
    for i in range(6):
        s = list(seqs[i])
        for j in rng.choice(31, 6, replace=False):
            s[j] = chars[rng.integers(0, len(chars))]
        seqs[i] = "".join(s)
    sm = 1.0 - np.eye(4)
    golden, pars, build_ops, rec_ops, root, score = _sankoff_both(
        newick, seqs, sm)
    assert score == pytest.approx(golden["pars_build_score"])
    for idx, anc in golden["pars_anc"].items():
        assert pars.get_ancestral(idx) == anc


def test_sankoff_protein():
    rng = np.random.default_rng(31)
    newick = random_rooted_newick(5, rng)
    aa = "ARNDCQEGHILKMFPSTWYV"
    seqs = ["".join(aa[b] for b in rng.integers(0, 20, 19))
            for _ in range(5)]
    sm = 1.0 - np.eye(20)
    golden, pars, build_ops, rec_ops, root, score = _sankoff_both(
        newick, seqs, sm, states=20, map_name="aa")
    assert score == pytest.approx(golden["pars_build_score"])
    for idx, anc in golden["pars_anc"].items():
        assert pars.get_ancestral(idx) == anc


# --------------------------------------------------------------------------
# Fitch (fast) parsimony
# --------------------------------------------------------------------------

def _fitch_both(newick, seqs, weights=None, states=4, map_name="nt"):
    tree = T.parse_newick_string(newick)
    tips = tree.tip_count
    sites = len(seqs[0])
    trav = T.traverse(tree.vroot)
    build_ops = T.create_pars_buildops(trav)
    root = tree.vroot
    edge = (root.node_index, root.back.node_index)

    lines = [
        f"create {tips} {tree.inner_count} {states} {sites} 1 "
        f"{2 * tips - 3} 1 {tree.inner_count} 0",
        f"map {map_name}",
    ]
    for i, s in enumerate(seqs):
        lines.append(f"tip {i} {s}")
    if weights is not None:
        lines.append("pattern_weights "
                     + " ".join(str(int(w)) for w in weights))
    # directional vectors for other edges: re-rooted traversals, exactly
    # the reference's stepwise pattern (stepwise.c:461-478)
    rerooted = []
    for node in trav:
        if node.next is not None and len(rerooted) < 4:
            rerooted.append(node.next)
    extra = [(h, T.create_pars_buildops(T.traverse(h))) for h in rerooted]
    extra_edges = [(h.node_index, h.back.node_index) for h in rerooted]

    lines.append("fastpars_init")
    for op in build_ops:
        lines.append(f"fastpars_op {op.parent_score_index} "
                     f"{op.child1_score_index} {op.child2_score_index}")
    lines.append("fastpars_update")
    lines.append(f"fastpars_edge {edge[0]} {edge[1]}")
    for (h, ops_h), e in zip(extra, extra_edges):
        for op in ops_h:
            lines.append(f"fastpars_op {op.parent_score_index} "
                         f"{op.child1_score_index} {op.child2_score_index}")
        lines.append("fastpars_update")
        lines.append(f"fastpars_edge {e[0]} {e[1]}")
    golden = run_oracle("\n".join(lines) + "\n")

    cmap = pll.MAPS[map_name]
    p = pll.Partition(tips, tree.inner_count, states, sites, 1,
                      2 * tips - 3, 1, tree.inner_count)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, cmap, s)
    if weights is not None:
        p.set_pattern_weights(weights)
    fp = pll.FastParsimony(p)
    fp.update_vectors(build_ops)
    ours = [fp.edge_score(*edge)]
    for (h, ops_h), e in zip(extra, extra_edges):
        fp.update_vectors(ops_h)
        ours.append(fp.edge_score(*e))
    return golden, fp, ours, edge


def test_fitch_dna_random_tree():
    rng = np.random.default_rng(7)
    newick = random_newick(12, rng)
    seqs = random_seqs(12, 61, rng)
    golden, fp, ours, edge = _fitch_both(newick, seqs)
    assert fp.const_cost == int(golden["fastpars_const"])
    assert fp.informative_count == int(golden["fastpars_informative"])
    assert ours == golden["fastpars_edge"]


def test_fitch_pattern_weights():
    rng = np.random.default_rng(13)
    newick = random_newick(9, rng)
    seqs = random_seqs(9, 40, rng)
    weights = rng.integers(1, 5, 40)
    golden, fp, ours, edge = _fitch_both(newick, seqs, weights=weights)
    assert fp.const_cost == int(golden["fastpars_const"])
    assert fp.informative_count == int(golden["fastpars_informative"])
    assert ours == golden["fastpars_edge"]


def test_fitch_with_ambiguities():
    rng = np.random.default_rng(17)
    newick = random_newick(10, rng)
    seqs = random_seqs(10, 45, rng)
    chars = "RYSWKMN-"
    for i in range(10):
        s = list(seqs[i])
        for j in rng.choice(45, 8, replace=False):
            s[j] = chars[rng.integers(0, len(chars))]
        seqs[i] = "".join(s)
    golden, fp, ours, edge = _fitch_both(newick, seqs)
    assert fp.const_cost == int(golden["fastpars_const"])
    assert ours == golden["fastpars_edge"]


def test_fitch_protein():
    rng = np.random.default_rng(19)
    newick = random_newick(7, rng)
    aa = "ARNDCQEGHILKMFPSTWYV"
    seqs = ["".join(aa[b] for b in rng.integers(0, 20, 33))
            for _ in range(7)]
    golden, fp, ours, edge = _fitch_both(newick, seqs, states=20,
                                         map_name="aa")
    assert fp.const_cost == int(golden["fastpars_const"])
    assert fp.informative_count == int(golden["fastpars_informative"])
    assert ours == golden["fastpars_edge"]
