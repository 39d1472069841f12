"""Rooted-tree layer: parsing, template indices, operations, rooted logL
parity vs. the oracle (mirrors 00020_NMDR_lkcalc intent), newick export,
and rooted/unrooted logL agreement under a reversible model (pulley
principle)."""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import tree as T

from .oracle import run_oracle

NEWICK = "((t0:0.2,t1:0.3)i1:0.1,(t2:0.25,(t3:0.15,t4:0.35)i2:0.05)i3:0.4)r;"
SEQS = {"t0": "WAACAB", "t1": "CACACD", "t2": "AGGACA", "t3": "CGTAGT",
        "t4": "CATCCA"}


def test_parse_and_indices():
    rt = T.parse_rtree_string(NEWICK)
    assert rt.tip_count == 5 and rt.inner_count == 4
    labels = [n.label for n in rt.nodes[:5]]
    assert labels == ["t0", "t1", "t2", "t3", "t4"]
    for i, n in enumerate(rt.nodes[:5]):
        assert n.clv_index == i and n.scaler_index == pll.SCALE_BUFFER_NONE
    for i, n in enumerate(rt.nodes[5:]):
        assert n.clv_index == 5 + i and n.scaler_index == i
    assert rt.root.clv_index == 8


def test_export_roundtrip():
    rt = T.parse_rtree_string(NEWICK)
    out = T.export_rtree_newick(rt.root)
    rt2 = T.parse_rtree_string(out)
    assert [n.label for n in rt2.nodes] == [n.label for n in rt.nodes]
    np.testing.assert_allclose(
        [n.length for n in rt2.nodes[:-1]],
        [n.length for n in rt.nodes[:-1]], rtol=1e-6)


def rooted_logl():
    rt = T.parse_rtree_string(NEWICK)
    trav = T.rtree_traverse(rt.root)
    ops, branches, pmat_idx = T.rtree_create_operations(trav)
    p = pll.Partition(5, 4, 4, 6, 1, len(branches), 4, 4)
    p.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.8)
    for n in rt.nodes[:5]:
        p.set_tip_states(n.clv_index, pll.MAP_NT, SEQS[n.label])
    p.update_prob_matrices([0] * 4, pmat_idx, branches)
    p.update_partials(ops)
    return p.compute_root_loglikelihood(rt.root.clv_index,
                                        rt.root.scaler_index, [0] * 4), \
        (ops, branches, pmat_idx, rt)


def test_rooted_logl_vs_oracle():
    (logl, (ops, branches, pmat_idx, rt)) = rooted_logl()
    lines = ["create 5 4 4 6 1 8 4 4 0", "map nt",
             "freqs 0 0.17 0.19 0.25 0.39",
             "subst 0 1.2 2.1 0.7 1.3 2.5 1.0", "gamma 0.8 4 mean"]
    for n in rt.nodes[:5]:
        lines.append(f"tip {n.clv_index} {SEQS[n.label]}")
    lines.append(f"pmatrices {len(branches)} 0 0 0 0")
    for mi, bl in zip(pmat_idx, branches):
        lines.append(f"{mi} {bl}")
    for o in ops:
        lines.append(
            f"op {o.parent_clv_index} {o.child1_clv_index} "
            f"{o.child2_clv_index} {o.child1_matrix_index} "
            f"{o.child2_matrix_index} {o.parent_scaler_index} "
            f"{o.child1_scaler_index} {o.child2_scaler_index}")
    lines += ["partials", "root 8 3"]
    golden = run_oracle("\n".join(lines) + "\n")
    np.testing.assert_allclose(logl, golden["root_logl"][0], rtol=1e-9)


def test_pulley_principle():
    """GTR is time-reversible: rooted logL == unrooted logL of the
    unrooted conversion (stationary root frequencies)."""
    rooted, _ = rooted_logl()

    ut = T.rtree_to_utree(T.parse_rtree_string(NEWICK))
    assert T.check_integrity(ut)
    trav = T.traverse(ut.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    p = pll.Partition(5, 3, 4, 6, 1, 2 * 5 - 3, 4, 3)
    p.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.8)
    for n in ut.nodes[:5]:
        p.set_tip_states(n.clv_index, pll.MAP_NT, SEQS[n.label])
    p.update_prob_matrices([0] * 4, pmat_idx, branches)
    p.update_partials(ops)
    root = ut.vroot
    unrooted = p.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * 4)
    np.testing.assert_allclose(unrooted, rooted, rtol=1e-10)
