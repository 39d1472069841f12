"""Tree layer: newick parsing, template indices, traversal, operations."""
import numpy as np
import pytest

from libpll2_jax import tree as T
from libpll2_jax.constants import SCALE_BUFFER_NONE

NEWICK = "((A:0.1,B:0.2):0.3,C:0.4,(D:0.5,E:0.6):0.7);"


def test_parse_structure():
    t = T.parse_newick_string(NEWICK)
    assert t.tip_count == 5
    assert t.inner_count == 3
    assert t.binary
    assert T.check_integrity(t)
    labels = [t.nodes[i].label for i in range(5)]
    assert labels == ["A", "B", "C", "D", "E"]


def test_template_indices():
    t = T.parse_newick_string(NEWICK)
    # tips: clv_index = pmatrix_index = 0..4, scaler NONE
    for i in range(5):
        n = t.nodes[i]
        assert n.clv_index == i and n.pmatrix_index == i
        assert n.scaler_index == SCALE_BUFFER_NONE
    # inner: clv 5..7, scaler = clv - tips
    for i in range(5, 8):
        n = t.nodes[i]
        assert n.clv_index == i
        assert n.scaler_index == i - 5
        for h in n.roundabout():
            assert h.clv_index == i


def test_operations():
    t = T.parse_newick_string(NEWICK)
    trav = T.traverse(t.vroot)
    assert len(trav) == 8
    ops, branches, pmat_idx = T.create_operations(trav)
    assert len(ops) == 3
    # every edge exactly once
    assert len(branches) == 7
    assert sorted(pmat_idx) == sorted(set(pmat_idx))
    # root op is last and targets the vroot's clv
    assert ops[-1].parent_clv_index == t.vroot.clv_index
    # branch lengths recovered (as a multiset)
    assert sorted(branches) == [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7]


def test_partial_traversal():
    t = T.parse_newick_string(NEWICK)
    # mark all inner CLVs valid except the root: prune everything
    for n in t.nodes:
        n.data = True  # clv valid
    trav = T.traverse(t.vroot, cbtrav=lambda n: n.data is not True
                      or n.next is None and False)
    assert trav == []


def test_export_roundtrip():
    t = T.parse_newick_string(NEWICK)
    out = T.export_newick(t.vroot)
    t2 = T.parse_newick_string(out)
    assert t2.tip_count == 5
    assert [t2.nodes[i].label for i in range(5)] == ["A", "B", "C", "D", "E"]
    b1 = sorted(n.length for n in t.nodes)
    b2 = sorted(n.length for n in t2.nodes)
    np.testing.assert_allclose(b1, b2)


def test_unroot():
    rooted = "((A:0.1,B:0.2):0.3,(C:0.4,D:0.5):0.6);"
    t = T.parse_newick_string_unroot(rooted)
    assert t.tip_count == 4
    assert t.inner_count == 2
    # merged root edge: 0.3 + 0.6
    lengths = sorted(set(round(n.length, 10) for n in t.nodes))
    assert 0.9 in lengths


def test_rejects_rooted():
    with pytest.raises(ValueError):
        T.parse_newick_string("((A:1,B:1):1,(C:1,D:1):1);")


def test_multifurcating_rooted_parse():
    t = T.parse_newick_string_rooted("((A:1,B:1,C:1):1,D:1);")
    assert t.tip_count == 4
    assert not t.binary


def test_strict_parser_rejects_multifurcation():
    """Round-1 regression: a multifurcating input silently compiled to a
    WRONG likelihood (create_operations drops 3rd+ children); the strict
    parser must reject it (parse_utree.y:462-479 binary-wraptree check)."""
    multi = "((A:1,B:1,C:1):1,D:1,(E:1,F:1):1);"
    with pytest.raises(ValueError, match="bifurcating"):
        T.parse_newick_string(multi)
    # the explicitly-multifurcating entry point still accepts it
    t = T.parse_newick_string_rooted(multi)
    assert t.tip_count == 6 and not t.binary


def test_unroot_rejects_multifurcation():
    with pytest.raises(ValueError, match="bifurcating"):
        T.parse_newick_string_unroot("((A:1,B:1,C:1):1,(D:1,E:1):1);")


def test_export_newick_serialize_callback():
    """pll_utree_export_newick(root, cb) contract (utree.c:162-248): the
    callback emits the full token for every node except the top-level
    root, which prints its bare label."""
    t = T.parse_newick_string("((A:0.1,B:0.2)ab:0.3,C:0.4,D:0.5)r;")

    def cb(node):
        return f"{node.label or ''}<{node.length:.1f}>"

    out = T.export_newick(t.vroot, cb_serialize=cb)
    assert out == "((A<0.1>,B<0.2>)ab<0.3>,C<0.4>,D<0.5>)r;"


def test_create_operations_empty_traversal():
    """A fully-pruned partial traversal compiles to zero operations
    (pll_utree_create_operations on an empty buffer), not an error —
    the partial-traversal workflow hits this when every CLV toward the
    chosen root is already valid."""
    ops, branches, pmat = T.create_operations([])
    assert ops == [] and branches == [] and pmat == []
