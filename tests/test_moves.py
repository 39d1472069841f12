"""SPR/NNI moves + rollback, and the partial-traversal (incremental CLV)
workflow after a move — mirrors examples/partial-traversal/partial.c and
utree_moves.c semantics."""
import numpy as np

import libpll2_jax as pll
from libpll2_jax import tree as T
from libpll2_jax.tree import moves

from .test_parity_tree import random_newick, random_seqs

N_TIPS, SITES = 10, 60


def build(seed=17):
    rng = np.random.default_rng(seed)
    newick = random_newick(N_TIPS, rng)
    seqs = random_seqs(N_TIPS, SITES, rng)
    tree = T.parse_newick_string(newick)
    return tree, seqs


def make_partition(tree, seqs):
    p = pll.Partition(N_TIPS, tree.inner_count, 4, SITES, 1,
                      2 * N_TIPS - 3, 4, tree.inner_count)
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.9)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    return p


def full_logl(p, tree):
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    p.update_prob_matrices([0] * 4, pmat_idx, branches)
    p.update_partials(ops)
    root = tree.vroot
    return p.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * 4)


def inner_halves(tree):
    out = []
    for n in tree.nodes[N_TIPS:]:
        out.extend(n.roundabout())
    return out


def find_spr_pair(tree):
    """First (prune half-node, regraft node) pair that is a legal,
    topology-changing SPR."""
    candidates = inner_halves(tree) + list(tree.nodes[:N_TIPS])
    for pnode in inner_halves(tree):
        if pnode.back.next is None:
            continue
        for cand in candidates:
            if cand in (pnode, pnode.back, pnode.next, pnode.next.back,
                        pnode.next.next, pnode.next.next.back):
                continue
            if not moves.subtree_contains(pnode.back, cand):
                return pnode, cand
    raise AssertionError("no legal SPR pair found")


def test_nni_twice_identity():
    tree, seqs = build()
    p = make_partition(tree, seqs)
    l0 = full_logl(p, tree)
    edge = next(h for h in inner_halves(tree)
                if h.back.next is not None)
    rb = moves.nni(edge, moves.NNI_LEFT)
    assert T.check_integrity(tree)
    moves.rollback(rb)
    assert T.check_integrity(tree)
    l1 = full_logl(p, tree)
    np.testing.assert_allclose(l1, l0, rtol=1e-12)


def test_nni_changes_topology_logl():
    tree, seqs = build()
    p = make_partition(tree, seqs)
    l0 = full_logl(p, tree)
    edge = next(h for h in inner_halves(tree) if h.back.next is not None)
    moves.nni(edge, moves.NNI_RIGHT)
    l1 = full_logl(p, tree)
    assert abs(l1 - l0) > 1e-9  # generic data: logL should move


def test_spr_and_rollback():
    tree, seqs = build()
    p = make_partition(tree, seqs)
    l0 = full_logl(p, tree)

    pnode, rnode = find_spr_pair(tree)

    rb, bl, mi = moves.spr(pnode, rnode, safe=True)
    assert T.check_integrity(tree)
    assert len(bl) == 3 and len(mi) == 3

    l_moved = full_logl(p, tree)

    moves.rollback(rb)
    assert T.check_integrity(tree)
    l_restored = full_logl(p, tree)
    np.testing.assert_allclose(l_restored, l0, rtol=1e-12)
    assert abs(l_moved - l0) > 1e-9


def test_spr_partial_traversal_matches_full():
    """After an SPR, recomputing only the invalid region (clv_valid flags
    in node.data, partial.c pattern) must equal a from-scratch partition."""
    tree, seqs = build(seed=23)
    p = make_partition(tree, seqs)
    full_logl(p, tree)  # fill all CLVs; now mark all inner nodes valid
    for n in tree.nodes[N_TIPS:]:
        for h in n.roundabout():
            h.data = True  # clv_valid

    pnode, rnode = find_spr_pair(tree)
    rb, bl, mi = moves.spr(pnode, rnode, safe=True)

    # invalidate CLVs at the two endpoints of every changed edge (partial.c
    # pattern: nodes whose subtree composition changed)
    for h in [pnode, rnode, rnode.back, pnode.next, pnode.next.next]:
        if h.next is not None:
            for hh in h.roundabout():
                hh.data = False
    # and everything on the path up to the traversal root gets invalidated
    # by the pruning callback below (returns False to *stop* descending
    # only into valid subtrees)

    p.update_prob_matrices([0] * 4, mi, bl)

    root = tree.vroot

    def cb(node):
        # descend only into invalid subtrees; tips always valid
        if node.next is None:
            return False  # tips have no ops
        return not bool(node.data)

    # the standard partial-traversal pattern: traverse with a callback that
    # prunes valid subtrees, emit ops only for the invalid region
    trav = T.traverse(root, cbtrav=lambda n: True)
    # recompute ops for nodes with any invalid flag on the path: emulate by
    # recomputing every op whose parent has data=False
    ops_all, _, _ = T.create_operations(trav)
    clv_valid = {}
    for n in tree.nodes[N_TIPS:]:
        clv_valid[n.clv_index] = bool(n.data)
    ops = [o for o in ops_all if not clv_valid.get(o.parent_clv_index, True)]
    # parents above an invalid child are also invalid (post-order ensures
    # children first); propagate:
    invalid = {o.parent_clv_index for o in ops}
    changed = True
    while changed:
        changed = False
        for o in ops_all:
            if o.parent_clv_index in invalid:
                continue
            if o.child1_clv_index in invalid or o.child2_clv_index in invalid:
                invalid.add(o.parent_clv_index)
                changed = True
    ops = [o for o in ops_all if o.parent_clv_index in invalid]
    p.update_partials(ops)
    l_partial = p.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * 4)

    # from-scratch reference
    p2 = make_partition(tree, seqs)
    l_full = full_logl(p2, tree)
    np.testing.assert_allclose(l_partial, l_full, rtol=1e-12)
