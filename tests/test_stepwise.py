"""Stepwise-addition starting trees + SPR rounds vs. the reference oracle.

Topology parity is compared via canonical split sets (identical trees),
cost via the returned parsimony score; determinism hinges on the
glibc-exact RNG (utils/random.py) reproducing the reference's shuffles
seed-for-seed (stepwise.c:56-106).
"""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import tree as T
from libpll2_jax.parsimony import (fastparsimony_stepwise,
                                   fastparsimony_stepwise_extend,
                                   fastparsimony_stepwise_spr_round)
from libpll2_jax.utils.random import GlibcRandom, create_shuffled

from .oracle import run_oracle
from .test_parity_tree import random_seqs


def _side_tips(h):
    if h.next is None:
        return {h.label}
    return _side_tips(h.next.back) | _side_tips(h.next.next.back)


def canonical_splits(tree):
    all_tips = frozenset(n.label for n in tree.nodes[:tree.tip_count])
    out = set()
    for h in T.traverse(tree.vroot):
        if h.next is None:
            continue
        s = frozenset(_side_tips(h))
        o = all_tips - s
        key_s = (len(s), tuple(sorted(s)))
        key_o = (len(o), tuple(sorted(o)))
        out.add(s if key_s <= key_o else o)
    return out


def _stepwise_both(n_tips, sites, seed, spr_seed=None, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    seqs = random_seqs(n_tips, sites, rng)
    labels = [f"t{i}" for i in range(n_tips)]

    lines = [f"create {n_tips} {n_tips - 2} 4 {sites} 1 "
             f"{2 * n_tips - 3} 1 {n_tips - 2} 0", "map nt"]
    for i, s in enumerate(seqs):
        lines.append(f"tip {i} {s}")
    lines.append("fastpars_init")
    lines.append(f"stepwise {seed}")
    if spr_seed is not None:
        lines.append(f"stepwise_spr {spr_seed}")
    golden = run_oracle("\n".join(lines) + "\n")

    p = pll.Partition(n_tips, n_tips - 2, 4, sites, 1, 2 * n_tips - 3, 1,
                      n_tips - 2)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    fp = pll.FastParsimony(p)
    tree, cost = fastparsimony_stepwise([fp], labels, seed)
    spr_cost = None
    if spr_seed is not None:
        spr_cost = fastparsimony_stepwise_spr_round(
            tree, [fp], spr_seed,
            clv_index_map=np.zeros(2 * n_tips, dtype=np.int64))
    return golden, tree, cost, spr_cost


def test_rng_matches_glibc():
    # glibc random() golden sequence for seed 1
    r = GlibcRandom(1)
    assert [r.next() for _ in range(5)] == [
        1804289383, 846930886, 1681692777, 1714636915, 1957747793]
    # seed 0 = identity (stepwise.c:73-75)
    assert list(create_shuffled(5, 0)) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("n_tips,seed", [(8, 42), (13, 7), (20, 12345)])
def test_stepwise_tree_parity(n_tips, seed):
    golden, tree, cost, _ = _stepwise_both(n_tips, 50, seed,
                                           rng_seed=seed)
    assert cost == golden["stepwise_cost"]
    ref_tree = T.parse_newick_string(golden["stepwise_tree"])
    assert canonical_splits(tree) == canonical_splits(ref_tree)


@pytest.mark.parametrize("seed,spr_seed", [(42, 17), (5, 99)])
def test_stepwise_spr_round_parity(seed, spr_seed):
    golden, tree, cost, spr_cost = _stepwise_both(15, 60, seed,
                                                  spr_seed=spr_seed,
                                                  rng_seed=seed)
    assert cost == golden["stepwise_cost"]
    assert spr_cost == golden["spr_cost"]
    ref_tree = T.parse_newick_string(golden["spr_tree"])
    assert canonical_splits(tree) == canonical_splits(ref_tree)


def test_stepwise_extend_invariants():
    """Extend has no oracle hookup; check structural invariants and that
    the cost equals an independent full-tree rescoring."""
    n_old, n_new, sites = 8, 12, 40
    rng = np.random.default_rng(3)
    seqs = random_seqs(n_new, sites, rng)
    labels = [f"t{i}" for i in range(n_new)]

    p_new = pll.Partition(n_new, n_new - 2, 4, sites, 1, 2 * n_new - 3, 1,
                          n_new - 2)
    for i, s in enumerate(seqs):
        p_new.set_tip_states(i, pll.MAP_NT, s)
    fp_new = pll.FastParsimony(p_new)

    # build a starting tree on the first n_old taxa with a parsimony struct
    # that knows only those taxa
    p_old = pll.Partition(n_old, n_old - 2, 4, sites, 1, 2 * n_old - 3, 1,
                          n_old - 2)
    for i in range(n_old):
        p_old.set_tip_states(i, pll.MAP_NT, seqs[i])
    fp_old = pll.FastParsimony(p_old)
    tree, _ = fastparsimony_stepwise([fp_old], labels[:n_old], 11)

    cost = fastparsimony_stepwise_extend(tree, [fp_new], labels[n_old:], 23)

    assert tree.tip_count == n_new
    assert tree.inner_count == n_new - 2
    assert sorted(n.label for n in tree.nodes[:n_new]) == sorted(labels)
    assert T.check_integrity(tree)

    # independent rescoring: fresh Fitch pass over the final topology
    fp2 = pll.FastParsimony(p_new)
    trav = T.traverse(tree.vroot)
    ops = T.create_pars_buildops(trav)
    fp2.update_vectors(ops)
    rescore = fp2.edge_score(tree.vroot.node_index,
                             tree.vroot.back.node_index)
    assert cost == rescore
