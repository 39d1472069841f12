"""Batched SPR/placement scoring: engine.score_placements on the
remainder tree must reproduce, edge for edge, the full-tree logL obtained
by actually performing the SPR (moves.spr keeps pll_utree_spr semantics:
regraft edge halves, subtree keeps its branch)."""
import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.tree import moves
from libpll2_jax.tree.utree import (reset_template_indices,
                                    traverse_subtree, wrap_tree)

from .test_parity_tree import random_newick, random_seqs

N_TIPS, SITES, SEED = 10, 160, 4


def make_cfg(tree, sites=SITES):
    return PartitionConfig(
        tips=tree.tip_count, clv_buffers=tree.inner_count, states=4,
        sites=sites, rate_matrices=1,
        prob_matrices=2 * tree.tip_count - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float64)


def make_model():
    return engine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(0.8, 4), dtype=jnp.float64)


def tip_labels_behind(h):
    return frozenset(n.label for n in traverse_subtree(h) if n.next is None)


def engine_logl(tree, seq_by_label, model):
    cfg = make_cfg(tree)
    program = engine.compile_tree(tree, cfg)
    raw = np.zeros((tree.tip_count, cfg.sites_alloc), dtype=np.uint64)
    for n in tree.nodes[:tree.tip_count]:
        raw[n.clv_index] = seq_by_label[n.label]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
    pw = np.zeros(cfg.sites_padded)
    pw[:SITES] = 1.0
    inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
    bl = jnp.asarray(program.default_branch_lengths, jnp.float64)
    return float(engine.loglikelihood(
        program, cfg, model, bl, tipchars, jnp.asarray(pw, jnp.float64),
        inv))


def test_score_placements_matches_actual_spr():
    rng = np.random.default_rng(SEED)
    newick = random_newick(N_TIPS, rng)
    seqs = random_seqs(N_TIPS, SITES, rng)
    model = make_model()

    tree0 = T.parse_newick_string(newick)
    seq_by_label = {}
    for n in tree0.nodes[:N_TIPS]:
        enc = pll.MAP_NT[np.frombuffer(seqs[n.clv_index].encode(), np.uint8)]
        seq_by_label[n.label] = enc.astype(np.uint64)

    # pick a prune point p (inner half-node) with a 2-4 tip subtree behind
    # p->back
    p = None
    for n in tree0.nodes[N_TIPS:]:
        for h in n.roundabout():
            k = len(tip_labels_behind(h.back))
            if 2 <= k <= 4:
                p = h
                break
        if p is not None:
            break
    assert p is not None
    pruned_tips = tip_labels_behind(p.back)
    sub_t3 = p.length

    # pruned-subtree CLV directed at the cut, via the partition API
    cfg0 = make_cfg(tree0)
    part = pll.Partition(N_TIPS, tree0.inner_count, 4, SITES, 1,
                         2 * N_TIPS - 3, 4, tree0.inner_count)
    part.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    part.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    part.set_gamma_rates(0.8)
    for n in tree0.nodes[:N_TIPS]:
        part.set_tip_states(n.clv_index, pll.MAP_NT,
                            seqs[n.clv_index])
    trav_all = T.traverse(tree0.vroot)
    _, branches, pmat_idx = T.create_operations(trav_all)
    part.update_prob_matrices([0] * 4, pmat_idx, branches)
    sub_trav = traverse_subtree(p.back)
    if p.back.next is None:
        sub_clv = part.clv[p.back.clv_index]
        sub_scaler = jnp.zeros(cfg0.sites_padded, jnp.int32)
    else:
        sub_ops, _, _ = T.create_operations(sub_trav)
        part.update_partials(sub_ops)
        sub_clv = part.clv[p.back.clv_index]
        sub_scaler = part.scalers[p.back.scaler_index]

    # remainder tree: fresh parse, prune at the same p (node_index match)
    tree_r = T.parse_newick_string(newick)
    p_r = next(h for n in tree_r.nodes for h in
               ([n] if n.next is None else list(n.roundabout()))
               if h.node_index == p.node_index)
    u = moves.prune_subtree(p_r)
    root_r = u if u.next is not None else u.back
    reset_template_indices(root_r, N_TIPS - len(pruned_tips))
    rtree = wrap_tree(root_r)
    cfg_r = make_cfg(rtree)
    full_r = engine.compile_tree_full(rtree, cfg_r)

    raw_r = np.zeros((rtree.tip_count, cfg_r.sites_alloc), dtype=np.uint64)
    for n in rtree.nodes[:rtree.tip_count]:
        raw_r[n.clv_index] = seq_by_label[n.label]
    tip_r = jnp.asarray(engine.pad_tipchars(raw_r, cfg_r))
    pw = np.zeros(cfg_r.sites_padded)
    pw[:SITES] = 1.0
    inv = jnp.asarray(np.full(cfg_r.sites_padded, -1, np.int32))
    bl_r = jnp.asarray(full_r.default_branch_lengths, jnp.float64)

    scores = np.asarray(engine.score_placements(
        full_r, cfg_r, model, bl_r, tip_r, jnp.asarray(pw, jnp.float64),
        inv, jnp.asarray(sub_clv), jnp.asarray(sub_scaler),
        jnp.float64(sub_t3)))

    # edge position -> a half-node of the remainder tree (compile_tree_full
    # branch order = create_operations order)
    by_pmatrix = {}
    for n in rtree.nodes:
        for g in ([n] if n.next is None else list(n.roundabout())):
            by_pmatrix.setdefault(g.back.pmatrix_index, g)

    checked = 0
    for i, pm in enumerate(full_r.pmatrix_indices):
        g = by_pmatrix[int(pm)]
        sig = tip_labels_behind(g)
        # locate the matching half-node in a FRESH original tree
        tree3 = T.parse_newick_string(newick)
        cands = [h for n in tree3.nodes for h in
                 ([n] if n.next is None else list(n.roundabout()))
                 if tip_labels_behind(h) == sig
                 and not (tip_labels_behind(h.back) & sig)]
        assert cands, sig
        r3 = cands[0]
        p3 = next(h for n in tree3.nodes for h in
                  ([n] if n.next is None else list(n.roundabout()))
                  if h.node_index == p.node_index)
        try:
            moves.spr(p3, r3)
        except ValueError:
            # the merged edge: regrafting reproduces the original topology;
            # emulate the SPR lengths (both halves = merged/2) directly
            a, b = p3.next.back, p3.next.next.back
            half = (a.length + b.length) / 2
            p3.next.length = p3.next.back.length = half
            p3.next.next.length = p3.next.next.back.length = half
        logl_spr = engine_logl(tree3, seq_by_label, model)
        np.testing.assert_allclose(scores[i], logl_spr, rtol=1e-10)
        checked += 1
    assert checked == len(full_r.pmatrix_indices)
