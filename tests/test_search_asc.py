"""Ascertainment-bias models through the FAST search path.

The reference's search mechanics are orthogonal to partition attributes
(utree_moves.c:119-254 work on any partition); round 4 refused asc-bias
in compile_spr.  These tests pin the round-5 widening:

  1. every (prune, regraft) score under Lewis/Stamatakis asc equals the
     EXACT asc-corrected logL of the post-move topology (scored via the
     sumtable path, checked against the static engine path);
  2. a Lewis-asc hill-climb is monotone and its final logL matches the
     static engine's evaluation of the final topology.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine, search_fast
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.tree import moves, parse_newick_string
from libpll2_jax.tree.utree import export_newick

from .test_parity_tree import random_newick
from .test_search import FREQS, SUBST, simulate

ASC_W = {pll.AB_LEWIS: [1, 1, 1, 1], pll.AB_STAMATAKIS: [2, 1, 1, 3]}


def _setup(asc, n_tips=7, sites=96, seed=5):
    rng = np.random.default_rng(seed)
    rates = pll.compute_gamma_cats(0.8, 4)
    true_tree = T.parse_newick_string(random_newick(n_tips, rng))
    seqs = simulate(true_tree, sites, rng, rates)
    chars = {lab: (1 << s.astype(np.uint64)) for lab, s in seqs.items()}
    start = T.parse_newick_string(random_newick(
        n_tips, np.random.default_rng(23)))
    relabel = dict(zip(sorted(n.label for n in start.nodes[:n_tips]),
                       sorted(seqs)))
    for n in start.nodes[:n_tips]:
        n.label = relabel[n.label]
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=jnp.float64,
        asc_bias=asc, asc_bias_flag=True)
    model = engine.make_model([SUBST], [FREQS], rates, dtype=jnp.float64)
    return start, cfg, model, chars


def _pw_inv(cfg):
    pw = np.zeros(cfg.sites_padded)
    pw[:cfg.sites] = 1.0
    pw[cfg.sites:cfg.sites + cfg.states] = ASC_W[cfg.asc_bias]
    inv = np.full(cfg.sites_padded, -1, np.int32)
    return pw, inv


def _exact_logl(tree, cfg, model, chars):
    """Static-engine asc-corrected logL of a topology (default lengths)."""
    cfg0 = dataclasses.replace(
        cfg, tips=tree.tip_count, clv_buffers=tree.inner_count,
        prob_matrices=2 * tree.tip_count - 3,
        scale_buffers=tree.inner_count)
    program = engine.compile_tree(tree, cfg0)
    raw = np.zeros((tree.tip_count, cfg0.sites_alloc), dtype=np.uint64)
    for n in tree.nodes[:tree.tip_count]:
        seq = chars[n.label]
        raw[n.clv_index, :len(seq)] = seq[:cfg0.sites_alloc]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg0))
    pw, inv = _pw_inv(cfg0)
    bl = jnp.asarray(program.default_branch_lengths, cfg0.dtype)
    return float(engine.loglikelihood(
        program, cfg0, model, bl, tipchars, jnp.asarray(pw, cfg0.dtype),
        jnp.asarray(inv)))


def _scores_exact(asc):
    start, cfg, model, chars = _setup(asc)
    prog = search_fast.compile_spr(start, cfg)
    cfg_ext = prog.cfg_ext
    tipchars = search_fast._tipchars_for(prog, chars)
    pw, inv = _pw_inv(cfg_ext)
    pw_d = jnp.asarray(pw, cfg_ext.dtype)
    inv_d = jnp.asarray(inv)
    bl = jnp.asarray(prog.branch_lengths, cfg_ext.dtype)

    scores, _ = search_fast._spr_all_scores(
        cfg_ext, model, jnp.asarray(prog.level_ops),
        jnp.asarray(prog.edge_rows), jnp.asarray(prog.pmatrix_slots),
        bl, tipchars, pw_d, inv_d,
        jnp.asarray(prog.cand_edge), jnp.asarray(prog.cand_sub_rows),
        jnp.asarray(prog.cand_gap_mask),
        jnp.asarray(prog.cand_edge_valid), newton_iters=0)
    scores = np.asarray(scores)

    rng = np.random.default_rng(0)
    C, E = scores.shape
    pairs = [(c, e) for c in range(C) for e in range(E)
             if prog.cand_edge_valid[c, e]]
    for c, e in rng.permutation(pairs)[:6]:
        work = parse_newick_string(
            export_newick(prog.tree.vroot, precision=None))
        halves = {h.node_index: h for h in search_fast._half_nodes(work)}
        moves.spr(halves[int(prog.cand_prune_node[c])],
                  halves[int(prog.edge_node[e])])
        new_tree = parse_newick_string(
            export_newick(work.vroot, precision=None))
        want = _exact_logl(new_tree, cfg, model, chars)
        assert abs(scores[c, e] - want) < 1e-6, (c, e, scores[c, e], want)


def test_lewis_spr_scores_exact():
    _scores_exact(pll.AB_LEWIS)


def test_stamatakis_spr_scores_exact():
    _scores_exact(pll.AB_STAMATAKIS)


def test_lewis_hill_climb_monotone_and_exact():
    start, cfg, model, chars = _setup(pll.AB_LEWIS, n_tips=8, sites=150)
    pw, inv = _pw_inv(dataclasses.replace(cfg))
    # cfg_ext shares sites_padded with cfg for the same site count
    tree, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=8, radius=3,
        pattern_weights=pw, invariant=inv)
    tr = stats["logl_trace"]
    assert all(b >= a - 1e-9 for a, b in zip(tr, tr[1:])), tr
    assert stats["moves"] >= 1
    # final hill_climb logL must match a fresh evaluation of the final
    # topology AT the final branch lengths under the same asc weights
    prog = search_fast.compile_spr(
        T.parse_newick_string(export_newick(tree.vroot, precision=None)),
        cfg)
    tipchars = search_fast._tipchars_for(prog, chars)
    pslots = jnp.asarray(prog.pmatrix_slots)
    want = float(search_fast._logl_rt(
        prog.cfg_ext, model, jnp.asarray(prog.level_ops), pslots,
        jnp.asarray(prog.branch_lengths, prog.cfg_ext.dtype), tipchars,
        jnp.asarray(pw, prog.cfg_ext.dtype), jnp.asarray(inv),
        jnp.asarray(prog.edge_rows)[prog.root_edge],
        pslots[prog.root_edge]))
    assert abs(logl - want) < 1e-6, (logl, want)
