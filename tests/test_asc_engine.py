"""Ascertainment-bias corrections on the BATCHED engine paths.

The single-edge asc machinery is oracle-checked in test_asc_bias.py; these
tests pin the batched paths the reference has no analog for:

  * engine.loglikelihood / branch_derivatives vs the reference oracle at
    the root edge, for all three corrections, on a shallow tree AND a deep
    caterpillar where the 2^-256 scaling protocol fires on the phantom
    columns (exercising the asc_scalers fold of update_sumtable,
    core_derivatives.c:884-892);
  * branch_derivatives vs central finite differences of the engine logL on
    EVERY edge (the oracle can only price one rooting per traversal);
  * optimize_branch_lengths reaching stationarity of the asc-corrected
    -lnL;
  * score_placements reconstructing a known tree's asc logL when a pruned
    tip is regrafted onto the edge it came from.

Reference: likelihood.c:24-120 (corrections), core_derivatives.c:851-924
(derivative corrections).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.tree import moves
from libpll2_jax.tree.utree import (reset_template_indices,
                                    traverse_subtree, wrap_tree)

from .oracle import run_oracle
from .test_parity_tree import random_newick, random_seqs

ATTRIB = {"lewis": 1 << 5, "felsenstein": 2 << 5, "stamatakis": 3 << 5}
AB = {"lewis": pll.AB_LEWIS, "felsenstein": pll.AB_FELSENSTEIN,
      "stamatakis": pll.AB_STAMATAKIS}
MODES = ["lewis", "felsenstein", "stamatakis"]

FREQS = [0.3, 0.25, 0.2, 0.25]
SUBST = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0]
ALPHA = 0.8
ASC_W = {"lewis": [1, 1, 1, 1], "felsenstein": [2, 1, 1, 3],
         "stamatakis": [2, 1, 1, 3]}


def deep_newick(n_tips, bl):
    """Caterpillar with long (near-saturating) branches: under saturation a
    phantom column's CLV decays ~ pi_s per level, so the 2^-256 rescue
    fires on the PHANTOM sites too (the asc_scalers fold is then live)."""
    labels = [f"t{i}" for i in range(n_tips)]
    s = f"{labels[0]}:{bl}"
    for lab in labels[1:-2]:
        s = f"({lab}:{bl},{s}):{bl}"
    return f"({labels[-2]}:{bl},{labels[-1]}:{bl},{s});"


def build(mode, n_tips, sites, rng, deep=False):
    alpha = 99.0 if deep else ALPHA   # deep: all rates ~1 => all saturate
    newick = deep_newick(n_tips, 4.0) if deep \
        else random_newick(n_tips, rng)
    seqs = random_seqs(n_tips, sites, rng)
    tree = T.parse_newick_string(newick)
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float64,
        asc_bias=AB[mode], asc_bias_flag=True)
    model = engine.make_model([SUBST], [FREQS],
                              pll.compute_gamma_cats(alpha, 4),
                              dtype=jnp.float64)
    raw = np.zeros((n_tips, cfg.sites), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    pw[sites:sites + 4] = ASC_W[mode]
    inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
    return newick, seqs, tree, cfg, model, tipchars, \
        jnp.asarray(pw, jnp.float64), inv


def oracle_root_edge(mode, newick, seqs, sites, at_lengths, alpha=ALPHA):
    """Oracle logL + (d1, d2) at the vroot edge of `newick`."""
    tree = T.parse_newick_string(newick)
    tips = tree.tip_count
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    root = tree.vroot
    lines = [
        f"create {tips} {tree.inner_count} 4 {sites} 1 "
        f"{2 * tips - 3} 4 {tree.inner_count} {ATTRIB[mode]}",
        "map nt",
        f"asc_bias {mode}",
        "asc_weights " + " ".join(str(w) for w in ASC_W[mode]),
        "freqs 0 " + " ".join(map(str, FREQS)),
        "subst 0 " + " ".join(map(str, SUBST)),
        f"gamma {alpha} 4 mean",
    ]
    for i, s in enumerate(seqs):
        lines.append(f"tip {i} {s}")
    lines.append(f"pmatrices {len(branches)} 0 0 0 0")
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
    for t in at_lengths:
        lines.append(f"derivatives {t}")
    return run_oracle("\n".join(lines) + "\n")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("deep", [False, True])
def test_asc_engine_logl_and_root_derivatives(mode, deep):
    rng = np.random.default_rng(11)
    n_tips, sites = (160, 23) if deep else (12, 57)
    newick, seqs, tree, cfg, model, tipchars, pw, inv = build(
        mode, n_tips, sites, rng, deep=deep)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    bl = jnp.asarray(program.default_branch_lengths, jnp.float64)
    root_pos = int(np.nonzero(
        full.pmatrix_indices == program.root_pmatrix)[0][0])

    golden = oracle_root_edge(mode, newick, seqs, sites,
                              [float(bl[root_pos])],
                              alpha=99.0 if deep else ALPHA)

    logl = float(engine.loglikelihood(program, cfg, model, bl, tipchars,
                                      pw, inv))
    np.testing.assert_allclose(logl, golden["edge_logl"][0], rtol=1e-9)

    if deep:
        # the deep case only means something if phantom columns scaled
        view, _ = engine._sweep(program, cfg, model, bl, tipchars, pw)
        ph = np.asarray(view.scaler_row(program.root_scaler))[
            cfg.sites:cfg.sites + 4]
        assert np.all(ph > 0), ph

    d1, d2 = engine.branch_derivatives(full, cfg, model, bl, tipchars,
                                       pw, inv)
    # 1e-7: Lewis divides by (L0 - 1), amplifying eigensolver rounding
    np.testing.assert_allclose(
        [float(d1[root_pos]), float(d2[root_pos])],
        golden["derivatives"][0][1:], rtol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_asc_branch_derivatives_all_edges_fd(mode):
    rng = np.random.default_rng(5)
    n_tips, sites = 10, 83
    newick, seqs, tree, cfg, model, tipchars, pw, inv = build(
        mode, n_tips, sites, rng)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    bl = jnp.asarray(full.default_branch_lengths, jnp.float64)

    d1, _ = engine.branch_derivatives(full, cfg, model, bl, tipchars,
                                      pw, inv)
    h = 1e-6
    for e in range(len(np.asarray(bl))):
        lp = float(engine.loglikelihood(
            program, cfg, model, bl.at[e].add(h), tipchars, pw, inv))
        lm = float(engine.loglikelihood(
            program, cfg, model, bl.at[e].add(-h), tipchars, pw, inv))
        fd = -(lp - lm) / (2 * h)            # d(-lnL)/dt
        np.testing.assert_allclose(float(d1[e]), fd, rtol=2e-5, atol=1e-7,
                                    err_msg=f"edge {e}")


@pytest.mark.parametrize("mode", ["lewis", "stamatakis"])
def test_asc_optimize_branch_lengths(mode):
    rng = np.random.default_rng(9)
    n_tips, sites = 10, 83
    newick, seqs, tree, cfg, model, tipchars, pw, inv = build(
        mode, n_tips, sites, rng)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    bl0 = jnp.asarray(full.default_branch_lengths, jnp.float64) * 2.5 + 0.03
    logl0 = float(engine.loglikelihood(program, cfg, model, bl0, tipchars,
                                       pw, inv))
    new_bl, logl1 = engine.optimize_branch_lengths(
        full, cfg, model, bl0, tipchars, pw, inv, rounds=64,
        newton_iters=20)
    assert float(logl1) > logl0, (logl0, float(logl1))
    # near-stationarity: the asc-corrected surface couples branches, so the
    # Jacobi smoothing converges more slowly than the plain-lnL case —
    # derivative PARITY is pinned by the oracle/FD tests above, this is a
    # convergence smoke test
    d1, d2 = engine.branch_derivatives(full, cfg, model, new_bl, tipchars,
                                       pw, inv)
    d1, d2 = np.asarray(d1), np.asarray(d2)
    interior = (np.asarray(new_bl) > 2e-8) & (np.asarray(new_bl) < 99.0)
    assert np.all(np.abs(d1[interior]) / (np.abs(d2[interior]) + 1.0)
                  < 1e-2), d1[interior]


@pytest.mark.parametrize("mode", MODES)
def test_asc_score_placements_roundtrip(mode):
    """Regrafting a pruned tip onto the edge it came from must reproduce
    the asc-corrected logL of the tree whose two attachment half-edges are
    set to half the merged length (SPR split semantics)."""
    rng = np.random.default_rng(21)
    n_tips, sites = 9, 61
    newick, seqs, tree, cfg, model, tipchars, pw, inv = build(
        mode, n_tips, sites, rng)

    # prune tip 0: p = the inner half-node whose back is tip 0
    tip0 = next(n for n in tree.nodes if n.next is None and n.clv_index == 0)
    p = tip0.back
    sub_len = float(p.length)
    # the two other neighbors of p's node, before pruning
    a, b = p.next.back, p.next.next.back
    la, lb = float(p.next.length), float(p.next.next.length)
    sig_a = frozenset(
        x.label for x in traverse_subtree(a) if x.next is None)
    seq_by_label = {n.label: seqs[n.clv_index]
                    for n in tree.nodes[:n_tips]}

    u = moves.prune_subtree(p)
    root_r = u if u.next is not None else u.back
    reset_template_indices(root_r, n_tips - 1)
    rtree = wrap_tree(root_r)
    cfg_r = dataclasses.replace(
        cfg, tips=n_tips - 1, clv_buffers=rtree.inner_count,
        prob_matrices=2 * (n_tips - 1) - 3, scale_buffers=rtree.inner_count)
    full_r = engine.compile_tree_full(rtree, cfg_r)

    raw_r = np.zeros((n_tips - 1, cfg_r.sites), dtype=np.uint64)
    for n in rtree.nodes[:n_tips - 1]:
        raw_r[n.clv_index] = pll.MAP_NT[np.frombuffer(
            seq_by_label[n.label].encode(), np.uint8)]
    tip_r = jnp.asarray(engine.pad_tipchars(raw_r, cfg_r))
    bl_r = jnp.asarray(full_r.default_branch_lengths, jnp.float64)

    sub_clv = engine.expand_tipchars(
        jnp.asarray(engine.pad_tipchars(
            np.asarray([pll.MAP_NT[np.frombuffer(
                seq_by_label["t0"].encode(), np.uint8)]], np.uint64),
            dataclasses.replace(cfg, tips=1))), 4, jnp.float64)[0]
    sub_clv = jnp.broadcast_to(sub_clv[None], (4,) + sub_clv.shape)
    sub_scaler = jnp.zeros(cfg.sites_padded, jnp.int32)

    scores = np.asarray(engine.score_placements(
        full_r, cfg_r, model, bl_r, tip_r, pw, inv,
        sub_clv, sub_scaler, jnp.float64(sub_len)))

    # the merged edge in the remainder: endpoints a and b, length la+lb
    by_pmatrix = {}
    for n in rtree.nodes:
        for g in ([n] if n.next is None else list(n.roundabout())):
            by_pmatrix.setdefault(int(g.back.pmatrix_index), g)
    merged_pos = None
    for i, pm in enumerate(full_r.pmatrix_indices):
        g = by_pmatrix[int(pm)]
        sig = frozenset(
            x.label for x in traverse_subtree(g) if x.next is None)
        if sig in (sig_a, frozenset(seq_by_label) - {"t0"} - sig_a):
            if abs(float(g.length) - (la + lb)) < 1e-12:
                merged_pos = i
                break
    assert merged_pos is not None

    # reference value: original tree with the attachment edges halved
    tree2 = T.parse_newick_string(newick)
    tip0_2 = next(n for n in tree2.nodes
                  if n.next is None and n.clv_index == 0)
    p2 = tip0_2.back
    half = (la + lb) / 2
    p2.next.length = p2.next.back.length = half
    p2.next.next.length = p2.next.next.back.length = half
    program2 = engine.compile_tree(tree2, cfg)
    bl2 = jnp.asarray(program2.default_branch_lengths, jnp.float64)
    logl2 = float(engine.loglikelihood(program2, cfg, model, bl2,
                                       tipchars, pw, inv))
    np.testing.assert_allclose(scores[merged_pos], logl2, rtol=1e-10)
