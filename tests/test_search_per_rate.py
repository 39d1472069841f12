"""Per-rate scalers through the FAST search path (round-5 widening; the
last partition attribute the search refused).

Setup uses a deep caterpillar with near-saturating branches and a high
rate spread so the per-rate 2^-256 rescue actually FIRES with different
counts per rate category (otherwise per-rate degenerates to per-site and
the test proves nothing); asserted explicitly.

Pins: every (prune, regraft) score under per-rate scaling equals the
EXACT engine logL of the post-move topology, on both the exhaustive and
the radius-limited scorer; a hill-climb stays monotone.
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

from .test_parity_tree import random_seqs

FREQS = [0.3, 0.25, 0.2, 0.25]
SUBST = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0]


def deep_newick(n_tips, bl):
    labels = [f"t{i}" for i in range(n_tips)]
    s = f"{labels[0]}:{bl}"
    for lab in labels[1:-2]:
        s = f"({lab}:{bl},{s}):{bl}"
    return f"({labels[-2]}:{bl},{labels[-1]}:{bl},{s});"


def _setup(n_tips=28, sites=64, seed=3, bl=8.0, alpha=0.1):
    rng = np.random.default_rng(seed)
    seqs = random_seqs(n_tips, sites, rng)
    chars = {f"t{i}": pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
             for i, s in enumerate(seqs)}
    start = T.parse_newick_string(deep_newick(n_tips, bl))
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=jnp.float64,
        per_rate_scalers=True)
    model = engine.make_model([SUBST], [FREQS],
                              pll.compute_gamma_cats(alpha, 4),
                              dtype=jnp.float64)
    return start, cfg, model, chars


def _exact_logl(tree, cfg, model, chars):
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
    pw = np.zeros(cfg0.sites_padded)
    pw[:cfg0.sites] = 1.0
    inv = jnp.asarray(np.full(cfg0.sites_padded, -1, np.int32))
    bl = jnp.asarray(program.default_branch_lengths, cfg0.dtype)
    return float(engine.loglikelihood(
        program, cfg0, model, bl, tipchars, jnp.asarray(pw, cfg0.dtype),
        inv))


def _assert_per_rate_fires(prog, cfg, model, chars):
    tipchars = search_fast._tipchars_for(prog, chars)
    bl = jnp.asarray(prog.branch_lengths, prog.cfg_ext.dtype)
    _clv, scal, _pm = search_fast._sweep_rt(
        prog.cfg_ext, model, jnp.asarray(prog.level_ops),
        jnp.asarray(prog.pmatrix_slots), bl, tipchars)
    s = np.asarray(scal)
    assert s.ndim == 3 and s.max() > 0
    # per-rate counters genuinely differ across rates somewhere
    assert (s.max(axis=1) != s.min(axis=1)).any()


def test_per_rate_spr_scores_exact_exhaustive():
    start, cfg, model, chars = _setup()
    prog = search_fast.compile_spr(start, cfg)
    _assert_per_rate_fires(prog, cfg, model, chars)
    cfg_ext = prog.cfg_ext
    tipchars = search_fast._tipchars_for(prog, chars)
    pw, inv = search_fast._aux_arrays(prog)
    bl = jnp.asarray(prog.branch_lengths, cfg_ext.dtype)
    scores, _ = search_fast._spr_all_scores(
        cfg_ext, model, jnp.asarray(prog.level_ops),
        jnp.asarray(prog.edge_rows), jnp.asarray(prog.pmatrix_slots),
        bl, tipchars, pw, inv,
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


def test_per_rate_radius_scores_match_exhaustive():
    start, cfg, model, chars = _setup()
    prog_r = search_fast.compile_spr(start, cfg, radius=3)
    prog_f = search_fast.compile_spr(start, cfg)
    cfg_ext = prog_f.cfg_ext
    tipchars = search_fast._tipchars_for(prog_f, chars)
    pw, inv = search_fast._aux_arrays(prog_f)
    bl = jnp.asarray(prog_f.branch_lengths, cfg_ext.dtype)
    full, _ = search_fast._spr_all_scores(
        cfg_ext, model, jnp.asarray(prog_f.level_ops),
        jnp.asarray(prog_f.edge_rows), jnp.asarray(prog_f.pmatrix_slots),
        bl, tipchars, pw, inv,
        jnp.asarray(prog_f.cand_edge), jnp.asarray(prog_f.cand_sub_rows),
        jnp.asarray(prog_f.cand_gap_mask),
        jnp.asarray(prog_f.cand_edge_valid), newton_iters=2)
    full = np.asarray(full)

    logl0_d, outs = search_fast._spr_round_device(
        cfg_ext, model, jnp.asarray(prog_r.level_ops),
        jnp.asarray(prog_r.pmatrix_slots), bl, tipchars, pw, inv,
        jnp.asarray(prog_r.edge_rows)[prog_r.root_edge],
        jnp.asarray(prog_r.pmatrix_slots)[prog_r.root_edge],
        tuple((tuple(jnp.asarray(a) for a in g.ball_levels),
               jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
               jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges))
              for g in prog_r.ball_groups),
        ball_slots=prog_r.ball_slots, newton_iters=2)
    checked = 0
    for g, (s, _t3) in zip(prog_r.ball_groups, outs):
        s = np.asarray(s)
        vmask = g.score_ops[..., search_fast.BOP_VALID] == 1
        rows, cols = np.nonzero(vmask)
        for r, cc in zip(rows, cols):
            c = int(g.cand_ids[r])
            e = int(g.score_ops[r, cc, search_fast.BOP_EDGE])
            np.testing.assert_allclose(s[r, cc], full[c, e], rtol=1e-9)
            checked += 1
    assert checked > 20


def test_per_rate_hill_climb_monotone():
    start, cfg, model, chars = _setup(n_tips=20, sites=80)
    tree, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=6, radius=3)
    tr = stats["logl_trace"]
    assert all(b >= a - 1e-9 for a, b in zip(tr, tr[1:])), tr
    assert np.isfinite(logl)
