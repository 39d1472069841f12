"""Fast (runtime-topology, cache-hitting) SPR search.

Pins the three claims search_fast makes:
  1. every (prune, regraft) score equals the EXACT log-likelihood of the
     post-move topology (the gap-tip remainder identity + SPR branch
     semantics of utree_moves.c:119-254);
  2. a hill-climb's logL trace is monotone and ends at least as high as
     the legacy per-candidate-compile search (legacy_search.ml_spr_round);
  3. every device program compiles exactly ONCE across all rounds and
     topologies (jit cache hits — the whole point of runtime topology).
"""
import jax
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


def _setup(n_tips=7, sites=120, seed=5, scramble_seed=23):
    rng = np.random.default_rng(seed)
    rates = pll.compute_gamma_cats(0.8, 4)
    true_tree = T.parse_newick_string(random_newick(n_tips, rng))
    seqs = simulate(true_tree, sites, rng, rates)
    chars = {lab: (1 << s.astype(np.uint64)) for lab, s in seqs.items()}
    labels = sorted(seqs)
    rng2 = np.random.default_rng(scramble_seed)
    start = T.parse_newick_string(random_newick(n_tips, rng2))
    relabel = dict(zip(sorted(n.label for n in start.nodes[:n_tips]),
                       labels))
    for n in start.nodes[:n_tips]:
        n.label = relabel[n.label]
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=jnp.float64)
    model = engine.make_model([SUBST], [FREQS], rates, dtype=jnp.float64)
    return start, cfg, model, chars


def _exact_logl(tree, cfg, model, chars):
    """Reference evaluation: static-program engine logL of a topology."""
    import dataclasses
    cfg0 = dataclasses.replace(
        cfg, tips=tree.tip_count, clv_buffers=tree.inner_count,
        prob_matrices=2 * tree.tip_count - 3,
        scale_buffers=tree.inner_count)
    program = engine.compile_tree(tree, cfg0)
    raw = np.zeros((tree.tip_count, cfg0.sites_alloc), dtype=np.uint64)
    for n in tree.nodes[:tree.tip_count]:
        raw[n.clv_index] = chars[n.label][:cfg0.sites_alloc]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg0))
    pw = np.zeros(cfg0.sites_padded)
    pw[:cfg0.sites] = 1.0
    inv = jnp.asarray(np.full(cfg0.sites_padded, -1, np.int32))
    bl = jnp.asarray(program.default_branch_lengths, cfg0.dtype)
    return float(engine.loglikelihood(
        program, cfg0, model, bl, tipchars, jnp.asarray(pw, cfg0.dtype),
        inv))


def test_spr_scores_are_exact_postmove_likelihoods():
    start, cfg, model, chars = _setup()
    prog = search_fast.compile_spr(start, cfg)
    cfg_ext = prog.cfg_ext
    tipchars = search_fast._tipchars_for(prog, chars)
    pw, inv = search_fast._aux_arrays(prog)
    bl = jnp.asarray(prog.branch_lengths, cfg_ext.dtype)

    scores, t3s = search_fast._spr_all_scores(
        cfg_ext, model, jnp.asarray(prog.level_ops),
        jnp.asarray(prog.edge_rows), jnp.asarray(prog.pmatrix_slots),
        bl, tipchars, pw, inv,
        jnp.asarray(prog.cand_edge), jnp.asarray(prog.cand_sub_rows),
        jnp.asarray(prog.cand_gap_mask),
        jnp.asarray(prog.cand_edge_valid), newton_iters=0)
    scores = np.asarray(scores)

    # check a spread of valid (candidate, edge) pairs against the static
    # engine's likelihood of the actually-applied move
    checked = 0
    rng = np.random.default_rng(0)
    C, E = scores.shape
    pairs = [(c, e) for c in range(C) for e in range(E)
             if prog.cand_edge_valid[c, e]]
    for c, e in rng.permutation(pairs)[:10]:
        newick = export_newick(prog.tree.vroot, precision=None)
        work = parse_newick_string(newick)
        halves = {h.node_index: h
                  for h in search_fast._half_nodes(work)}
        p = halves[int(prog.cand_prune_node[c])]
        r = halves[int(prog.edge_node[e])]
        moves.spr(p, r)
        new_tree = parse_newick_string(
            export_newick(work.vroot, precision=None))
        want = _exact_logl(new_tree, cfg, model, chars)
        assert abs(scores[c, e] - want) < 1e-6, (c, e, scores[c, e], want)
        checked += 1
    assert checked == 10

    # invalid pairs are masked out
    assert np.all(np.isneginf(scores[~prog.cand_edge_valid]))


def test_hill_climb_monotone_beats_legacy_and_caches():
    start, cfg, model, chars = _setup(n_tips=8, sites=200, seed=17,
                                      scramble_seed=99)
    scores_compiles0 = search_fast._spr_all_scores._cache_size()
    logl_rt0 = search_fast._logl_rt._cache_size()
    smooth0 = search_fast._smooth_rt._cache_size()

    tree, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=10)

    # monotone non-decreasing trace (each round's logL is exact)
    trace = stats["logl_trace"]
    for a, b in zip(trace, trace[1:]):
        assert b >= a - 1e-9, trace
    assert stats["moves"] >= 1

    # runtime topology => one compile per program across all rounds
    # (deltas: other tests in the session share these global jit caches)
    assert (search_fast._spr_all_scores._cache_size()
            - scores_compiles0) == 1
    assert search_fast._logl_rt._cache_size() - logl_rt0 <= 2
    assert search_fast._smooth_rt._cache_size() - smooth0 <= 2

    # at least as good as the legacy (per-topology-compile) search.
    # Drop the executables accumulated by the whole session first: the
    # legacy search compiles hundreds of fresh CPU programs, and XLA:CPU's
    # compiler segfaults (observed deterministically at this point in a
    # full-suite run) when that lands on top of a large in-process
    # compilation cache.
    jax.clear_caches()
    from libpll2_jax import legacy_search as search
    legacy = start
    legacy_logl = None
    for _ in range(10):
        legacy, legacy_logl, improved = search.ml_spr_round(
            legacy, cfg, model, chars)
        if not improved:
            break
    assert logl >= legacy_logl - 1e-6

    # same taxa, valid binary topology
    labels = sorted(chars)
    assert sorted(n.label for n in tree.nodes[:8]) == labels
    assert tree.binary


def test_radius_scores_match_exhaustive():
    """Radius-limited scores must EQUAL the exhaustive scores for every
    pair inside the ball (same math over the bounded recursion), and at a
    radius covering the whole tree the ball must reach exactly the
    exhaustive scorer's valid regraft set."""
    start, cfg, model, chars = _setup(n_tips=10, sites=96, seed=3)
    prog_x = search_fast.compile_spr(start, cfg)
    prog_r = search_fast.compile_spr(start, cfg, radius=16)
    cfg_ext = prog_x.cfg_ext
    tipchars = search_fast._tipchars_for(prog_x, chars)
    pw, inv = search_fast._aux_arrays(prog_x)
    bl = jnp.asarray(prog_x.branch_lengths, cfg_ext.dtype)
    lops = jnp.asarray(prog_x.level_ops)
    pslots = jnp.asarray(prog_x.pmatrix_slots)

    scores_x, t3_x = search_fast._spr_all_scores(
        cfg_ext, model, lops, jnp.asarray(prog_x.edge_rows), pslots,
        bl, tipchars, pw, inv,
        jnp.asarray(prog_x.cand_edge), jnp.asarray(prog_x.cand_sub_rows),
        jnp.asarray(prog_x.cand_gap_mask),
        jnp.asarray(prog_x.cand_edge_valid), newton_iters=3)
    base = search_fast._spr_base_jit(
        cfg_ext, model, jnp.asarray(prog_r.level_ops), pslots, bl,
        tipchars)
    scores_x = np.asarray(scores_x)
    t3_x = np.asarray(t3_x)

    C = scores_x.shape[0]
    seen_by_cand = {c: set() for c in range(C)}
    compared = 0
    for g in prog_r.ball_groups:
        scores_r, t3_r = search_fast._spr_ball_scores(
            cfg_ext, model, *base, bl, pw, inv,
            tuple(jnp.asarray(a) for a in g.ball_levels),
            jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
            jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges),
            ball_slots=prog_r.ball_slots, newton_iters=3)
        scores_r, t3_r = np.asarray(scores_r), np.asarray(t3_r)
        edge_of = g.score_ops[..., search_fast.BOP_EDGE]
        valid = g.score_ops[..., search_fast.BOP_VALID]
        for k in range(len(g.cand_ids)):
            c = int(g.cand_ids[k])
            for b in np.nonzero(valid[k])[0]:
                e = int(edge_of[k, b])
                assert abs(scores_r[k, b] - scores_x[c, e]) \
                    < 1e-8 * max(1.0, abs(scores_x[c, e])), (c, b, e)
                assert abs(t3_r[k, b] - t3_x[c, e]) < 1e-8
                seen_by_cand[c].add(e)
                compared += 1
    for c in range(C):
        want = set(np.nonzero(prog_x.cand_edge_valid[c])[0].tolist())
        assert seen_by_cand[c] == want, (c, seen_by_cand[c] ^ want)
    assert compared > 50


def test_radius_hill_climb_monotone_and_caches():
    start, cfg, model, chars = _setup(n_tips=9, sites=160, seed=29,
                                      scramble_seed=77)
    compiles0 = search_fast._spr_round_device._cache_size()
    tree, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=8, radius=3)
    trace = stats["logl_trace"]
    for a, b in zip(trace, trace[1:]):
        assert b >= a - 1e-9, trace
    assert stats["moves"] >= 1
    # fixed shapes: every round of every topology hits the jit cache
    assert (search_fast._spr_round_device._cache_size() - compiles0) == 1
    # the returned logl is the exact likelihood of the returned tree
    want = _exact_logl(tree, cfg, model, chars)
    assert abs(logl - want) < 1e-6


def test_simulate_alignment_valid_codes():
    """Generator sanity: every simulated tip state is a single-base
    bitmask, labels cover the tips, and short branches preserve state
    more often than long ones (signal exists for search demos)."""
    from libpll2_jax.tree.generate import simulate_alignment
    rng = np.random.default_rng(1)
    short = T.parse_newick_string("((a:0.01,b:0.01):0.01,c:0.01,d:0.01);")
    long = T.parse_newick_string("((a:5.0,b:5.0):5.0,c:5.0,d:5.0);")
    rates = pll.compute_gamma_cats(1.0, 4)
    subst = [1.0, 2.0, 1.0, 1.0, 2.0, 1.0]
    freqs = [0.25] * 4
    out_s = simulate_alignment(short, 2000, rng, subst, freqs, rates)
    out_l = simulate_alignment(long, 2000, rng, subst, freqs, rates)
    assert sorted(out_s) == ["a", "b", "c", "d"]
    for v in out_s.values():
        assert np.isin(v, [1, 2, 4, 8]).all()
    agree_s = float(np.mean(out_s["a"] == out_s["b"]))
    agree_l = float(np.mean(out_l["a"] == out_l["b"]))
    assert agree_s > 0.9 > agree_l
    # saturated branches approach the stationary agreement rate (~0.25)
    assert abs(agree_l - 0.25) < 0.06


def test_adaptive_radius_and_checkpoint(tmp_path):
    """radius_max: a stalled radius-1 climb must widen its radius and
    keep improving (reaching the exhaustive optimum on this small case);
    checkpointing leaves a resumable latest.newick + monotone trace."""
    import json
    start, cfg, model, chars = _setup(n_tips=9, sites=160, seed=29,
                                      scramble_seed=77)
    tree_x, logl_x, _ = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=10)

    tree_r, logl_r, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=20, radius=1, radius_max=8,
        checkpoint_dir=tmp_path)
    assert max(r for r in stats["radius_trace"] if r) > 1
    # same optimum up to batched-smoothing convergence state
    assert logl_r >= logl_x - 1e-3

    lines = [json.loads(x) for x in
             (tmp_path / "search_trace.jsonl").read_text().splitlines()]
    assert len(lines) == stats["rounds"]
    logls = [x["logl"] for x in lines]
    assert all(b >= a - 1e-9 for a, b in zip(logls, logls[1:]))
    resumed = T.parse_newick_string(
        (tmp_path / "latest.newick").read_text())
    assert resumed.tip_count == 9
    # the checkpointed tree prices to the last recorded logL
    assert abs(_exact_logl(resumed, cfg, model, chars) - logls[-1]) < 1e-5
