"""Multi-partition models through the FAST search path (round-5 widening;
reference clients drive one pll_partition_t per gene over one shared
topology — SURVEY.md §2.6, RAxML-NG `--brlen unlinked` semantics).

Pins:
  * a 2-partition hill-climb (different site counts and models) has a
    monotone summed-logL trace and applies moves;
  * the final total equals the sum of independent static-engine
    evaluations of the final topology at each partition's own lengths;
  * searching the concatenation is consistent: the 2-partition search's
    final topology scores at least as high (summed) as the start.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine, search_fast
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.tree.utree import export_newick

from .test_parity_tree import random_newick
from .test_search import FREQS, SUBST, simulate

SUBST2 = [0.8, 1.9, 1.2, 0.9, 2.4, 1.0]
FREQS2 = [0.21, 0.27, 0.31, 0.21]


def _setup(n_tips=8, sites=(120, 72), seed=5):
    rng = np.random.default_rng(seed)
    rates = pll.compute_gamma_cats(0.8, 4)
    true_tree = T.parse_newick_string(random_newick(n_tips, rng))
    chars_list = []
    for s in sites:
        seqs = simulate(true_tree, s, rng, rates)
        chars_list.append({lab: (1 << q.astype(np.uint64))
                           for lab, q in seqs.items()})
    start = T.parse_newick_string(random_newick(
        n_tips, np.random.default_rng(31)))
    relabel = dict(zip(sorted(n.label for n in start.nodes[:n_tips]),
                       sorted(chars_list[0])))
    for n in start.nodes[:n_tips]:
        n.label = relabel[n.label]
    cfgs, models = [], []
    for s, (sub, fr) in zip(sites, ((SUBST, FREQS), (SUBST2, FREQS2))):
        cfgs.append(PartitionConfig(
            tips=n_tips, clv_buffers=start.inner_count, states=4, sites=s,
            rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
            scale_buffers=start.inner_count, dtype=jnp.float64))
        models.append(engine.make_model([sub], [fr], rates,
                                        dtype=jnp.float64))
    return start, cfgs, models, chars_list


def _engine_logl(tree, branch_lengths_by_pm, cfg, model, chars):
    """Independent static-engine evaluation at given per-edge lengths."""
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
    bl = jnp.asarray(branch_lengths_by_pm, cfg0.dtype)
    return float(engine.loglikelihood(
        program, cfg0, model, bl, tipchars, jnp.asarray(pw, cfg0.dtype),
        inv))


def test_two_partition_hill_climb():
    start, cfgs, models, chars_list = _setup()

    tree, total, stats = search_fast.hill_climb_multi(
        start, cfgs, models, chars_list, max_rounds=8, radius=3)

    tr = stats["logl_trace"]
    assert all(b >= a - 1e-9 for a, b in zip(tr, tr[1:])), tr
    assert stats["moves"] >= 1

    # the summed total must equal independent static-engine evaluations
    # of each partition's (topology, own branch lengths)
    check = 0.0
    for k, prog in enumerate(stats["programs"]):
        t = T.parse_newick_string(
            export_newick(prog.tree.vroot, precision=None))
        # program branch lengths are ordered by pmatrix slot list; the
        # static engine orders by its own template — evaluate via the
        # tree's branch lengths, which smooth_branches keeps in sync
        ptree = engine.compile_tree(t, dataclasses.replace(
            cfgs[k], tips=t.tip_count, clv_buffers=t.inner_count,
            prob_matrices=2 * t.tip_count - 3,
            scale_buffers=t.inner_count))
        check += _engine_logl(t, ptree.default_branch_lengths, cfgs[k],
                              models[k], chars_list[k])
    assert abs(total - check) < 1e-6, (total, check)

    # partitions keep their OWN lengths (unlinked): they must differ
    bl0 = stats["programs"][0].branch_lengths
    bl1 = stats["programs"][1].branch_lengths
    assert not np.allclose(bl0, bl1)
