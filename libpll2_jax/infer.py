"""One-call maximum-likelihood tree inference — the full user journey.

The reference library is a toolkit; its clients (RAxML-NG, ModelTest-NG)
assemble the actual workflow: read an alignment, compress site patterns,
build a randomized stepwise-addition parsimony starting tree, then
alternate SPR topology search with model-parameter optimization
(stepwise.c:883-1082 for the start; search + Brent/L-BFGS model fitting
client-side).  Here the whole journey is one framework call:

    result = infer_ml_tree(sequences)            # dict label -> str
    result.tree, result.logl, result.alpha, ...

Pipeline (every numeric stage runs on the default JAX device):
  1. encode + compress site patterns (io/compress.py; exact weighted logL)
  2. stepwise-addition parsimony start (parsimony/stepwise.py, pinned to
     the host CPU backend — tiny popcount dispatches are bound by
     per-dispatch latency on an accelerator)
  3. a few SPR rounds on the starting model (empirical frequencies,
     unit GTR rates, gamma alpha0)
  4. gradient model fit (fit.py — Adam through the differentiable
     likelihood, incl. the gamma shape)
  5. SPR hill-climb to convergence under the fitted model, batched
     Newton branch smoothing between rounds (search_fast.py)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np

from . import engine, fit, search_fast
from .config import PartitionConfig
from .constants import MAPS
from .io import MSA, compress_site_patterns
from .models.gamma import compute_gamma_cats
from .tree import parse_newick_string
from .tree.utree import UTree, export_newick


@dataclasses.dataclass
class InferenceResult:
    tree: UTree                  # final topology with branch lengths
    logl: float                  # exact logL at the fitted model
    subst_params: np.ndarray     # fitted GTR exchangeabilities
    frequencies: np.ndarray      # fitted base frequencies
    alpha: float                 # fitted gamma shape
    newick: str
    stats: dict                  # phase timings, logl traces, parsimony cost


def _encode(sequences, states: int):
    if isinstance(sequences, MSA):
        labels, seqs = list(sequences.labels), list(sequences.sequences)
    else:
        labels = sorted(sequences)
        seqs = [sequences[lab] for lab in labels]
    charmap = {4: MAPS["nt"], 20: MAPS["aa"], 2: MAPS["bin"],
               10: MAPS["gt10"], 16: MAPS["gt16"]}.get(states)
    if charmap is None:
        raise ValueError(f"no built-in character map for {states} states")
    return labels, seqs, charmap


def _empirical_frequencies(chars: Dict[str, np.ndarray], weights,
                           states: int) -> np.ndarray:
    """Weighted single-state counts (ambiguity codes skipped), uniform
    prior of one pseudo-count per state."""
    counts = np.ones(states, dtype=np.float64)
    for codes in chars.values():
        single = (codes & (codes - 1)) == 0       # one bit set
        state = np.where(single, np.round(np.log2(
            np.maximum(codes, 1)).astype(np.float64)), -1).astype(np.int64)
        for s in range(states):
            counts[s] += float(np.sum(weights[: len(codes)]
                                      * (state == s)))
    return counts / counts.sum()


def infer_ml_tree(sequences: Union[Dict[str, str], MSA], *,
                  states: int = 4, rate_cats: int = 4, alpha0: float = 1.0,
                  radius: int = 5, max_rounds: int = 30,
                  warmup_rounds: int = 4, fit_steps: int = 150,
                  fit_lr: float = 0.05, fit_alpha: bool = True,
                  seed: int = 42, dtype=None, compress: bool = True,
                  smooth_every: int = 2,
                  checkpoint_dir: Optional[str] = None) -> InferenceResult:
    """Infer an ML tree from raw sequences (see module docstring).

    sequences: {label: sequence string} or an io.MSA.
    dtype: None picks f32 on accelerator backends, f64 on CPU.
    """
    import contextlib
    import time

    import jax
    import jax.numpy as jnp

    from . import Partition
    from .parsimony import FastParsimony
    from .parsimony.stepwise import fastparsimony_stepwise

    stats: dict = {}
    labels, seqs, charmap = _encode(sequences, states)
    tips = len(labels)
    if tips < 4:
        raise ValueError("need at least four taxa")
    if dtype is None:
        dtype = jnp.float64 if jax.default_backend() == "cpu" \
            else jnp.float32

    # 1. site-pattern compression (exact: weighted logL == uncompressed)
    if compress:
        patterns, weights = compress_site_patterns(seqs, charmap)
    else:
        patterns, weights = seqs, np.ones(len(seqs[0]), np.float64)
    sites = len(patterns[0])
    stats["sites_raw"] = len(seqs[0])
    stats["sites_patterns"] = sites
    chars = {lab: charmap[np.frombuffer(p.encode(), np.uint8)]
             for lab, p in zip(labels, patterns)}

    # 2. stepwise-addition parsimony starting tree (host CPU backend)
    t0 = time.time()
    try:
        pars_dev = jax.default_device(jax.devices("cpu")[0])
    except RuntimeError:                      # pragma: no cover
        pars_dev = contextlib.nullcontext()
    with pars_dev:
        partition = Partition(tips, tips - 2, states, sites, 1,
                              2 * tips - 3, 1, tips - 2)
        for i, lab in enumerate(labels):
            partition.set_tip_states(i, charmap, patterns[i])
        fp = FastParsimony(partition)
        start, pars_cost = fastparsimony_stepwise([fp], labels, seed=seed)
    for n in start.nodes:
        group = [n] if n.next is None else list(n.roundabout())
        for h in group:
            h.length = h.back.length = 0.1
    start = parse_newick_string(export_newick(start.vroot, precision=6))
    stats["parsimony_cost"] = int(pars_cost)
    stats["parsimony_secs"] = time.time() - t0

    cfg = PartitionConfig(
        tips=tips, clv_buffers=start.inner_count, states=states,
        sites=sites, rate_matrices=1, prob_matrices=2 * tips - 3,
        rate_cats=rate_cats, scale_buffers=start.inner_count, dtype=dtype)
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = weights
    inv = np.full(cfg.sites_padded, -1, np.int32)

    n_ex = states * (states - 1) // 2
    freqs0 = _empirical_frequencies(chars, np.asarray(weights), states)
    subst0 = np.ones(n_ex)
    rates0 = compute_gamma_cats(alpha0, rate_cats)
    model = engine.make_model([subst0], [freqs0], rates0, dtype=dtype)

    # 3. warm-up SPR rounds under the starting model
    t0 = time.time()
    tree, logl_a, stats_a = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=warmup_rounds, radius=radius,
        smooth_every=smooth_every, pattern_weights=pw, invariant=inv,
        checkpoint_dir=checkpoint_dir)
    stats["warmup_secs"] = time.time() - t0
    stats["warmup_logl"] = logl_a
    stats["warmup"] = {k: stats_a[k] for k in ("rounds", "moves")}

    # 4. gradient model fit on the warmed topology
    t0 = time.time()
    alpha = alpha0
    subst_fit, freqs_fit = subst0, freqs0
    if fit_steps > 0:
        program = engine.compile_tree(tree, cfg)
        raw = np.full((tips, cfg.sites_alloc), 0, dtype=np.uint64)
        for n in tree.nodes[:tips]:
            seq = chars[n.label]
            raw[n.clv_index, :len(seq)] = seq[:cfg.sites_alloc]
        tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
        params0 = fit.pack([subst0], [freqs0],
                           np.asarray(program.default_branch_lengths),
                           alpha=alpha0, dtype=dtype)
        res = fit.fit_model(program, cfg, params0, rates0,
                            tipchars, jnp.asarray(pw, dtype),
                            jnp.asarray(inv), steps=fit_steps, lr=fit_lr,
                            fit_alpha=fit_alpha)
        subst_l, freqs_l, _bl = fit.unpack(res.params)
        subst_fit = np.asarray(subst_l, np.float64)[0]
        freqs_fit = np.asarray(freqs_l, np.float64)[0]
        if fit_alpha:
            alpha = float(np.exp(np.asarray(res.params.log_alpha)))
        rates0 = compute_gamma_cats(alpha, rate_cats)
        model = engine.make_model([subst_fit], [freqs_fit], rates0,
                                  dtype=dtype)
        stats["fit_logl_trace"] = np.asarray(res.logl)[
            :: max(1, fit_steps // 10)].tolist()
    stats["fit_secs"] = time.time() - t0
    stats["alpha"] = alpha

    # 5. hill-climb to convergence under the fitted model
    t0 = time.time()
    tree, logl, stats_b = search_fast.hill_climb(
        tree, cfg, model, chars,
        max_rounds=max(1, max_rounds - warmup_rounds), radius=radius,
        smooth_every=smooth_every, pattern_weights=pw, invariant=inv,
        checkpoint_dir=checkpoint_dir)
    stats["search_secs"] = time.time() - t0
    stats["search"] = {k: stats_b[k] for k in ("rounds", "moves")}
    stats["logl_trace"] = stats_b["logl_trace"]
    stats["round_secs"] = stats_b["round_secs"]

    return InferenceResult(
        tree=tree, logl=logl, subst_params=subst_fit,
        frequencies=freqs_fit, alpha=alpha,
        newick=export_newick(tree.vroot, precision=9), stats=stats)
