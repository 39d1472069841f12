"""End-to-end ML workflow demo — capabilities BEYOND the reference:

  1. batched all-branch Newton smoothing (engine.optimize_branch_lengths)
  2. autodiff model fitting: GTR rates + frequencies + branch lengths +
     gamma shape in one compiled Adam loop (fit.fit_model)
  3. a greedy ML SPR round on the batched placement scorer
     (legacy_search.ml_spr_round)

The reference library provides single-branch Newton machinery and SPR
mechanics; the optimization loops live in its clients (RAxML-NG).  Here
they are first-class, batched, and compiled.

Run:  python examples/optimize_demo.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
jax.config.update("jax_enable_x64", True)
# f64 end-to-end demo: run on the CPU backend (the GPU fast path is f32;
# must be set before any backend initialization)
try:
    jax.config.update("jax_platforms", "cpu")
except RuntimeError:
    pass

import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine, fit
from libpll2_jax import legacy_search as search
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig

NEWICK = ("((A:0.12,B:0.20):0.05,(C:0.09,(D:0.15,E:0.11):0.07):0.04,"
          "(F:0.18,G:0.25):0.06);")
SEQS = {
    "A": "CTAGCGCAGTTCAAGACAGCTTACGGTCCTGACGTGCTAAGCAT",
    "B": "CTAGCGAAGTTCAAGACAGCTTACGGTACTGACGTGCTAAGCGT",
    "C": "CTTGCGCAGGTCAAGACTGCTTACGGACCTGACGTGCTTAGCAT",
    "D": "CTTGCACAGGTCGAGACTGCATACGGACCTGATGTGCTTAGCAT",
    "E": "CTTGCACAGGTCGAGACTGCATACGGACCTAATGTGCTTAGCAT",
    "F": "TTAGCGCAGTTCAAGCCAGCTTACGGTCCTGACGAGCTAAGTAT",
    "G": "TTAGCGCAGTACAAGCCAGCTTATGGTCCTGACGAGCTAAGTAT",
}


def main():
    tree = T.parse_newick_string(NEWICK)
    sites = len(SEQS["A"])
    cfg = PartitionConfig(
        tips=7, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=11, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float64)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)

    rates = pll.compute_gamma_cats(1.0, 4)
    model = engine.make_model([[1.0] * 6], [[0.25] * 4], rates,
                              dtype=jnp.float64)
    raw = np.zeros((7, cfg.sites_alloc), dtype=np.uint64)
    for n in tree.nodes[:7]:
        raw[n.clv_index] = pll.MAP_NT[np.frombuffer(
            SEQS[n.label].encode(), np.uint8)]
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    pw = jnp.asarray(pw, jnp.float64)
    inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
    bl = jnp.asarray(program.default_branch_lengths, jnp.float64)

    logl0 = float(engine.loglikelihood(program, cfg, model, bl, tipchars,
                                       pw, inv))
    print(f"start                  logL = {logl0:.6f}")

    # 1. all-branch Newton smoothing
    bl_opt, logl1 = engine.optimize_branch_lengths(
        full, cfg, model, bl, tipchars, pw, inv, rounds=16)
    print(f"branch smoothing       logL = {float(logl1):.6f}")

    # 2. joint model fit (rates, freqs, branches, alpha)
    params0 = fit.pack([[1.0] * 6], [[0.25] * 4], np.asarray(bl_opt),
                       alpha=1.0, dtype=jnp.float64)
    res = fit.fit_model(program, cfg, params0, rates, tipchars, pw, inv,
                        steps=200, lr=0.05, fit_alpha=True)
    subst, freqs, bl_fit = fit.unpack(res.params)
    alpha = float(np.exp(np.asarray(res.params.log_alpha)))
    print(f"model fit (Adam)       logL = {float(res.logl[-1]):.6f}")
    print(f"  fitted alpha = {alpha:.3f}")
    print(f"  fitted freqs = {np.round(np.asarray(freqs)[0], 3)}")
    print(f"  fitted rates = {np.round(np.asarray(subst)[0], 3)}")

    # 3. one ML SPR round from the fitted model + fitted branch lengths
    model_fit = fit.make_model_traced(
        subst, freqs, pll.compute_gamma_cats(alpha, 4), dtype=jnp.float64)
    pos_of = {int(pm): i for i, pm in enumerate(program.pmatrix_indices)}
    bl_np = np.asarray(bl_fit)
    for n in tree.nodes:
        for h in ([n] if n.next is None else list(n.roundabout())):
            h.length = float(bl_np[pos_of[h.pmatrix_index]])
    chars = {n.label: raw[n.clv_index] for n in tree.nodes[:7]}
    tree2, logl2, improved = search.ml_spr_round(tree, cfg, model_fit,
                                                 chars)
    print(f"SPR round              logL = {logl2:.6f} "
          f"({'move applied' if improved else 'local optimum'})")


if __name__ == "__main__":
    main()
