"""Cases and timing shared by chip_smoke.py, bench.py and
tools/profile_engine.py: seeded engine and search inputs at a given
width, the chained logL timer, and the kernel-path probe."""
from __future__ import annotations

import dataclasses
import time

import numpy as np

RATE_CATS = 4
REPS = 16                               # chained logL evaluations timed


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def config(tree, sites, states, dtype):
    """One partition over `tree`'s topology, GAMMA4."""
    from libpll2_jax.config import PartitionConfig

    return PartitionConfig(
        tips=tree.tip_count, clv_buffers=tree.inner_count, states=states,
        sites=sites, rate_matrices=1, prob_matrices=2 * tree.tip_count - 3,
        rate_cats=RATE_CATS, scale_buffers=tree.inner_count, dtype=dtype)


def make_case(tips, sites, states, dtype, seed=0):
    """Balanced tree, random tip states, GTR+G4 (DNA) or LG+G4.
    Returns (tree, cfg, program, (model, bl, tipchars, weights, inv))."""
    import jax.numpy as jnp

    from libpll2_jax import engine
    from libpll2_jax import tree as T
    from libpll2_jax.models.gamma import compute_gamma_cats
    from libpll2_jax.tree.generate import balanced_newick, random_tipchars

    tree = T.parse_newick_string(balanced_newick(tips))
    cfg = config(tree, sites, states, dtype)
    program = engine.compile_tree(tree, cfg)
    if states == 20:
        from libpll2_jax.models.aa import aa_model
        subst, freqs = aa_model("lg")
    else:
        subst, freqs = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0], [0.28, 0.24, 0.22,
                                                        0.26]
    model = engine.make_model([subst], [freqs],
                              compute_gamma_cats(0.8, RATE_CATS), dtype=dtype)
    rng = np.random.default_rng(seed)
    raw = random_tipchars(tips, cfg.sites_alloc, rng, states=states)
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    args = (model, jnp.asarray(program.default_branch_lengths, dtype),
            jnp.asarray(engine.pad_tipchars(raw, cfg)),
            jnp.asarray(pw, dtype),
            jnp.asarray(np.full(cfg.sites_padded, -1, np.int32)))
    return tree, cfg, program, args


def with_dtype(cfg, args, dtype):
    """The same case in another dtype (f64 reference)."""
    import jax
    import jax.numpy as jnp

    model, bl, tip, pw, inv = args
    cast = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, model)
    return (dataclasses.replace(cfg, dtype=dtype),
            (cast, bl.astype(dtype), tip, pw.astype(dtype), inv))


def took_kernel(lowered) -> bool:
    """Whether a lowered program calls the fused sweep."""
    from libpll2_jax.ops.partials_pallas_tree import KERNEL_NAME
    return KERNEL_NAME in lowered.as_text(debug_info=True)


def chained_ms(program, cfg, args, reps=REPS) -> float:
    """Per-call milliseconds of `reps` data-dependent logL evaluations in
    one jitted lax.scan, ended by block_until_ready (best of 3)."""
    import jax
    import jax.numpy as jnp

    from libpll2_jax import engine

    model, bl, tip, pw, inv = args

    @jax.jit
    def chain(bl0, tip, pw, inv):
        def body(c, _):
            r = engine.loglikelihood(program, cfg, model,
                                     bl0 * (1.0 + 1e-12 * c), tip, pw, inv)
            return r, None
        last, _ = jax.lax.scan(body, jnp.zeros((), bl0.dtype), None,
                               length=reps)
        return last

    jax.block_until_ready(chain(bl, tip, pw, inv))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(bl * 1.0000001, tip, pw, inv))
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e3


def simulated(tips, sites, seed):
    """(truth tree, random start tree, {label: codes}, (subst, freqs,
    rates)): an alignment simulated under GTR+G4 along a random tree."""
    from libpll2_jax import tree as T
    from libpll2_jax.models.gamma import compute_gamma_cats
    from libpll2_jax.tree.generate import random_newick, simulate_alignment

    rng = np.random.default_rng(seed)
    subst = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0]
    freqs = [0.28, 0.24, 0.22, 0.26]
    rates = compute_gamma_cats(0.9, RATE_CATS)
    truth = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.02, max_bl=0.35))
    chars = simulate_alignment(truth, sites, rng, subst, freqs, rates)
    start = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.05, max_bl=0.3))
    ren = dict(zip(sorted(n.label for n in start.nodes[:tips]),
                   sorted(chars)))
    for n in start.nodes[:tips]:
        n.label = ren[n.label]
    return truth, start, chars, (subst, freqs, rates)


def search_case(tips, sites, seed):
    """(start tree, f32 config, model, {label: codes}) for an SPR search."""
    import jax.numpy as jnp

    from libpll2_jax import engine

    _, start, chars, (subst, freqs, rates) = simulated(tips, sites, seed)
    cfg = config(start, sites, 4, jnp.float32)
    model = engine.make_model([subst], [freqs], rates, dtype=jnp.float32)
    return start, cfg, model, chars
