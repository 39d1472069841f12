"""Multi-partition models (per-gene partitions sharing one topology).

Done-criterion from the build plan: a 3-partition GTR/LG mixed run must
match the SUM of single-partition reference-oracle logLs to 1e-9 and run
as one device program; joint branch-length optimization must improve the
summed likelihood to stationarity of the summed per-branch derivatives.
Reference context: one pll_partition_t per site range (pll.h:241-288),
combination left to clients (SURVEY.md §2.6).
"""
import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine, multipartition
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.models.aa import aa_model

from .oracle import run_oracle
from .test_parity_tree import random_newick, random_seqs

AAS = "ARNDCQEGHILKMFPSTWYV"
N_TIPS = 8


def fmt(vals):
    return " ".join(f"{v:.17g}" for v in np.asarray(vals).ravel())


def random_aa_seqs(n_tips, sites, rng):
    return ["".join(AAS[b] for b in rng.integers(0, 20, sites))
            for _ in range(n_tips)]


def make_partitions(tree, rng):
    """Three partitions: GTR+G4 DNA, HKY-ish+G4 DNA, LG+G4 protein."""
    lg_rates, lg_freqs = aa_model("lg")
    specs = [
        dict(states=4, sites=61, map=pll.MAP_NT, map_name="nt", alpha=0.8,
             subst=[1.2, 2.1, 0.7, 1.3, 2.5, 1.0],
             freqs=[0.3, 0.25, 0.2, 0.25],
             seqs=random_seqs(N_TIPS, 61, rng)),
        dict(states=4, sites=83, map=pll.MAP_NT, map_name="nt", alpha=1.4,
             subst=[1.0, 4.0, 1.0, 1.0, 4.0, 1.0],
             freqs=[0.2, 0.3, 0.3, 0.2],
             seqs=random_seqs(N_TIPS, 83, rng)),
        dict(states=20, sites=37, map=pll.MAP_AA, map_name="aa", alpha=0.75,
             subst=lg_rates, freqs=lg_freqs,
             seqs=random_aa_seqs(N_TIPS, 37, rng)),
    ]
    cfgs, models, tipchars, pws, invs = [], [], [], [], []
    for s in specs:
        cfg = PartitionConfig(
            tips=N_TIPS, clv_buffers=tree.inner_count, states=s["states"],
            sites=s["sites"], rate_matrices=1,
            prob_matrices=2 * N_TIPS - 3, rate_cats=4,
            scale_buffers=tree.inner_count, dtype=jnp.float64)
        model = engine.make_model([s["subst"]], [s["freqs"]],
                                  pll.compute_gamma_cats(s["alpha"], 4),
                                  dtype=jnp.float64)
        raw = np.zeros((N_TIPS, cfg.sites), dtype=np.uint64)
        for i, seq in enumerate(s["seqs"]):
            raw[i] = s["map"][np.frombuffer(seq.encode(), np.uint8)]
        pw = np.zeros(cfg.sites_padded)
        pw[:cfg.sites] = 1.0
        cfgs.append(cfg)
        models.append(model)
        tipchars.append(jnp.asarray(engine.pad_tipchars(raw, cfg)))
        pws.append(jnp.asarray(pw, jnp.float64))
        invs.append(jnp.asarray(np.full(cfg.sites_padded, -1, np.int32)))
    return specs, cfgs, models, tuple(tipchars), tuple(pws), tuple(invs)


def oracle_logl(spec, newick, branches=None):
    tree = T.parse_newick_string(newick)
    trav = T.traverse(tree.vroot)
    ops, default_branches, pmat_idx = T.create_operations(trav)
    if branches is None:
        branches = default_branches
    root = tree.vroot
    lines = [
        f"create {N_TIPS} {tree.inner_count} {spec['states']} "
        f"{spec['sites']} 1 {2 * N_TIPS - 3} 4 {tree.inner_count} 0",
        f"map {spec['map_name']}",
        f"freqs 0 {fmt(spec['freqs'])}",
        f"subst 0 {fmt(spec['subst'])}",
        f"gamma {spec['alpha']} 4 mean",
    ]
    for i, s in enumerate(spec["seqs"]):
        lines.append(f"tip {i} {s}")
    lines.append(f"pmatrices {len(branches)} 0 0 0 0")
    for b, m in zip(branches, pmat_idx):
        lines.append(f"{m} {b:.17g}")
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
    return run_oracle("\n".join(lines) + "\n")["edge_logl"][0]


def test_mixed_three_partition_oracle_parity():
    rng = np.random.default_rng(17)
    newick = random_newick(N_TIPS, rng)
    tree = T.parse_newick_string(newick)
    specs, cfgs, models, tipchars, pws, invs = make_partitions(tree, rng)
    mp = multipartition.compile_multipartition(tree, cfgs)
    bl = jnp.asarray(mp.programs[0].default_branch_lengths, jnp.float64)

    total = float(multipartition.loglikelihood(
        mp, tuple(models), bl, tipchars, pws, invs))
    want = sum(oracle_logl(s, newick) for s in specs)
    np.testing.assert_allclose(total, want, rtol=1e-9)


def test_mixed_scaled_brlens_match_oracle_and_fd():
    rng = np.random.default_rng(23)
    newick = random_newick(N_TIPS, rng)
    tree = T.parse_newick_string(newick)
    specs, cfgs, models, tipchars, pws, invs = make_partitions(tree, rng)
    mp = multipartition.compile_multipartition(tree, cfgs)
    bl = jnp.asarray(mp.programs[0].default_branch_lengths, jnp.float64)
    scalers = jnp.asarray([1.0, 0.5, 2.0], jnp.float64)

    total = float(multipartition.loglikelihood(
        mp, tuple(models), bl, tipchars, pws, invs, scalers))
    want = sum(oracle_logl(s, newick,
                           branches=np.asarray(bl) * float(scalers[k]))
               for k, s in enumerate(specs))
    np.testing.assert_allclose(total, want, rtol=1e-9)

    # summed, chain-ruled (d1, d2) vs central finite differences
    d1, d2 = multipartition.branch_derivatives(
        mp, tuple(models), bl, tipchars, pws, invs, scalers)
    h = 1e-6
    for e in [0, 3, len(np.asarray(bl)) - 1]:
        lp = float(multipartition.loglikelihood(
            mp, tuple(models), bl.at[e].add(h), tipchars, pws, invs,
            scalers))
        lm = float(multipartition.loglikelihood(
            mp, tuple(models), bl.at[e].add(-h), tipchars, pws, invs,
            scalers))
        np.testing.assert_allclose(float(d1[e]), -(lp - lm) / (2 * h),
                                   rtol=2e-5, atol=1e-7)


def test_joint_branch_optimization():
    rng = np.random.default_rng(29)
    newick = random_newick(N_TIPS, rng)
    tree = T.parse_newick_string(newick)
    specs, cfgs, models, tipchars, pws, invs = make_partitions(tree, rng)
    mp = multipartition.compile_multipartition(tree, cfgs)
    bl0 = jnp.asarray(mp.programs[0].default_branch_lengths,
                      jnp.float64) * 2.0 + 0.05
    logl0 = float(multipartition.loglikelihood(
        mp, tuple(models), bl0, tipchars, pws, invs))
    new_bl, logl1 = multipartition.optimize_branch_lengths(
        mp, tuple(models), bl0, tipchars, pws, invs, rounds=24,
        newton_iters=16)
    assert float(logl1) > logl0 + 1.0, (logl0, float(logl1))
    # the optimum of the SUM is not the optimum of any single partition:
    # summed d1 must vanish on interior branches
    d1, d2 = multipartition.branch_derivatives(
        mp, tuple(models), new_bl, tipchars, pws, invs)
    d1, d2 = np.asarray(d1), np.asarray(d2)
    interior = (np.asarray(new_bl) > 2e-8) & (np.asarray(new_bl) < 99.0)
    assert np.all(np.abs(d1[interior]) / (np.abs(d2[interior]) + 1.0)
                  < 1e-3), d1[interior]
    # and the total must match a fresh one-program evaluation
    np.testing.assert_allclose(
        float(logl1),
        float(multipartition.loglikelihood(mp, tuple(models), new_bl,
                                           tipchars, pws, invs)),
        rtol=1e-12)
