"""Derivative (sumtable + d1/d2) parity vs. the reference oracle.

Modeled on the reference's test/src/derivatives.c grid: multiple alphas,
proportions of invariant sites, category counts, and branch lengths, on an
inner-inner edge of a 5-taxon caterpillar.
"""
import numpy as np
import pytest

import libpll2_jax as pll

from .oracle import run_oracle

SEQS = ["ACGTACGTAA", "CCGTACGTAT", "ACGAACGTGA", "ACGTTCGTAC", "AGGTACATAA"]
SITES = 10
TIPS = 5
BRANCHES = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7]
TEST_LENGTHS = [1e-4, 0.01, 0.1, 0.5, 1.0, 2.0, 10.0, 50.0, 90.0]


def build_script(rate_cats, alpha, pinv):
    # caterpillar: ((0,1)5, 2)6, ((5?,...)) — ops below
    lines = [
        f"create {TIPS} 4 4 {SITES} 1 7 {rate_cats} 4 0",
        "map nt",
        "freqs 0 0.25 0.25 0.25 0.25",
        "subst 0 1 2 1 1 2 1",
        f"gamma {alpha} {rate_cats} mean",
    ]
    for i, s in enumerate(SEQS):
        lines.append(f"tip {i} {s}")
    if pinv > 0:
        lines.append(f"pinv 0 {pinv}")
    pidx = " ".join(["0"] * rate_cats)
    lines.append(f"pmatrices {len(BRANCHES)} {pidx}")
    for i, b in enumerate(BRANCHES):
        lines.append(f"{i} {b}")
    # post-order ops: 5=(0,1), 6=(5,2), 7=(3,4); edge 6-7 is inner-inner
    lines += [
        "op 5 0 1 0 1 0 -1 -1",
        "op 6 5 2 2 3 1 0 -1",
        "op 7 3 4 4 5 2 -1 -1",
        "partials",
        "edge 6 1 7 2 6",
        "sumtable 6 1 7 2",
    ]
    for bl in TEST_LENGTHS:
        lines.append(f"derivatives {bl}")
    return "\n".join(lines) + "\n"


def build_partition(rate_cats, alpha, pinv):
    p = pll.Partition(TIPS, 4, 4, SITES, 1, 7, rate_cats, 4)
    p.set_frequencies(0, [0.25] * 4)
    p.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    p.set_gamma_rates(alpha)
    for i, s in enumerate(SEQS):
        p.set_tip_states(i, pll.MAP_NT, s)
    if pinv > 0:
        p.update_invariant_sites_proportion(0, pinv)
    pidx = [0] * rate_cats
    p.update_prob_matrices(pidx, list(range(len(BRANCHES))), BRANCHES)
    p.update_partials([
        pll.Operation(5, 0, 1, 0, 1, 0, -1, -1),
        pll.Operation(6, 5, 2, 2, 3, 1, 0, -1),
        pll.Operation(7, 3, 4, 4, 5, 2, -1, -1),
    ])
    return p, pidx


@pytest.mark.parametrize("rate_cats", [1, 2, 4])
@pytest.mark.parametrize("alpha,pinv", [
    (0.5, 0.0), (1.0, 0.0), (2.0, 0.0),
    (1.0, 0.3), (0.75, 0.5), (1.5, 0.9),
])
def test_derivatives_grid(rate_cats, alpha, pinv):
    golden = run_oracle(build_script(rate_cats, alpha, pinv))
    p, pidx = build_partition(rate_cats, alpha, pinv)

    logl = p.compute_edge_loglikelihood(6, 1, 7, 2, 6, pidx)
    ref_logl = golden["edge_logl"][0]
    assert abs(logl - ref_logl) < 1e-9 * abs(ref_logl)

    st = p.update_sumtable(6, 7, 1, 2, pidx)
    for i, bl in enumerate(TEST_LENGTHS):
        d1, d2 = p.compute_likelihood_derivatives(st, bl, pidx)
        ref_bl, ref_d1, ref_d2 = golden["derivatives"][i]
        assert ref_bl == bl
        np.testing.assert_allclose(d1, ref_d1, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(d2, ref_d2, rtol=1e-8, atol=1e-10)
