"""Ascertainment-bias correction parity (Lewis / Felsenstein / Stamatakis)
vs. the reference oracle, for root/edge logL and branch-length derivatives.
Mirrors the reference's asc-bias test intent (test/src/asc-bias.c)."""
import numpy as np
import pytest

import libpll2_jax as pll

from .oracle import run_oracle

# PLL_ATTRIB_AB_* (pll.h:124-128): lewis=1<<5 — enables asc allocation
ATTRIB = {"lewis": 1 << 5, "felsenstein": 2 << 5, "stamatakis": 3 << 5}
AB = {"lewis": pll.AB_LEWIS, "felsenstein": pll.AB_FELSENSTEIN,
      "stamatakis": pll.AB_STAMATAKIS}

SEQS = ["WAACAB", "CACACD", "AGGACA", "CGTAGT", "CATCCA"]
WEIGHTS = [2, 1, 1, 3]


def build_golden(mode):
    return run_oracle(f"""
create 5 3 4 6 1 7 4 3 {ATTRIB[mode]}
map nt
asc_bias {mode}
asc_weights {' '.join(str(w) for w in WEIGHTS)}
freqs 0 0.17 0.19 0.25 0.39
subst 0 1.2 2.1 0.7 1.3 2.5 1.0
gamma 0.8 4 mean
tip 0 {SEQS[0]}
tip 1 {SEQS[1]}
tip 2 {SEQS[2]}
tip 3 {SEQS[3]}
tip 4 {SEQS[4]}
pmatrices 7 0 0 0 0
0 0.2
1 0.4
2 0.3
3 0.5
4 0.6
5 0.15
6 0.23
op 5 0 1 0 1 0 -1 -1
op 6 2 3 2 3 1 -1 -1
op 7 5 4 5 4 2 0 -1
partials
root 7 2
edge 7 2 6 1 6
sumtable 7 2 6 1
derivatives 0.3
derivatives 1.1
""")


def build_partition(mode):
    p = pll.Partition(5, 3, 4, 6, 1, 7, 4, 3, asc_bias=AB[mode])
    p.set_asc_state_weights(WEIGHTS)
    p.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.8)
    for i, s in enumerate(SEQS):
        p.set_tip_states(i, pll.MAP_NT, s)
    p.update_prob_matrices([0] * 4, list(range(7)),
                           [0.2, 0.4, 0.3, 0.5, 0.6, 0.15, 0.23])
    p.update_partials([
        pll.Operation(5, 0, 1, 0, 1, 0, -1, -1),
        pll.Operation(6, 2, 3, 2, 3, 1, -1, -1),
        pll.Operation(7, 5, 4, 5, 4, 2, 0, -1),
    ])
    return p


@pytest.mark.parametrize("mode", ["lewis", "felsenstein", "stamatakis"])
def test_asc_logl(mode):
    golden = build_golden(mode)
    p = build_partition(mode)
    root = p.compute_root_loglikelihood(7, 2, [0] * 4)
    np.testing.assert_allclose(root, golden["root_logl"][0], rtol=1e-9)
    edge = p.compute_edge_loglikelihood(7, 2, 6, 1, 6, [0] * 4)
    np.testing.assert_allclose(edge, golden["edge_logl"][0], rtol=1e-9)


@pytest.mark.parametrize("mode", ["lewis", "felsenstein", "stamatakis"])
def test_asc_derivatives(mode):
    golden = build_golden(mode)
    p = build_partition(mode)
    st = p.update_sumtable(7, 6, 2, 1, [0] * 4)
    for i, bl in enumerate([0.3, 1.1]):
        d1, d2 = p.compute_likelihood_derivatives(st, bl, [0] * 4)
        # 1e-7: the Lewis correction divides by (L0 - 1), a cancellation
        # that amplifies eigensolver rounding differences
        np.testing.assert_allclose(
            [d1, d2], golden["derivatives"][i][1:], rtol=1e-7,
            err_msg=f"mode={mode} bl={bl}")
