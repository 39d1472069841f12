"""Non-DNA/AA state counts vs. the reference oracle: 5-state (odd count —
exercises state padding), 10-state unphased genotypes (pll_map_gt10) and
16-state phased genotypes (pll_map_gt16).  Mirrors the reference's
derivatives-oddstates.c test and the GT model support added for genotype
calling (maps.c:26-265, special-cased 16-state kernels pll.h:2429)."""
import numpy as np
import pytest

import libpll2_jax as pll

from .oracle import run_oracle

ODD5_MAP = np.zeros(256, dtype=np.uint64)
for _i in range(5):
    ODD5_MAP[ord(str(_i))] = 1 << _i
ODD5_MAP[ord("-")] = ODD5_MAP[ord("?")] = 31


def _params(states, seed):
    rng = np.random.default_rng(seed)
    n = states * (states - 1) // 2
    subst = np.round(rng.uniform(0.5, 2.0, n), 3)
    subst[-1] = 1.0
    freqs = np.round(rng.uniform(0.5, 1.5, states), 3)
    freqs = freqs / freqs.sum()
    return subst, freqs


def _fmt(a):
    return " ".join(repr(float(x)) for x in a)


CASES = {
    "odd5": (5, ["01234-", "013?42".replace("?", "?"), "210342", "430124"],
             ODD5_MAP, 11),
    "gt10": (10, ["ACGTMR", "WSYKAC", "MRACGT", "KYSWAC"], pll.MAP_GT10, 12),
    "gt16": (16, ["ACGTMR", "WSYKAC", "MRACGT", "KYSWAC"], pll.MAP_GT16, 13),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name = request.param
    states, seqs, pymap, seed = CASES[name]
    subst, freqs = _params(states, seed)
    sites = len(seqs[0])
    bl = [0.2, 0.4, 0.3, 0.5, 0.6]
    script = f"""
create 4 2 {states} {sites} 1 5 4 2 0
map {name}
freqs 0 {_fmt(freqs)}
subst 0 {_fmt(subst)}
gamma 0.8 4 mean
tip 0 {seqs[0]}
tip 1 {seqs[1]}
tip 2 {seqs[2]}
tip 3 {seqs[3]}
pmatrices 5 0 0 0 0
0 {bl[0]}
1 {bl[1]}
2 {bl[2]}
3 {bl[3]}
4 {bl[4]}
print_pmatrix 0
op 4 0 1 0 1 0 -1 -1
op 5 2 3 2 3 1 -1 -1
partials
print_clv 4
print_clv 5
edge 4 0 5 1 4
root 4 0
sumtable 4 0 5 1
derivatives 0.3
derivatives 1.7
"""
    golden = run_oracle(script)

    p = pll.Partition(4, 2, states, sites, 1, 5, 4, 2)
    p.set_frequencies(0, freqs)
    p.set_subst_params(0, subst)
    p.set_gamma_rates(0.8)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pymap, s)
    p.update_prob_matrices([0, 0, 0, 0], list(range(5)), bl)
    p.update_partials([
        pll.Operation(4, 0, 1, 0, 1, 0, -1, -1),
        pll.Operation(5, 2, 3, 2, 3, 1, -1, -1),
    ])
    return name, states, sites, golden, p


def test_pmatrix(case):
    name, states, sites, golden, p = case
    ref = golden["pmatrix"][0].reshape(4, states, states)
    np.testing.assert_allclose(p.get_pmatrix(0), ref, rtol=1e-7, atol=1e-11)


def test_clvs(case):
    name, states, sites, golden, p = case
    for idx in (4, 5):
        ref = golden["clv"][idx].reshape(sites, 4, states)
        np.testing.assert_allclose(p.get_clv(idx), ref, rtol=1e-7,
                                   atol=1e-11)


def test_logl(case):
    name, states, sites, golden, p = case
    edge = p.compute_edge_loglikelihood(4, 0, 5, 1, 4, [0] * 4)
    root = p.compute_root_loglikelihood(4, 0, [0] * 4)
    assert abs(edge - golden["edge_logl"][0]) < 1e-8 * abs(edge)
    assert abs(root - golden["root_logl"][0]) < 1e-8 * abs(root)


def test_derivatives(case):
    name, states, sites, golden, p = case
    st = p.update_sumtable(4, 5, 0, 1, [0] * 4)
    for k, t in enumerate((0.3, 1.7)):
        d1, d2 = p.compute_likelihood_derivatives(st, t, [0] * 4)
        ref = golden["derivatives"][k]   # line format: blen d1 d2
        np.testing.assert_allclose([d1, d2], ref[1:], rtol=1e-6)
