"""20-state (protein) parity vs. the reference oracle: empirical AA model
tables, eigen/P-matrix/CLV/logL on states=20, and LG4-style per-category
rate matrices.  Mirrors the reference's protein-models.c test intent."""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax.models.aa import aa_model, available_models

from .oracle import run_oracle

RTOL = 1e-9

SEQS = [
    "ARNDCQEGHILKMFPSTWYV",
    "ARNDCQEGHILKMFPSTWYY",
    "AANDCQEGHILKMFPSTWYV",
    "ARNDCQEGHILKMFPSTWY-",
]


def fmt(vals):
    return " ".join(f"{v:.17g}" for v in np.asarray(vals).ravel())


@pytest.fixture(scope="module", params=["lg", "wag", "dayhoff", "q_pfam"])
def model_name(request):
    return request.param


@pytest.fixture(scope="module")
def golden(model_name):
    rates, freqs = aa_model(model_name)
    return run_oracle(f"""
create 4 2 20 20 1 5 4 2 0
map aa
freqs 0 {fmt(freqs)}
subst 0 {fmt(rates)}
gamma 0.75 4 mean
tip 0 {SEQS[0]}
tip 1 {SEQS[1]}
tip 2 {SEQS[2]}
tip 3 {SEQS[3]}
pmatrices 5 0 0 0 0
0 0.2
1 0.4
2 0.3
3 0.5
4 0.6
print_pmatrix 0
op 4 0 1 0 1 0 -1 -1
op 5 2 3 2 3 1 -1 -1
partials
print_clv 4
edge 4 0 5 1 4
root 4 0
""")


@pytest.fixture(scope="module")
def partition(model_name):
    rates, freqs = aa_model(model_name)
    p = pll.Partition(4, 2, 20, 20, 1, 5, 4, 2)
    p.set_frequencies(0, freqs)
    p.set_subst_params(0, rates)
    p.set_gamma_rates(0.75)
    for i, s in enumerate(SEQS):
        p.set_tip_states(i, pll.MAP_AA, s)
    p.update_prob_matrices([0, 0, 0, 0], [0, 1, 2, 3, 4],
                           [0.2, 0.4, 0.3, 0.5, 0.6])
    p.update_partials([
        pll.Operation(4, 0, 1, 0, 1, 0, -1, -1),
        pll.Operation(5, 2, 3, 2, 3, 1, -1, -1),
    ])
    return p


def test_aa_pmatrix(golden, partition):
    ours = np.asarray(partition.pmatrix[0]).reshape(-1)
    # elementwise tolerance reflects eigensolver rounding (jnp.linalg.eigh
    # vs the reference's tred2/tqli): ~1e-10 absolute on 20x20 P entries.
    np.testing.assert_allclose(ours, golden["pmatrix"][0], rtol=1e-6,
                               atol=1e-9)


def test_aa_clv(golden, partition):
    ours = np.asarray(partition.clv[4][:, :, :partition.cfg.sites]
                      ).transpose(2, 0, 1).reshape(-1)
    np.testing.assert_allclose(ours, golden["clv"][4], rtol=1e-6, atol=1e-12)


def test_aa_edge_logl(golden, partition):
    logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4, [0, 0, 0, 0])
    np.testing.assert_allclose(logl, golden["edge_logl"][0], rtol=RTOL)


def test_aa_root_logl(golden, partition):
    logl = partition.compute_root_loglikelihood(4, 0, [0, 0, 0, 0])
    np.testing.assert_allclose(logl, golden["root_logl"][0], rtol=RTOL)


def test_all_model_tables_normalized():
    """Every table: 190 positive rates, 20 frequencies summing to ~1."""
    for name in available_models():
        rates, freqs = aa_model(name)
        assert rates.shape[-1] == 190 and freqs.shape[-1] == 20, name
        assert np.all(rates >= 0), name
        np.testing.assert_allclose(freqs.sum(axis=-1), 1.0, atol=5e-3,
                                   err_msg=name)


def test_lg4x_per_category_matrices():
    """LG4X: a different rate matrix per Γ category via params_indices —
    P-matrices must match the oracle computed per matrix."""
    rates4, freqs4 = aa_model("lg4x")
    p = pll.Partition(4, 2, 20, 20, 4, 5, 4, 2)
    for m in range(4):
        p.set_frequencies(m, freqs4[m])
        p.set_subst_params(m, rates4[m])
    p.set_gamma_rates(0.75)
    pi = [0, 1, 2, 3]
    p.update_prob_matrices(pi, [0], [0.37])

    script = ["create 4 2 20 20 4 5 4 2 0", "map aa"]
    for m in range(4):
        script += [f"freqs {m} {fmt(freqs4[m])}",
                   f"subst {m} {fmt(rates4[m])}"]
    script += ["gamma 0.75 4 mean", "pmatrices 1 0 1 2 3", "0 0.37",
               "print_pmatrix 0"]
    golden = run_oracle("\n".join(script) + "\n")
    ours = np.asarray(p.pmatrix[0]).reshape(-1)
    np.testing.assert_allclose(ours, golden["pmatrix"][0], rtol=1e-6,
                               atol=1e-9)
