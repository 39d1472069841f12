"""Evaluate an alignment under every empirical amino-acid model.

Mirror of /root/reference/examples/protein-list: iterate the 28 bundled
empirical rate/frequency tables (Dayhoff ... Q.pfam families), score the
same data under each, and rank by log-likelihood.
"""
import _common  # noqa: F401
import libpll2_jax as pll
from libpll2_jax.models.aa import aa_model, available_models

SEQS = [
    "ARNDCQEGHILKMFPSTWYVARNDCQEGHILKMFPSTWYV",
    "ARNDCQEGHILKMFPSTWYVARNDCQEGHILKMFPSTWYV"[::-1],
    "AANDCQEGHILKMFPSTWYAARNDCQEGHILKMFPSTWYV",
    "ARNDCEQGHILKMFPSTWYVARNDCQEGHILKMFPSTWYA",
]
NONE = pll.SCALE_BUFFER_NONE

results = []
for name in available_models():
    rates, freqs = aa_model(name)
    if rates.ndim == 2:          # LG4M/LG4X need per-category matrices
        continue
    partition = pll.Partition(tips=4, clv_buffers=2, states=20,
                              sites=len(SEQS[0]), rate_matrices=1,
                              prob_matrices=5, rate_cats=4,
                              scale_buffers=2)
    partition.set_frequencies(0, freqs)
    partition.set_subst_params(0, rates)
    partition.set_category_rates(pll.compute_gamma_cats(1.0, 4))
    for i, seq in enumerate(SEQS):
        partition.set_tip_states(i, pll.MAP_AA, seq)
    partition.update_prob_matrices([0] * 4, [0, 1, 2, 3, 4],
                                   [0.2, 0.4, 0.3, 0.5, 0.6])
    operations = [
        pll.Operation(4, 0, 1, 0, 1, 0, NONE, NONE),
        pll.Operation(5, 2, 3, 2, 3, 1, NONE, NONE),
    ]
    partition.update_partials(operations)
    logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4, [0] * 4)
    results.append((logl, name))

for logl, name in sorted(results, reverse=True):
    print(f"{name:>12s}: {logl:f}")
