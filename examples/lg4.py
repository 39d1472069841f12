"""LG4M / LG4X: four rate matrices, one per Γ category.

Mirror of /root/reference/examples/lg4/lg4.c: protein data where each
rate category uses its own empirical matrix (params_indices =
[0, 1, 2, 3] instead of all zeros).
"""
import _common  # noqa: F401
import libpll2_jax as pll
from libpll2_jax.models.aa import aa_model

SEQS = [
    "ARNDCQEGHILKMFPSTWYV",
    "ARNDCQEGHILKMFPSTWYV"[::-1],
    "AANDCQEGHILKMFPSTWYA",
    "ARNDCEQGHILKMFPSTWYV",
]

for name in ("LG4M", "LG4X"):
    rates4, freqs4 = aa_model(name.lower())     # [4, 190], [4, 20]
    partition = pll.Partition(tips=4, clv_buffers=2, states=20, sites=20,
                              rate_matrices=4, prob_matrices=5, rate_cats=4,
                              scale_buffers=2)
    for i in range(4):
        partition.set_frequencies(i, freqs4[i])
        partition.set_subst_params(i, rates4[i])
    partition.set_category_rates(pll.compute_gamma_cats(1.0, 4))
    for i, seq in enumerate(SEQS):
        partition.set_tip_states(i, pll.MAP_AA, seq)

    params_indices = [0, 1, 2, 3]   # one matrix per category
    partition.update_prob_matrices(params_indices, [0, 1, 2, 3, 4],
                                   [0.2, 0.4, 0.3, 0.5, 0.6])

    NONE = pll.SCALE_BUFFER_NONE
    operations = [
        pll.Operation(4, 0, 1, 0, 1, 0, NONE, NONE),
        pll.Operation(5, 2, 3, 2, 3, 1, NONE, NONE),
    ]
    partition.update_partials(operations)
    logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4,
                                                params_indices)
    print(f"Log-L ({name}): {logl:f}")
