"""Per-branch heterotachy: a different rate matrix per tree region.

Mirror of /root/reference/examples/heterotachy/heterotachy.c: three GTR
models — one per subtree plus one for the root branch — mapped onto the
five branches via grouped pll_update_prob_matrices calls.
"""
import _common  # noqa: F401
import libpll2_jax as pll

RMATRIX_COUNT = 3

partition = pll.Partition(tips=4, clv_buffers=2, states=4, sites=6,
                          rate_matrices=RMATRIX_COUNT, prob_matrices=5,
                          rate_cats=4, scale_buffers=2)

branch_lengths = [0.2, 0.4, 0.3, 0.5, 0.6]
matrix_indices = [0, 1, 2, 3, 4]
matrix_start = [0, 2, 4]
matrix_count = [2, 2, 1]

# three distinct GTR parameterizations
partition.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
partition.set_frequencies(1, [0.25, 0.25, 0.25, 0.25])
partition.set_frequencies(2, [0.30, 0.25, 0.20, 0.25])
partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
partition.set_subst_params(1, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
partition.set_subst_params(2, [0.9, 1.8, 1.1, 0.8, 2.0, 1.0])
partition.set_category_rates(pll.compute_gamma_cats(1.0, 4))

for i, seq in enumerate(["WAAAAB", "CACACD", "AGGACA", "CGTAGT"]):
    partition.set_tip_states(i, pll.MAP_NT, seq)

# grouped P-matrix updates: branches of region i use rate matrix i
for i in range(RMATRIX_COUNT):
    s, c = matrix_start[i], matrix_count[i]
    partition.update_prob_matrices([i] * 4, matrix_indices[s:s + c],
                                   branch_lengths[s:s + c])

NONE = pll.SCALE_BUFFER_NONE
operations = [
    pll.Operation(4, 0, 1, 0, 1, 0, NONE, NONE),
    pll.Operation(5, 2, 3, 2, 3, 1, NONE, NONE),
]
partition.update_partials(operations)

# the root branch (matrix 4) was built with model 2; evaluation mixes the
# per-category models through params_indices of model 2
logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4, [2, 2, 2, 2])
print(f"Log-L (heterotachy, 3 models): {logl:f}")
