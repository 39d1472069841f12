"""Unrooted-tree log-likelihood on a manually built operations array.

Mirror of the reference's canonical example
(/root/reference/examples/unrooted/unrooted.c): 4 taxa, GTR+GAMMA4,
manual operations, P-matrix/CLV display, edge logL across the virtual
root, and +I (invariant sites) re-evaluation — byte-identical output.
"""
import _common  # noqa: F401  (platform bootstrap)
import libpll2_jax as pll
from libpll2_jax.utils import show_clv, show_pmatrix

partition = pll.Partition(tips=4, clv_buffers=2, states=4, sites=6,
                          rate_matrices=1, prob_matrices=5, rate_cats=4,
                          scale_buffers=2)

branch_lengths = [0.2, 0.4, 0.3, 0.5, 0.6]
matrix_indices = [0, 1, 2, 3, 4]
partition.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
partition.set_category_rates(pll.compute_gamma_cats(1.0, 4))

partition.set_tip_states(0, pll.MAP_NT, "WAAAAB")
partition.set_tip_states(1, pll.MAP_NT, "CACACD")
partition.set_tip_states(2, pll.MAP_NT, "AGGACA")
partition.set_tip_states(3, pll.MAP_NT, "CGTAGT")

params_indices = [0, 0, 0, 0]
partition.update_prob_matrices(params_indices, matrix_indices,
                               branch_lengths)
for i in range(5):
    print(f"P-matrix for branch length {branch_lengths[i]:f}")
    show_pmatrix(partition, i, 7)
    print()

NONE = pll.SCALE_BUFFER_NONE
operations = [
    pll.Operation(4, 0, 1, 0, 1, 0, NONE, NONE),
    pll.Operation(5, 2, 3, 2, 3, 1, NONE, NONE),
]
partition.update_partials(operations)

for i in range(4):
    print(f"Tip {i}: ", end="")
    show_clv(partition, i, NONE, 7)
print("CLV 4: ", end="")
show_clv(partition, 4, 0, 7)
print("CLV 5: ", end="")
show_clv(partition, 5, 1, 7)

logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4, params_indices)
print(f"Log-L: {logl:f}")

# invariant sites: +I proportion 0.5, then 0.75 (models.c:495-544)
partition.update_invariant_sites()
partition.update_invariant_sites_proportion(0, 0.5)
partition.update_prob_matrices(params_indices, matrix_indices,
                               branch_lengths)
partition.update_partials(operations)
logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4, params_indices)
print(f"Log-L (Inv+Gamma 0.5): {logl:f}")

partition.update_invariant_sites_proportion(0, 0.75)
partition.update_prob_matrices(params_indices, matrix_indices,
                               branch_lengths)
partition.update_partials(operations)
logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4, params_indices)
print(f"Log-L (Inv+Gamma 0.75): {logl:f}")
