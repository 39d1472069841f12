"""Full pipeline: newick + FASTA -> pattern compression -> logL.

Mirror of /root/reference/examples/newick-fasta-unrooted: parse a tree
and an alignment, compress site patterns, compile the traversal to an
operations array, and evaluate GTR+GAMMA4 log-likelihood.
"""
import _common  # noqa: F401
import pathlib
import tempfile

import libpll2_jax as pll
from libpll2_jax import tree as T
from libpll2_jax.io import compress_site_patterns, load_fasta_msa

NEWICK = ("((t0:0.12,t1:0.34):0.11,(t2:0.23,t3:0.18):0.09,"
          "(t4:0.40,t5:0.05):0.17);")
FASTA = """>t0
ACGTACGTACGTACGTAAAA
>t1
ACGTACGAACGTACGTAAAA
>t2
ACCTACGTACGAACGTAAAA
>t3
TCGTACGTACGTACGAAAAA
>t4
ACGTACTTACGTACGCAAAA
>t5
GCGTACGTACGTACGTAAAA
"""

with tempfile.TemporaryDirectory() as d:
    path = pathlib.Path(d) / "msa.fa"
    path.write_text(FASTA)
    msa = load_fasta_msa(str(path))
headers, seqs = msa.labels, msa.sequences

tree = T.parse_newick_string(NEWICK)
order = {lab: i for i, lab in enumerate(headers)}
tips = tree.tip_count

patterns, weights = compress_site_patterns(seqs, pll.MAP_NT)
sites = len(patterns[0])
print(f"Compressed {len(seqs[0])} sites -> {sites} patterns")

partition = pll.Partition(tips, tree.inner_count, 4, sites, 1,
                          2 * tips - 3, 4, tree.inner_count)
partition.set_frequencies(0, [0.25, 0.25, 0.25, 0.25])
partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
partition.set_category_rates(pll.compute_gamma_cats(0.75, 4))
partition.set_pattern_weights(weights)
for node in tree.nodes[:tips]:
    partition.set_tip_states(node.clv_index, pll.MAP_NT,
                             patterns[order[node.label]])

trav = T.traverse(tree.vroot)
ops, branches, pmat_idx = T.create_operations(trav)
partition.update_prob_matrices([0] * 4, pmat_idx, branches)
partition.update_partials(ops)

root = tree.vroot
logl = partition.compute_edge_loglikelihood(
    root.clv_index, root.scaler_index, root.back.clv_index,
    root.back.scaler_index, root.pmatrix_index, [0] * 4)
print(f"Log-L: {logl:f}")
