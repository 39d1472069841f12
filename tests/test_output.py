"""Debug printer parity (pll_show_pmatrix / pll_show_clv, output.c) —
byte-level diff against the reference — and the hardware probe."""
import subprocess

import numpy as np

import libpll2_jax as pll
from libpll2_jax import tree as T
from libpll2_jax.utils.output import (format_clv, format_pmatrix,
                                      hardware_probe)

from .oracle import ensure_oracle
from .test_parity_tree import random_newick, random_seqs


def _run_raw(script: str) -> str:
    binary = ensure_oracle()
    proc = subprocess.run([str(binary)], input=script, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_printers_match_reference():
    rng = np.random.default_rng(53)
    sites, rate_cats = 23, 4
    newick = random_newick(60, rng, caterpillar=True)  # deep => scaling
    tree = T.parse_newick_string(newick)
    tips = tree.tip_count
    trav = T.traverse(tree.vroot)
    ops, branches, pmat_idx = T.create_operations(trav)
    seqs = random_seqs(tips, sites, rng)
    root = tree.vroot

    lines = [
        f"create {tips} {tree.inner_count} 4 {sites} 1 "
        f"{2 * tips - 3} {rate_cats} {tree.inner_count} 0",
        "map nt",
        "freqs 0 0.3 0.25 0.2 0.25",
        "subst 0 1.2 2.1 0.7 1.3 2.5 1.0",
        f"gamma 0.8 {rate_cats} mean",
    ]
    for i, s in enumerate(seqs):
        lines.append(f"tip {i} {s}")
    lines.append(f"pmatrices {len(branches)} "
                 + " ".join(["0"] * rate_cats))
    for b, m in zip(branches, pmat_idx):
        lines.append(f"{m} {b}")
    for op in ops:
        lines.append(
            f"op {op.parent_clv_index} {op.child1_clv_index} "
            f"{op.child2_clv_index} {op.child1_matrix_index} "
            f"{op.child2_matrix_index} {op.parent_scaler_index} "
            f"{op.child1_scaler_index} {op.child2_scaler_index}")
    lines.append("partials")
    lines.append(f"show_pmatrix {root.pmatrix_index} 4")
    lines.append(f"show_clv {root.clv_index} {root.scaler_index} 4")
    ref_out = _run_raw("\n".join(lines) + "\n")

    p = pll.Partition(tips, tree.inner_count, 4, sites, 1, 2 * tips - 3,
                      rate_cats, tree.inner_count)
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_category_rates(pll.compute_gamma_cats(0.8, rate_cats))
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    p.update_prob_matrices([0] * rate_cats, pmat_idx, branches)
    p.update_partials(ops)

    ours = format_pmatrix(p.get_pmatrix(root.pmatrix_index), 4)
    ours += format_clv(np.asarray(p.clv[root.clv_index]),
                       np.asarray(p.scalers[root.scaler_index]),
                       sites, 4, p.cfg.scale_threshold)
    assert ours == ref_out
    # deep caterpillar must actually have scaled sites
    assert int(np.asarray(p.scalers[root.scaler_index]).max()) > 0


def test_hardware_probe():
    info = hardware_probe()
    assert info["device_count"] >= 1
    assert info["backend"] in ("cpu", "gpu")
