"""SVG export parity: byte-level diff against the reference
(pll_utree_export_svg, utree_svg.c) on a stepwise tree with
deterministic branch lengths."""
import numpy as np

import libpll2_jax as pll
from libpll2_jax import tree as T
from libpll2_jax.parsimony import fastparsimony_stepwise
from libpll2_jax.tree.svg import SvgAttrib, export_svg

from .oracle import ORACLE_DIR, run_oracle
from .test_parity_tree import random_seqs


def _assign_lengths(tree):
    """Mirror of the oracle's svg_lengths rule."""
    for node in tree.nodes:
        for h in ((node,) if node.next is None else tuple(node.roundabout())):
            lo = min(h.node_index, h.back.node_index)
            h.length = h.back.length = 0.05 * ((lo % 10) + 1)


def test_svg_matches_reference(tmp_path):
    n_tips, sites, seed = 9, 40, 31
    rng = np.random.default_rng(seed)
    seqs = random_seqs(n_tips, sites, rng)
    labels = [f"t{i}" for i in range(n_tips)]

    out = tmp_path / "ref.svg"
    lines = [f"create {n_tips} {n_tips - 2} 4 {sites} 1 "
             f"{2 * n_tips - 3} 1 {n_tips - 2} 0", "map nt"]
    for i, s in enumerate(seqs):
        lines.append(f"tip {i} {s}")
    lines += ["fastpars_init", f"stepwise {seed}", "svg_lengths",
              f"svg {out}"]
    run_oracle("\n".join(lines) + "\n")
    ref_svg = out.read_text()

    p = pll.Partition(n_tips, n_tips - 2, 4, sites, 1, 2 * n_tips - 3, 1,
                      n_tips - 2)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    fp = pll.FastParsimony(p)
    tree, _ = fastparsimony_stepwise([fp], labels, seed)
    _assign_lengths(tree)
    ours = export_svg(tree)

    assert ours == ref_svg


def test_svg_attrib_defaults():
    a = SvgAttrib()
    assert (a.width, a.font_size, a.tip_spacing, a.precision) == \
        (1920, 12, 20, 7)
