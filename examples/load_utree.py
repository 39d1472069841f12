"""Load a newick file as an unrooted tree, rooted or not.

Mirror of /root/reference/examples/load-utree (load-utree.c:37-89): try
parsing the input as a ROOTED newick first; on failure fall back to the
unrooted parser.  A rooted input is unrooted (pll_rtree_unroot) and its
clv/pmatrix indices reset to the template assignment.  Finally a random
inner node is selected and the tree re-exported in newick from there —
any inner node of an unrooted tree can serve as its (virtual) root.

Usage: python load_utree.py [newick-file]   (defaults to a demo tree)
"""
import _common  # noqa: F401
import sys

from libpll2_jax import tree as T
from libpll2_jax.utils.random import GlibcRandom

DEMO = "((A:0.1,B:0.2):0.3,((C:0.1,D:0.1):0.2,E:0.3):0.1);"


def load_tree_unrooted(source: str, is_path: bool) -> T.UTree:
    """Rooted-or-unrooted newick -> UTree (load-utree.c:37-63)."""
    text = open(source).read() if is_path else source
    try:
        rtree = T.parse_rtree_string(text)
    except ValueError:
        return T.parse_newick_string(text)
    utree = T.rtree_to_utree(rtree)
    # optional step if using default template clv/pmatrix assignments
    T.reset_template_indices(utree.vroot, utree.tip_count)
    return utree


def main() -> None:
    if len(sys.argv) > 2:
        sys.exit(f"syntax: {sys.argv[0]} [newick]")
    if len(sys.argv) == 2:
        utree = load_tree_unrooted(sys.argv[1], is_path=True)
    else:
        utree = load_tree_unrooted(DEMO, is_path=False)
    if utree is None or not utree.binary:
        sys.exit("Tree must be a rooted or unrooted binary.")

    # select a random inner node (deterministic glibc RNG, seed 1 — the
    # reference's unseeded random() starts from the same stream)
    rng = GlibcRandom(1)
    r = rng.next() % utree.inner_count
    root = utree.nodes[utree.tip_count + r]

    # export with the selected inner node as the virtual root
    print(T.export_newick(root))


if __name__ == "__main__":
    main()
