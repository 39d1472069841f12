"""Newick export with a custom per-node serialization callback.

Mirror of /root/reference/examples/newick-export (newick-export.c:60-191):
attach data (support values; inner nodes also a random value) to every
node, then export the tree with a cb_serialize callback that prints
`label[&support=...]:length` for tips and
`label[&support=...,rvalue=...]:length` for inner nodes — the
pll_utree_export_newick(root, cb) contract.  Inner-node data is attached
to only ONE of the three round-about half-nodes; the callback searches
the roundabout for it, exactly as the reference's cb does.

Usage: python newick_export.py [newick-file]   (defaults to a demo tree)
"""
import _common  # noqa: F401
import sys

from libpll2_jax import tree as T
from libpll2_jax.utils.random import GlibcRandom

from load_utree import DEMO, load_tree_unrooted

RAND_MAX = 2**31 - 1


def cb_serialize(node: T.UNode) -> str:
    """newick-export.c:60-95 (asprintf formats, %f = 6 decimals)."""
    if node.next is not None:
        # find which half-node of the roundabout carries the data element
        nd = next(getattr(g, "data") for g in node.roundabout()
                  if getattr(g, "data", None) is not None)
        return (f"{node.label or ''}[&support={nd['support']:f},"
                f"rvalue={nd['rvalue']:f}]:{node.length:f}")
    nd = node.data
    return f"{node.label or ''}[&support={nd['support']:f}]:{node.length:f}"


def main() -> None:
    if len(sys.argv) > 2:
        sys.exit(f"syntax: {sys.argv[0]} [newick]")
    if len(sys.argv) == 2:
        utree = load_tree_unrooted(sys.argv[1], is_path=True)
    else:
        utree = load_tree_unrooted(DEMO, is_path=False)
    if utree is None or not utree.binary:
        sys.exit("Tree must be a rooted or unrooted binary.")

    rng = GlibcRandom(1)        # deterministic demo (ref uses time(NULL))

    # random support values for tip nodes
    for node in utree.nodes[:utree.tip_count]:
        node.data = {"support": rng.next() / RAND_MAX}

    # support + random value on inner nodes; the data element lives on
    # only one of the three round-about half-nodes
    for node in utree.nodes[utree.tip_count:]:
        s = rng.next() / RAND_MAX
        node.data = {"support": s, "rvalue": s * rng.next()}

    # select a random inner node as the export root
    r = rng.next() % utree.inner_count
    root = utree.nodes[utree.tip_count + r]

    print(T.export_newick(root, cb_serialize=cb_serialize))


if __name__ == "__main__":
    main()
