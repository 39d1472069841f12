"""ASCII tree render byte-parity vs pll_utree_show_ascii (the reference
renderer, driven through the oracle's ascii_utree command on the same
newick).  Options = SHOW_LABEL | SHOW_BRANCH_LENGTH (index options would
compare parser-assigned template indices, covered by test_tree.py)."""
import subprocess

import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import tree as T
from libpll2_jax.tree.utree import show_ascii

from .oracle import ensure_oracle
from .test_parity_tree import random_newick


def reference_ascii(newick: str, options: int) -> str:
    binary = ensure_oracle()
    out = subprocess.run([str(binary)],
                         input=f"ascii_utree {options} {newick}\n",
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return out.stdout.split("ascii_begin\n")[1].split("ascii_end\n")[0]


NEWICKS = [
    "((t0:0.1,t1:0.2)i1:0.05,(t2:0.3,(t3:0.15,t4:0.25):0.4):0.12,t5:0.33);",
    "(a:1,b:2,c:3);",
]


@pytest.mark.parametrize("newick", NEWICKS)
def test_ascii_byte_parity(newick):
    tree = T.parse_newick_string(newick)
    ours = show_ascii(tree.vroot, pll.SHOW_LABEL | pll.SHOW_BRANCH_LENGTH)
    assert ours == reference_ascii(newick, 3)


def test_ascii_byte_parity_random():
    rng = np.random.default_rng(13)
    newick = random_newick(17, rng)
    tree = T.parse_newick_string(newick)
    # re-export so both sides read the same 6-decimal lengths
    canon = T.export_newick(tree.vroot)
    tree2 = T.parse_newick_string(canon)
    ours = show_ascii(tree2.vroot, pll.SHOW_LABEL | pll.SHOW_BRANCH_LENGTH)
    assert ours == reference_ascii(canon, 3)


def test_rtree_ascii_byte_parity():
    from libpll2_jax.tree.rtree import show_ascii_rtree
    nwk = ("((t0:0.1,t1:0.2)i1:0.05,"
           "(t2:0.3,(t3:0.15,t4:0.25):0.4)x:0.12)r;")
    binary = ensure_oracle()
    out = subprocess.run([str(binary)],
                         input=f"ascii_rtree 3 {nwk}\n",
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    ref = out.stdout.split("ascii_begin\n")[1].split("ascii_end\n")[0]
    rt = T.parse_rtree_string(nwk)
    ours = show_ascii_rtree(rt.root,
                            pll.SHOW_LABEL | pll.SHOW_BRANCH_LENGTH)
    assert ours == ref
