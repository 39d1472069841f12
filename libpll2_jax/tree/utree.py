"""Unrooted tree objects: roundabout half-node graph, traversals, and
compilation of post-order traversals into operation arrays.

Mirrors the reference's pll_unode_t / pll_utree_t semantics
(libpll-2 src/pll.h:388-411, src/utree.c):

  * an inner node of degree d is a circular list of d half-nodes sharing
    clv_index / scaler_index / label; each half-node's `back` crosses one
    edge and carries the branch length and the edge's pmatrix_index;
  * template indices (parse_utree.y:269-345): tips get node_index =
    clv_index = pmatrix_index = 0..tips-1 and scaler_index = NONE; the i-th
    inner roundabout shares clv_index = tips + i, scaler_index = i; an
    edge's pmatrix_index is the clv_index of its child-side end;
  * a post-order traversal compiles to a flat operation array plus branch
    length / pmatrix index vectors, with the root edge emitted once
    (utree.c:317-366) — the numeric engine never sees the tree.

On top of the reference semantics, `levelize` (partition.py) groups the
operation list into batches of independent updates for the device engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from ..constants import SCALE_BUFFER_NONE, TRAVERSE_POSTORDER, \
    TRAVERSE_PREORDER
from ..partition import Operation


class UNode:
    """One half-node of the roundabout representation."""
    __slots__ = ("label", "length", "node_index", "clv_index", "scaler_index",
                 "pmatrix_index", "next", "back", "data")

    def __init__(self, label: Optional[str] = None, length: float = 0.0):
        self.label = label
        self.length = length
        self.node_index = 0
        self.clv_index = 0
        self.scaler_index = SCALE_BUFFER_NONE
        self.pmatrix_index = 0
        self.next: Optional[UNode] = None
        self.back: Optional[UNode] = None
        self.data = None

    def is_tip(self) -> bool:
        return self.next is None

    def roundabout(self):
        """Iterate the half-nodes of this (inner) node, starting at self."""
        yield self
        n = self.next
        while n is not None and n is not self:
            yield n
            n = n.next

    def __repr__(self):
        return (f"UNode({self.label!r}, clv={self.clv_index}, "
                f"len={self.length})")


@dataclasses.dataclass
class UTree:
    """Wrapper with a node array and virtual root (pll_utree_t)."""
    nodes: List[UNode]           # tips first (by node_index), inner after
    vroot: UNode
    tip_count: int
    inner_count: int
    binary: bool

    @property
    def edge_count(self) -> int:
        return len(self.nodes) - 1


# --------------------------------------------------------------------------
# traversal (utree.c:394-462)
# --------------------------------------------------------------------------

def traverse(root: UNode, order: int = TRAVERSE_POSTORDER,
             cbtrav: Optional[Callable[[UNode], bool]] = None
             ) -> List[UNode]:
    """Full or pruned traversal from a virtual root (must be inner).

    The callback decides whether to descend into a subtree (partial
    traversals for CLV invalidation — utree.c:427-462).
    """
    if root.next is None:
        raise ValueError("traversal root must be an inner node")
    if cbtrav is None:
        cbtrav = lambda n: True  # noqa: E731
    out: List[UNode] = []

    def rec(node: UNode) -> None:
        if not cbtrav(node):
            return
        if order == TRAVERSE_PREORDER:
            out.append(node)
        if node.next is not None:
            snode = node.next
            while snode is not None and snode is not node:
                rec(snode.back)
                snode = snode.next
        if order == TRAVERSE_POSTORDER:
            out.append(node)

    rec(root.back)
    rec(root)
    return out


def traverse_subtree(root: UNode, order: int = TRAVERSE_POSTORDER
                     ) -> List[UNode]:
    """Traversal of ONLY the subtree behind `root` (away from root->back).

    Ends (post-order) at `root` itself; compiling the result with
    create_operations yields the operations that make root's node CLV the
    subtree's likelihood directed toward root->back — the pruned-subtree
    CLV an SPR/placement scorer needs (engine.score_placements)."""
    out: List[UNode] = []

    def rec(node: UNode) -> None:
        if order == TRAVERSE_PREORDER:
            out.append(node)
        if node.next is not None:
            snode = node.next
            while snode is not node:
                rec(snode.back)
                snode = snode.next
        if order == TRAVERSE_POSTORDER:
            out.append(node)

    rec(root)
    return out


# --------------------------------------------------------------------------
# operations compilation (utree.c:317-366)
# --------------------------------------------------------------------------

def create_operations(trav_buffer: Sequence[UNode]
                      ) -> Tuple[List[Operation], List[float], List[int]]:
    """Compile a post-order traversal into (ops, branch_lengths,
    pmatrix_indices), de-duplicating the root edge."""
    ops: List[Operation] = []
    branches: List[float] = []
    pmatrix_indices: List[int] = []
    if not trav_buffer:
        # a fully-pruned partial traversal (every CLV already valid);
        # the reference returns ops_count = matrix_count = 0 here
        # (pll_utree_create_operations on an empty buffer)
        return ops, branches, pmatrix_indices
    last_back = trav_buffer[-1].back

    for node in trav_buffer:
        if node is not last_back:
            branches.append(node.length)
            pmatrix_indices.append(node.pmatrix_index)
        if node.next is not None:
            c1 = node.next.back
            c2 = node.next.next.back
            ops.append(Operation(
                parent_clv_index=node.clv_index,
                child1_clv_index=c1.clv_index,
                child2_clv_index=c2.clv_index,
                child1_matrix_index=c1.pmatrix_index,
                child2_matrix_index=c2.pmatrix_index,
                parent_scaler_index=node.scaler_index,
                child1_scaler_index=c1.scaler_index,
                child2_scaler_index=c2.scaler_index,
            ))
    return ops, branches, pmatrix_indices


def create_pars_buildops(trav_buffer: Sequence[UNode]) -> List["ParsBuildOp"]:
    """Compile a post-order traversal into parsimony build operations
    (pll_utree_create_pars_buildops, utree.c:762-785): score indices are
    node_index-based — each inner half-node direction has its own vector."""
    from ..parsimony.sankoff import ParsBuildOp
    ops: List[ParsBuildOp] = []
    for node in trav_buffer:
        if node.next is not None:
            ops.append(ParsBuildOp(
                parent_score_index=node.node_index,
                child1_score_index=node.next.back.node_index,
                child2_score_index=node.next.next.back.node_index))
    return ops


# --------------------------------------------------------------------------
# template indices (parse_utree.y:269-345)
# --------------------------------------------------------------------------

def reset_template_indices(root: UNode, tip_count: int) -> None:
    if root.next is None:
        root = root.back

    counters = {"tip": 0, "inner_clv": tip_count, "inner_node": tip_count,
                "inner_scaler": 0}

    def rec(node: UNode, level: int) -> None:
        if node.next is None:
            node.node_index = node.clv_index = node.pmatrix_index = \
                counters["tip"]
            node.scaler_index = SCALE_BUFFER_NONE
            counters["tip"] += 1
            return
        snode = node.next if level else node
        while True:
            rec(snode.back, level + 1)
            snode = snode.next
            if snode is node:
                break
        snode = node
        while True:
            snode.node_index = counters["inner_node"]
            counters["inner_node"] += 1
            snode.clv_index = counters["inner_clv"]
            snode.scaler_index = counters["inner_scaler"]
            if snode is node and level > 0:
                snode.pmatrix_index = counters["inner_clv"]
            else:
                snode.pmatrix_index = snode.back.pmatrix_index
            snode = snode.next
            if snode is node:
                break
        counters["inner_clv"] += 1
        counters["inner_scaler"] += 1

    rec(root, 0)


def wrap_tree(root: UNode, binary_required: bool = True) -> UTree:
    """Fill the node array (tips first, then inner, in discovery order) and
    wrap into a UTree (parse_utree.y:345-436 utree_wraptree)."""
    if root.next is None:
        root = root.back

    tips: List[UNode] = []
    inners: List[UNode] = []

    def rec(node: UNode, level: int) -> None:
        if node.next is None:
            tips.append(node)
            return
        snode = node.next if level else node
        while True:
            rec(snode.back, level + 1)
            snode = snode.next
            if snode is node:
                break
        inners.append(node)

    rec(root, 0)
    tip_count, inner_count = len(tips), len(inners)
    rooted = root.next.next is root
    binary = inner_count == tip_count - (1 if rooted else 2)
    if binary_required and not binary:
        raise ValueError("input tree is not strictly bifurcating")
    return UTree(nodes=tips + inners, vroot=root, tip_count=tip_count,
                 inner_count=inner_count, binary=binary)


# --------------------------------------------------------------------------
# newick export (utree.c:250-315)
# --------------------------------------------------------------------------

def _format_length(length: float, precision: Optional[int]) -> str:
    if precision is None:
        return repr(float(length))        # shortest exact roundtrip
    return f"{length:.{precision}f}"


def export_newick(root: UNode, with_lengths: bool = True,
                  precision: Optional[int] = 6,
                  cb_serialize: Optional[Callable[[UNode], str]] = None
                  ) -> str:
    """Serialize the unrooted tree from a (virtual) root node.

    precision: decimal places for branch lengths ("%f" of the reference's
    pll_utree_export_newick = 6); None = full-precision repr (exact float
    roundtrip, used by tree search so lengths survive re-parsing).

    cb_serialize: optional callback returning the COMPLETE serialized
    token (label, annotations, branch length) for one node, replacing the
    default "label:length" — the pll_utree_export_newick(root, cb)
    contract (utree.c:162-248): applied to every node except the
    top-level root, which prints its bare label."""

    def subtree(node: UNode) -> str:
        if node.next is None:
            if cb_serialize is not None:
                return cb_serialize(node)
            s = node.label or ""
        else:
            kids = []
            snode = node.next
            while snode is not node:
                kids.append(subtree(snode.back))
                snode = snode.next
            if cb_serialize is not None:
                return "(" + ",".join(kids) + ")" + cb_serialize(node)
            s = "(" + ",".join(kids) + ")" + (node.label or "")
        if with_lengths:
            s += ":" + _format_length(node.length, precision)
        return s

    if root.next is None:
        root = root.back
    kids = [subtree(root.back)]
    snode = root.next
    while snode is not root:
        kids.append(subtree(snode.back))
        snode = snode.next
    return "(" + ",".join(kids) + ")" + (root.label or "") + ";"


# --------------------------------------------------------------------------
# ASCII render (pll_utree_show_ascii, utree.c:132-160)
# --------------------------------------------------------------------------

_INDENT_SPACE = 4


def _ascii_node_info(node: UNode, options: int) -> str:
    from ..constants import (SHOW_BRANCH_LENGTH, SHOW_CLV_INDEX, SHOW_LABEL,
                             SHOW_PMATRIX_INDEX, SHOW_SCALER_INDEX)
    s = ""
    if options & SHOW_LABEL:
        # the reference printf("%s", NULL) on unlabeled inner nodes; glibc
        # renders that as "(null)" — byte parity keeps it
        s += " " + (node.label if node.label is not None else "(null)")
    if options & SHOW_BRANCH_LENGTH:
        s += f" {node.length:f}"
    if options & SHOW_CLV_INDEX:
        s += f" {node.clv_index}"
    if options & SHOW_SCALER_INDEX:
        s += f" {node.scaler_index}"
    if options & SHOW_PMATRIX_INDEX:
        s += f" {node.pmatrix_index}"
    return s


def show_ascii(root: UNode, options: int = 0b11) -> str:
    """Render the unrooted tree as ASCII art, byte-identical to
    pll_utree_show_ascii (utree.c:132-160) which prints to stdout; here the
    text is returned (print() it for the reference behavior)."""
    if root.next is None:
        root = root.back

    def indent_level(node: UNode, indent: int) -> int:
        if node.next is None:
            return indent + 1
        snode = node.next
        ind = 0
        while snode is not node:
            ind = max(ind, indent_level(snode.back, indent + 1))
            snode = snode.next
        return ind

    max_indent = max(indent_level(root.back, 1), indent_level(root, 0))
    active = [0] * (max_indent + 1)
    active[0] = active[1] = 1
    out: List[str] = []
    pad = " " * (_INDENT_SPACE - 1)

    def rec(node: UNode, indent: int) -> None:
        out.append("".join(("|" if active[i] else " ") + pad
                           for i in range(indent)))
        line = "".join(("|" if active[i] else " ") + pad
                       for i in range(indent - 1))
        line += "+" + "-" * (_INDENT_SPACE - 1)
        if node.next is not None:
            line += "+"
        out.append(line + _ascii_node_info(node, options))
        if active[indent - 1] == 2:
            active[indent - 1] = 0
        if node.next is not None:
            snode = node.next
            while snode is not node:
                active[indent] = 2 if snode.next is node else 1
                rec(snode.back, indent + 1)
                snode = snode.next

    node = root
    while True:
        active[0] = 2 if node.next is root else 1
        rec(node.back, 1)
        node = node.next
        if node is root:
            break
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------
# structural helpers
# --------------------------------------------------------------------------

def clone_graph(root: UNode) -> UNode:
    """Deep-copy the node graph reachable from `root` (utree.c:551-633)."""
    mapping: dict[int, UNode] = {}

    def get(node: UNode) -> UNode:
        key = id(node)
        if key not in mapping:
            c = UNode(node.label, node.length)
            c.node_index = node.node_index
            c.clv_index = node.clv_index
            c.scaler_index = node.scaler_index
            c.pmatrix_index = node.pmatrix_index
            c.data = node.data
            mapping[key] = c
        return mapping[key]

    stack = [root]
    seen = set()
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        c = get(node)
        if node.next is not None and c.next is None:
            c.next = get(node.next)
            stack.append(node.next)
        if node.back is not None and c.back is None:
            c.back = get(node.back)
            stack.append(node.back)
    return mapping[id(root)]


def check_integrity(tree: UTree) -> bool:
    """Validate back-pointers, shared indices and lengths (utree.c:464-548)."""
    for node in tree.nodes:
        if node.back is not None:
            if node.back.back is not node:
                return False
            if node.length != node.back.length:
                return False
            if node.pmatrix_index != node.back.pmatrix_index:
                return False
        if node.next is not None:
            for h in node.roundabout():
                if h.clv_index != node.clv_index:
                    return False
                if h.scaler_index != node.scaler_index:
                    return False
    return True
