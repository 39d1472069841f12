"""Production-scale ML SPR search: one fixed-shape device program scores
EVERY (prune, regraft) pair, for any topology of a given tip count.

The reference's search mechanics — partial traversals that recompute only
the invalidated region after a move (utree.c:427-462,
examples/partial-traversal/partial.c:365-463) and cheap move/rollback
loops (utree_moves.c:119-254) — exist to amortize host-side CLV work.
On an accelerator the search must instead amortize XLA *compilation*: a
search visits thousands of topologies and each fresh program costs
seconds to compile, dwarfing the numeric work.

Two ideas make every SPR round hit the jit cache:

1. **Runtime topology.**  The level-batched operation tensor, edge-row
   table and pmatrix-slot vector are passed as *runtime arrays* (indices
   are data, not constants), padded to size buckets, so every topology of
   the same tip count compiles to the SAME program.

2. **The gap-tip identity.**  Pruning subtree S at node u leaves a
   remainder tree whose directional CLVs equal those of the ORIGINAL
   topology with S's tips replaced by the gap state: an all-ones CLV
   stays all-ones through any P (rows of expm(Qt) sum to 1), so S
   contributes a neutral factor at u, and the two half-edges (a,u),(u,b)
   chain into the merainder's merged edge (a,b) exactly because
   P(t1)·P(t2) = P(t1+t2).  Scalers inside S stay 0 (ones never rescue).
   Hence remainder CLVs for EVERY prune candidate come from the same
   fixed-shape sweep with a different tip mask — no per-candidate
   topology, no recompilation, exact likelihoods.

A round therefore runs as ONE device call:
  base sweep (all 2E directional messages = every pruned-subtree CLV)
  → per candidate: gapped sweep (remainder messages)
  → per remainder edge: regraft score with Newton-optimized attachment
    branch (sumtable machinery, core_derivatives.c:321-471 semantics).

Host-side per round: O(n²) numpy bookkeeping + the move application
(graph surgery, moves.py).  Applies all non-conflicting improving moves
(RAxML-style batch), verifies the combined result exactly, and falls
back to the single best move (whose score IS its exact post-move logL)
if the batch interacted destructively — logL is monotone by construction.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import engine
from .config import PartitionConfig
from .constants import gap_state
from .ops import derivatives as derivatives_ops
from .ops import likelihood as likelihood_ops
from .ops import partials as partials_ops
from .ops import pmatrix as pmatrix_ops
from .tree import moves, parse_newick_string
from .tree.utree import UTree, export_newick, traverse_subtree


def _pad_level_ops(level_ops: np.ndarray, cfg: PartitionConfig,
                   min_shape: Optional[Tuple[int, int]] = None
                   ) -> np.ndarray:
    """Pad [L, W, 8] to bucketed (L, W) so different topologies of the same
    tip count share one device program (no-op rows write the scratch
    slots; no-op levels are entire rows of them).

    min_shape: carry-forward floor — a hill-climb passes the previous
    topology's padded shape so buckets only ever GROW and successive
    rounds keep hitting the jit cache even as the tree's depth drifts."""
    L, W, _ = level_ops.shape
    # ladder bucketing with headroom (see _ladder): every (Lb, Wb)
    # change recompiles the score+smooth+verify programs together, and
    # L/W DRIFT in opposite
    # directions over a search (random starts are deep and narrow; ML
    # trees shallow and wide)
    Lb = _ladder(max(L, 1))
    Wb = _ladder(max(W, 1))
    if min_shape is not None:
        Lb, Wb = max(Lb, min_shape[0]), max(Wb, min_shape[1])
    noop = np.array([cfg.clv_scratch, cfg.clv_scratch, cfg.clv_scratch,
                     0, 0, cfg.scaler_scratch, cfg.scaler_zero,
                     cfg.scaler_zero], dtype=np.int32)
    out = np.broadcast_to(noop, (Lb, Wb, 8)).copy()
    out[:L, :W] = level_ops
    return out


def _ladder(n: int, margin: float = 1.25) -> int:
    """Round a shape dimension UP a coarse ladder with headroom.

    Fused-round program shapes must stabilize across rounds (every
    change costs a recompile); a 25%
    margin plus coarsening steps makes the first round's shapes an
    upper bound for almost every later round."""
    import math
    n = int(math.ceil(n * margin))
    for step, cap in ((16, 64), (32, 128), (64, 256), (128, 1 << 30)):
        if n <= cap:
            return -(-n // step) * step
    raise AssertionError


@dataclasses.dataclass
class BallGroup:
    """One ball-size bucket of prune candidates (radius-limited scoring).

    Ball sizes are wildly skewed (an interior candidate's radius-K ball has
    ~2^K regraft edges; a near-leaf candidate's has a handful), so padding
    every candidate to the global max wastes ~4x device work.  Candidates
    are bucketed by ball size into FIXED-size groups (sizes depend only on
    C, so shapes stay jit-stable across rounds), each padded only to its
    own max widths."""
    cand_ids: np.ndarray                   # [Cg] global candidate positions
    ball_levels: Tuple[np.ndarray, ...]    # K arrays [Cg, W_d, 12] int32
    score_ops: np.ndarray                  # [Cg, Vg, 12] int32 (valid ops)
    sub_rows: np.ndarray                   # [Cg, 2] int32
    edge_pos: np.ndarray                   # [Cg] int32 (pruned edge)
    merge_edges: np.ndarray                # [Cg, 2] int32

    @property
    def shape_key(self) -> tuple:
        return (tuple(a.shape[1] for a in self.ball_levels),
                self.score_ops.shape[1])


@dataclasses.dataclass
class SprProgram:
    """Host-compiled SPR search state for one topology.

    All device-visible arrays have shapes that depend only on the tip
    count (and the level-op buckets), so successive topologies reuse the
    same compiled XLA programs."""
    tree: UTree
    cfg: PartitionConfig            # caller's config
    cfg_ext: PartitionConfig        # row space extended to message slots
    # device data (numpy; jnp-converted per call)
    level_ops: np.ndarray           # [Lb, Wb, 8] int32
    edge_rows: np.ndarray           # [E, 4] int32
    pmatrix_slots: np.ndarray       # [E] int32
    branch_lengths: np.ndarray      # [E] f64
    color_masks: np.ndarray         # [4, E] bool (proper edge coloring)
    root_edge: int
    # candidates (C = 3*tips - 6, fixed per tip count)
    cand_edge: np.ndarray           # [C] int32
    cand_sub_rows: np.ndarray       # [C, 2] int32 (clv row, scaler row)
    cand_gap_mask: np.ndarray       # [C, tips] bool
    cand_edge_valid: np.ndarray     # [C, E] bool (all-False = invalid cand)
    # host metadata for applying moves
    cand_prune_node: np.ndarray     # [C] node_index of remainder half-node p
    cand_affected: List[frozenset]  # clv-index sets for conflict detection
    cand_hard: List[frozenset]      # clv sets the SPR surgery itself touches
    edge_endpoints: np.ndarray      # [E, 2] clv indices of edge endpoints
    edge_node: np.ndarray           # [E] node_index of the A-side half-node
    # radius-limited scoring (present when compiled with radius=K):
    radius: Optional[int] = None
    ball_groups: Optional[Tuple[BallGroup, ...]] = None
    ball_slots: Optional[int] = None         # scratch rows per candidate


# ball-op column layout (one row = one outward "changed message" op,
# which is ALSO one (candidate, regraft-edge) score slot):
BOP_PARENT = 0        # scratch slot this op writes
BOP_C1_ROW = 1        # base msg row (seed) | scratch slot (deeper)
BOP_C1_SCAL = 2       # base scaler row (seed) | scratch slot (deeper)
BOP_C1_SEED = 3       # 1 -> c1 is a base row propagated through MERGED P
BOP_C1_PM = 4         # pmatrix slot of the in-edge (ignored when seed)
BOP_C2_ROW = 5        # base msg row of the side subtree
BOP_C2_SCAL = 6
BOP_C2_PM = 7
BOP_SC_ROW = 8        # base msg row facing the changed message across e
BOP_SC_SCAL = 9
BOP_EDGE = 10         # edge position of the regraft target
BOP_VALID = 11
BOP_COLS = 12


def compile_spr(tree: UTree, cfg: PartitionConfig,
                min_level_shape: Optional[Tuple[int, int]] = None,
                radius: Optional[int] = None,
                min_group_shapes: Optional[Tuple[tuple, ...]] = None,
                min_ball_slots: Optional[int] = None
                ) -> SprProgram:
    """Compile one topology into runtime search arrays + candidate table."""
    if cfg.per_rate_scalers and cfg.asc_bias != 0:
        raise ValueError("per-rate scalers cannot combine with asc bias "
                         "(reference partition-creation rule)")
    full = engine.compile_tree_full(tree, cfg)
    cfg_ext = full.cfg_ext
    level_ops = _pad_level_ops(full.level_ops, cfg_ext,
                               min_shape=min_level_shape)

    E = len(full.pmatrix_indices)
    n = tree.tip_count

    # A-side half-node of each edge, matching compile_tree_full's edge_rows
    by_pmatrix = {}
    seen = set()
    for node in tree.nodes:
        for g in ([node] if node.next is None else list(node.roundabout())):
            key = tuple(sorted((g.node_index, g.back.node_index)))
            if key in seen:
                continue
            seen.add(key)
            by_pmatrix[g.back.pmatrix_index] = g
    # match compile_tree_full's canonical edge orientation (parent side
    # first: the end whose clv_index differs from the pmatrix index)
    edge_half = [by_pmatrix[int(p)] for p in full.pmatrix_indices]
    edge_half = [g.back if g.clv_index == int(p) else g
                 for g, p in zip(edge_half, full.pmatrix_indices)]
    edge_endpoints = np.array([[g.clv_index, g.back.clv_index]
                               for g in edge_half], np.int32)
    edge_node = np.array([g.node_index for g in edge_half], np.int32)

    # behind-set DP: ONE bool mask per half-edge instead of O(n^2)
    # python subtree traversals (0.4 s/round at 256 taxa, and rebuilt
    # every round) — S(h) = {clv(h)} | S(h.next.back) | S(h.next2.back)
    nrows = int(max(edge_endpoints.max(), n - 1)) + 1
    behind: Dict[int, np.ndarray] = {}

    def behind_of(h0):
        out = behind.get(h0.node_index)
        if out is not None:
            return out
        stack = [(h0, False)]
        while stack:
            h, ready = stack.pop()
            if h.node_index in behind:
                continue
            if h.next is None:
                r = np.zeros(nrows, bool)
                r[h.clv_index] = True
                behind[h.node_index] = r
                continue
            kids = (h.next.back, h.next.next.back)
            if not ready:
                stack.append((h, True))
                stack.extend((k, False) for k in kids
                             if k.node_index not in behind)
            else:
                r = behind[kids[0].node_index] \
                    | behind[kids[1].node_index]
                r[h.clv_index] = True
                behind[h.node_index] = r
        return behind[h0.node_index]

    cands = []
    for i, g in enumerate(edge_half):
        for side, (sub_h, p) in enumerate(((g, g.back), (g.back, g))):
            # prune the subtree behind sub_h (containing node(sub_h));
            # p is the remainder-side endpoint and must be inner
            if p.next is None:
                continue
            bh = behind_of(sub_h)
            k = int(bh[:n].sum())
            valid = (n - k) >= 4
            sub_rows = full.edge_rows[i, 0:2] if side == 0 \
                else full.edge_rows[i, 2:4]
            gap = bh[:n].copy()
            # regraft targets: edges fully inside the remainder and not
            # incident to p's node (those reconstruct the same topology)
            if valid:
                ev = ~(bh[edge_endpoints[:, 0]]
                       | bh[edge_endpoints[:, 1]]
                       | (edge_endpoints[:, 0] == p.clv_index)
                       | (edge_endpoints[:, 1] == p.clv_index))
            else:
                ev = np.zeros(E, bool)
            # conservative conflict set: pruned nodes + p's node + p's
            # other neighbors (any overlap can stale a score); the HARD
            # set is only the surgery anchor — p's node and the pruned
            # subtree's root (one prune per anchor; everything else a
            # batch can break is caught by the apply-time applicability
            # checks and the exact verify ladder)
            hard = {p.clv_index, p.back.clv_index}
            affected = set(np.nonzero(bh)[0].tolist()) | hard \
                | {h.back.clv_index for h in p.roundabout()}
            cands.append((i, sub_rows, gap, ev, p.node_index,
                          frozenset(affected), frozenset(hard)))

    C = len(cands)
    assert C == 3 * n - 6, (C, n)

    ball_groups = ball_slots = None
    if radius is not None:
        # Radius-limited exact scoring (the reference clients' bounded
        # partial traversals, examples/partial-traversal/partial.c:365-463,
        # as fixed-shape batched ops).  Pruning S at p leaves every message
        # directed AWAY from p unchanged; the changed ones — the remainder
        # messages FACING each regraft edge from the prune side — form an
        # outward recursion from the merged edge, consuming only base
        # messages as side inputs.  Each op doubles as one (candidate,
        # regraft edge) score slot, so a round costs O(n * 2^K) message
        # ops instead of O(n^2).
        inner_nodes = [nd for nd in tree.nodes if nd.next is not None]
        msg_half = [g for nd in inner_nodes for g in nd.roundabout()]
        msg_row = {g.node_index: cfg_ext.tips + k
                   for k, g in enumerate(msg_half)}
        msg_scal = {g.node_index: k for k, g in enumerate(msg_half)}
        pos_of_pm = {int(p): i for i, p in enumerate(full.pmatrix_indices)}
        zero_row = cfg_ext.scaler_zero

        def incoming(s):
            """(msg row, scaler row, pmatrix slot) arriving through s."""
            if s.back.next is None:
                return s.back.clv_index, zero_row, s.back.pmatrix_index
            return (msg_row[s.back.node_index],
                    msg_scal[s.back.node_index], s.back.pmatrix_index)

        def build_ball(p, valid):
            """Levelized changed-message ops for pruning at half-edge p."""
            levels: List[List[List[int]]] = [[] for _ in range(radius)]
            slot_of: Dict[int, int] = {}
            n_slots = 0
            if not valid:
                return levels, 0
            sides = [(p.next, p.next.next), (p.next.next, p.next)]
            frontier = []
            for h_in, h_far in sides:
                x = h_in.back                   # half-node back toward p
                if x.next is None:
                    continue
                far_row, far_scal, _ = incoming(h_far)
                outs = [g for g in x.roundabout() if g is not x]
                for g in outs:
                    o = next(s for s in x.roundabout()
                             if s is not x and s is not g)
                    o_row, o_scal, o_pm = incoming(o)
                    sc_row, sc_scal, _ = incoming(g)
                    slot = n_slots
                    n_slots += 1
                    slot_of[g.node_index] = slot
                    levels[0].append([
                        slot, far_row, far_scal, 1, 0,
                        o_row, o_scal, o_pm,
                        sc_row, sc_scal,
                        pos_of_pm[int(g.back.pmatrix_index)], 1])
                    if radius > 1 and g.back.next is not None:
                        frontier.append((g, 1))
            while frontier:
                g_prev, d = frontier.pop()
                if d >= radius:
                    continue
                v_in = g_prev.back              # entered node via this half
                in_row = slot_of[g_prev.node_index]
                in_pm = int(v_in.back.pmatrix_index)
                for gg in v_in.roundabout():
                    if gg is v_in:
                        continue
                    o = next(s for s in v_in.roundabout()
                             if s is not v_in and s is not gg)
                    o_row, o_scal, o_pm = incoming(o)
                    sc_row, sc_scal, _ = incoming(gg)
                    slot = n_slots
                    n_slots += 1
                    slot_of[gg.node_index] = slot
                    levels[d].append([
                        slot, in_row, in_row, 0, in_pm,
                        o_row, o_scal, o_pm,
                        sc_row, sc_scal,
                        pos_of_pm[int(gg.back.pmatrix_index)], 1])
                    if gg.back.next is not None:
                        frontier.append((gg, d + 1))
            return levels, n_slots

        def renumber_slots(levels):
            """Remap scratch slots to FLAT level-major positions, so the
            away message of score row v lives in scratch slot v — the
            Pallas edge scorer then reads away operands as consecutive
            blocks with no dynamic index maps."""
            mapping = {}
            pos = 0
            for lv in levels:
                for row in lv:
                    mapping[row[BOP_PARENT]] = pos
                    pos += 1
            for lv in levels:
                for row in lv:
                    row[BOP_PARENT] = mapping[row[BOP_PARENT]]
                    if row[BOP_C1_SEED] == 0:
                        row[BOP_C1_ROW] = mapping[row[BOP_C1_ROW]]
                        row[BOP_C1_SCAL] = mapping[row[BOP_C1_SCAL]]

        balls = []
        ball_slots = 1 if min_ball_slots is None else int(min_ball_slots)
        for i, g in enumerate(edge_half):
            for sub_h, p in ((g, g.back), (g.back, g)):
                if p.next is None:
                    continue
                k = int(behind_of(sub_h)[:n].sum())
                levels, n_slots = build_ball(p, (n - k) >= 4)
                renumber_slots(levels)
                ball_slots = max(ball_slots, n_slots + 1)
                balls.append(levels)
        assert len(balls) == C

        # size the scratch pool by the widest padded score table, ladder
        # bucketed: ball_slots is a static arg of the fused round
        # program, so its growth forces a recompile
        v_bound = max((sum(len(lv) for lv in levels) for levels in balls),
                      default=0)
        struct = sum(4 << d for d in range(radius))
        ball_slots = max(ball_slots,
                         min(_ladder(max(v_bound, 1)),
                             -(-struct // 16) * 16) + 1)
        dump = ball_slots - 1
        # level-0 rows are ALL seeds and deeper rows NEVER are (build_ball
        # construction) — _score_group exploits this with a static
        # per-level branch instead of a seed-select over two gathers, so
        # the padding row must match its level's kind: seed noop reads
        # base row 0; deep noop reads the dump scratch slot (zeros in,
        # zeros out — never NaN)
        noop = np.asarray(
            [dump, 0, zero_row, 1, 0, 0, zero_row, 0, 0, zero_row, 0, 0],
            np.int32)
        noop_deep = np.asarray(
            [dump, dump, dump, 0, 0, 0, zero_row, 0, 0, zero_row, 0, 0],
            np.int32)
        merge_edges = np.zeros((C, 2), np.int32)
        ci = 0
        for i, g in enumerate(edge_half):
            for sub_h, p in ((g, g.back), (g.back, g)):
                if p.next is None:
                    continue
                merge_edges[ci] = (
                    pos_of_pm[int(p.next.back.pmatrix_index)],
                    pos_of_pm[int(p.next.next.back.pmatrix_index)])
                ci += 1

        # ---- ball-size buckets (see BallGroup) --------------------------
        valid_counts = np.asarray(
            [sum(len(lv) for lv in levels) for levels in balls])
        order = np.argsort(-valid_counts, kind="stable")
        if C >= 48:
            s0, s1 = -(-C // 8), -(-3 * C // 8)
            sizes = (s0, s1, C - s0 - s1)
        else:
            sizes = (C,)
        all_sub_rows = np.stack([c[1] for c in cands]).astype(np.int32)
        all_edge_pos = np.array([c[0] for c in cands], np.int32)
        groups = []
        off = 0
        for gi, sz in enumerate(sizes):
            ids = np.sort(order[off:off + sz])
            off += sz
            # pad each group to a multiple of the scorer's candidate
            # chunk (padding rows are all-noop / valid=0, masked out at
            # flatten time)
            sz0 = sz
            szp = -(-sz // 16) * 16
            ids = np.concatenate([ids, np.full(szp - sz, ids[0],
                                               ids.dtype)])
            sz = szp
            pin = (min_group_shapes[gi]
                   if min_group_shapes is not None
                   and len(min_group_shapes) == len(sizes)
                   and len(min_group_shapes[gi][0]) == radius else None)
            w_ds = [max((len(balls[c][d]) for c in ids), default=0)
                    for d in range(radius)]
            # LADDER bucketing with headroom, capped by the structural
            # per-level bound (level d holds <= 4*2^d messages):
            # every shape change of the fused round program costs a
            # recompile, so shapes must SATURATE after the first round,
            # not ratchet by 16 every round
            bound = [4 << d for d in range(radius)]
            w_ds = [min(_ladder(max(w, 1)), -(-b // 16) * 16)
                    for w, b in zip(w_ds, bound)]
            if pin is not None:
                w_ds = [max(w, int(m)) for w, m in zip(w_ds, pin[0])]
            lvls = []
            for d, wd in enumerate(w_ds):
                arr = np.tile(noop if d == 0 else noop_deep, (sz, wd, 1))
                for k, c in enumerate(ids[:sz0]):
                    lv = balls[c][d]
                    if lv:
                        arr[k, :len(lv)] = np.asarray(lv, np.int32)
                lvls.append(arr)
            vg = max((int(valid_counts[c]) for c in ids), default=0)
            vg = min(_ladder(max(vg, 1)),
                     -(-sum(bound) // 16) * 16)
            if pin is not None:
                vg = max(vg, int(pin[1]))
            sco = np.tile(noop, (sz, vg, 1))
            for k, c in enumerate(ids[:sz0]):
                flat = [row for lv in balls[c] for row in lv]
                if flat:
                    sco[k, :len(flat)] = np.asarray(flat, np.int32)
            groups.append(BallGroup(
                cand_ids=ids.astype(np.int32),
                ball_levels=tuple(lvls),
                score_ops=sco,
                sub_rows=all_sub_rows[ids],
                edge_pos=all_edge_pos[ids],
                merge_edges=merge_edges[ids],
            ))
        ball_groups = tuple(groups)

    return SprProgram(
        tree=tree, cfg=cfg, cfg_ext=cfg_ext,
        level_ops=level_ops,
        edge_rows=full.edge_rows,
        pmatrix_slots=np.asarray(full.pmatrix_indices, np.int32),
        branch_lengths=np.asarray(full.default_branch_lengths, np.float64),
        color_masks=np.stack([np.asarray(full.edge_colors) == c
                              for c in range(4)]),
        root_edge=full.root_edge,
        cand_edge=np.array([c[0] for c in cands], np.int32),
        cand_sub_rows=np.stack([c[1] for c in cands]).astype(np.int32),
        cand_gap_mask=np.stack([c[2] for c in cands]),
        cand_edge_valid=np.stack([c[3] for c in cands]),
        cand_prune_node=np.array([c[4] for c in cands], np.int32),
        cand_affected=[c[5] for c in cands],
        cand_hard=[c[6] for c in cands],
        edge_endpoints=edge_endpoints,
        edge_node=edge_node,
        radius=radius,
        ball_groups=ball_groups,
        ball_slots=ball_slots,
    )


# --------------------------------------------------------------------------
# runtime-topology device programs (shapes fixed per tip count)
# --------------------------------------------------------------------------


def _sweep_rt(cfg: PartitionConfig, model, level_ops, pmat_slots,
              branch_lengths, tipchars, pmatrix=None):
    """Directional-message sweep with the topology as runtime data.

    cfg is the EXTENDED config (message row space).  Identical math to
    engine._sweep_all; only the op tensor / slot vector are traced."""
    dtype = cfg.dtype
    R, S, T = cfg.rate_cats, cfg.states, tipchars.shape[-1]
    if pmatrix is None:
        pmats = pmatrix_ops.compute_pmatrices(
            branch_lengths, model.eigenvals, model.eigenvecs,
            model.inv_eigenvecs, model.rates, model.prop_invar,
            model.params_indices, dtype=dtype)
        num_slots = 2 * cfg.tips - 2     # template pmatrix index space
        pmatrix = jnp.zeros((num_slots, R, S, S), dtype)
        pmatrix = pmatrix.at[pmat_slots].set(pmats)

    clv = jnp.zeros((cfg.num_clvs + 1, R, S, T), dtype)
    tip_clv = engine.expand_tipchars(tipchars, S, dtype)
    clv = clv.at[:cfg.tips].set(
        jnp.broadcast_to(tip_clv[:, None, :, :], (cfg.tips, R, S, T)))
    if cfg.per_rate_scalers:
        scalers = jnp.zeros((cfg.scale_buffers + 2, R, T), jnp.int32)
    else:
        scalers = jnp.zeros((cfg.scale_buffers + 2, T), jnp.int32)
    clv, scalers = partials_ops.update_partials(
        clv, scalers, pmatrix, level_ops, cfg)
    return clv, scalers, pmatrix


@functools.partial(jax.jit, static_argnames=("cfg", "newton_iters"))
def _spr_all_scores(cfg: PartitionConfig, model, level_ops, edge_rows,
                    pmat_slots, branch_lengths, tipchars, pattern_weights,
                    invariant, cand_edge, cand_sub_rows, cand_gap_mask,
                    cand_edge_valid, newton_iters: int = 5):
    """Exact post-SPR log-likelihood of every (prune candidate, regraft
    edge) pair: ([C, E] scores, [C, E] Newton-optimized attachment branch).

    cfg is the extended config.  Invalid pairs score -inf."""
    dtype = cfg.dtype
    R, S = cfg.rate_cats, cfg.states
    E = edge_rows.shape[0]
    gap = jnp.asarray(gap_state(S), tipchars.dtype)

    base_clv, base_scal, pmatrix = _sweep_rt(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    halves = pmatrix_ops.compute_pmatrices(
        branch_lengths * 0.5, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=dtype)                    # [E, R, S, S]
    evecs = model.eigenvecs[model.params_indices]
    inv_evecs = model.inv_eigenvecs[model.params_indices]
    evals = model.eigenvals[model.params_indices]
    hi = jax.lax.Precision.HIGHEST

    def per_cand(c):
        gapped = jnp.where(cand_gap_mask[c][:, None], gap, tipchars)
        rem_clv, rem_scal, _ = _sweep_rt(
            cfg, model, level_ops, pmat_slots, branch_lengths, gapped,
            pmatrix=pmatrix)
        sub_clv = base_clv[cand_sub_rows[c, 0]]
        sub_scal = base_scal[cand_sub_rows[c, 1]]
        t3_0 = branch_lengths[cand_edge[c]]

        def per_edge(e):
            rows = edge_rows[e]
            ph = halves[e]
            ta = jnp.einsum("rij,rjt->rit", ph, rem_clv[rows[0]],
                            preferred_element_type=dtype, precision=hi)
            tb = jnp.einsum("rij,rjt->rit", ph, rem_clv[rows[2]],
                            preferred_element_type=dtype, precision=hi)
            clvp = ta * tb                                   # [R, S, T]
            if cfg.per_rate_scalers:
                # relative (capped) per-rate scalers fold into the
                # sumtable; the site MIN is the absolute correction
                # (core_derivatives.c:418-460 protocol)
                sp = rem_scal[rows[1]] + rem_scal[rows[3]]   # [R, T]
                st = derivatives_ops.update_sumtable(
                    clvp, sub_clv, sp, sub_scal, evecs, inv_evecs,
                    model.cat_freqs, cfg)
                scal = jnp.min(sp + sub_scal, axis=0)        # [T]
            else:
                scal = rem_scal[rows[1]] + rem_scal[rows[3]] + sub_scal
                st = derivatives_ops.update_sumtable(
                    clvp, sub_clv, None, None, evecs, inv_evecs,
                    model.cat_freqs, cfg, asc_scalers=scal)

            def newton_step(_, t):
                d1, d2 = derivatives_ops.likelihood_derivatives(
                    st, t, model.rates, evals, model.cat_pinv,
                    model.rate_weights, model.cat_freqs, invariant,
                    pattern_weights, cfg)
                newton = t - d1 / d2
                fallback = jnp.where(d1 > 0, t * 0.5, t * 2.0)
                t_new = jnp.where(d2 > 0, newton, fallback)
                # f32 pathologies on terrible topologies can make (d1, d2)
                # overflow to inf/nan; a nan step would poison the branch
                # and every score downstream — hold the current value
                t_new = jnp.where(jnp.isfinite(t_new), t_new, t)
                return jnp.clip(t_new, 1e-8, 100.0)

            t3 = jax.lax.fori_loop(0, newton_iters, newton_step, t3_0)
            score = derivatives_ops.sumtable_loglikelihood(
                st, t3, model.rates, evals, model.cat_pinv,
                model.rate_weights, model.cat_freqs, invariant,
                pattern_weights, scal, cfg)
            return score, t3

        scores, t3s = jax.lax.map(per_edge, jnp.arange(E), batch_size=32)
        scores = jnp.where(cand_edge_valid[c], scores, -jnp.inf)
        return scores, t3s

    return jax.lax.map(per_cand, jnp.arange(cand_edge.shape[0]))


def _spr_base(cfg: PartitionConfig, model, level_ops, pmat_slots,
              branch_lengths, tipchars):
    """Shared per-round device state for the ball-group scorers: the base
    directional-message sweep and the half-length P matrices.  Hoisted out
    of _spr_ball_scores so the (per-ball-size-group) scorer calls reuse
    ONE sweep; the big arrays stay device-resident between calls."""
    base_clv, base_scal, pmatrix = _sweep_rt(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    halves = pmatrix_ops.compute_pmatrices(
        branch_lengths * 0.5, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=cfg.dtype)
    return base_clv, base_scal, pmatrix, halves


_spr_base_jit = jax.jit(_spr_base, static_argnames=("cfg",))


def _score_group(cfg: PartitionConfig, model, base_clv, base_scal,
                 pmatrix, halves, branch_lengths, pattern_weights,
                 invariant, ball_levels, score_ops, sub_rows, edge_pos,
                 merge_edges, ball_slots: int,
                 newton_iters: int = 5, cand_batch: int = 16,
                 score_batch: int = 104):
    """Radius-limited exact SPR scores of ONE ball-size group:
    ([Cg, Vg] scores, [Cg, Vg] t3).

    Per candidate, runs the outward changed-message recursion over its
    jagged ball levels (seeded through the merged edge's
    P(t1+t2) = P(t1)P(t2)) and scores each valid ball edge (the compacted
    [Cg, Vg] score table) with the Newton-refined attachment branch —
    identical math to _spr_all_scores restricted to the radius-K ball.

    cand_batch candidates run vmapped per map step: serial per-candidate
    dispatch leaves the device idle between tiny [W, R, S, T] programs;
    batching widens every einsum / Newton reduction by cand_batch.  The
    recursion and the scoring run under the named scopes "ball_recursion"
    and "edge_scoring", which profiles attribute device time by."""
    dtype = cfg.dtype
    R, S = cfg.rate_cats, cfg.states
    T = base_clv.shape[-1]
    hi = jax.lax.Precision.HIGHEST

    evecs = model.eigenvecs[model.params_indices]
    inv_evecs = model.inv_eigenvecs[model.params_indices]
    evals = model.eigenvals[model.params_indices]
    thresh = jnp.asarray(cfg.scale_threshold, dtype)
    factor = jnp.asarray(cfg.scale_factor, dtype)

    @jax.named_scope("ball_recursion")
    def recurse_one(c):
        """Ball recursion for candidate c -> (scratch [slots, R, S, T],
        sscr [slots, T], sub_scal [T], t3_0)."""
        m = merge_edges[c]
        merged = pmatrix_ops.compute_pmatrices(
            (branch_lengths[m[0]] + branch_lengths[m[1]])[None],
            model.eigenvals, model.eigenvecs, model.inv_eigenvecs,
            model.rates, model.prop_invar, model.params_indices,
            dtype=dtype)[0]                                # [R, S, S]
        sub_scal = base_scal[sub_rows[c, 1]]
        t3_0 = branch_lengths[edge_pos[c]]

        scratch = jnp.zeros((ball_slots, R, S, T), dtype)
        if cfg.per_rate_scalers:
            sscr = jnp.zeros((ball_slots, R, T), jnp.int32)
        else:
            sscr = jnp.zeros((ball_slots, T), jnp.int32)
        for d, lv_all in enumerate(ball_levels):           # static unroll
            lv = lv_all[c]                                 # [W_d, 12]
            if d == 0:
                # seed level: c1 is a base message propagated through the
                # merged edge's P (all rows, by construction) — one
                # gather, no select
                c1 = base_clv[lv[:, BOP_C1_ROW]]
                s1 = base_scal[lv[:, BOP_C1_SCAL]]
                p1 = jnp.broadcast_to(merged[None],
                                      (lv.shape[0],) + merged.shape)
            else:
                c1 = scratch[lv[:, BOP_C1_ROW]]
                s1 = sscr[lv[:, BOP_C1_SCAL]]
                p1 = pmatrix[lv[:, BOP_C1_PM]]
            c2 = base_clv[lv[:, BOP_C2_ROW]]
            s2 = base_scal[lv[:, BOP_C2_SCAL]]
            p2 = pmatrix[lv[:, BOP_C2_PM]]
            left = jnp.einsum("wrij,wrjt->writ", p1, c1,
                              preferred_element_type=dtype, precision=hi)
            right = jnp.einsum("wrij,wrjt->writ", p2, c2,
                               preferred_element_type=dtype, precision=hi)
            parent = left * right
            if cfg.per_rate_scalers:
                mask = jnp.all(parent < thresh, axis=2)    # [W, R, T]
                parent = jnp.where(mask[:, :, None, :], parent * factor,
                                   parent)
            else:
                mask = jnp.all(parent < thresh, axis=(1, 2))   # [W, T]
                parent = jnp.where(mask[:, None, None, :],
                                   parent * factor, parent)
            snew = s1 + s2 + mask.astype(jnp.int32)
            scratch = scratch.at[lv[:, BOP_PARENT]].set(parent)
            sscr = sscr.at[lv[:, BOP_PARENT]].set(snew)
        return scratch, sscr, sub_scal, t3_0

    def per_cand(c):
        scratch, sscr, sub_scal, t3_0 = recurse_one(c)
        sub_clv = base_clv[sub_rows[c, 0]]

        @jax.named_scope("edge_scoring")
        def per_slot(row):
            away = scratch[row[BOP_PARENT]]
            away_s = sscr[row[BOP_PARENT]]
            other = base_clv[row[BOP_SC_ROW]]
            other_s = base_scal[row[BOP_SC_SCAL]]
            ph = halves[row[BOP_EDGE]]
            ta = jnp.einsum("rij,rjt->rit", ph, away,
                            preferred_element_type=dtype, precision=hi)
            tb = jnp.einsum("rij,rjt->rit", ph, other,
                            preferred_element_type=dtype, precision=hi)
            clvp = ta * tb
            if cfg.per_rate_scalers:
                sp = away_s + other_s                       # [R, T]
                st = derivatives_ops.update_sumtable(
                    clvp, sub_clv, sp, sub_scal, evecs, inv_evecs,
                    model.cat_freqs, cfg)
                scal = jnp.min(sp + sub_scal, axis=0)       # [T]
            else:
                scal = away_s + other_s + sub_scal
                st = derivatives_ops.update_sumtable(
                    clvp, sub_clv, None, None, evecs, inv_evecs,
                    model.cat_freqs, cfg, asc_scalers=scal)

            def newton_step(_, t):
                d1, d2 = derivatives_ops.likelihood_derivatives(
                    st, t, model.rates, evals, model.cat_pinv,
                    model.rate_weights, model.cat_freqs, invariant,
                    pattern_weights, cfg)
                newton = t - d1 / d2
                fallback = jnp.where(d1 > 0, t * 0.5, t * 2.0)
                t_new = jnp.where(d2 > 0, newton, fallback)
                # f32 pathologies on terrible topologies can make (d1, d2)
                # overflow to inf/nan; a nan step would poison the branch
                # and every score downstream — hold the current value
                t_new = jnp.where(jnp.isfinite(t_new), t_new, t)
                return jnp.clip(t_new, 1e-8, 100.0)

            t3 = jax.lax.fori_loop(0, newton_iters, newton_step, t3_0)
            score = derivatives_ops.sumtable_loglikelihood(
                st, t3, model.rates, evals, model.cat_pinv,
                model.rate_weights, model.cat_freqs, invariant,
                pattern_weights, scal, cfg)
            return jnp.where(row[BOP_VALID] == 1, score, -jnp.inf), t3

        # score_batch slots at a time: a plain lax.map serializes V tiny
        # [R, S, T] programs and is dispatch-bound
        return jax.lax.map(per_slot, score_ops[c], batch_size=score_batch)

    return jax.lax.map(per_cand, jnp.arange(score_ops.shape[0]),
                       batch_size=cand_batch)


# standalone jitted form (tests); spr_round uses the fused
# _spr_round_device below instead
_spr_ball_scores = jax.jit(
    _score_group,
    static_argnames=("cfg", "ball_slots", "newton_iters",
                     "cand_batch", "score_batch"))


@functools.partial(jax.jit, static_argnames=("cfg", "ball_slots",
                                              "newton_iters"))
def _spr_round_device(cfg: PartitionConfig, model, level_ops, pmat_slots,
                      branch_lengths, tipchars, pattern_weights, invariant,
                      root_rows, root_slot, group_args, ball_slots: int,
                      newton_iters: int = 3):
    """One fused device program per SPR round: the base message sweep,
    the root-edge logL, and EVERY ball-size group's recursion + scoring —
    a single dispatch, a single executable, one sweep shared by all
    consumers (separate per-group dispatches pay a program switch each
    and a second sweep for logl0)."""
    base_clv, base_scal, pmatrix, halves = _spr_base(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    logl0 = likelihood_ops.edge_loglikelihood(
        base_clv[root_rows[0]], base_scal[root_rows[1]],
        base_clv[root_rows[2]], base_scal[root_rows[3]],
        pmatrix[root_slot], model.cat_freqs, model.rate_weights,
        model.cat_pinv, invariant, pattern_weights, cfg)
    # chain the groups through an optimization barrier: without it XLA
    # may schedule all groups' GB-scale scratch concurrently, and the
    # summed transients exhaust device memory; the barrier serializes
    # them at bit-identical values
    outs = []
    dep = logl0
    for (lvls, sops, srows, epos, medges) in group_args:
        bl_g, _ = jax.lax.optimization_barrier((branch_lengths, dep))
        s, t3 = _score_group(cfg, model, base_clv, base_scal, pmatrix,
                             halves, bl_g, pattern_weights, invariant,
                             lvls, sops, srows, epos, medges,
                             ball_slots=ball_slots,
                             newton_iters=newton_iters)
        dep = s
        outs.append((s, t3))
    return logl0, tuple(outs)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _logl_rt(cfg: PartitionConfig, model, level_ops, pmat_slots,
             branch_lengths, tipchars, pattern_weights, invariant,
             root_rows, root_slot):
    """Edge logL across the root edge with runtime topology (extended
    cfg); used to verify multi-move batches exactly."""
    clv, scalers, pmatrix = _sweep_rt(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    return likelihood_ops.edge_loglikelihood(
        clv[root_rows[0]], scalers[root_rows[1]],
        clv[root_rows[2]], scalers[root_rows[3]],
        pmatrix[root_slot], model.cat_freqs, model.rate_weights,
        model.cat_pinv, invariant, pattern_weights, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "rounds", "newton_iters"))
def _smooth_rt(cfg: PartitionConfig, model, level_ops, edge_rows,
               pmat_slots, branch_lengths, tipchars, pattern_weights,
               invariant, color_masks, rounds: int = 2,
               newton_iters: int = 8):
    """Batched Newton branch smoothing with runtime topology (extended
    cfg): engine.optimize_branch_lengths re-expressed over traced arrays
    so SPR hill-climbs smooth without recompiling per topology.

    color_masks: [4, E] bool — proper edge coloring as runtime data (a
    binary tree needs ≤ 4 greedy colors; unused classes are all-False
    no-ops)."""
    dtype = cfg.dtype
    evecs = model.eigenvecs[model.params_indices]
    inv_evecs = model.inv_eigenvecs[model.params_indices]
    evals = model.eigenvals[model.params_indices]

    def optimize_class(bl, color_mask):
        clv, scalers, _ = _sweep_rt(cfg, model, level_ops, pmat_slots,
                                    bl, tipchars)

        def per_edge(args):
            rows, t0 = args
            if cfg.per_rate_scalers:
                st = derivatives_ops.update_sumtable(
                    clv[rows[0]], clv[rows[2]], scalers[rows[1]],
                    scalers[rows[3]], evecs, inv_evecs,
                    model.cat_freqs, cfg)
            else:
                st = derivatives_ops.update_sumtable(
                    clv[rows[0]], clv[rows[2]], None, None, evecs,
                    inv_evecs, model.cat_freqs, cfg,
                    asc_scalers=scalers[rows[1]] + scalers[rows[3]])

            def newton_step(_, t):
                d1, d2 = derivatives_ops.likelihood_derivatives(
                    st, t, model.rates, evals, model.cat_pinv,
                    model.rate_weights, model.cat_freqs, invariant,
                    pattern_weights, cfg)
                newton = t - d1 / d2
                fallback = jnp.where(d1 > 0, t * 0.5, t * 2.0)
                t_new = jnp.where(d2 > 0, newton, fallback)
                # f32 pathologies on terrible topologies can make (d1, d2)
                # overflow to inf/nan; a nan step would poison the branch
                # and every score downstream — hold the current value
                t_new = jnp.where(jnp.isfinite(t_new), t_new, t)
                return jnp.clip(t_new, 1e-8, 100.0)

            return jax.lax.fori_loop(0, newton_iters, newton_step, t0)

        proposal = jax.lax.map(per_edge, (edge_rows, bl), batch_size=32)
        return jnp.where(color_mask, proposal, bl).astype(dtype)

    def one_round(bl, _):
        for c in range(4):
            bl = optimize_class(bl, color_masks[c])
        return bl, None

    bl, _ = jax.lax.scan(one_round, branch_lengths, None, length=rounds)
    return bl


# --------------------------------------------------------------------------
# host-side round driver
# --------------------------------------------------------------------------


def _aux_arrays(prog: SprProgram):
    cfg = prog.cfg_ext
    pw = np.zeros(cfg.sites_padded)
    pw[:cfg.sites] = 1.0
    inv = np.full(cfg.sites_padded, -1, np.int32)
    return jnp.asarray(pw, cfg.dtype), jnp.asarray(inv)


def _tipchars_for(prog: SprProgram,
                  tipchars_by_label: Dict[str, np.ndarray]) -> jnp.ndarray:
    cfg = prog.cfg_ext
    tree = prog.tree
    # sites_alloc exceeds the user's columns under asc bias (phantom
    # per-state room); missing columns default to gap and the phantoms
    # are stamped by pad_tipchars
    raw = np.full((tree.tip_count, cfg.sites_alloc),
                  gap_state(cfg.states), dtype=np.uint64)
    for node in tree.nodes[:tree.tip_count]:
        seq = tipchars_by_label[node.label]
        m = min(seq.shape[0], cfg.sites_alloc)
        raw[node.clv_index, :m] = seq[:m]
    return jnp.asarray(engine.pad_tipchars(raw, cfg))


def _half_nodes(tree: UTree):
    for node in tree.nodes:
        if node.next is None:
            yield node
        else:
            yield from node.roundabout()


def _contains_iter(start, target) -> bool:
    """Iterative `target inside the subtree behind start`
    (moves.subtree_contains without the recursion limit)."""
    stack = [start]
    while stack:
        h = stack.pop()
        if h is target:
            return True
        if h.next is None:
            continue
        g = h.next
        while g is not h:
            if g is target:
                return True
            stack.append(g.back)
            g = g.next
    return False


def _flatten_groups(ball_groups, outs):
    """Compact a round's per-group (score, t3) tables into flat arrays.

    Returns (scores, t3s, cand_of, edge_of)."""
    flat_s, flat_t, flat_c, flat_e = [], [], [], []
    for g, (s, t3) in zip(ball_groups, outs):
        s, t3 = np.asarray(s), np.asarray(t3)
        vmask = g.score_ops[..., BOP_VALID] == 1
        rows, cols = np.nonzero(vmask)
        flat_s.append(s[rows, cols])
        flat_t.append(t3[rows, cols])
        flat_c.append(g.cand_ids[rows])
        flat_e.append(g.score_ops[rows, cols, BOP_EDGE])
    scores = np.concatenate(flat_s)
    # NaNs (f32 pathologies) sort FIRST under descending argsort and
    # would end selection immediately — mask them out
    scores = np.where(np.isnan(scores), -np.inf, scores)
    return (scores, np.concatenate(flat_t),
            np.concatenate(flat_c), np.concatenate(flat_e))


def _select_improving(scores, cand_of, edge_of, logl0, eps, limit,
                      region_sets, edge_endpoints,
                      block_regraft_edge: bool):
    """Greedy improving-move selection over flat score arrays.

    Two region granularities feed this (see spr_round): the surgery-
    anchor sets (cand_hard, aggressive default) and the full staleness
    sets (cand_affected, the verified-ladder fallback)."""
    order = np.argsort(scores, kind="stable")[::-1]
    chosen: List[Tuple[int, int]] = []
    chosen_idx: List[int] = []
    used: set = set()
    for f in order:
        f = int(f)
        if scores[f] <= logl0 + eps or not np.isfinite(scores[f]):
            break
        c, e = int(cand_of[f]), int(edge_of[f])
        region = set(region_sets[c])
        if block_regraft_edge:
            region |= set(edge_endpoints[e])
        if used & region:
            continue
        chosen.append((c, e))
        chosen_idx.append(f)
        used |= region
        if len(chosen) >= limit:
            break
    return chosen, chosen_idx


def _apply_to_tree(prog: SprProgram, selection, sel_idx, t3s):
    """Apply moves sequentially on a fresh copy of prog's tree; moves
    made inapplicable by earlier surgery (regraft target swallowed by a
    pruned subtree, or now-degenerate) are skipped.  Returns
    (new_tree, applied flat indices)."""
    work = parse_newick_string(
        export_newick(prog.tree.vroot, precision=None))
    halves = {h.node_index: h for h in _half_nodes(work)}
    applied: List[int] = []
    for (c, e), f in zip(selection, sel_idx):
        p = halves[int(prog.cand_prune_node[c])]
        r = halves[int(prog.edge_node[e])]
        if _contains_iter(p.back, r):
            continue
        try:
            moves.spr(p, r)
        except ValueError:
            continue
        p.length = p.back.length = float(t3s[f])
        applied.append(f)
    return parse_newick_string(
        export_newick(work.vroot, precision=None)), applied


def spr_round(prog: SprProgram, model,
              tipchars_by_label: Dict[str, np.ndarray],
              *, newton_iters: int = 3, max_moves: Optional[int] = None,
              eps: float = 1e-6, pattern_weights=None, invariant=None,
              timings: Optional[dict] = None
              ) -> Tuple[SprProgram, float, int]:
    """One SPR round: score all pairs, apply all non-conflicting improving
    moves, smooth nothing (see hill_climb for smoothing cadence).

    timings: if a dict is passed, per-phase wall seconds are accumulated
    into it ("score", "select", "apply", "verify") — production search
    diagnostics (compile stalls show up as score-phase outliers).

    Returns (new_program, logl, moves_applied); logl is exact for the
    returned topology and monotone vs. the input's."""
    import time as _time

    def _mark(key, t0):
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + (_time.perf_counter()
                                                    - t0)
        return _time.perf_counter()

    _t = _time.perf_counter()
    cfg = prog.cfg_ext
    tipchars = _tipchars_for(prog, tipchars_by_label)
    pw_d, inv_d = _aux_arrays(prog)
    if pattern_weights is not None:
        pw_d = jnp.asarray(pattern_weights, cfg.dtype)
    if invariant is not None:
        inv_d = jnp.asarray(invariant)
    bl = jnp.asarray(prog.branch_lengths, cfg.dtype)
    lops = jnp.asarray(prog.level_ops)
    erow = jnp.asarray(prog.edge_rows)
    pslots = jnp.asarray(prog.pmatrix_slots)

    _t = _mark("setup", _t)
    if prog.radius is not None:
        group_args = tuple(
            (tuple(jnp.asarray(a) for a in g.ball_levels),
             jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
             jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges))
            for g in prog.ball_groups)
        logl0_d, outs = _spr_round_device(
            cfg, model, lops, pslots, bl, tipchars, pw_d, inv_d,
            erow[prog.root_edge], pslots[prog.root_edge], group_args,
            ball_slots=prog.ball_slots, newton_iters=newton_iters)
        logl0 = float(logl0_d)
        scores, t3s, cand_of, edge_of = _flatten_groups(prog.ball_groups,
                                                        outs)
        C = len(prog.cand_affected)
        _t = _mark("score", _t)
    else:
        logl0 = float(_logl_rt(cfg, model, lops, pslots, bl, tipchars,
                               pw_d, inv_d, erow[prog.root_edge],
                               pslots[prog.root_edge]))
        scores2, t3s2 = _spr_all_scores(
            cfg, model, lops, erow, pslots, bl, tipchars, pw_d, inv_d,
            jnp.asarray(prog.cand_edge), jnp.asarray(prog.cand_sub_rows),
            jnp.asarray(prog.cand_gap_mask),
            jnp.asarray(prog.cand_edge_valid),
            newton_iters=newton_iters)
        scores2, t3s2 = np.asarray(scores2), np.asarray(t3s2)
        C, E = scores2.shape
        scores = scores2.reshape(-1)
        t3s = t3s2.reshape(-1)
        cand_of = np.repeat(np.arange(C, dtype=np.int32), E)
        edge_of = np.tile(np.arange(E, dtype=np.int32), C)
        # NaNs (f32 pathologies) sort FIRST under descending argsort
        scores = np.where(np.isnan(scores), -np.inf, scores)

    # greedy improving move selection (flat arrays).  Two region
    # granularities:
    #   * cand_hard — only the nodes the SPR surgery itself rewires
    #     (p's node, its remainder neighbors, the pruned-subtree root):
    #     moves may interact through stale scores, but every batch is
    #     verified exactly below, so correctness never depends on the
    #     region choice.  This is the default — conservative regions
    #     block ~95% of improving moves on random starts (a whole pruned
    #     subtree conflicts with everything inside it) and convergence
    #     becomes round-starved.
    #   * cand_affected — the full staleness region (pruned subtree +
    #     attachment); scores of non-conflicting moves stay exact.  Used
    #     as the fallback when the aggressive batch verifies worse.
    limit = max_moves if max_moves is not None else C

    def select(region_sets, block_regraft_edge: bool):
        return _select_improving(scores, cand_of, edge_of, logl0, eps,
                                 limit, region_sets,
                                 prog.edge_endpoints, block_regraft_edge)

    chosen, chosen_idx = select(prog.cand_hard, block_regraft_edge=False)
    if timings is not None:
        imp = scores > logl0 + eps
        timings["n_improving"] = int(np.sum(imp))
        timings["n_cand_improving"] = int(len(np.unique(cand_of[imp])))
        timings["n_chosen"] = len(chosen)
    _t = _mark("select", _t)
    if not chosen:
        return prog, logl0, 0

    def apply_moves(selection, sel_idx):
        return _apply_to_tree(prog, selection, sel_idx, t3s)

    bucket = prog.level_ops.shape[:2]
    if prog.radius is not None:
        group_shapes = tuple(g.shape_key for g in prog.ball_groups)
        ball_s = prog.ball_slots
    else:
        group_shapes = ball_s = None

    def recompile(tree):
        return compile_spr(tree, prog.cfg, min_level_shape=bucket,
                           radius=prog.radius,
                           min_group_shapes=group_shapes,
                           min_ball_slots=ball_s)

    def exact_logl(new_prog):
        tip_n = _tipchars_for(new_prog, tipchars_by_label)
        return float(_logl_rt(
            cfg, model, jnp.asarray(new_prog.level_ops),
            jnp.asarray(new_prog.pmatrix_slots),
            jnp.asarray(new_prog.branch_lengths, cfg.dtype), tip_n, pw_d,
            inv_d, jnp.asarray(new_prog.edge_rows)[new_prog.root_edge],
            jnp.asarray(new_prog.pmatrix_slots)[new_prog.root_edge]))

    best_single = float(scores[chosen_idx[0]])
    new_tree, applied = apply_moves(chosen, chosen_idx)
    if timings is not None:
        timings["n_applied"] = len(applied)
    if not applied:
        return prog, logl0, 0
    new_prog = recompile(new_tree)
    _t = _mark("apply", _t)

    if len(applied) == 1:
        # a single move's score is its exact post-move likelihood
        return new_prog, float(scores[applied[0]]), 1

    # verify the aggressive batch exactly; ladder down to the
    # conservative-region batch, then the single best move — each rung
    # is verified, so the returned logL is exact and monotone
    logl_batch = exact_logl(new_prog)
    if logl_batch >= best_single - eps:
        _t = _mark("verify", _t)
        if timings is not None:
            timings["ladder"] = 0
        return new_prog, logl_batch, len(applied)

    chosen2, chosen_idx2 = select(prog.cand_affected, block_regraft_edge=True)
    if len(chosen2) > 1:
        tree2, applied2 = apply_moves(chosen2, chosen_idx2)
        prog2 = recompile(tree2)
        logl2 = exact_logl(prog2)
        if logl2 >= best_single - eps:
            _t = _mark("verify", _t)
            if timings is not None:
                timings["ladder"] = 1
            return prog2, logl2, len(applied2)

    single_tree, applied1 = apply_moves(chosen[:1], chosen_idx[:1])
    _t = _mark("verify", _t)
    if timings is not None:
        timings["ladder"] = 2
    return recompile(single_tree), best_single, 1


def smooth_branches(prog: SprProgram, model,
                    tipchars_by_label: Dict[str, np.ndarray],
                    *, rounds: int = 2, newton_iters: int = 8,
                    pattern_weights=None, invariant=None) -> SprProgram:
    """Batched Newton smoothing of all branch lengths (runtime topology);
    returns a program with updated branch_lengths (tree lengths synced)."""
    cfg = prog.cfg_ext
    tipchars = _tipchars_for(prog, tipchars_by_label)
    pw_d, inv_d = _aux_arrays(prog)
    if pattern_weights is not None:
        pw_d = jnp.asarray(pattern_weights, cfg.dtype)
    if invariant is not None:
        inv_d = jnp.asarray(invariant)
    bl = _smooth_rt(
        cfg, model, jnp.asarray(prog.level_ops),
        jnp.asarray(prog.edge_rows), jnp.asarray(prog.pmatrix_slots),
        jnp.asarray(prog.branch_lengths, cfg.dtype), tipchars, pw_d, inv_d,
        jnp.asarray(prog.color_masks), rounds=rounds,
        newton_iters=newton_iters)
    bl = np.asarray(bl, np.float64)
    # write back into the tree so later exports carry the new lengths
    pm_to_len = {int(p): float(t) for p, t in zip(prog.pmatrix_slots, bl)}
    for h in _half_nodes(prog.tree):
        h.length = pm_to_len[h.pmatrix_index]
    return dataclasses.replace(prog, branch_lengths=bl)


def evaluate_tree(tree: UTree, cfg: PartitionConfig, model,
                  tipchars_by_label: Dict[str, np.ndarray],
                  *, smooth_rounds: int = 2,
                  pattern_weights=None, invariant=None
                  ) -> Tuple[float, SprProgram]:
    """Exact logL of one topology, after `smooth_rounds` rounds of batched
    Newton branch smoothing (0 = score the lengths as given).

    The search-quality yardstick: score a known-truth topology with the
    same machinery the hill-climb uses, so Δ logL between the search
    result and the truth is an apples-to-apples comparison."""
    tree = parse_newick_string(export_newick(tree.vroot, precision=None))
    prog = compile_spr(tree, cfg)
    if smooth_rounds:
        prog = smooth_branches(prog, model, tipchars_by_label,
                               rounds=smooth_rounds,
                               pattern_weights=pattern_weights,
                               invariant=invariant)
    tipchars = _tipchars_for(prog, tipchars_by_label)
    pw_d, inv_d = _aux_arrays(prog)
    if pattern_weights is not None:
        pw_d = jnp.asarray(pattern_weights, prog.cfg_ext.dtype)
    if invariant is not None:
        inv_d = jnp.asarray(invariant)
    cfg_ext = prog.cfg_ext
    pslots = jnp.asarray(prog.pmatrix_slots)
    logl = float(_logl_rt(
        cfg_ext, model, jnp.asarray(prog.level_ops), pslots,
        jnp.asarray(prog.branch_lengths, cfg_ext.dtype), tipchars, pw_d,
        inv_d, jnp.asarray(prog.edge_rows)[prog.root_edge],
        pslots[prog.root_edge]))
    return logl, prog


def hill_climb(tree: UTree, cfg: PartitionConfig, model,
               tipchars_by_label: Dict[str, np.ndarray],
               *, max_rounds: int = 30, newton_iters: int = 3,
               smooth_every: int = 2, smooth_rounds: int = 2,
               eps: float = 1e-6,
               radius: Optional[int] = None,
               radius_max: Optional[int] = None,
               pattern_weights=None, invariant=None,
               checkpoint_dir=None) -> Tuple[UTree, float, dict]:
    """Full SPR hill-climb: rounds of batched moves until no improvement.

    radius: regraft-distance bound for each round's scoring (RAxML-NG's
    SPR radius).  None scores every (prune, regraft) pair exhaustively —
    O(n^2) message sweeps per round; a radius K costs O(n * 2^K) and is
    the production setting for large trees.

    radius_max: adaptive schedule (RAxML-style) — when a radius-K round
    finds no improving move, the radius doubles (one extra compile per
    distinct radius) up to radius_max before the climb is declared
    converged.

    checkpoint_dir: if set, every round appends the current newick +
    exact logL to <dir>/search_trace.jsonl and rewrites
    <dir>/latest.newick, so a killed search resumes by restarting from
    latest.newick (all state lives in the tree: branch lengths included).

    Returns (tree, logl, stats) with stats = {"rounds", "moves",
    "logl_trace", "round_secs", "radius_trace"}; logl_trace is monotone
    non-decreasing."""
    import json
    import pathlib
    import time

    ckpt = pathlib.Path(checkpoint_dir) if checkpoint_dir else None
    if ckpt:
        ckpt.mkdir(parents=True, exist_ok=True)
        # a resumed run appends round numbers starting at 1 again; a
        # separator record keeps the trace parseable as distinct runs
        if (ckpt / "search_trace.jsonl").exists():
            with open(ckpt / "search_trace.jsonl", "a") as f:
                f.write(json.dumps({"run_start": True}) + "\n")

    # normalize to parser template indexing (trees from other builders —
    # e.g. stepwise addition — may carry non-template clv indices)
    tree = parse_newick_string(export_newick(tree.vroot, precision=None))
    prog = compile_spr(tree, cfg, radius=radius)
    init_smooth_s = 0.0
    if smooth_every:
        # optimize the starting branch lengths first: parsimony starting
        # trees carry arbitrary lengths, and SPR scores against unsmoothed
        # branches under-rank good moves (RAxML-NG smooths before its
        # first round too)
        t0 = time.perf_counter()
        prog = smooth_branches(prog, model, tipchars_by_label,
                               rounds=smooth_rounds,
                               pattern_weights=pattern_weights,
                               invariant=invariant)
        init_smooth_s = time.perf_counter() - t0
    trace: List[float] = []
    round_secs: List[float] = []
    radius_trace: List[Optional[int]] = []
    total_moves = 0
    rounds = 0
    cur_radius = radius
    phase_timings: List[dict] = []
    for r in range(max_rounds):
        t0 = time.perf_counter()
        tm: dict = {"shapes": tuple(g.shape_key for g in prog.ball_groups)
                    if prog.ball_groups is not None else None,
                    "lops": prog.level_ops.shape,
                    "cfg_hash": hash(prog.cfg_ext) & 0xffff,
                    "cache": (_spr_round_device._cache_size(),
                              _smooth_rt._cache_size(),
                              _logl_rt._cache_size())}
        prog, logl, applied = spr_round(
            prog, model, tipchars_by_label, newton_iters=newton_iters,
            eps=eps, pattern_weights=pattern_weights, invariant=invariant,
            timings=tm)
        round_secs.append(time.perf_counter() - t0)
        phase_timings.append(tm)
        trace.append(logl)
        radius_trace.append(cur_radius)
        rounds += 1
        total_moves += applied
        if ckpt:
            newick = export_newick(prog.tree.vroot, precision=9)
            (ckpt / "latest.newick").write_text(newick + "\n")
            with open(ckpt / "search_trace.jsonl", "a") as f:
                f.write(json.dumps({"round": rounds, "logl": logl,
                                    "moves": applied,
                                    "radius": cur_radius}) + "\n")
        if applied == 0:
            if (cur_radius is not None and radius_max is not None
                    and cur_radius < radius_max):
                cur_radius = min(2 * cur_radius, radius_max)
                # group widths can't be pinned across a radius change (K
                # differs; compile_spr ignores mismatched pins); the
                # scratch size only grows
                prog = compile_spr(prog.tree, cfg, radius=cur_radius,
                                   min_level_shape=prog.level_ops.shape[:2],
                                   min_ball_slots=prog.ball_slots)
                continue
            break
        if smooth_every and (r + 1) % smooth_every == 0:
            ts = time.perf_counter()
            prog = smooth_branches(prog, model, tipchars_by_label,
                                   rounds=smooth_rounds,
                                   pattern_weights=pattern_weights,
                                   invariant=invariant)
            tm["smooth"] = time.perf_counter() - ts
    if smooth_every:
        prog = smooth_branches(prog, model, tipchars_by_label,
                               rounds=smooth_rounds,
                               pattern_weights=pattern_weights,
                               invariant=invariant)
    tipchars = _tipchars_for(prog, tipchars_by_label)
    pw_d, inv_d = _aux_arrays(prog)
    if pattern_weights is not None:
        pw_d = jnp.asarray(pattern_weights, prog.cfg_ext.dtype)
    if invariant is not None:
        inv_d = jnp.asarray(invariant)
    cfg_ext = prog.cfg_ext
    pslots = jnp.asarray(prog.pmatrix_slots)
    logl = float(_logl_rt(
        cfg_ext, model, jnp.asarray(prog.level_ops), pslots,
        jnp.asarray(prog.branch_lengths, cfg_ext.dtype), tipchars, pw_d,
        inv_d, jnp.asarray(prog.edge_rows)[prog.root_edge],
        pslots[prog.root_edge]))
    trace.append(logl)
    return prog.tree, logl, {"rounds": rounds, "moves": total_moves,
                             "logl_trace": trace,
                             "round_secs": round_secs,
                             "radius_trace": radius_trace,
                             "phase_timings": phase_timings,
                             "init_smooth_s": init_smooth_s}


# --------------------------------------------------------------------------
# multi-partition search (K per-gene partitions, ONE topology)
# --------------------------------------------------------------------------


def compile_spr_multi(tree: UTree, cfgs: Sequence[PartitionConfig],
                      radius: Optional[int] = None,
                      pins: Optional[List[dict]] = None
                      ) -> List[SprProgram]:
    """K SprPrograms over one topology (reference clients drive one
    pll_partition_t per gene over the same tree — SURVEY.md §2.6).

    The candidate tables, ball groups and edge layouts depend only on the
    topology, so the K programs share one move/index structure; only the
    per-partition row spaces and branch lengths differ."""
    tips = {c.tips for c in cfgs}
    if len(tips) != 1 or tips.pop() != tree.tip_count:
        raise ValueError("all partitions must cover the same taxa as the "
                         "shared topology")
    progs = []
    newick = export_newick(tree.vroot, precision=None)
    for k, cfg in enumerate(cfgs):
        pin = pins[k] if pins is not None else {}
        # each partition owns its tree COPY: branch lengths are unlinked,
        # and smooth_branches writes lengths back into the tree graph
        progs.append(compile_spr(parse_newick_string(newick), cfg,
                                 radius=radius, **pin))
    for p in progs[1:]:
        np.testing.assert_array_equal(p.cand_edge, progs[0].cand_edge)
        np.testing.assert_array_equal(p.edge_endpoints,
                                      progs[0].edge_endpoints)
    return progs


def spr_round_multi(progs: List[SprProgram], models,
                    tipchars_by_label_list, *, newton_iters: int = 3,
                    max_moves: Optional[int] = None, eps: float = 1e-6,
                    pattern_weights_list=None, invariant_list=None,
                    timings: Optional[dict] = None
                    ) -> Tuple[List[SprProgram], float, int]:
    """One SPR round over K partitions under UNLINKED branch lengths
    (RAxML-NG `--brlen unlinked`): each partition keeps its own branch
    vector, each move's attachment branch is Newton-optimized per
    partition, and the move score is the SUM of the partitions' exact
    post-move logLs.  Selection, verification and the monotone-logL
    guarantee work exactly as in the single-partition spr_round.

    Returns (new_programs, total_logl, moves_applied)."""
    import time as _time

    K = len(progs)
    assert len(models) == K and len(tipchars_by_label_list) == K

    def _mark(key, t0):
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + (_time.perf_counter()
                                                    - t0)
        return _time.perf_counter()

    _t = _time.perf_counter()
    per_part = []
    logl0 = 0.0
    sum_scores = None
    t3_list = []
    for k, prog in enumerate(progs):
        cfg = prog.cfg_ext
        tipchars = _tipchars_for(prog, tipchars_by_label_list[k])
        pw_d, inv_d = _aux_arrays(prog)
        if pattern_weights_list is not None \
                and pattern_weights_list[k] is not None:
            pw_d = jnp.asarray(pattern_weights_list[k], cfg.dtype)
        if invariant_list is not None and invariant_list[k] is not None:
            inv_d = jnp.asarray(invariant_list[k])
        bl = jnp.asarray(prog.branch_lengths, cfg.dtype)
        lops = jnp.asarray(prog.level_ops)
        erow = jnp.asarray(prog.edge_rows)
        pslots = jnp.asarray(prog.pmatrix_slots)
        if prog.radius is None:
            raise ValueError("spr_round_multi requires radius-compiled "
                             "programs")
        group_args = tuple(
            (tuple(jnp.asarray(a) for a in g.ball_levels),
             jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
             jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges))
            for g in prog.ball_groups)
        logl0_d, outs = _spr_round_device(
            cfg, models[k], lops, pslots, bl, tipchars, pw_d, inv_d,
            erow[prog.root_edge], pslots[prog.root_edge], group_args,
            ball_slots=prog.ball_slots, newton_iters=newton_iters)
        logl0_k = float(logl0_d)
        scores_k, t3s_k, cand_of, edge_of = _flatten_groups(
            prog.ball_groups, outs)
        logl0 += logl0_k
        t3_list.append(t3s_k)
        if sum_scores is None:
            sum_scores = scores_k
            cand_ref, edge_ref = cand_of, edge_of
        else:
            np.testing.assert_array_equal(cand_of, cand_ref)
            np.testing.assert_array_equal(edge_of, edge_ref)
            sum_scores = sum_scores + scores_k
        per_part.append((cfg, tipchars, pw_d, inv_d))
    scores, cand_of, edge_of = sum_scores, cand_ref, edge_ref
    prog0 = progs[0]
    _t = _mark("score", _t)

    limit = max_moves if max_moves is not None else len(prog0.cand_hard)

    def select(region_sets, block_regraft_edge):
        return _select_improving(scores, cand_of, edge_of, logl0, eps,
                                 limit, region_sets,
                                 prog0.edge_endpoints,
                                 block_regraft_edge)

    chosen, chosen_idx = select(prog0.cand_hard, False)
    _t = _mark("select", _t)
    if not chosen:
        return progs, logl0, 0

    def apply_all(selection, sel_idx):
        """Apply the moves to every partition's tree (shared topology,
        per-partition t3); returns (new_progs, applied indices)."""
        new_trees, applied_ref = [], None
        for k, prog in enumerate(progs):
            tree_k, applied = _apply_to_tree(prog, selection, sel_idx,
                                             t3_list[k])
            if applied_ref is None:
                applied_ref = applied
            else:
                assert applied == applied_ref   # topology-driven: same
            new_trees.append(tree_k)
        pins = [{"min_level_shape": p.level_ops.shape[:2],
                 "min_group_shapes": tuple(g.shape_key
                                           for g in p.ball_groups),
                 "min_ball_slots": p.ball_slots} for p in progs]
        new_progs = []
        for k, (t, prog) in enumerate(zip(new_trees, progs)):
            new_progs.append(compile_spr(t, prog.cfg, radius=prog.radius,
                                         **pins[k]))
        return new_progs, applied_ref

    def total_exact(new_progs):
        tot = 0.0
        for k, np_ in enumerate(new_progs):
            cfg, _, pw_d, inv_d = per_part[k]
            tip_n = _tipchars_for(np_, tipchars_by_label_list[k])
            tot += float(_logl_rt(
                cfg, models[k], jnp.asarray(np_.level_ops),
                jnp.asarray(np_.pmatrix_slots),
                jnp.asarray(np_.branch_lengths, cfg.dtype), tip_n, pw_d,
                inv_d, jnp.asarray(np_.edge_rows)[np_.root_edge],
                jnp.asarray(np_.pmatrix_slots)[np_.root_edge]))
        return tot

    best_single = float(scores[chosen_idx[0]])
    new_progs, applied = apply_all(chosen, chosen_idx)
    if not applied:
        return progs, logl0, 0
    _t = _mark("apply", _t)

    if len(applied) == 1:
        return new_progs, float(scores[applied[0]]), 1

    logl_batch = total_exact(new_progs)
    if logl_batch >= best_single - eps:
        _t = _mark("verify", _t)
        return new_progs, logl_batch, len(applied)

    chosen2, chosen_idx2 = select(prog0.cand_affected, True)
    if len(chosen2) > 1:
        progs2, applied2 = apply_all(chosen2, chosen_idx2)
        logl2 = total_exact(progs2)
        if logl2 >= best_single - eps:
            _t = _mark("verify", _t)
            return progs2, logl2, len(applied2)

    progs1, _ = apply_all(chosen[:1], chosen_idx[:1])
    _t = _mark("verify", _t)
    return progs1, best_single, 1


def hill_climb_multi(tree: UTree, cfgs: Sequence[PartitionConfig], models,
                     tipchars_by_label_list, *, max_rounds: int = 30,
                     newton_iters: int = 3, smooth_every: int = 2,
                     smooth_rounds: int = 2, eps: float = 1e-6,
                     radius: int = 5, pattern_weights_list=None,
                     invariant_list=None) -> Tuple[UTree, float, dict]:
    """Multi-partition SPR hill-climb (unlinked branch lengths): one
    shared topology, K per-gene partitions, summed logL maximized.

    Returns (tree, total_logl, stats); the tree carries partition 0's
    branch lengths (each partition's own lengths live in its program —
    exposed via stats["programs"])."""
    import time

    tree = parse_newick_string(export_newick(tree.vroot, precision=None))
    progs = compile_spr_multi(tree, cfgs, radius=radius)

    def smooth_all(progs):
        out = []
        for k, p in enumerate(progs):
            pw = (pattern_weights_list[k]
                  if pattern_weights_list is not None else None)
            iv = (invariant_list[k]
                  if invariant_list is not None else None)
            out.append(smooth_branches(p, models[k],
                                       tipchars_by_label_list[k],
                                       rounds=smooth_rounds,
                                       pattern_weights=pw, invariant=iv))
        return out

    if smooth_every:
        progs = smooth_all(progs)
    trace: List[float] = []
    round_secs: List[float] = []
    phase_timings: List[dict] = []
    total_moves = rounds = 0
    for r in range(max_rounds):
        t0 = time.perf_counter()
        tm: dict = {}
        progs, logl, applied = spr_round_multi(
            progs, models, tipchars_by_label_list,
            newton_iters=newton_iters, eps=eps,
            pattern_weights_list=pattern_weights_list,
            invariant_list=invariant_list, timings=tm)
        round_secs.append(time.perf_counter() - t0)
        phase_timings.append(tm)
        trace.append(logl)
        rounds += 1
        total_moves += applied
        if applied == 0:
            break
        if smooth_every and (r + 1) % smooth_every == 0:
            progs = smooth_all(progs)
    if smooth_every:
        progs = smooth_all(progs)
    # final exact total at the smoothed lengths
    total = 0.0
    for k, p in enumerate(progs):
        cfg = p.cfg_ext
        tip_n = _tipchars_for(p, tipchars_by_label_list[k])
        pw_d, inv_d = _aux_arrays(p)
        if pattern_weights_list is not None \
                and pattern_weights_list[k] is not None:
            pw_d = jnp.asarray(pattern_weights_list[k], cfg.dtype)
        if invariant_list is not None and invariant_list[k] is not None:
            inv_d = jnp.asarray(invariant_list[k])
        total += float(_logl_rt(
            cfg, models[k], jnp.asarray(p.level_ops),
            jnp.asarray(p.pmatrix_slots),
            jnp.asarray(p.branch_lengths, cfg.dtype), tip_n, pw_d, inv_d,
            jnp.asarray(p.edge_rows)[p.root_edge],
            jnp.asarray(p.pmatrix_slots)[p.root_edge]))
    trace.append(total)
    return progs[0].tree, total, {
        "rounds": rounds, "moves": total_moves, "logl_trace": trace,
        "round_secs": round_secs, "phase_timings": phase_timings,
        "programs": progs}
