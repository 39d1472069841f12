"""Weighted (Sankoff) parsimony: arbitrary score-matrix dynamic programming.

Reference semantics (libpll-2 src/parsimony.c):

  * tips: score 0 for each state whose bit is set in the encoded character,
    INF (= max score-matrix entry + 1) otherwise (:24-66);
  * build (pll_parsimony_build, :204-284): post-order min-plus DP —
    parent[n] = min_k(child1[k] + M[k,n]) + min_k(child2[k] + M[k,n]);
  * score (pll_parsimony_score, :286-307): sum over sites of min over
    states at the (sub)tree root;
  * reconstruct (pll_parsimony_reconstruct, :309-383): preorder; pick the
    min-score state unless keeping the parent's state costs no more
    (parent-tie rule: min+1 > parent_val -> inherit parent state).

Device design: score buffers are one dense tensor [B, S, T] (site axis
innermost); the DP over states is a min-plus contraction
min over k of (score[k, t] + M[k, n]) — vectorized over (n, t); operations
run levelized under lax.scan like the likelihood engine.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import round_up


@dataclasses.dataclass
class ParsBuildOp:
    """Mirrors pll_pars_buildop_t (pll.h:466-472)."""
    parent_score_index: int
    child1_score_index: int
    child2_score_index: int


@dataclasses.dataclass
class ParsRecOp:
    """Mirrors pll_pars_recop_t (pll.h:474-482)."""
    node_score_index: int
    node_ancestral_index: int
    parent_score_index: int
    parent_ancestral_index: int


@functools.partial(jax.jit, static_argnames=())
def _minplus_level(sbuf, ops, score_matrix):
    """One level of independent build ops.

    sbuf: [B, S, T]; ops: [W, 3] int32; score_matrix: [S, S]."""
    c1 = sbuf[ops[:, 1]]                                   # [W, S, T]
    c2 = sbuf[ops[:, 2]]
    # min over k of (c[k, t] + M[k, n]) -> [W, S(n), T]
    m = score_matrix[None, :, :, None]                     # [1, K, N, 1]
    p1 = jnp.min(c1[:, :, None, :] + m, axis=1)
    p2 = jnp.min(c2[:, :, None, :] + m, axis=1)
    return sbuf.at[ops[:, 0]].set(p1 + p2)


class Parsimony:
    """Mirrors pll_parsimony_t (pll.h:484-500) + its lifecycle functions."""

    def __init__(self, tips: int, states: int, sites: int,
                 score_matrix, score_buffers: int, ancestral_buffers: int,
                 site_block: int = 128):
        self.tips = tips
        self.states = states
        self.sites = sites
        self.sites_padded = round_up(sites, site_block)
        self.score_matrix = np.asarray(score_matrix,
                                       dtype=np.float64).reshape(states,
                                                                 states)
        self.inf = float(self.score_matrix.max()) + 1.0
        B = tips + score_buffers
        # padding sites: all-zero columns so they never affect the min-sum
        self.sbuffer = jnp.zeros((B, states, self.sites_padded))
        self.anc_states: List[Optional[np.ndarray]] = \
            [None] * (tips + ancestral_buffers)

    # --- tips (parsimony.c:24-66) ------------------------------------------

    def set_tip_states(self, tip_index: int, map_arr: np.ndarray,
                       sequence: str) -> None:
        codes = np.asarray(map_arr)[
            np.frombuffer(sequence.encode("ascii"), np.uint8)]
        if np.any(codes == 0):
            bad = int(np.flatnonzero(codes == 0)[0])
            raise ValueError(f"illegal state code in tip {sequence[bad]!r}")
        bits = (codes[None, :].astype(np.uint64)
                >> np.arange(self.states, dtype=np.uint64)[:, None]) & 1
        row = np.full((self.states, self.sites_padded), 0.0)
        row[:, :self.sites] = np.where(bits == 1, 0.0, self.inf)
        self.sbuffer = self.sbuffer.at[tip_index].set(jnp.asarray(row))

    # --- build + score (parsimony.c:204-307) --------------------------------

    def build(self, operations: Sequence[ParsBuildOp]) -> float:
        level_of: dict[int, int] = {}
        levels: List[List[ParsBuildOp]] = []
        for op in operations:
            lvl = max(level_of.get(op.child1_score_index, 0),
                      level_of.get(op.child2_score_index, 0))
            level_of[op.parent_score_index] = lvl + 1
            while len(levels) <= lvl:
                levels.append([])
            levels[lvl].append(op)
        sm = jnp.asarray(self.score_matrix)
        for lops in levels:
            arr = jnp.asarray([[o.parent_score_index, o.child1_score_index,
                                o.child2_score_index] for o in lops],
                              dtype=jnp.int32)
            self.sbuffer = _minplus_level(self.sbuffer, arr, sm)
        return self.score(operations[-1].parent_score_index)

    def score(self, score_buffer_index: int) -> float:
        row = self.sbuffer[score_buffer_index][:, :self.sites]
        return float(jnp.sum(jnp.min(row, axis=0)))

    # --- ancestral reconstruction (parsimony.c:309-383) ----------------------

    def reconstruct(self, map_arr: np.ndarray,
                    operations: Sequence[ParsRecOp]) -> None:
        map_arr = np.asarray(map_arr)
        # reference iterates ascending chars and overwrites: last wins
        # (parsimony.c:328-334)
        revmap = np.zeros(self.states, dtype=np.uint8)
        for i in range(256):
            v = int(map_arr[i])
            if v and (v & (v - 1)) == 0:  # popcount == 1
                revmap[v.bit_length() - 1] = i

        sbuf = np.asarray(self.sbuffer)[:, :, :self.sites]
        op0 = operations[0]
        scores = sbuf[op0.node_score_index]                 # [S, T]
        minidx = np.argmin(scores, axis=0)
        self.anc_states[op0.node_ancestral_index] = revmap[minidx]

        for op in operations[1:]:
            scores = sbuf[op.node_score_index]
            minidx = np.argmin(scores, axis=0)
            minval = scores[minidx, np.arange(self.sites)]
            parent_chars = self.anc_states[op.parent_ancestral_index]
            # CTZ of the parent's (single-bit) state
            parent_states = np.array(
                [(int(map_arr[c]) & -int(map_arr[c])).bit_length() - 1
                 for c in parent_chars])
            parent_val = sbuf[op.parent_score_index][
                parent_states, np.arange(self.sites)]
            keep_parent = minval + 1 > parent_val
            self.anc_states[op.node_ancestral_index] = np.where(
                keep_parent, parent_chars, revmap[minidx]).astype(np.uint8)

    def get_ancestral(self, index: int) -> str:
        arr = self.anc_states[index]
        if arr is None:
            raise ValueError("ancestral buffer not computed")
        return bytes(arr.tolist()).decode("ascii")
