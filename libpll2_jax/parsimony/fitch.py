"""Fast (Fitch) parsimony: bit-parallel unweighted scoring.

Reference semantics (libpll-2 src/fast_parsimony.c):

  * init (pll_fastparsimony_init, :523-555): informative-site filter —
    a site is informative iff >=2 distinct tip codes occur >=2 times;
    non-informative sites contribute ``singletons * weight`` to a constant
    cost (pll_set_informative :369-403, check_informative :128-194);
  * vectors (fill_parsimony_vectors, :196-367): per (node, state) packed
    bit-vectors over informative site occurrences (expanded by pattern
    weight); trailing pad bits are set to ONES so they never score;
    ``tips + 3*inner`` vectors — one per direction of each inner node
    (alloc_pars_structs :26-80);
  * update (pll_fastparsimony_update_vector, :557-609): Fitch rule
    ``orvand = OR_j(c1_j & c2_j)``,
    ``parent_j = (c1_j & c2_j) | (~orvand & (c1_j | c2_j))``,
    ``cost[parent] = popcount(~orvand) + cost[c1] + cost[c2]``;
  * edge score (:611-648): ``popcount(~OR_j(v1_j & v2_j)) + costs +
    const_cost``; root score (:776-781) = ``cost[root] + const_cost``.

Device design: all vectors live in ONE dense uint32 tensor
``packed[nodes, states, W]`` (W = 32-bit words, padded);
the Fitch rule is pure elementwise bitwise ops + ``lax.population_count``
— no matrix unit needed.  Updates run levelized (all ops whose
children are ready execute as one batched gather/scatter), and
``edge_scores_batch`` scores MANY candidate edges in one shot — the
batched replacement for the reference's sequential splice-and-score
loop in stepwise addition (src/stepwise.c:486-525).
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import round_up
from .sankoff import ParsBuildOp

BITVECTOR_SIZE = 32  # PLL_BITVECTOR_SIZE (fast_parsimony.c:24)


def _informative_filter(tipchars: np.ndarray, weights: np.ndarray,
                        sites: int):
    """Mark informative sites; accumulate singleton const-cost.

    Mirrors pll_set_informative (fast_parsimony.c:369-403): for each site
    count occurrences of each distinct tip code; informative iff >1 code
    occurs >1 time; else const_cost += singletons * weight.
    """
    informative = np.zeros(sites, dtype=bool)
    const_cost = 0
    cols = tipchars[:, :sites]
    for j in range(sites):
        _, counts = np.unique(cols[:, j], return_counts=True)
        repeated = int(np.count_nonzero(counts > 1))
        singletons = int(np.count_nonzero(counts == 1))
        if repeated > 1:
            informative[j] = True
        else:
            const_cost += singletons * int(weights[j])
    return informative, const_cost


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _fitch_level(packed, node_cost, ops):
    """One level of independent Fitch updates.

    packed: [N, S, W] uint32; node_cost: [N] int32; ops: [K, 3] int32."""
    c1 = packed[ops[:, 1]]                                  # [K, S, W]
    c2 = packed[ops[:, 2]]
    vand = c1 & c2
    orvand = jax.lax.reduce(vand, np.uint32(0),
                            jax.lax.bitwise_or, (1,))       # [K, W]
    parent = vand | (~orvand[:, None, :] & (c1 | c2))
    score = jnp.sum(jax.lax.population_count(~orvand),
                    axis=1).astype(jnp.int32)               # [K]
    cost = score + node_cost[ops[:, 1]] + node_cost[ops[:, 2]]
    return (packed.at[ops[:, 0]].set(parent),
            node_cost.at[ops[:, 0]].set(cost))


@jax.jit
def _placement_scores(packed, node_cost, pairs, sub_index):
    """Batched insertion scoring: for each candidate edge (c1, c2) in
    ``pairs`` [K, 2], form the Fitch parent of (c1, c2) and score the new
    edge against the subtree vector ``sub_index`` — the whole
    splice-update-score-unsplice loop of the reference's stepwise
    insertion (stepwise.c:486-525) as ONE vectorized program."""
    c1 = packed[pairs[:, 0]]
    c2 = packed[pairs[:, 1]]
    vand = c1 & c2
    orvand = jax.lax.reduce(vand, np.uint32(0),
                            jax.lax.bitwise_or, (1,))       # [K, W]
    parent = vand | (~orvand[:, None, :] & (c1 | c2))
    pcost = (jnp.sum(jax.lax.population_count(~orvand), axis=1)
             .astype(jnp.int32)
             + node_cost[pairs[:, 0]] + node_cost[pairs[:, 1]])
    vt = packed[sub_index]                                  # [S, W]
    orv2 = jax.lax.reduce(parent & vt[None], np.uint32(0),
                          jax.lax.bitwise_or, (1,))
    escore = jnp.sum(jax.lax.population_count(~orv2),
                     axis=1).astype(jnp.int32)
    return escore + pcost + node_cost[sub_index]


@jax.jit
def _edge_scores(packed, node_cost, pairs):
    """Batched edge scores (without const_cost): pairs [K, 2] int32."""
    v1 = packed[pairs[:, 0]]
    v2 = packed[pairs[:, 1]]
    orvand = jax.lax.reduce(v1 & v2, np.uint32(0),
                            jax.lax.bitwise_or, (1,))
    score = jnp.sum(jax.lax.population_count(~orvand),
                    axis=1).astype(jnp.int32)
    return score + node_cost[pairs[:, 0]] + node_cost[pairs[:, 1]]


class FastParsimony:
    """Mirrors pll_parsimony_t in fast (Fitch) mode + its functions
    (pll_fastparsimony_{init,update_vectors,edge_score,root_score},
    fast_parsimony.c:523-781)."""

    def __init__(self, partition=None, *, tipchars=None, weights=None,
                 tips=None, states=None, sites=None, word_pad: int = 128):
        if partition is not None:
            cfg = partition.cfg
            tips, states, sites = cfg.tips, cfg.states, cfg.sites
            tipchars = partition.tipchars
            weights = partition.pattern_weights
        tipchars = np.asarray(tipchars, dtype=np.uint64)
        weights = np.asarray(weights[:sites], dtype=np.int64)
        self.tips = tips
        self.states = states
        self.sites = sites
        self.inner_nodes = tips - 1
        nodes_count = tips + 3 * self.inner_nodes

        self.informative, self.const_cost = _informative_filter(
            tipchars, weights, sites)
        self.informative_count = int(np.count_nonzero(self.informative))

        # weight-expand informative columns -> [tips, bitcount] codes
        inf_idx = np.flatnonzero(self.informative)
        rep = np.repeat(inf_idx, weights[inf_idx])
        bitcount = rep.size
        self.packedvector_count = W = max(
            1, round_up((bitcount + BITVECTOR_SIZE - 1) // BITVECTOR_SIZE,
                        word_pad))

        # bits[t, k, b] = 1 iff state k set at occurrence b (pad -> ones)
        total_bits = W * BITVECTOR_SIZE
        bits = np.ones((tips, states, total_bits), dtype=np.uint8)
        codes = tipchars[:, rep]                            # [tips, bitcount]
        for k in range(states):
            bits[:, k, :bitcount] = ((codes >> np.uint64(k))
                                     & np.uint64(1)).astype(np.uint8)
        # pack LSB-first within each 32-bit word (val |= 1 << bitcount)
        words = bits.reshape(tips, states, W, 4, 8)
        packed8 = np.packbits(words, axis=-1, bitorder="little")[..., 0]
        packed = (packed8.astype(np.uint32).reshape(tips, states, W, 4)
                  * (1 << (8 * np.arange(4, dtype=np.uint32)))).sum(
                      axis=-1, dtype=np.uint32)

        full = np.full((nodes_count, states, W), np.uint32(0xFFFFFFFF))
        full[:tips] = packed
        self.packed = jnp.asarray(full)
        self.node_cost = jnp.zeros(nodes_count, dtype=jnp.int32)

    # --- build (fast_parsimony.c:557-609 / levelized) -----------------------

    def update_vectors(self, operations: Sequence[ParsBuildOp]) -> None:
        level_of: dict[int, int] = {}
        levels: List[List[ParsBuildOp]] = []
        for op in operations:
            lvl = max(level_of.get(op.child1_score_index, 0),
                      level_of.get(op.child2_score_index, 0))
            level_of[op.parent_score_index] = lvl + 1
            while len(levels) <= lvl:
                levels.append([])
            levels[lvl].append(op)
        for lops in levels:
            arr = jnp.asarray([[o.parent_score_index, o.child1_score_index,
                                o.child2_score_index] for o in lops],
                              dtype=jnp.int32)
            self.packed, self.node_cost = _fitch_level(
                self.packed, self.node_cost, arr)

    # --- scores (fast_parsimony.c:611-648, 776-781) -------------------------

    def edge_score(self, node1_score_index: int,
                   node2_score_index: int) -> int:
        pairs = jnp.asarray([[node1_score_index, node2_score_index]],
                            dtype=jnp.int32)
        return int(_edge_scores(self.packed, self.node_cost, pairs)[0]
                   ) + self.const_cost

    def edge_scores_batch(self, pairs) -> np.ndarray:
        """Score many (node1, node2) edges at once (batched extension)."""
        out = _edge_scores(self.packed, self.node_cost,
                           jnp.asarray(pairs, dtype=jnp.int32))
        return np.asarray(out) + self.const_cost

    def placement_scores(self, pairs, subtree_index: int) -> np.ndarray:
        """Insertion scores of a subtree at many candidate edges at once
        (batched replacement for stepwise.c:486-525)."""
        out = _placement_scores(self.packed, self.node_cost,
                                jnp.asarray(pairs, dtype=jnp.int32),
                                jnp.int32(subtree_index))
        return np.asarray(out) + self.const_cost

    def root_score(self, root_index: int) -> int:
        return int(self.node_cost[root_index]) + self.const_cost
