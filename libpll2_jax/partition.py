"""Partition object: owns the CLV/scaler/P-matrix device buffers and model
parameters, and exposes a libpll-2-compatible API surface.

Mirrors pll_partition_t and its lifecycle functions
(libpll-2 src/pll.c:424-1224, src/models.c:445-493) re-designed for an accelerator:

  * all numeric state is a flat pytree of jnp arrays (dense tensors with the
    site axis innermost/padded, see config.py) — no per-node mallocs;
  * tips are materialized as 0/1 CLV rows from bit-encoded ambiguity states
    (pll.c:959-1024 semantics) so one fused kernel serves tt/ti/ii cases;
  * eigendecomposition is lazy and host-side (models.py), invalidated by
    set_subst_params / set_frequencies exactly like the reference
    (models.c:466,490);
  * compute methods dispatch to jitted functional kernels in ops/.

The mutating API exists for parity and scripting convenience; performance
paths should use the functional engine (engine.py) where the whole
traversal + reduction compiles into one XLA program.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import constants
from . import repeats as repeats_mod
from .config import PartitionConfig
from .models import gamma as gamma_mod
from .models import ratematrix
from .ops import derivatives as derivatives_ops
from .ops import likelihood as likelihood_ops
from .ops import partials as partials_ops
from .ops import pmatrix as pmatrix_ops

SCALE_BUFFER_NONE = constants.SCALE_BUFFER_NONE


@dataclasses.dataclass
class Operation:
    """One CLV update: mirrors pll_operation_t (pll.h:325-335)."""
    parent_clv_index: int
    child1_clv_index: int
    child2_clv_index: int
    child1_matrix_index: int
    child2_matrix_index: int
    parent_scaler_index: int = SCALE_BUFFER_NONE
    child1_scaler_index: int = SCALE_BUFFER_NONE
    child2_scaler_index: int = SCALE_BUFFER_NONE


# --------------------------------------------------------------------------
# jitted kernels (cfg static)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_update_partials(clv, scalers, pmatrix, level_ops, cfg):
    return partials_ops.update_partials(clv, scalers, pmatrix, level_ops, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_update_partials_repeats(clv, scalers, pmatrix, level_ops,
                                 level_gathers, cfg):
    return partials_ops.update_partials_repeats(clv, scalers, pmatrix,
                                                level_ops, level_gathers,
                                                cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_pmatrices(pmatrix, matrix_indices, branch_lengths, eigenvals,
                   eigenvecs, inv_eigenvecs, rates, prop_invar,
                   params_indices, cfg):
    new = pmatrix_ops.compute_pmatrices(
        branch_lengths, eigenvals, eigenvecs, inv_eigenvecs, rates,
        prop_invar, params_indices, dtype=cfg.dtype)
    return pmatrix.at[matrix_indices].set(new)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_root_logl(clv_row, scaler_row, freqs, rate_weights, prop_invar,
                   invariant, pattern_weights, cfg):
    return likelihood_ops.root_loglikelihood(
        clv_row, scaler_row, freqs, rate_weights, prop_invar, invariant,
        pattern_weights, cfg, with_persite=True)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_edge_logl(clvp, sp, clvc, sc, pmat, freqs, rate_weights, prop_invar,
                   invariant, pattern_weights, cfg):
    return likelihood_ops.edge_loglikelihood(
        clvp, sp, clvc, sc, pmat, freqs, rate_weights, prop_invar,
        invariant, pattern_weights, cfg, with_persite=True)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_node_ancestral(clv_node, scaler_node, clv_other, scaler_other,
                        pmat, freqs, rate_weights, cfg):
    return likelihood_ops.node_ancestral(
        clv_node, scaler_node, clv_other, scaler_other, pmat, freqs,
        rate_weights, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_sumtable(clvp, clvc, sp, sc, eigenvecs, inv_eigenvecs, freqs, cfg,
                  asc_scalers=None):
    return derivatives_ops.update_sumtable(
        clvp, clvc, sp, sc, eigenvecs, inv_eigenvecs, freqs, cfg,
        asc_scalers=asc_scalers)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_derivatives(sumtable, branch_length, rates, eigenvals, prop_invar,
                     rate_weights, freqs, invariant, pattern_weights, cfg):
    return derivatives_ops.likelihood_derivatives(
        sumtable, branch_length, rates, eigenvals, prop_invar, rate_weights,
        freqs, invariant, pattern_weights, cfg)


# --------------------------------------------------------------------------
# levelization of operation lists
# --------------------------------------------------------------------------

def levelize_operations(ops: Sequence[Operation], cfg: PartitionConfig
                        ) -> np.ndarray:
    """Group a post-order operation list into levels of independent updates.

    An op can run once none of its children are produced later in the same
    level; ops whose children are all tips/previously-ready run first.  The
    result is a dense [L, W, 8] int32 tensor, padded with no-op rows that
    target the scratch CLV/scaler slots (config.py row conventions).

    The reference executes ops strictly serially (partials.c:245-291); on device
    each level becomes one batched gather+einsum+scatter.
    """
    level_of: dict[int, int] = {}
    levels: list[list[Operation]] = []
    for op in ops:
        l1 = level_of.get(op.child1_clv_index, 0)
        l2 = level_of.get(op.child2_clv_index, 0)
        lvl = max(l1, l2)
        level_of[op.parent_clv_index] = lvl + 1
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(op)

    if not levels:
        return np.zeros((0, 1, partials_ops.OP_COLS), dtype=np.int32)

    width = max(len(l) for l in levels)
    out = np.empty((len(levels), width, partials_ops.OP_COLS), dtype=np.int32)
    noop = np.array([cfg.clv_scratch, cfg.clv_scratch, cfg.clv_scratch,
                     0, 0, cfg.scaler_scratch, cfg.scaler_zero,
                     cfg.scaler_zero], dtype=np.int32)
    out[:] = noop
    for li, lops in enumerate(levels):
        for wi, op in enumerate(lops):
            out[li, wi] = _encode_op(op, cfg)
    return out


def levelize_operations_repeats(ops: Sequence[Operation],
                                cfg: PartitionConfig,
                                repeats) -> tuple:
    """Levelize AND update the site-repeats class structure in post-order,
    emitting per-op child gather arrays (see repeats.py).

    Returns (level_ops [L, W, 8], level_gathers [L, W, 2, T])."""
    T = cfg.sites_padded
    gather_of: dict[int, np.ndarray] = {}
    for op in ops:
        repeats.update(op.parent_clv_index, op.child1_clv_index,
                       op.child2_clv_index, op.parent_scaler_index)
        g1 = repeats.child_gather(op.parent_clv_index, op.child1_clv_index,
                                  T)
        g2 = repeats.child_gather(op.parent_clv_index, op.child2_clv_index,
                                  T)
        gather_of[id(op)] = np.stack([g1, g2])

    level_of: dict[int, int] = {}
    levels: list[list[Operation]] = []
    for op in ops:
        lvl = max(level_of.get(op.child1_clv_index, 0),
                  level_of.get(op.child2_clv_index, 0))
        level_of[op.parent_clv_index] = lvl + 1
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(op)

    if not levels:
        return (np.zeros((0, 1, partials_ops.OP_COLS), dtype=np.int32),
                np.zeros((0, 1, 2, T), dtype=np.int32))

    width = max(len(l) for l in levels)
    out = np.empty((len(levels), width, partials_ops.OP_COLS),
                   dtype=np.int32)
    noop = np.array([cfg.clv_scratch, cfg.clv_scratch, cfg.clv_scratch,
                     0, 0, cfg.scaler_scratch, cfg.scaler_zero,
                     cfg.scaler_zero], dtype=np.int32)
    out[:] = noop
    gathers = np.broadcast_to(np.arange(T, dtype=np.int32),
                              (len(levels), width, 2, T)).copy()
    for li, lops in enumerate(levels):
        for wi, op in enumerate(lops):
            out[li, wi] = _encode_op(op, cfg)
            gathers[li, wi] = gather_of[id(op)]
    return out, gathers


def _encode_op(op: Operation, cfg: PartitionConfig) -> np.ndarray:
    def scaler_read(idx):
        return cfg.scaler_zero if idx == SCALE_BUFFER_NONE else idx

    def scaler_write(idx):
        return cfg.scaler_scratch if idx == SCALE_BUFFER_NONE else idx

    return np.array([
        op.parent_clv_index,
        op.child1_clv_index,
        op.child2_clv_index,
        op.child1_matrix_index,
        op.child2_matrix_index,
        scaler_write(op.parent_scaler_index),
        scaler_read(op.child1_scaler_index),
        scaler_read(op.child2_scaler_index),
    ], dtype=np.int32)


# --------------------------------------------------------------------------
# Partition
# --------------------------------------------------------------------------

class Partition:
    """Device-array equivalent of pll_partition_t."""

    def __init__(self, tips: int, clv_buffers: int, states: int, sites: int,
                 rate_matrices: int, prob_matrices: int, rate_cats: int,
                 scale_buffers: int, *, per_rate_scalers: bool = False,
                 pattern_tip: bool = False, site_repeats: bool = False,
                 asc_bias: int = constants.AB_NONE,
                 dtype=jnp.float64, site_block: int = 128):
        # repeats auto-disabled for tiny alignments (pll.c:446-449)
        site_repeats = site_repeats and sites >= repeats_mod.MIN_SITES
        cfg = PartitionConfig(
            tips=tips, clv_buffers=clv_buffers, states=states, sites=sites,
            rate_matrices=rate_matrices, prob_matrices=prob_matrices,
            rate_cats=rate_cats, scale_buffers=scale_buffers,
            per_rate_scalers=per_rate_scalers, pattern_tip=pattern_tip,
            site_repeats=site_repeats, asc_bias=asc_bias, dtype=dtype,
            site_block=site_block)
        self.cfg = cfg
        self.repeats: Optional[repeats_mod.Repeats] = None
        if site_repeats:
            additional = cfg.sites_alloc - sites
            self.repeats = repeats_mod.Repeats(cfg.num_clvs, scale_buffers,
                                               sites, additional)
        T = cfg.sites_padded
        R, S = rate_cats, states

        self.clv = jnp.zeros((cfg.num_clvs + 1, R, S, T), dtype=dtype)
        if per_rate_scalers:
            self.scalers = jnp.zeros((scale_buffers + 2, R, T), jnp.int32)
        else:
            self.scalers = jnp.zeros((scale_buffers + 2, T), jnp.int32)
        self.pmatrix = jnp.zeros((prob_matrices, R, S, S), dtype=dtype)

        M = rate_matrices
        self.frequencies = np.full((M, S), 1.0 / S)
        self.subst_params = np.ones((M, S * (S - 1) // 2))
        self.rates = np.zeros(R)
        self.rate_weights = np.full(R, 1.0 / R)
        self.prop_invar = np.zeros(M)
        self.invariant: Optional[np.ndarray] = None

        self.pattern_weights = np.zeros(T)
        self.pattern_weights[:sites] = 1.0
        if cfg.asc_bias != constants.AB_NONE:
            # phantom per-state sites get weight 1 by default (pll.c:1145+)
            self.pattern_weights[sites:sites + states] = 1.0

        # per-rate-matrix eigen decomposition (lazy, host-side)
        self.eigenvals = np.zeros((M, S))
        self.eigenvecs = np.zeros((M, S, S))
        self.inv_eigenvecs = np.zeros((M, S, S))
        self.eigen_decomp_valid = np.zeros(M, dtype=bool)

        # encoded tip characters (for invariant sites & pattern-tip mode)
        self.tipchars = np.zeros((tips, cfg.sites_alloc), dtype=np.uint64)
        self.tipchars_valid = np.zeros(tips, dtype=bool)

    # --- setters (pll.c / models.c) ---------------------------------------

    def set_tip_states(self, tip_index: int, charmap: np.ndarray,
                       sequence: str) -> None:
        """Encode an ASCII sequence into a 0/1 tip CLV (pll.c:1026-1064)."""
        cfg = self.cfg
        if len(sequence) != cfg.sites:
            raise ValueError(
                f"sequence length {len(sequence)} != sites {cfg.sites}")
        codes = charmap[np.frombuffer(sequence.encode("ascii"), np.uint8)]
        if np.any(codes == 0):
            bad = np.flatnonzero(codes == 0)[0]
            raise ValueError(
                f"illegal state character {sequence[bad]!r} at site {bad}")
        codes = codes.astype(np.uint64)
        full = np.zeros(cfg.sites_alloc, dtype=np.uint64)
        full[:cfg.sites] = codes
        if cfg.asc_bias != constants.AB_NONE:
            # phantom site s observes pure state s (pll.c:1006-1018)
            full[cfg.sites:cfg.sites + cfg.states] = \
                1 << np.arange(cfg.states, dtype=np.uint64)
        self.tipchars[tip_index] = full
        self.tipchars_valid[tip_index] = True

        if self.repeats is not None:
            # class-indexed tip CLV (pll_update_repeats_tips,
            # repeats.c:189-254): one 0/1 column per distinct state code
            self.repeats.update_tip(tip_index, full)
            ns = self.repeats.sites_number(tip_index)
            full = full[self.repeats.pernode_id_site[tip_index, :ns]]
        bits = (full[None, :] >> np.arange(cfg.states, dtype=np.uint64)
                [:, None]) & 1                        # [S, len(full)]
        row = np.zeros((cfg.rate_cats, cfg.states, cfg.sites_padded))
        row[:, :, :full.size] = bits[None, :, :]
        self.clv = self.clv.at[tip_index].set(jnp.asarray(row, cfg.dtype))

    def set_tip_clv(self, tip_index: int, clv: np.ndarray,
                    padded: bool = False) -> None:
        """Set a tip CLV from user-supplied values (pll.c:1066-1129).

        clv is [sites, rate_cats, states] (or [sites*rate_cats*states] flat).
        """
        cfg = self.cfg
        arr = np.asarray(clv, dtype=np.float64).reshape(
            cfg.sites, cfg.rate_cats, cfg.states)
        row = np.zeros((cfg.rate_cats, cfg.states, cfg.sites_padded))
        row[:, :, :cfg.sites] = np.transpose(arr, (1, 2, 0))
        if cfg.asc_bias != constants.AB_NONE:
            for s in range(cfg.states):
                row[:, s, cfg.sites + s] = 1.0
        self.clv = self.clv.at[tip_index].set(jnp.asarray(row, cfg.dtype))
        self.tipchars_valid[tip_index] = False

    def set_frequencies(self, freqs_index: int, freqs) -> None:
        self.frequencies[freqs_index] = ratematrix.normalize_frequencies(
            np.asarray(freqs))
        self.eigen_decomp_valid[freqs_index] = False

    def set_subst_params(self, params_index: int, params) -> None:
        self.subst_params[params_index] = np.asarray(params, dtype=np.float64)
        self.eigen_decomp_valid[params_index] = False

    def set_category_rates(self, rates) -> None:
        self.rates = np.asarray(rates, dtype=np.float64)

    def set_category_weights(self, weights) -> None:
        self.rate_weights = np.asarray(weights, dtype=np.float64)

    def set_gamma_rates(self, alpha: float,
                        mode: int = constants.GAMMA_RATES_MEAN) -> None:
        self.set_category_rates(
            gamma_mod.compute_gamma_cats(alpha, self.cfg.rate_cats, mode))

    def set_pattern_weights(self, weights) -> None:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape[0] != self.cfg.sites:
            raise ValueError("pattern weights length mismatch")
        self.pattern_weights[:self.cfg.sites] = w

    def set_asc_state_weights(self, weights) -> None:
        """Weights of the phantom per-state sites (pll.c:1193-1224)."""
        cfg = self.cfg
        if cfg.asc_bias == constants.AB_NONE:
            raise ValueError("partition created without asc bias")
        self.pattern_weights[cfg.sites:cfg.sites + cfg.states] = \
            np.asarray(weights, dtype=np.float64)

    # --- invariant sites (models.c:495-752) --------------------------------

    def update_invariant_sites(self) -> None:
        cfg = self.cfg
        if not self.tipchars_valid.all():
            raise ValueError("all tips must be set via set_tip_states first")
        gap = constants.gap_state(cfg.states)
        state = np.full(cfg.sites, gap, dtype=np.uint64)
        for t in range(cfg.tips):
            state &= self.tipchars[t, :cfg.sites]
        popcnt = np.array([bin(int(v)).count("1") for v in state])
        inv = np.where(popcnt == 1,
                       np.array([(int(v) & -int(v)).bit_length() - 1
                                 if v else 0 for v in state]),
                       -1).astype(np.int32)
        full = np.full(cfg.sites_padded, -1, dtype=np.int32)
        full[:cfg.sites] = inv
        self.invariant = full

    def count_invariant_sites(self) -> int:
        """Weighted count of invariant sites (pll_count_invariant_sites,
        models.c:546-649)."""
        if self.invariant is None:
            self.update_invariant_sites()
        inv = self.invariant[:self.cfg.sites]
        w = self.pattern_weights[:self.cfg.sites]
        return int(np.sum(np.where(inv >= 0, w, 0)))

    def update_invariant_sites_proportion(self, params_index: int,
                                          prop_invar: float) -> None:
        if prop_invar < 0 or prop_invar >= 1:
            raise ValueError(f"invalid proportion of invariant sites "
                             f"({prop_invar})")
        if prop_invar > 0 and self.invariant is None:
            self.update_invariant_sites()
            if not np.any(self.invariant[:self.cfg.sites] >= 0):
                raise ValueError("no invariant sites found")
        self.prop_invar[params_index] = prop_invar

    # --- eigen + P-matrices ------------------------------------------------

    def update_eigen(self, params_index: int) -> None:
        dec = ratematrix.update_eigen(self.subst_params[params_index],
                                      self.frequencies[params_index])
        self.eigenvals[params_index] = dec.eigenvals
        self.eigenvecs[params_index] = dec.eigenvecs
        self.inv_eigenvecs[params_index] = dec.inv_eigenvecs
        self.eigen_decomp_valid[params_index] = True

    def update_prob_matrices(self, params_indices, matrix_indices,
                             branch_lengths) -> None:
        """Mirror of pll_update_prob_matrices (models.c:412-443)."""
        params_indices = np.asarray(params_indices, dtype=np.int32)
        for pi in np.unique(params_indices):
            if not self.eigen_decomp_valid[pi]:
                self.update_eigen(pi)
        self.pmatrix = _jit_pmatrices(
            self.pmatrix, jnp.asarray(matrix_indices, jnp.int32),
            jnp.asarray(branch_lengths, self.cfg.dtype),
            jnp.asarray(self.eigenvals), jnp.asarray(self.eigenvecs),
            jnp.asarray(self.inv_eigenvecs), jnp.asarray(self.rates),
            jnp.asarray(self.prop_invar), jnp.asarray(params_indices),
            cfg=self.cfg)

    # --- partials ----------------------------------------------------------

    def update_partials(self, operations: Sequence[Operation]) -> None:
        if self.repeats is not None:
            level_ops, level_gathers = levelize_operations_repeats(
                operations, self.cfg, self.repeats)
            self.clv, self.scalers = _jit_update_partials_repeats(
                self.clv, self.scalers, self.pmatrix,
                jnp.asarray(level_ops), jnp.asarray(level_gathers),
                cfg=self.cfg)
            return
        level_ops = levelize_operations(operations, self.cfg)
        self.clv, self.scalers = _jit_update_partials(
            self.clv, self.scalers, self.pmatrix, jnp.asarray(level_ops),
            cfg=self.cfg)

    # --- likelihoods -------------------------------------------------------

    def _gather_model(self, freqs_indices):
        fi = np.asarray(freqs_indices, dtype=np.int32)
        freqs = jnp.asarray(self.frequencies[fi])
        pinv = jnp.asarray(self.prop_invar[fi])
        return freqs, pinv

    def _invariant_arr(self):
        if self.invariant is None:
            return jnp.full(self.cfg.sites_padded, -1, jnp.int32)
        return jnp.asarray(self.invariant)

    def _clv_row(self, idx):
        """CLV row, expanded to site-indexed when class-indexed (repeats)."""
        row = self.clv[idx]
        if self.repeats is not None and self.repeats.pernode_ids[idx]:
            g = self.repeats.expand_gather(idx, self.cfg.sites_padded)
            row = row[:, :, jnp.asarray(g)]
        return row

    def _scaler_row(self, idx, node_idx=None):
        if idx == SCALE_BUFFER_NONE:
            return self.scalers[self.cfg.scaler_zero]
        row = self.scalers[idx]
        if (self.repeats is not None and self.repeats.perscale_ids[idx]):
            node = self.repeats.perscale_node[idx] \
                if node_idx is None else node_idx
            g = jnp.asarray(self.repeats.expand_gather(
                node, self.cfg.sites_padded))
            row = row[..., g]
        return row

    def compute_root_loglikelihood(self, clv_index: int, scaler_index: int,
                                   freqs_indices, return_persite=False):
        freqs, pinv = self._gather_model(freqs_indices)
        logl, persite = _jit_root_logl(
            self._clv_row(clv_index), self._scaler_row(scaler_index),
            freqs,
            jnp.asarray(self.rate_weights), pinv, self._invariant_arr(),
            jnp.asarray(self.pattern_weights, self.cfg.dtype), cfg=self.cfg)
        if return_persite:
            return float(logl), np.asarray(persite)[:self.cfg.sites]
        return float(logl)

    def compute_edge_loglikelihood(self, parent_clv_index: int,
                                   parent_scaler_index: int,
                                   child_clv_index: int,
                                   child_scaler_index: int,
                                   matrix_index: int, freqs_indices,
                                   return_persite=False):
        freqs, pinv = self._gather_model(freqs_indices)
        logl, persite = _jit_edge_logl(
            self._clv_row(parent_clv_index),
            self._scaler_row(parent_scaler_index),
            self._clv_row(child_clv_index),
            self._scaler_row(child_scaler_index),
            self.pmatrix[matrix_index], freqs,
            jnp.asarray(self.rate_weights), pinv, self._invariant_arr(),
            jnp.asarray(self.pattern_weights, self.cfg.dtype), cfg=self.cfg)
        if return_persite:
            return float(logl), np.asarray(persite)[:self.cfg.sites]
        return float(logl)

    def compute_node_ancestral(self, node_clv_index: int,
                               node_scaler_index: int,
                               other_clv_index: int,
                               other_scaler_index: int,
                               matrix_index: int, freqs_indices) -> np.ndarray:
        """Marginal ancestral state probabilities, [sites, states]
        (pll_compute_node_ancestral, likelihood.c:639-823)."""
        freqs, _ = self._gather_model(freqs_indices)
        anc = _jit_node_ancestral(
            self._clv_row(node_clv_index),
            self._scaler_row(node_scaler_index),
            self._clv_row(other_clv_index),
            self._scaler_row(other_scaler_index),
            self.pmatrix[matrix_index], freqs,
            jnp.asarray(self.rate_weights), cfg=self.cfg)
        return np.asarray(anc)[:self.cfg.sites]

    # --- derivatives -------------------------------------------------------

    def update_sumtable(self, parent_clv_index: int, child_clv_index: int,
                        parent_scaler_index: int, child_scaler_index: int,
                        params_indices):
        pi = np.asarray(params_indices, dtype=np.int32)
        for p in np.unique(pi):
            if not self.eigen_decomp_valid[p]:
                self.update_eigen(p)
        if self.cfg.per_rate_scalers:
            sp = self._scaler_row(parent_scaler_index)
            sc = self._scaler_row(child_scaler_index)
        else:
            sp = sc = jnp.zeros((self.cfg.rate_cats, 1), jnp.int32)
        asc_scalers = None
        if (self.cfg.asc_bias in (constants.AB_LEWIS, constants.AB_FELSENSTEIN)
                and not self.cfg.per_rate_scalers):
            asc_scalers = (self._scaler_row(parent_scaler_index)
                           + self._scaler_row(child_scaler_index))
        return _jit_sumtable(
            self._clv_row(parent_clv_index), self._clv_row(child_clv_index),
            sp, sc,
            jnp.asarray(self.eigenvecs[pi]),
            jnp.asarray(self.inv_eigenvecs[pi]),
            jnp.asarray(self.frequencies[pi]), cfg=self.cfg,
            asc_scalers=asc_scalers)

    def compute_likelihood_derivatives(self, sumtable, branch_length: float,
                                       params_indices):
        pi = np.asarray(params_indices, dtype=np.int32)
        d1, d2 = _jit_derivatives(
            sumtable, jnp.asarray(branch_length, self.cfg.dtype),
            jnp.asarray(self.rates), jnp.asarray(self.eigenvals[pi]),
            jnp.asarray(self.prop_invar[pi]),
            jnp.asarray(self.rate_weights), jnp.asarray(self.frequencies[pi]),
            self._invariant_arr(),
            jnp.asarray(self.pattern_weights, self.cfg.dtype), cfg=self.cfg)
        return float(d1), float(d2)

    # --- debug accessors ---------------------------------------------------

    def get_clv(self, index: int) -> np.ndarray:
        """CLV as [sites_alloc, rate_cats, states] (reference layout)."""
        cfg = self.cfg
        row = np.asarray(self.clv[index])[:, :, :cfg.sites_alloc]
        return np.transpose(row, (2, 0, 1))

    def get_pmatrix(self, index: int) -> np.ndarray:
        return np.asarray(self.pmatrix[index])

    # --- site-repeats queries (repeats.c:63-98) ----------------------------

    def repeats_enabled(self) -> bool:
        return self.repeats is not None

    def get_sites_number(self, clv_index: int) -> int:
        """pll_get_sites_number: class count (or sites) + phantom sites."""
        if self.repeats is not None:
            return self.repeats.sites_number(clv_index)
        return self.cfg.sites_alloc

    def get_clv_size(self, clv_index: int) -> int:
        return self.get_sites_number(clv_index) * self.cfg.span

    def get_site_id(self, clv_index: int):
        """site -> class id map, or None when the node is dense."""
        if self.repeats is None:
            return None
        return self.repeats.site_id(clv_index)

    def get_id_site(self, clv_index: int):
        """class id -> representative site map, or None when dense."""
        if self.repeats is None:
            return None
        return self.repeats.id_site(clv_index)

    def get_scaler(self, index: int) -> np.ndarray:
        cfg = self.cfg
        row = np.asarray(self.scalers[index])
        return row[..., :cfg.sites_alloc]
