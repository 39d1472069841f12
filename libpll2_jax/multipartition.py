"""Multi-partition models: K per-gene partitions sharing ONE topology.

Reference clients (RAxML-NG / ModelTest-NG) drive one `pll_partition_t`
per gene over its site range (SURVEY.md §2.6; struct `pll.h:241-288`) and
combine log-likelihoods / derivative sums host-side, branch by branch.
Re-design: the K partitions are compiled into ONE jitted
program — the per-partition sweeps run back to back on device (XLA
schedules them without host round-trips), the per-edge Newton steps
optimize the SHARED branch lengths against the summed (d1, d2), and the
total log-likelihood is a single scalar.

Partitions may differ in everything but the topology: states (mixed
DNA + protein runs), rate categories, models, site counts, asc-bias,
scaler mode.  Branch-length linkage (the RAxML-NG brlen modes):

  * linked  — one branch-length vector shared by all partitions
              (scalers=None);
  * scaled  — shared vector, per-partition multiplier (pass `scalers`,
              shape [K]; d/dt folds the chain rule into the Newton sums);
  * unlinked — just run K independent engines; no machinery needed here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import engine
from .config import PartitionConfig
from .ops import derivatives as derivatives_ops
from .ops import likelihood as likelihood_ops
from .tree.utree import UTree


@dataclasses.dataclass(frozen=True, eq=False)
class MultiPartition:
    """Static compiled form: one topology, K partition configs."""
    programs: tuple                  # TreeProgram per partition
    fulls: tuple                     # FullTreeProgram per partition
    cfgs: tuple                      # PartitionConfig per partition
    _hash: int = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def n_partitions(self) -> int:
        return len(self.cfgs)

    def _content_key(self):
        return (self.programs, self.fulls, self.cfgs)

    def __eq__(self, other):
        return (type(other) is type(self)
                and self._content_key() == other._content_key())

    def __hash__(self):
        if self._hash is None:
            object.__setattr__(self, "_hash", hash(self._content_key()))
        return self._hash


def compile_multipartition(tree: UTree, cfgs: Sequence[PartitionConfig]
                           ) -> MultiPartition:
    """Compile one topology against K partition configs.

    All cfgs must agree on `tips` (same taxa); everything else may vary.
    The edge layout (edge_rows order, colors, pmatrix indices) depends on
    the topology only, so it is identical across the K FullTreePrograms —
    the shared branch vector indexes all of them consistently.
    """
    tips = {c.tips for c in cfgs}
    if len(tips) != 1 or tips.pop() != tree.tip_count:
        raise ValueError("all partitions must cover the same taxa as the "
                         "shared topology")
    programs = tuple(engine.compile_tree(tree, c) for c in cfgs)
    fulls = tuple(engine.compile_tree_full(tree, c) for c in cfgs)
    for f in fulls[1:]:
        np.testing.assert_array_equal(f.edge_rows, fulls[0].edge_rows)
        np.testing.assert_array_equal(f.pmatrix_indices,
                                      fulls[0].pmatrix_indices)
    return MultiPartition(programs=programs, fulls=fulls, cfgs=tuple(cfgs))


def _partition_branches(branch_lengths, scalers, k: int, dtype):
    bl = branch_lengths.astype(dtype)
    if scalers is None:
        return bl
    return bl * scalers[k].astype(dtype)


@functools.partial(jax.jit, static_argnames=("mp",))
def loglikelihood(mp: MultiPartition, models, branch_lengths,
                  tipchars, pattern_weights, invariant, scalers=None):
    """Total log-likelihood over all partitions, one device program.

    models / tipchars / pattern_weights / invariant: K-tuples (one entry
    per partition, shaped for that partition's cfg); branch_lengths: the
    SHARED [E] vector; scalers: optional [K] per-partition multipliers.
    """
    total = jnp.zeros((), jnp.float64 if mp.cfgs[0].dtype == jnp.float64
                      else jnp.float32)
    for k in range(mp.n_partitions):
        cfg = mp.cfgs[k]
        lk = engine.loglikelihood(
            mp.programs[k], cfg, models[k],
            _partition_branches(branch_lengths, scalers, k, cfg.dtype),
            tipchars[k], pattern_weights[k], invariant[k])
        total = total + lk.astype(total.dtype)
    return total


@functools.partial(jax.jit, static_argnames=("mp",))
def branch_derivatives(mp: MultiPartition, models, branch_lengths,
                       tipchars, pattern_weights, invariant, scalers=None):
    """Summed (d1, d2) of -lnL w.r.t. every SHARED branch length ([E], [E]).

    The reference's per-branch sumtable machinery evaluated per partition
    and chain-ruled through the optional per-partition scaler:
    d/dt Σ_k L_k(s_k t) = Σ_k s_k d1_k, d² = Σ_k s_k² d2_k.
    """
    edge_rows = jnp.asarray(mp.fulls[0].edge_rows)
    sweeps = []
    for k in range(mp.n_partitions):
        cfg = mp.cfgs[k]
        sweeps.append(engine._sweep_all(
            mp.fulls[k], cfg, models[k],
            _partition_branches(branch_lengths, scalers, k, cfg.dtype),
            tipchars[k]))

    def per_edge(args):
        rows, t = args
        d1 = jnp.zeros((), jnp.float64)
        d2 = jnp.zeros((), jnp.float64)
        for k in range(mp.n_partitions):
            cfg = mp.cfgs[k]
            model = models[k]
            clv, scals, _ = sweeps[k]
            sp_zero = jnp.zeros((cfg.rate_cats, 1), jnp.int32)
            sp, sc = ((scals[rows[1]], scals[rows[3]])
                      if cfg.per_rate_scalers else (sp_zero, sp_zero))
            st = derivatives_ops.update_sumtable(
                clv[rows[0]], clv[rows[2]], sp, sc,
                model.eigenvecs[model.params_indices],
                model.inv_eigenvecs[model.params_indices],
                model.cat_freqs, cfg,
                asc_scalers=engine._asc_scalers(scals, rows, cfg))
            s_k = (jnp.asarray(1.0, cfg.dtype) if scalers is None
                   else scalers[k].astype(cfg.dtype))
            d1k, d2k = derivatives_ops.likelihood_derivatives(
                st, t.astype(cfg.dtype) * s_k, model.rates,
                model.eigenvals[model.params_indices], model.cat_pinv,
                model.rate_weights, model.cat_freqs, invariant[k],
                pattern_weights[k], cfg)
            d1 = d1 + (s_k * d1k).astype(d1.dtype)
            d2 = d2 + (s_k * s_k * d2k).astype(d2.dtype)
        return d1, d2

    return jax.lax.map(per_edge, (edge_rows, branch_lengths))


@functools.partial(jax.jit, static_argnames=("mp", "rounds", "newton_iters"))
def optimize_branch_lengths(mp: MultiPartition, models, branch_lengths,
                            tipchars, pattern_weights, invariant,
                            scalers=None, rounds: int = 3,
                            newton_iters: int = 10,
                            min_branch: float = 1e-8,
                            max_branch: float = 100.0):
    """Newton-optimize the SHARED branch lengths against the summed
    multi-partition likelihood (engine.optimize_branch_lengths lifted to
    K partitions; same color-class Jacobi smoothing).

    Returns (optimized_branch_lengths, total_logl_after).
    """
    edge_rows = jnp.asarray(mp.fulls[0].edge_rows)
    colors = np.asarray(mp.fulls[0].edge_colors)
    bl_dtype = branch_lengths.dtype

    def optimize_class(bl, color_mask):
        sweeps = []
        for k in range(mp.n_partitions):
            cfg = mp.cfgs[k]
            sweeps.append(engine._sweep_all(
                mp.fulls[k], cfg, models[k],
                _partition_branches(bl, scalers, k, cfg.dtype),
                tipchars[k]))

        def per_edge(args):
            rows, t0 = args
            sts = []
            for k in range(mp.n_partitions):
                cfg = mp.cfgs[k]
                model = models[k]
                clv, scals, _ = sweeps[k]
                sp_zero = jnp.zeros((cfg.rate_cats, 1), jnp.int32)
                sp, sc = ((scals[rows[1]], scals[rows[3]])
                          if cfg.per_rate_scalers else (sp_zero, sp_zero))
                sts.append(derivatives_ops.update_sumtable(
                    clv[rows[0]], clv[rows[2]], sp, sc,
                    model.eigenvecs[model.params_indices],
                    model.inv_eigenvecs[model.params_indices],
                    model.cat_freqs, cfg,
                    asc_scalers=engine._asc_scalers(scals, rows, cfg)))

            def newton_step(_, t):
                d1 = jnp.zeros((), jnp.float64)
                d2 = jnp.zeros((), jnp.float64)
                for k in range(mp.n_partitions):
                    cfg = mp.cfgs[k]
                    model = models[k]
                    s_k = (jnp.asarray(1.0, cfg.dtype) if scalers is None
                           else scalers[k].astype(cfg.dtype))
                    d1k, d2k = derivatives_ops.likelihood_derivatives(
                        sts[k], t.astype(cfg.dtype) * s_k, model.rates,
                        model.eigenvals[model.params_indices],
                        model.cat_pinv, model.rate_weights,
                        model.cat_freqs, invariant[k], pattern_weights[k],
                        cfg)
                    d1 = d1 + (s_k * d1k).astype(d1.dtype)
                    d2 = d2 + (s_k * s_k * d2k).astype(d2.dtype)
                newton = t - (d1 / d2).astype(bl_dtype)
                fallback = jnp.where(d1 > 0, t * 0.5, t * 2.0)
                t_new = jnp.where(d2 > 0, newton, fallback)
                return jnp.clip(t_new, min_branch, max_branch)

            return jax.lax.fori_loop(0, newton_iters, newton_step, t0)

        proposal = jax.lax.map(per_edge, (edge_rows, bl))
        return jnp.where(color_mask, proposal, bl).astype(bl_dtype)

    n_colors = mp.fulls[0].n_colors

    def one_round(bl, _):
        for c in range(n_colors):
            bl = optimize_class(bl, jnp.asarray(colors == c))
        return bl, None

    bl, _ = jax.lax.scan(one_round, branch_lengths, None, length=rounds)

    total = jnp.zeros((), jnp.float64)
    ra, rsa, rb, rsb = mp.fulls[0].edge_rows[mp.fulls[0].root_edge]
    root_slot = int(mp.fulls[0].pmatrix_indices[mp.fulls[0].root_edge])
    for k in range(mp.n_partitions):
        cfg = mp.cfgs[k]
        model = models[k]
        clv, scals, pmatrix = engine._sweep_all(
            mp.fulls[k], cfg, models[k],
            _partition_branches(bl, scalers, k, cfg.dtype), tipchars[k])
        lk = likelihood_ops.edge_loglikelihood(
            clv[ra], scals[rsa], clv[rb], scals[rsb], pmatrix[root_slot],
            model.cat_freqs, model.rate_weights, model.cat_pinv,
            invariant[k], pattern_weights[k], cfg)
        total = total + lk.astype(total.dtype)
    return bl, total
