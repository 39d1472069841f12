"""Conditional-likelihood-vector (CLV) updates — the Felsenstein pruning
inner loop, level-batched for an accelerator.

Reference semantics: pll_core_update_partial_ii and the scaling protocol
(libpll-2 src/core_partials.c:612-765, src/pll.h:96-104):

  parent[site, r, i] = (sum_j PL[r,i,j] * left[site,r,j])
                     * (sum_j PR[r,i,j] * right[site,r,j])

with counter-based underflow rescue: if every entry of a site's (or, in
per-rate mode, a (site, rate)'s) freshly computed CLV is below
scale_threshold, multiply by scale_factor and increment the integer scaler;
parent scaler = left scaler + right scaler + this increment.

Design decisions (vs. the reference's per-node serial loop):

  * CLVs live in one dense tensor [num_clvs+1, R, S, T] with the site axis
    innermost (contiguous, sharded across the mesh); tips are materialized as 0/1
    rows so a single fused kernel covers tip-tip / tip-inner / inner-inner.
  * The tree's post-order operation list is compiled (host-side) into levels
    of independent operations; each level executes as one gather + batched
    einsum + scatter, exposing within-tree parallelism the reference runs
    serially.  A lax.scan over the padded level tensor keeps one compiled
    body for any topology of the same (depth, width) signature.
  * Row num_clvs is write-scratch for padded (no-op) lanes; scaler rows
    scale_buffers / scale_buffers+1 are read-zeros / write-scratch
    (see config.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 matmuls may run in TF32 on the GPU (about three decimal digits);
# the likelihood recursion is precision-critical, so force full f32
HIGHEST = jax.lax.Precision.HIGHEST

from ..config import PartitionConfig

# Column layout of an operation row (host-compiled; see tree/utree.py):
OP_PARENT_CLV = 0
OP_CHILD1_CLV = 1
OP_CHILD2_CLV = 2
OP_CHILD1_MAT = 3
OP_CHILD2_MAT = 4
OP_PARENT_SCALER = 5
OP_CHILD1_SCALER = 6
OP_CHILD2_SCALER = 7
OP_COLS = 8


def _level_update(clv, scalers, pmatrix, ops, cfg: PartitionConfig):
    """Execute one level: a batch of W independent CLV updates.

    clv:      [N+1, R, S, T]
    scalers:  [Z+2, T] int32  (per-rate: [Z+2, R, T])
    pmatrix:  [P, R, S, S]
    ops:      [W, 8] int32
    """
    dtype = clv.dtype
    # bf16 is a storage format: accumulate each level in f32 and round the
    # stored parent once per level (error ~2^-9/level otherwise)
    acc = jnp.float32 if dtype == jnp.bfloat16 else dtype
    c1 = clv[ops[:, OP_CHILD1_CLV]]          # [W, R, S, T]
    c2 = clv[ops[:, OP_CHILD2_CLV]]
    p1 = pmatrix[ops[:, OP_CHILD1_MAT]]      # [W, R, S, S]
    p2 = pmatrix[ops[:, OP_CHILD2_MAT]]

    left = jnp.einsum("wrij,wrjt->writ", p1, c1,
                      preferred_element_type=acc, precision=HIGHEST)
    right = jnp.einsum("wrij,wrjt->writ", p2, c2,
                       preferred_element_type=acc, precision=HIGHEST)
    parent = (left * right).astype(dtype)     # [W, R, S, T]

    thresh = jnp.asarray(cfg.scale_threshold, dtype)
    factor = jnp.asarray(cfg.scale_factor, dtype)

    s1 = scalers[ops[:, OP_CHILD1_SCALER]]
    s2 = scalers[ops[:, OP_CHILD2_SCALER]]

    if cfg.per_rate_scalers:
        # per-(site, rate): all states below threshold -> rescue
        mask = jnp.all(parent < thresh, axis=2)               # [W, R, T]
        parent = jnp.where(mask[:, :, None, :], parent * factor, parent)
        snew = s1 + s2 + mask.astype(jnp.int32)               # [W, R, T]
    else:
        # per-site: all (rate, state) entries below threshold -> rescue
        mask = jnp.all(parent < thresh, axis=(1, 2))          # [W, T]
        parent = jnp.where(mask[:, None, None, :], parent * factor, parent)
        snew = s1 + s2 + mask.astype(jnp.int32)               # [W, T]

    clv = clv.at[ops[:, OP_PARENT_CLV]].set(parent)
    scalers = scalers.at[ops[:, OP_PARENT_SCALER]].set(snew)
    return clv, scalers


def update_partials(clv, scalers, pmatrix, level_ops, cfg: PartitionConfig):
    """Run a level-batched operations program.

    level_ops: [L, W, 8] int32 — L levels of up to W ops each, padded with
    no-op rows that read/write the scratch slots.
    Returns updated (clv, scalers).
    """
    if level_ops.shape[0] == 0:
        return clv, scalers

    def body(carry, ops):
        clv, scalers = carry
        clv, scalers = _level_update(clv, scalers, pmatrix, ops, cfg)
        return (clv, scalers), None

    (clv, scalers), _ = jax.lax.scan(body, (clv, scalers), level_ops)
    return clv, scalers


def _level_update_gather(clv, scalers, pmatrix, ops, gathers,
                         cfg: PartitionConfig):
    """One level of CLV updates with per-op site-axis gathers — the site
    repeats kernel (repeats.c semantics; see repeats.py).

    gathers: [W, 2, T] int32 — child1/child2 CLV slot feeding each parent
    slot.  Identity rows make this the dense kernel; class-indexed
    children are dereferenced by the gather, and the parent row is
    written class-indexed (slots beyond its class count hold unread
    values)."""
    dtype = clv.dtype
    g1 = gathers[:, 0][:, None, None, :]     # [W, 1, 1, T]
    g2 = gathers[:, 1][:, None, None, :]
    c1 = jnp.take_along_axis(clv[ops[:, OP_CHILD1_CLV]], g1, axis=3)
    c2 = jnp.take_along_axis(clv[ops[:, OP_CHILD2_CLV]], g2, axis=3)
    p1 = pmatrix[ops[:, OP_CHILD1_MAT]]
    p2 = pmatrix[ops[:, OP_CHILD2_MAT]]

    acc = jnp.float32 if dtype == jnp.bfloat16 else dtype
    left = jnp.einsum("wrij,wrjt->writ", p1, c1,
                      preferred_element_type=acc, precision=HIGHEST)
    right = jnp.einsum("wrij,wrjt->writ", p2, c2,
                       preferred_element_type=acc, precision=HIGHEST)
    parent = (left * right).astype(dtype)

    thresh = jnp.asarray(cfg.scale_threshold, dtype)
    factor = jnp.asarray(cfg.scale_factor, dtype)

    s1 = scalers[ops[:, OP_CHILD1_SCALER]]
    s2 = scalers[ops[:, OP_CHILD2_SCALER]]
    if cfg.per_rate_scalers:
        s1 = jnp.take_along_axis(s1, gathers[:, 0][:, None, :], axis=2)
        s2 = jnp.take_along_axis(s2, gathers[:, 1][:, None, :], axis=2)
        mask = jnp.all(parent < thresh, axis=2)
        parent = jnp.where(mask[:, :, None, :], parent * factor, parent)
        snew = s1 + s2 + mask.astype(jnp.int32)
    else:
        s1 = jnp.take_along_axis(s1, gathers[:, 0], axis=1)
        s2 = jnp.take_along_axis(s2, gathers[:, 1], axis=1)
        mask = jnp.all(parent < thresh, axis=(1, 2))
        parent = jnp.where(mask[:, None, None, :], parent * factor, parent)
        snew = s1 + s2 + mask.astype(jnp.int32)

    clv = clv.at[ops[:, OP_PARENT_CLV]].set(parent)
    scalers = scalers.at[ops[:, OP_PARENT_SCALER]].set(snew)
    return clv, scalers


def update_partials_repeats(clv, scalers, pmatrix, level_ops, level_gathers,
                            cfg: PartitionConfig):
    """Level-batched operations program with site-repeats gathers.

    level_ops: [L, W, 8]; level_gathers: [L, W, 2, T]."""
    if level_ops.shape[0] == 0:
        return clv, scalers

    def body(carry, x):
        ops, gathers = x
        c, s = _level_update_gather(carry[0], carry[1], pmatrix, ops,
                                    gathers, cfg)
        return (c, s), None

    (clv, scalers), _ = jax.lax.scan(body, (clv, scalers),
                                     (level_ops, level_gathers))
    return clv, scalers


def update_partials_unrolled(clv, scalers, pmatrix, levels, cfg):
    """Same as update_partials but with a Python-level loop over a list of
    differently-shaped level tensors (no scan padding waste; longer trace).
    Useful when level widths vary wildly (caterpillar trees)."""
    for ops in levels:
        clv, scalers = _level_update(clv, scalers, pmatrix, ops, cfg)
    return clv, scalers
