"""Root and edge log-likelihood reductions.

Reference semantics: pll_core_root_loglikelihood and
pll_core_edge_loglikelihood_ii (libpll-2 src/core_likelihood.c:25-209,
1191-1496), including:

  * +I invariant-site mixing:  L_r = (1-p) * L_var,r + p * pi[inv_state]
    per rate category (prop_invar can differ per category via params_indices);
  * per-site scaler correction:  logL += scaler * log(scale_threshold);
  * per-rate scalers: per-site common minimum, relative per-rate scalers
    capped at SCALE_RATE_MAXDIFF and un-done multiplicatively
    (core_likelihood.c:1388-1414);
  * the invariant term is never scaled — with active scalers the variant part
    is un-scaled (capped) before adding the invariant part
    (core_likelihood.c:1462-1481).

All functions are pure, shaped [R = rate cats, S = states, T = padded sites],
and reduce over sites with pattern weights (zero on padding ⇒ padding inert).
The weighted per-site log-likelihood sum is exactly site-shardable: under a
mesh, shard T and psum the scalar (SURVEY.md §2.6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 matmuls may run in TF32 on the GPU (about three decimal digits);
# the likelihood recursion is precision-critical, so force full f32
HIGHEST = jax.lax.Precision.HIGHEST
import numpy as np

from ..config import PartitionConfig
from ..constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE, AB_STAMATAKIS,
                         SCALE_RATE_MAXDIFF)


def _real_site_mask(cfg: PartitionConfig):
    """Static bool [T]: True on real alignment columns, False on the
    asc-bias phantom per-state columns and padding (pll.c:525-531)."""
    return np.arange(cfg.sites_padded) < cfg.sites


def asc_bias_correction(term, site_scalings, pattern_weights,
                        cfg: PartitionConfig, dtype):
    """Ascertainment-bias logL correction from the phantom per-state sites.

    Mirrors compute_asc_bias_correction + root_loglikelihood_asc_bias
    (likelihood.c:24-120): `term` is the pre-log per-site likelihood
    (rate-weighted, no +I — incompatible), `site_scalings` the per-site
    scaler counters.  Lewis: -sum_w*log(1-L_base); Felsenstein:
    sum_w_inv*log(L_base); Stamatakis: weighted lnL of the phantom sites.
    """
    s0, S = cfg.sites, cfg.states
    log_thresh = jnp.asarray(cfg.log_scale_threshold, dtype)
    t_ph = term[s0:s0 + S]
    sc_ph = site_scalings[s0:s0 + S].astype(dtype)
    w_ph = pattern_weights[s0:s0 + S].astype(dtype)
    if cfg.asc_bias == AB_STAMATAKIS:
        # the reference adds the scaler correction UNWEIGHTED (site_lk =
        # w*log(term); then += scale_factors*log(thresh) — likelihood.c:
        # 97-101); replicate exactly, weights on the log-likelihood only
        return jnp.sum(w_ph * jnp.log(t_ph) + sc_ph * log_thresh)
    base = jnp.sum(t_ph * jnp.exp(sc_ph * log_thresh))
    if cfg.asc_bias == AB_LEWIS:
        sum_w = jnp.sum(jnp.where(jnp.asarray(_real_site_mask(cfg)),
                                  pattern_weights, 0.0).astype(dtype))
        return -(sum_w * jnp.log1p(-base))
    if cfg.asc_bias == AB_FELSENSTEIN:
        return jnp.sum(w_ph) * jnp.log(base)
    raise ValueError(f"illegal asc bias type {cfg.asc_bias}")


def _per_rate_undo(scaler_p, scaler_c, cfg: PartitionConfig, dtype):
    """Combine per-rate scalers of two nodes into (site_min, undo_factor).

    Returns (site_scalings [T] int32, undo [R, T] multiplicative factor).
    """
    total = scaler_p + scaler_c                       # [R, T]
    site_scalings = jnp.min(total, axis=0)            # [T]
    rel = jnp.minimum(total - site_scalings[None, :], SCALE_RATE_MAXDIFF)
    undo = jnp.power(jnp.asarray(cfg.scale_threshold, dtype),
                     rel.astype(dtype))               # thresh^rel, rel=0 -> 1
    return site_scalings, undo


def _invariant_site_lk(freqs, invariant):
    """pi[inv_state] per (rate, site); 0 where the site is variant.

    freqs: [R, S]; invariant: [T] int32 (-1 = variant).
    """
    idx = jnp.maximum(invariant, 0)                   # [T]
    vals = freqs[:, idx]                              # [R, T]
    return jnp.where(invariant[None, :] >= 0, vals, 0.0)


def root_loglikelihood(clv,              # [R, S, T]
                       scaler,           # [T] int32 or [R, T] (per-rate)
                       freqs,            # [R, S] (gathered by freqs_indices)
                       rate_weights,     # [R]
                       prop_invar,       # [R] (gathered by freqs_indices)
                       invariant,        # [T] int32, -1 = variant
                       pattern_weights,  # [T] (0 on padding)
                       cfg: PartitionConfig,
                       with_persite: bool = False):
    """Weighted log-likelihood at a (virtual) root CLV.

    Mirrors pll_core_root_loglikelihood (core_likelihood.c:25-209).  The
    per-rate-scaler mode uses the same min+cap protocol as the edge kernel
    (the reference's generic root kernel predates per-rate scaling and does
    not support it; we implement the natural extension).
    """
    # bf16 is a CLV STORAGE format, not an accumulation format: the
    # reduction runs in f32 (a bf16 sum quantizes the total logL itself)
    dtype = jnp.float32 if clv.dtype == jnp.bfloat16 else clv.dtype
    term_r = jnp.einsum("rst,rs->rt", clv, freqs.astype(dtype),
                        preferred_element_type=dtype, precision=HIGHEST)       # [R, T]

    if cfg.per_rate_scalers:
        zero = jnp.zeros_like(scaler)
        site_scalings, undo = _per_rate_undo(scaler, zero, cfg, dtype)
        term_r = term_r * undo
    else:
        site_scalings = scaler                               # [T]

    pinv = prop_invar.astype(dtype)                          # [R]
    any_pinv = True  # traced branch: keep single program; pinv==0 is inert
    if any_pinv:
        inv_lk = _invariant_site_lk(freqs.astype(dtype), invariant)  # [R, T]
        mixed = term_r * (1.0 - pinv)[:, None] + inv_lk * pinv[:, None]
        term_r = jnp.where((pinv > 0)[:, None], mixed, term_r)

    term = jnp.einsum("rt,r->t", term_r, rate_weights.astype(dtype), precision=HIGHEST)  # [T]

    live = pattern_weights > 0
    if cfg.asc_bias != AB_NONE:
        # phantom per-state sites feed the correction, not the main sum
        live = jnp.logical_and(live, jnp.asarray(_real_site_mask(cfg)))
    safe_term = jnp.where(live, term, 1.0)
    site_lk = jnp.log(safe_term)
    site_lk = site_lk + site_scalings.astype(dtype) * cfg.log_scale_threshold
    site_lk = jnp.where(live, site_lk * pattern_weights.astype(dtype), 0.0)

    logl = jnp.sum(site_lk)
    if cfg.asc_bias != AB_NONE:
        logl = logl + asc_bias_correction(term, site_scalings,
                                          pattern_weights, cfg, dtype)
    if with_persite:
        return logl, site_lk
    return logl


def edge_loglikelihood(clvp,             # [R, S, T] parent CLV
                       scaler_p,         # [T] or [R, T] int32
                       clvc,             # [R, S, T] child CLV
                       scaler_c,         # [T] or [R, T] int32
                       pmat,             # [R, S, S] P-matrix of the edge
                       freqs,            # [R, S]
                       rate_weights,     # [R]
                       prop_invar,       # [R]
                       invariant,        # [T] int32
                       pattern_weights,  # [T]
                       cfg: PartitionConfig,
                       with_persite: bool = False):
    """Log-likelihood across an edge: parent-side CLV · P(t) · child-side CLV.

    Mirrors pll_core_edge_loglikelihood_ii (core_likelihood.c:1191-1496).
    """
    # bf16 CLVs: accumulate in f32 (see root_loglikelihood)
    dtype = jnp.float32 if clvp.dtype == jnp.bfloat16 else clvp.dtype
    termb = jnp.einsum("rjk,rkt->rjt", pmat.astype(dtype), clvc,
                       preferred_element_type=dtype, precision=HIGHEST)
    terma_r = jnp.einsum("rjt,rj,rjt->rt", clvp, freqs.astype(dtype), termb,
                         preferred_element_type=dtype, precision=HIGHEST)       # [R, T]
    return edge_reduce(terma_r, scaler_p, scaler_c, freqs, rate_weights,
                       prop_invar, invariant, pattern_weights, cfg,
                       with_persite=with_persite)


def edge_reduce(terma_r,          # [R, T] pre-log edge terms (stored scale)
                scaler_p,         # [T] or [R, T] int32
                scaler_c,         # [T] or [R, T] int32
                freqs,            # [R, S]
                rate_weights,     # [R]
                prop_invar,       # [R]
                invariant,        # [T] int32
                pattern_weights,  # [T]
                cfg: PartitionConfig,
                with_persite: bool = False):
    """Reduction tail of edge_loglikelihood from the per-(rate, site) edge
    terms Σ_ij π_i · clvp_i · P_ij · clvc_j (at the CLVs' stored scaling).

    Split out so the analytic reverse pass (engine.loglikelihood_analytic)
    can differentiate the reduction — scaler undo, +I mixing, asc-bias
    corrections — per edge by ordinary autodiff of THIS small [R, T]
    function while the message sweep stays analytic."""
    dtype = terma_r.dtype
    if cfg.per_rate_scalers:
        site_scalings, undo = _per_rate_undo(scaler_p, scaler_c, cfg, dtype)
        terma_r = terma_r * undo
    else:
        site_scalings = scaler_p + scaler_c                   # [T]

    pinv = prop_invar.astype(dtype)
    rw = rate_weights.astype(dtype)
    inv_lk = _invariant_site_lk(freqs.astype(dtype), invariant)   # [R, T]

    # variant part gets (1-p); invariant part accumulates separately
    terma = jnp.einsum("rt,r->t", terma_r * (1.0 - pinv)[:, None], rw, precision=HIGHEST)
    terminv = jnp.einsum("rt,r->t", inv_lk * pinv[:, None], rw, precision=HIGHEST)

    # site log-likelihood; three cases (core_likelihood.c:1462-1481)
    log_thresh = jnp.asarray(cfg.log_scale_threshold, dtype)
    scal = site_scalings.astype(dtype)
    capped = jnp.minimum(site_scalings, SCALE_RATE_MAXDIFF).astype(dtype)
    cap_factor = jnp.exp(capped * log_thresh)      # thresh^capped

    live = pattern_weights > 0
    if cfg.asc_bias != AB_NONE:
        live = jnp.logical_and(live, jnp.asarray(_real_site_mask(cfg)))
    has_scal = site_scalings > 0
    has_inv = terminv > 0.0

    # each log reads 1.0 wherever its case is not taken: an unused
    # argument that underflows to 0 (terma * thresh^capped) would give
    # log 0 = -inf and, under autodiff, 0 * inf = NaN gradients
    plain = jnp.where(live & ~has_scal, terma + terminv, 1.0)
    scaled_inv = jnp.where(live & has_scal & has_inv,
                           terma * cap_factor + terminv, 1.0)
    scaled_plain = jnp.where(live & has_scal & ~has_inv, terma, 1.0)

    site_lk = jnp.where(
        has_scal,
        jnp.where(has_inv,
                  jnp.log(scaled_inv),
                  jnp.log(scaled_plain) + scal * log_thresh),
        jnp.log(plain))

    site_lk = jnp.where(live, site_lk * pattern_weights.astype(dtype), 0.0)
    logl = jnp.sum(site_lk)
    if cfg.asc_bias != AB_NONE:
        # pinv is disallowed with asc bias, so terma+terminv == raw term
        logl = logl + asc_bias_correction(terma + terminv, site_scalings,
                                          pattern_weights, cfg, dtype)
    if with_persite:
        return logl, site_lk
    return logl


def node_ancestral(clv_node,         # [R, S, T] CLV toward the edge
                   scaler_node,      # [T] / [R, T] int32
                   clv_other,        # [R, S, T] CLV of the other direction
                   scaler_other,     # [T] / [R, T] int32
                   pmat,             # [R, S, S] P-matrix across the edge
                   freqs,            # [R, S]
                   rate_weights,     # [R]
                   cfg: PartitionConfig):
    """Marginal ancestral state probabilities at a node.

    pll_compute_node_ancestral (likelihood.c:639-823): combine the CLVs of
    the two edge directions — the node's own CLV passes through an IDENTITY
    P-matrix, the other direction through ``pmat`` — then form the per-site
    posterior  anc[t, j] ∝ Σ_r rw_r · π_{r,j} · clv_combined[r, j, t],
    normalized over states.

    Per-site scalers multiply every (r, j) of a site by the same power and
    cancel in the normalization; per-rate scalers are un-done (capped at
    SCALE_RATE_MAXDIFF, core_likelihood.c:445-491) before the rate sum.

    Returns [T, S] (padding sites normalized against a sum of ~0 are
    clamped to 0).
    """
    dtype = cfg.dtype
    combined = clv_node * jnp.einsum("rij,rjt->rit", pmat, clv_other,
                                     preferred_element_type=dtype, precision=HIGHEST)
    if cfg.per_rate_scalers:
        _, undo = _per_rate_undo(scaler_node, scaler_other, cfg, dtype)
        combined = combined * undo[:, None, :]
    weighted = jnp.einsum("r,rs,rst->ts", rate_weights.astype(dtype),
                          freqs.astype(dtype), combined, precision=HIGHEST)
    total = jnp.sum(weighted, axis=1, keepdims=True)
    return jnp.where(total > 0, weighted / jnp.where(total > 0, total, 1.0),
                     0.0)
