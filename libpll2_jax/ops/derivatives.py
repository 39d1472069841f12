"""Branch-length derivative machinery: sumtable + analytic (d1, d2).

Reference semantics (libpll-2 src/core_derivatives.c):

  * The sumtable factors out everything branch-length-independent
    (pll_core_update_sumtable_ii, core_derivatives.c:321-471):
        sum[t, r, j] = (sum_k clvp[k] * freq[k] * inv_evec[k, j])
                     * (sum_k evec[j, k] * clvc[k])
    so each Newton iteration costs only a sites×rates×states contraction.
  * Per (rate, state), diagp carries {e^{lam k t}, lam k e^{...},
    (lam k)^2 e^{...}} with k = rate / (1 - pinv)
    (core_derivatives.c:757-772).
  * site_lk[0..2] = sum_r rw_r * sum_j sum[r,j] * diagp[r,j,0..2] with +I
    mixing on the 0th component only (core_site_likelihood_derivatives,
    core_derivatives.c:643-694).
  * d(-lnL)/dt  = sum_t w_t * (-L'/L)
    d2(-lnL)/dt2 = sum_t w_t * ((L'/L)^2 - L''/L)   (:843-848).

Scalers: in per-site mode the common scale factor cancels in L'/L, so the
sumtable ignores scalers; in per-rate mode relative (capped) per-rate scalers
must be folded into the sumtable (core_derivatives.c:418-460).

Layout: sumtable [R, S, T] — site axis innermost, shardable across the mesh;
(d1, d2) are per-site weighted sums, reduced with psum when sharded.
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


def update_sumtable(clvp,            # [R, S, T] parent CLV
                    clvc,            # [R, S, T] child CLV
                    scaler_p,        # [R, T] int32 or None (per-rate only)
                    scaler_c,        # [R, T] int32 or None
                    eigenvecs,       # [R, S, S] (gathered per category)
                    inv_eigenvecs,   # [R, S, S]
                    freqs,           # [R, S]
                    cfg: PartitionConfig,
                    asc_scalers=None):  # [T] int32: per-site sp+sc sums
    """Branch-invariant sufficient statistics for one edge. Returns [R, S, T].

    Mirrors pll_core_update_sumtable_ii (core_derivatives.c:321-471).
    """
    dtype = clvp.dtype
    lefterm = jnp.einsum("rkt,rk,rkj->rjt", clvp, freqs.astype(dtype),
                         inv_eigenvecs.astype(dtype),
                         preferred_element_type=dtype, precision=HIGHEST)
    righterm = jnp.einsum("rjk,rkt->rjt", eigenvecs.astype(dtype), clvc,
                          preferred_element_type=dtype, precision=HIGHEST)
    sum_rjt = lefterm * righterm

    if (cfg.asc_bias in (AB_LEWIS, AB_FELSENSTEIN)
            and asc_scalers is not None and not cfg.per_rate_scalers):
        # fold thresh^scalers into the PHANTOM columns only: the asc
        # corrections need absolute likelihoods there (core_derivatives.c:
        # 884-892), while real-site ratios L'/L make scaling cancel.
        phantom = (np.arange(cfg.sites_padded) >= cfg.sites) \
            & (np.arange(cfg.sites_padded) < cfg.sites + cfg.states)
        undo = jnp.exp(asc_scalers.astype(dtype)
                       * jnp.asarray(cfg.log_scale_threshold, dtype))
        sum_rjt = jnp.where(jnp.asarray(phantom)[None, None, :],
                            sum_rjt * undo[None, None, :], sum_rjt)

    if cfg.per_rate_scalers:
        total = scaler_p + scaler_c                      # [R, T]
        min_scaler = jnp.min(total, axis=0)              # [T]
        rel = jnp.minimum(total - min_scaler[None, :], SCALE_RATE_MAXDIFF)
        undo = jnp.power(jnp.asarray(cfg.scale_threshold, dtype),
                         rel.astype(dtype))              # [R, T]
        sum_rjt = sum_rjt * undo[:, None, :]

    return sum_rjt


def sumtable_loglikelihood(sumtable,         # [R, S, T]
                           branch_length,    # scalar
                           rates,            # [R]
                           eigenvals,        # [R, S]
                           prop_invar,       # [R]
                           rate_weights,     # [R]
                           freqs,            # [R, S]
                           invariant,        # [T] int32
                           pattern_weights,  # [T]
                           site_scalings,    # [T] int32 summed scalers
                           cfg: PartitionConfig):
    """Log-likelihood of the edge AT branch length t, from its sumtable.

    Σ_j sum[r,j,t]·e^{λ_j k t} = clvp·freq·expm(Q k t)·clvc — the same
    per-site likelihood the edge logL kernel computes (cat0 of
    core_derivatives.c:643-694 with +I mixing), so one sumtable prices the
    edge at ANY length with an [R,S]×[R,S,T] contraction.  This is what
    makes batched placement scoring with per-edge Newton refinement cheap
    (no re-sweep per trial length).  Per-site scalers enter as the summed
    counter correction; per-rate relative scalers must already be folded
    into the sumtable (update_sumtable).

    Asc-bias: Lewis/Felsenstein require the PHANTOM columns of the
    sumtable to already be absolute (caller passes asc_scalers to
    update_sumtable, mirroring the likelihood_derivatives contract);
    Stamatakis uses the raw scalings.  +I is incompatible with asc bias
    (the reference refuses the combination at partition creation).
    """
    dtype = sumtable.dtype
    pinv = prop_invar.astype(dtype)
    ki = rates.astype(dtype) / (1.0 - pinv)
    e0 = jnp.exp(eigenvals.astype(dtype) * ki[:, None]
                 * jnp.asarray(branch_length, dtype))          # [R, S]
    cat0 = jnp.einsum("rjt,rj->rt", sumtable, e0,
                      preferred_element_type=dtype, precision=HIGHEST)
    idx = jnp.maximum(invariant, 0)
    inv_lk = jnp.where(invariant[None, :] >= 0,
                       freqs.astype(dtype)[:, idx], 0.0)
    has_pinv = (pinv > 0)[:, None]
    cat0 = jnp.where(has_pinv,
                     cat0 * (1.0 - pinv)[:, None] + inv_lk * pinv[:, None],
                     cat0)
    term = jnp.einsum("rt,r->t", cat0, rate_weights.astype(dtype),
                      precision=HIGHEST)
    live = pattern_weights > 0
    if cfg.asc_bias != AB_NONE:
        live = jnp.logical_and(
            live, jnp.asarray(np.arange(cfg.sites_padded) < cfg.sites))
    safe = jnp.where(live, term, 1.0)
    site_lk = jnp.log(safe) + site_scalings.astype(dtype) \
        * jnp.asarray(cfg.log_scale_threshold, dtype)
    logl = jnp.sum(jnp.where(live,
                             site_lk * pattern_weights.astype(dtype), 0.0))
    if cfg.asc_bias != AB_NONE:
        from .likelihood import asc_bias_correction
        sc = site_scalings
        if cfg.asc_bias in (AB_LEWIS, AB_FELSENSTEIN):
            # phantoms already absolute in the sumtable -> no re-undo
            phantom = (np.arange(cfg.sites_padded) >= cfg.sites) \
                & (np.arange(cfg.sites_padded) < cfg.sites + cfg.states)
            sc = jnp.where(jnp.asarray(phantom), 0, sc)
        logl = logl + asc_bias_correction(term, sc, pattern_weights, cfg,
                                          dtype)
    return logl


def likelihood_derivatives(sumtable,         # [R, S, T]
                           branch_length,    # scalar
                           rates,            # [R]
                           eigenvals,        # [R, S] (gathered per category)
                           prop_invar,       # [R]
                           rate_weights,     # [R]
                           freqs,            # [R, S]
                           invariant,        # [T] int32, -1 = variant
                           pattern_weights,  # [T] (0 on padding)
                           cfg: PartitionConfig):
    """(d1, d2) of -lnL wrt branch length, given the edge's sumtable.

    Mirrors pll_core_likelihood_derivatives (core_derivatives.c:696-929),
    without asc-bias corrections (handled by the caller for phantom sites).
    """
    dtype = sumtable.dtype
    pinv = prop_invar.astype(dtype)
    ki = rates.astype(dtype) / (1.0 - pinv)                    # [R]
    x = eigenvals.astype(dtype) * ki[:, None]                  # [R, S]
    e0 = jnp.exp(x * jnp.asarray(branch_length, dtype))        # [R, S]
    e1 = x * e0
    e2 = x * x * e0

    cat0 = jnp.einsum("rjt,rj->rt", sumtable, e0,
                      preferred_element_type=dtype, precision=HIGHEST)            # [R, T]
    cat1 = jnp.einsum("rjt,rj->rt", sumtable, e1,
                      preferred_element_type=dtype, precision=HIGHEST)
    cat2 = jnp.einsum("rjt,rj->rt", sumtable, e2,
                      preferred_element_type=dtype, precision=HIGHEST)

    # +I mixing, 0th component only (core_derivatives.c:676-686)
    idx = jnp.maximum(invariant, 0)
    inv_lk = jnp.where(invariant[None, :] >= 0,
                       freqs.astype(dtype)[:, idx], 0.0)       # [R, T]
    has_pinv = (pinv > 0)[:, None]
    cat0 = jnp.where(has_pinv,
                     cat0 * (1.0 - pinv)[:, None] + inv_lk * pinv[:, None],
                     cat0)
    cat1 = jnp.where(has_pinv, cat1 * (1.0 - pinv)[:, None], cat1)
    cat2 = jnp.where(has_pinv, cat2 * (1.0 - pinv)[:, None], cat2)

    rw = rate_weights.astype(dtype)
    lk0 = jnp.einsum("rt,r->t", cat0, rw, precision=HIGHEST)
    lk1 = jnp.einsum("rt,r->t", cat1, rw, precision=HIGHEST)
    lk2 = jnp.einsum("rt,r->t", cat2, rw, precision=HIGHEST)

    live = pattern_weights > 0
    if cfg.asc_bias not in (AB_NONE, AB_STAMATAKIS):
        # Lewis/Felsenstein: phantom sites excluded from the main sum and
        # folded in via the closed-form corrections (core_derivatives.c:
        # 851-924).  Stamatakis keeps them in the main sum (ef_sites =
        # sites + states, core_derivatives.c:735-742).
        live = jnp.logical_and(
            live, jnp.asarray(np.arange(cfg.sites_padded) < cfg.sites))
    safe0 = jnp.where(live, lk0, 1.0)
    deriv1 = -lk1 / safe0
    deriv2 = deriv1 * deriv1 - lk2 / safe0

    w = pattern_weights.astype(dtype)
    d1 = jnp.sum(jnp.where(live, w * deriv1, 0.0))
    d2 = jnp.sum(jnp.where(live, w * deriv2, 0.0))

    if cfg.asc_bias in (AB_LEWIS, AB_FELSENSTEIN):
        s0, S = cfg.sites, cfg.states
        # scalers cancel in L'/L for the main sum but NOT in the absolute
        # phantom likelihoods: the caller folds thresh^scalers into the
        # sumtable's phantom columns (update_sumtable asc_scalers).
        L0 = jnp.sum(lk0[s0:s0 + S])
        L1 = jnp.sum(lk1[s0:s0 + S])
        L2 = jnp.sum(lk2[s0:s0 + S])
        if cfg.asc_bias == AB_LEWIS:
            real = jnp.asarray(np.arange(cfg.sites_padded) < cfg.sites)
            sum_w = jnp.sum(jnp.where(real, w, 0.0))
            d1 = d1 + sum_w * (L1 / (L0 - 1.0))
            d2 = d2 + sum_w * (((L0 - 1.0) * L2 - L1 * L1)
                               / ((L0 - 1.0) * (L0 - 1.0)))
        else:
            sum_w_inv = jnp.sum(w[s0:s0 + S])
            d1 = d1 - sum_w_inv * (L1 / L0)
            d2 = d2 - sum_w_inv * ((L2 * L0 - L1 * L1) / (L0 * L0))
    return d1, d2
