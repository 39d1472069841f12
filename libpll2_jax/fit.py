"""Gradient-based model fitting — autodiff through the whole likelihood.

The reference library exposes only likelihood values and analytic
branch-length derivatives; model-parameter optimization (GTR rates, base
frequencies, alpha) is left to clients, which wrap it in derivative-free
optimizers (Brent/L-BFGS-B in RAxML-NG / ModelTest-NG).  Because this
framework's entire pipeline — eigendecomposition (ratematrix.update_
eigen_jax), P-matrices, CLV sweep, logL reduction — is a differentiable
JAX program, d logL / d(anything) comes from jax.grad in one backward
pass, and fitting is a standard first-order optimization.

Parametrization (all unconstrained):
  * subst params:  exp(x) for the first K-1, last pinned to 1
    (models.c:198-202 normalization makes the last rate the unit)
  * frequencies:   softmax(logits) — strictly positive, sums to 1
  * branch lengths: exp(x) — strictly positive

By default the fit runs on the XLA engine path (cfg.use_pallas=False),
whose whole graph XLA can differentiate.  Passing a FullTreeProgram
(engine.compile_tree_full) switches gradients to the analytic message-
based VJP (engine.loglikelihood_analytic), which lets the FORWARD pass
run the fused Pallas sweep — fitting on the fast path.  Gradient checks
against the analytic (d1, d2) machinery live in tests/test_fit.py and
tests/test_analytic_vjp.py.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import engine
from .config import PartitionConfig
from .models import ratematrix


class FitParams(NamedTuple):
    """Unconstrained optimization variables (a pytree)."""
    log_subst: jax.Array     # [M, K-1]
    freq_logits: jax.Array   # [M, S]
    log_branch: jax.Array    # [E]
    log_alpha: jax.Array     # [] gamma shape (ignored unless fit_alpha)


def pack(subst_params, frequencies, branch_lengths, alpha: float = 1.0,
         dtype=jnp.float32, break_ties: float = 1e-3) -> FitParams:
    """Pack starting values into unconstrained variables.

    break_ties: symmetric starts (e.g. Jukes–Cantor: all rates equal,
    uniform frequencies) have exactly degenerate Q eigenvalues, where the
    eigh JVP is singular (it divides by eigenvalue gaps) and the first
    gradient is NaN.  Tied substitution rates are therefore nudged apart
    by a deterministic relative stagger of this size (0 disables)."""
    subst = np.atleast_2d(np.asarray(subst_params, np.float64))
    freqs = np.atleast_2d(np.asarray(frequencies, np.float64))
    if break_ties:
        for m in range(subst.shape[0]):
            if np.unique(subst[m]).size < subst.shape[1]:
                k = subst.shape[1]
                subst[m] = subst[m] * (1.0 + break_ties
                                       * np.arange(k) / k)
    subst = subst / subst[:, -1:]
    return FitParams(
        log_subst=jnp.asarray(np.log(subst[:, :-1]), dtype),
        freq_logits=jnp.asarray(np.log(freqs), dtype),
        log_branch=jnp.asarray(np.log(np.asarray(branch_lengths)), dtype),
        log_alpha=jnp.asarray(np.log(alpha), dtype),
    )


def unpack(p: FitParams):
    """-> (subst_params [M,K], frequencies [M,S], branch_lengths [E])."""
    subst = jnp.concatenate(
        [jnp.exp(p.log_subst),
         jnp.ones((p.log_subst.shape[0], 1), p.log_subst.dtype)], axis=1)
    freqs = jax.nn.softmax(p.freq_logits, axis=-1)
    return subst, freqs, jnp.exp(p.log_branch)


def make_model_traced(subst_params, frequencies, rates, rate_weights=None,
                      prop_invar=None, params_indices=None,
                      dtype=jnp.float32) -> engine.Model:
    """Differentiable counterpart of engine.make_model: eigendecomposition
    stays inside the trace (grads flow to subst_params / frequencies)."""
    M = frequencies.shape[0]
    R = len(rates)
    d, v, iv = jax.vmap(ratematrix.update_eigen_jax)(subst_params,
                                                     frequencies)
    if rate_weights is None:
        rate_weights = jnp.full((R,), 1.0 / R, dtype)
    if prop_invar is None:
        prop_invar = jnp.zeros((M,), dtype)
    if params_indices is None:
        params_indices = jnp.zeros((R,), jnp.int32)
    return engine.Model(
        eigenvals=d.astype(dtype), eigenvecs=v.astype(dtype),
        inv_eigenvecs=iv.astype(dtype),
        frequencies=frequencies.astype(dtype),
        rates=jnp.asarray(rates, dtype),
        rate_weights=jnp.asarray(rate_weights, dtype),
        prop_invar=jnp.asarray(prop_invar, dtype),
        params_indices=jnp.asarray(params_indices, jnp.int32),
    )


def _xla_cfg(cfg: PartitionConfig) -> PartitionConfig:
    return dataclasses.replace(cfg, use_pallas=False)


def _rates(params: FitParams, rates, cfg: PartitionConfig,
           fit_alpha: bool):
    if not fit_alpha:
        return jnp.asarray(rates, cfg.dtype)
    from .models.gamma import compute_gamma_cats_jax
    n = len(rates)
    return compute_gamma_cats_jax(jnp.exp(params.log_alpha),
                                  n).astype(cfg.dtype)


@functools.partial(jax.jit, static_argnames=("program", "cfg", "fit_alpha",
                                             "full_program"))
def loglikelihood_fn(program, cfg: PartitionConfig, params: FitParams,
                     rates, tipchars, pattern_weights, invariant,
                     fit_alpha: bool = False, full_program=None):
    """logL as a differentiable function of FitParams.

    With a FullTreeProgram (engine.compile_tree_full), the gradient uses
    the analytic message-based VJP (engine.loglikelihood_analytic), so the
    forward pass may run the Pallas fast path; otherwise the XLA path is
    forced (the Pallas sweep has no XLA-differentiable graph)."""
    subst, freqs, bl = unpack(params)
    if full_program is None:
        cfg = _xla_cfg(cfg)
    model = make_model_traced(subst, freqs,
                              _rates(params, rates, cfg, fit_alpha),
                              dtype=cfg.dtype)
    if full_program is not None:
        return engine.loglikelihood_analytic(
            program, full_program, cfg, model, bl, tipchars,
            pattern_weights, invariant)
    return engine.loglikelihood(program, cfg, model, bl, tipchars,
                                pattern_weights, invariant)


class FitResult(NamedTuple):
    params: FitParams
    logl: jax.Array          # [steps] trajectory
    grad_norm: jax.Array     # final gradient norm


@functools.partial(jax.jit,
                   static_argnames=("program", "cfg", "steps", "lr",
                                    "fit_alpha", "full_program"))
def fit_model(program, cfg: PartitionConfig, params0: FitParams, rates,
              tipchars, pattern_weights, invariant,
              steps: int = 200, lr: float = 0.05,
              fit_alpha: bool = False, full_program=None) -> FitResult:
    """Maximize logL over (GTR rates, frequencies, branch lengths, and —
    with fit_alpha — the gamma shape via the differentiable
    discretization) with Adam — the whole optimization is ONE compiled
    program on device.

    full_program (engine.compile_tree_full): use the analytic VJP so the
    forward pass rides the Pallas fast path (see loglikelihood_fn)."""
    import optax
    if full_program is None:
        cfg = _xla_cfg(cfg)
    opt = optax.adam(lr)

    def loss(p):
        return -loglikelihood_fn(program, cfg, p, rates, tipchars,
                                 pattern_weights, invariant,
                                 fit_alpha=fit_alpha,
                                 full_program=full_program)

    def step(carry, _):
        p, opt_state = carry
        value, grads = jax.value_and_grad(loss)(p)
        updates, opt_state = opt.update(grads, opt_state)
        p = optax.apply_updates(p, updates)
        return (p, opt_state), -value

    (p, _), logls = jax.lax.scan(step, (params0, opt.init(params0)), None,
                                 length=steps)
    g = jax.grad(loss)(p)
    gn = jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)))
    return FitResult(params=p, logl=logls, grad_norm=gn)
