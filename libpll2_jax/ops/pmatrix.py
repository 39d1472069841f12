"""Batched transition-probability matrix computation (device side).

P(t) for every (edge, rate-category) pair in one fused XLA program, mirroring
the reference semantics of pll_core_update_pmatrix
(libpll-2 src/core_pmatrix.c:24-258):

  * expd_j = expm1(lambda_j * rate_r * t / (1 - pinv_r))  — the expm1 + add-I
    trick keeps P exact as Qt -> 0;
  * P = I + inv_eigenvecs @ diag(expd) @ eigenvecs;
  * t == 0 -> exact identity matrix;
  * params_indices maps each rate category to its rate matrix (LG4-style
    per-category matrices fall out naturally).

Shapes: E = edges/branches in the batch, R = rate categories, S = states,
M = rate matrices.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 matmuls may run in TF32 on the GPU (about three decimal digits);
# the likelihood recursion is precision-critical, so force full f32
HIGHEST = jax.lax.Precision.HIGHEST


def compute_pmatrices(branch_lengths,      # [E] f
                      eigenvals,           # [M, S]
                      eigenvecs,           # [M, S, S]
                      inv_eigenvecs,       # [M, S, S]
                      rates,               # [R]
                      prop_invar,          # [M]
                      params_indices,      # [R] int (rate cat -> rate matrix)
                      dtype=jnp.float64):
    """Return P-matrices [E, R, S, S] for a batch of branch lengths."""
    evals = eigenvals[params_indices]          # [R, S]
    evecs = eigenvecs[params_indices]          # [R, S, S]
    inv_evecs = inv_eigenvecs[params_indices]  # [R, S, S]
    pinv = prop_invar[params_indices]          # [R]

    t = jnp.asarray(branch_lengths, dtype=dtype)            # [E]
    # exponent per (edge, rate, state)
    scaled_rates = rates / (1.0 - pinv)                     # [R]
    exponent = (t[:, None, None] * scaled_rates[None, :, None]
                * evals[None, :, :])                        # [E, R, S]
    expd = jnp.expm1(exponent).astype(dtype)

    # temp[e,r,j,k] = inv_evecs[r,j,k] * expd[e,r,k];  P = I + temp @ evecs
    temp = inv_evecs[None, :, :, :] * expd[:, :, None, :]
    pmat = jnp.einsum("erjm,rmk->erjk", temp, evecs.astype(dtype),
                      preferred_element_type=dtype, precision=HIGHEST)
    states = evals.shape[-1]
    eye = jnp.eye(states, dtype=dtype)
    pmat = pmat + eye[None, None, :, :]

    # zero branch length -> exact identity (core_pmatrix.c:239-245)
    zero = (t <= 0.0)[:, None, None, None]
    pmat = jnp.where(zero, eye[None, None, :, :], pmat)
    return pmat


def scatter_pmatrices(pmatrix,            # [P, R, S, S] full buffer
                      matrix_indices,     # [E] int
                      new_pmats):         # [E, R, S, S]
    """Write freshly computed P-matrices into the partition's buffer."""
    return pmatrix.at[matrix_indices].set(new_pmats)
