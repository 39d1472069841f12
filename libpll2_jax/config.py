"""Static partition configuration (hashable; safe to close over under jit).

The engine splits libpll-2's pll_partition_t (pll.h:241-288) into two
halves:

  * PartitionConfig — static shape/mode information, fixed at creation time,
    traced into compiled programs as Python constants;
  * a pytree of device arrays (see partition.py) — everything numeric.

Sites are padded to a multiple of `site_block` so the site axis tiles the
fused sweep's site blocks and shards cleanly across a device mesh; padding
columns carry pattern_weight 0 and never contribute to results.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from .constants import AB_NONE


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Mirror of pll_partition_create's static arguments (pll.c:424-868)."""
    tips: int
    clv_buffers: int
    states: int
    sites: int
    rate_matrices: int
    prob_matrices: int
    rate_cats: int
    scale_buffers: int
    per_rate_scalers: bool = False
    # PATTERN_TIP (pll.h:124): in the reference, tips stay char-encoded and
    # kernels expand through a precomputed tip-pair lookup.  Here the
    # functional engine (engine.py) always keeps tips as packed chars and
    # expands on the fly (same semantics, SURVEY.md §8.3#4);
    # the mutable Partition materializes tip CLVs into the dense tensor, so
    # the flag is accepted for API parity but does not change its layout.
    pattern_tip: bool = False
    site_repeats: bool = False
    asc_bias: int = AB_NONE
    asc_bias_flag: bool = False  # apply correction during logL computation
    dtype: Any = jnp.float64
    site_block: int = 128
    # fused Pallas sweep on the GPU: None = where it was measured faster,
    # True = wherever it can run, False = never (XLA level path)
    use_pallas: Any = None

    @property
    def num_clvs(self) -> int:
        return self.tips + self.clv_buffers

    @property
    def sites_alloc(self) -> int:
        """True sites plus asc-bias phantom sites (pll.c:525-531)."""
        if self.asc_bias != AB_NONE:
            return self.sites + self.states
        return self.sites

    @property
    def sites_padded(self) -> int:
        return round_up(self.sites_alloc, self.site_block)

    @property
    def span(self) -> int:
        return self.states * self.rate_cats

    # --- reserved array rows -------------------------------------------------
    # CLV row layout:    [0, num_clvs) real, num_clvs = scratch (dummy writes).
    # Scaler row layout: [0, scale_buffers) real, scale_buffers = always-zero
    #                    (reads for SCALE_BUFFER_NONE), scale_buffers+1 =
    #                    scratch (dummy writes).
    @property
    def clv_scratch(self) -> int:
        return self.num_clvs

    @property
    def scaler_zero(self) -> int:
        return self.scale_buffers

    @property
    def scaler_scratch(self) -> int:
        return self.scale_buffers + 1

    @property
    def scale_threshold(self) -> float:
        """Underflow-rescue threshold; dtype-dependent.

        f64 matches the reference exactly (2^-256, pll.h:96-99).  f32 cannot
        represent 2^-256; the f32 fast path uses 2^-30 so that a *product of
        two* rescued CLVs (root-edge logL, core_likelihood.c:1191+) stays
        ≥ 2^-60, comfortably inside f32 normal range — scaler counts differ
        from the reference but the corrected log-likelihood agrees.
        """
        if self.dtype == jnp.float64:
            return 2.0 ** -256
        return 2.0 ** -30

    @property
    def scale_factor(self) -> float:
        if self.dtype == jnp.float64:
            return 2.0 ** 256
        return 2.0 ** 30

    @property
    def log_scale_threshold(self) -> float:
        import math
        return math.log(self.scale_threshold)
