"""Device-memory residency accounting and the max-sites-per-device story.

The reference's memory lever is site repeats (class-indexed CLVs,
src/repeats.c; −30% in EPA-ng per README.md:10).  The engine's lever is
stronger on its fast path: the fused sweep never materializes most inner
CLVs — residency is packed tip bitmasks (4 B/site/tip instead of
R·S·itemsize dense) plus a slot pool of O(log n) CLV rows (the live set of
the Sethi–Ullman schedule, ops/partials_pallas_tree.py).  For the
dense path (XLA level sweep) the lever is bf16 CLV storage
(2× headroom; error budget measured in tests/test_memory.py: ≤3e-4
relative logL, flat in depth — levels accumulate in f32 and round the
stored CLV once, so only storage rounding remains; f32 stays ≤2e-7).

All formulas count the arrays the jitted program keeps live; XLA adds
transient workspace it sizes itself (double-buffering one level batch).
"""
from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import PartitionConfig


def _itemsize(dtype) -> int:
    return int(np.dtype(dtype).itemsize) if dtype != jnp.bfloat16 else 2


def dense_clv_bytes(cfg: PartitionConfig) -> int:
    """CLV tensor residency of the dense (XLA level) path:
    one [num_clvs+1, R, S, T] slab (pll_partition_t's per-node CLVs in one
    allocation), plus the scaler rows."""
    it = _itemsize(cfg.dtype)
    clv = (cfg.num_clvs + 1) * cfg.rate_cats * cfg.states \
        * cfg.sites_padded * it
    sr = cfg.rate_cats if cfg.per_rate_scalers else 1
    scal = (cfg.scale_buffers + 2) * sr * cfg.sites_padded * 4
    return clv + scal


def device_memory_bytes(device=None) -> int:
    """Memory the JAX allocator may use on `device` (default: the first)."""
    import jax
    stats = (device or jax.devices()[0]).memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise ValueError("device reports no memory limit; pass hbm_bytes")
    return int(stats["bytes_limit"])


def max_sites(tips: int, states: int = 4, rate_cats: int = 4,
              dtype=jnp.float32, fast_path: bool = True,
              hbm_bytes: Optional[int] = None,
              reserve_fraction: float = 0.25) -> int:
    """Largest site count fitting one device's memory for a full binary
    tree on `tips` taxa, leaving `reserve_fraction` for XLA workspace.

    hbm_bytes: the device memory to plan for; None reads it from the
    first device (device_memory_bytes).
    fast_path=True: the fused-sweep engine (per-site cost 4·tips plus
    pool rows; the pool of a balanced tree, the Sethi–Ullman worst case,
    holds ceil(log2 tips) + 1 slots of R·Sp f32, Sp = states padded to a
    power of two); False: the dense CLV path (per-site cost
    ~2·tips·R·S·itemsize).
    """
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes()
    budget = int(hbm_bytes * (1.0 - reserve_fraction))
    it = _itemsize(dtype)
    if fast_path:
        slots = math.ceil(math.log2(tips)) + 1
        sp = 1 << (states - 1).bit_length()
        per_site = (tips * 4 + slots * (rate_cats * sp + 1) * 4
                    + 2 * rate_cats * states * 4 + 16)
        fixed = (2 * tips - 3) * rate_cats * states ** 2 * it
    else:
        num_clvs = 2 * tips - 2 + 1                      # tips + inners + 1
        per_site = num_clvs * rate_cats * states * it + tips * 4 \
            + (tips + 1) * 4
        fixed = (2 * tips - 3) * rate_cats * states ** 2 * it
    sites = (budget - fixed) // per_site
    return max(0, (sites // 128) * 128)


def max_sites_table(hbm_bytes: Optional[int] = None) -> str:
    """Markdown table of max sites per device across tree sizes and modes
    (README 'memory' section is generated from this)."""
    rows = ["| taxa | states | dense f64 | dense f32 | dense bf16 | "
            "fast path (f32-quality) |",
            "|---|---|---|---|---|---|"]
    for tips in (64, 256, 1024, 4096):
        for states in (4, 20):
            vals = [max_sites(tips, states, 4, dt, False, hbm_bytes)
                    for dt in (jnp.float64, jnp.float32, jnp.bfloat16)]
            fast = max_sites(tips, states, 4, jnp.float32, True, hbm_bytes)
            rows.append(f"| {tips} | {states} | " +
                        " | ".join(f"{v:,}" for v in vals) +
                        f" | {fast:,} |")
    return "\n".join(rows)
