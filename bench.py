"""Benchmark: CLV site-update throughput of the engine on the GPU.

Prints ONE JSON line; primary metric:
  {"metric": "clv_site_updates_per_sec", "value": N,
   "unit": "site-updates/s/device", "device": {...}}
plus an "extra" object: a taxa sweep (64/256/1024), protein S=20
throughput and the production SPR search round time.  Each engine case
checks fused-sweep/XLA logL parity before it is timed.  Any failed case
fails the run; without a GPU it fails at once.

One site-update = one CLV operation applied to one alignment column over
all rate categories (the unit implied by the reference's speed harness,
test/runtest.py speed mode).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

from tools import cases

TIPS = int(os.environ.get("BENCH_TIPS", 256))
SITES = int(os.environ.get("BENCH_SITES", 65536))
REPS = int(os.environ.get("BENCH_REPS", 64))
FULL = os.environ.get("BENCH_FULL", "1") != "0"   # extra metric set


def measure_case(tips: int, sites: int, states: int = 4,
                 reps: int = REPS) -> dict:
    """Throughput + latency + on-device path parity for one engine case."""
    import jax
    import jax.numpy as jnp

    from libpll2_jax import engine

    _, cfg, program, args = cases.make_case(tips, sites, states, jnp.float32)
    t0 = time.time()
    logl = float(engine.loglikelihood(program, cfg, *args))
    cold_s = time.time() - t0
    cases.check(bool(np.isfinite(logl)), "non-finite logL")
    kernel = cases.took_kernel(engine.loglikelihood.lower(program, cfg, *args))
    cfg_xla = dataclasses.replace(cfg, use_pallas=False)
    logl_xla = float(engine.loglikelihood(program, cfg_xla, *args))
    parity = cases.rel(logl, logl_xla)
    print(f"[{tips}x{sites} S={states}] path={'kernel' if kernel else 'xla'}"
          f" compile+first {cold_s:.1f}s logl={logl} xla={logl_xla} "
          f"rel={parity:.2e}", file=sys.stderr)
    cases.check(parity < 5e-6, f"fused sweep vs XLA logL rel error {parity}")
    ms = cases.chained_ms(program, cfg, args, reps)
    jax.clear_caches()
    return {
        "tips": tips, "sites": sites, "states": states,
        "path": "kernel" if kernel else "xla",
        "updates_per_sec": (tips - 2) * sites / ms * 1e3,
        "full_tree_logl_ms": ms,
        "cold_compile_s": cold_s,
        "kernel_parity_rel_err": parity,
    }


def measure_search_round(rounds: int = 8) -> dict:
    """Steady SPR round (search_fast, radius 5) at 256 taxa x 4096 sites:
    per-phase wall time of the steady rounds and the logL reached."""
    from libpll2_jax import search_fast

    start, cfg, model, chars = cases.search_case(256, 4096, 20260820)
    t0 = time.time()
    _, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=rounds, radius=5,
        smooth_every=2)
    total = time.time() - t0
    rs = stats["round_secs"]
    steady = float(np.median(rs[1:])) if len(rs) > 1 else rs[0]
    steady_tms = stats["phase_timings"][1:] or stats["phase_timings"]
    phases = {}
    for k in {k for tm in steady_tms for k, v in tm.items()
              if isinstance(v, float)}:
        vals = [tm[k] for tm in steady_tms if isinstance(tm.get(k), float)]
        phases[k] = float(np.median(vals))
    print(f"[search] rounds={stats['rounds']} moves={stats['moves']} "
          f"first={rs[0]:.1f}s steady={steady:.2f}s total={total:.1f}s",
          file=sys.stderr)
    return {"tips": 256, "sites": 4096, "radius": 5,
            "first_round_s": rs[0], "steady_round_s": steady,
            "moves": stats["moves"], "phase_secs_steady": phases,
            "logl_final": logl}


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform}")
    from libpll2_jax.utils.cache import enable_compile_cache
    enable_compile_cache()

    primary = measure_case(TIPS, SITES, 4)
    extra = {"dna_256": primary}
    if FULL:
        for tips, sites, states, key in ((64, SITES, 4, "dna_64"),
                                         (1024, 16384, 4, "dna_1024"),
                                         (128, 16384, 20, "protein_128")):
            extra[key] = measure_case(tips, sites, states)
        extra["search_round"] = measure_search_round()
    print(json.dumps({
        "metric": "clv_site_updates_per_sec",
        "value": primary["updates_per_sec"],
        "unit": "site-updates/s/device",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
