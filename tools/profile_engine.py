#!/usr/bin/env python
"""Device-time profiles of the likelihood engine on the GPU.

  sweep  Full-tree logL: the fused Pallas sweep at each (site block,
         warps) variant against the XLA level path, timed as chained
         evaluations in one jitted lax.scan ended by block_until_ready.
  round  One traced steady SPR round (search_fast): device time by named
         scope ("ball_recursion", "edge_scoring", the rest), read from
         the jax.profiler trace.

Usage:
  python tools/profile_engine.py sweep [--shape dna_256] [--variants 128x4,256x4]
  python tools/profile_engine.py round [--tips 256] [--sites 4096] [--radius 5]
      [--trace-dir traces]
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools import cases  # noqa: E402

SHAPES = {"dna_256": (256, 65536, 4), "dna_1024": (1024, 16384, 4),
          "protein_128": (128, 16384, 20)}


def sweep(shape: str, variants, reps: int) -> None:
    import jax
    import jax.numpy as jnp

    from libpll2_jax import engine
    from libpll2_jax.ops import partials_pallas_tree as ppt

    tips, sites, states = SHAPES[shape]
    _, cfg, program, args = cases.make_case(tips, sites, states, jnp.float32)
    cfg_x = dataclasses.replace(cfg, use_pallas=False)
    logl_x = float(engine.loglikelihood(program, cfg_x, *args))
    ms_x = cases.chained_ms(program, cfg_x, args, reps)
    upd = (tips - 2) * sites
    print(f"[{shape}] xla: {ms_x:.4f} ms  {upd / ms_x * 1e3:.3e} "
          f"site-updates/s  logL={logl_x!r}", flush=True)
    cfg_k = dataclasses.replace(cfg, use_pallas=True)
    defaults = ppt.SITE_BLOCK, ppt.NUM_WARPS
    try:
        for tb, warps in variants:
            # the engine reads these defaults when it traces; clearing
            # the caches makes every variant trace afresh
            ppt.SITE_BLOCK, ppt.NUM_WARPS = tb, warps
            t0 = time.perf_counter()
            logl_k = float(engine.loglikelihood(program, cfg_k, *args))
            first = time.perf_counter() - t0
            ms_k = cases.chained_ms(program, cfg_k, args, reps)
            print(f"[{shape}] kernel tb={tb} warps={warps}: compile+first "
                  f"{first:.1f}s {ms_k:.4f} ms  {upd / ms_k * 1e3:.3e} "
                  f"site-updates/s  x{ms_x / ms_k:.2f} vs xla  "
                  f"rel={cases.rel(logl_k, logl_x):.2e}", flush=True)
            jax.clear_caches()
    finally:
        ppt.SITE_BLOCK, ppt.NUM_WARPS = defaults


def _op_names(hlo_text: str) -> dict:
    """HLO instruction name -> metadata op_name (named-scope path)."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?metadata=\{[^}]*?"
                         r"op_name=\"([^\"]*)\"", hlo_text):
        out[m.group(1)] = m.group(2)
    return out


def _scope(op_name: str) -> str:
    for s in ("edge_scoring", "ball_recursion"):
        if s in op_name:
            return s
    return "other"


def round_profile(tips, sites, radius, trace_dir: Path) -> None:
    import jax
    import jax.numpy as jnp

    from libpll2_jax import search_fast as sf

    start, cfg, model, chars = cases.search_case(tips, sites, 5)
    prog = sf.compile_spr(start, cfg, radius=radius)
    # warm: one round compiles every program the steady round runs
    prog, logl, moves = sf.spr_round(prog, model, chars)
    print(f"[round] warm round: logL={logl!r} moves={moves}", flush=True)
    cfgx = prog.cfg_ext
    tip = sf._tipchars_for(prog, chars)
    pw, inv = sf._aux_arrays(prog)
    gdev = tuple((tuple(jnp.asarray(a) for a in g.ball_levels),
                  jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
                  jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges))
                 for g in prog.ball_groups)
    pslots = jnp.asarray(prog.pmatrix_slots)
    erow = jnp.asarray(prog.edge_rows)
    call_args = (cfgx, model, jnp.asarray(prog.level_ops), pslots,
                 jnp.asarray(prog.branch_lengths, jnp.float32), tip, pw,
                 inv, erow[prog.root_edge], pslots[prog.root_edge], gdev)
    kw = dict(ball_slots=prog.ball_slots)
    names = _op_names(sf._spr_round_device.lower(*call_args, **kw)
                      .compile().as_text())
    jax.block_until_ready(sf._spr_round_device(*call_args, **kw))
    t0 = time.perf_counter()
    jax.block_until_ready(sf._spr_round_device(*call_args, **kw))
    wall = time.perf_counter() - t0
    trace_dir.mkdir(parents=True, exist_ok=True)
    with jax.profiler.trace(str(trace_dir), create_perfetto_trace=True):
        jax.block_until_ready(sf._spr_round_device(*call_args, **kw))
    path = sorted(trace_dir.rglob("*.trace.json.gz"))[-1]
    events = json.load(gzip.open(path))["traceEvents"]
    pids = {e["pid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev = [e for e in events if e.get("ph") == "X"
           and "/device:GPU" in pids.get(e.get("pid"), "")]
    by_scope, by_kernel = defaultdict(float), defaultdict(float)
    spans = []
    for e in dev:
        hlo = e.get("args", {}).get("hlo_op", e["name"])
        op = names.get(hlo, "")
        by_scope[_scope(op)] += e["dur"]
        by_kernel[(hlo, op[-80:])] += e["dur"]
        spans.append((e["ts"], e["ts"] + e["dur"]))
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    print(f"[round] trace {path}: {len(dev)} device events of "
          f"{len(events)}", flush=True)
    if not dev:
        print(f"[round] no device events; processes: "
              f"{sorted(set(pids.values()))}")
    total = sum(by_scope.values()) or 1.0
    print(f"[round] {tips}x{sites} r{radius}: wall {wall * 1e3:.1f} ms, "
          f"device kernel time {total / 1e3:.1f} ms, busy {busy / 1e3:.1f}"
          f" of {window / 1e3:.1f} ms window", flush=True)
    for k, v in sorted(by_scope.items(), key=lambda kv: -kv[1]):
        print(f"[round] scope {k}: {v / 1e3:.2f} ms "
              f"({100 * v / total:.1f}% of kernel time)")
    for (hlo, op), v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[round]   {v / 1e3:8.2f} ms  {hlo}  {op}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--shape", default="dna_256", choices=sorted(SHAPES))
    s.add_argument("--variants", default="128x4")
    s.add_argument("--reps", type=int, default=cases.REPS)
    r = sub.add_parser("round")
    r.add_argument("--tips", type=int, default=256)
    r.add_argument("--sites", type=int, default=4096)
    r.add_argument("--radius", type=int, default=5)
    r.add_argument("--trace-dir", default="traces")
    a = ap.parse_args()

    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_engine: needs a GPU")
    from libpll2_jax.utils.cache import enable_compile_cache
    enable_compile_cache()
    if a.cmd == "sweep":
        variants = [tuple(int(x) for x in v.split("x"))
                    for v in a.variants.split(",")]
        sweep(a.shape, variants, a.reps)
    else:
        round_profile(a.tips, a.sites, a.radius, Path(a.trace_dir))


if __name__ == "__main__":
    main()
