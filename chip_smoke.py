"""Smoke test of the likelihood engine and SPR search on the GPU.

Drives the main path once through the entry points a user calls
(engine, fit, search_fast, infer) at real widths, compares every result
with a plain reference, and prints one JSON line last:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases (default, one card):
  1. full-tree logL at dna_256, dna_1024 and protein_128 on the path
     choose() picks, against the f64 XLA path; where that is the fused
     sweep, also against the f32 XLA level path, with both timings
  2. f64 parity on the GPU against the CPU device
  3. batched branch-length smoothing on simulated and on random data,
     f32 against f64
  4. a few Adam steps of the model fit with the analytic VJP
  5. an SPR hill-climb at 256 x 4096, radius 5
  6. the one-call driver infer.infer_ml_tree

--devices 4 runs only the site-sharded paths on four cards: the dna_256
logL (fused sweep under shard_map) and one SPR round, each against one
card.

Any failed check raises; the script exits non-zero without the JSON line
when JAX finds no GPU.

    python chip_smoke.py [--devices 1|4]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

from tools import cases
from tools.cases import check, rel


def log(msg: str) -> None:
    print(msg, flush=True)


def compile_and_time(fn, *args, **static):
    """(lowered, first-call seconds incl. compile, steady seconds, out)."""
    import jax

    t0 = time.perf_counter()
    lowered = fn.lower(*args, **static)
    out = jax.block_until_ready(fn(*args, **static))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **static))
    return lowered, first, time.perf_counter() - t0, out


def root_rows(program, cfg, args):
    """Exported root-edge CLV and scaler rows of one sweep."""
    import jax

    from libpll2_jax import engine

    @jax.jit
    def rows(model, bl, tip, pw):
        view, _ = engine._sweep(program, cfg, model, bl, tip, pw)
        out = []
        for c, s in ((program.root_clv, program.root_scaler),
                     (program.root_back_clv, program.root_back_scaler)):
            if c >= cfg.tips:
                out += [view.clv_row(c), view.scaler_row(s)]
        return out

    return [np.asarray(x) for x in rows(*args[:4])]


def phase_logl(name, tips, sites, states):
    import jax
    import jax.numpy as jnp

    from libpll2_jax import engine
    from libpll2_jax.ops import partials_pallas_tree as ppt

    _, cfg, program, args = cases.make_case(tips, sites, states,
                                            jnp.float32)
    auto = ppt.choose(program.sweep_prog, cfg, jax.default_backend())
    lowered, first, steady, logl = compile_and_time(
        engine.loglikelihood, program, cfg, *args)
    path = "kernel" if cases.took_kernel(lowered) else "xla"
    check(cases.took_kernel(lowered) == auto,
          f"{name}: path {path} but choose() says kernel={auto}")
    check(bool(np.isfinite(float(logl))), f"{name}: logL not finite")
    log(f"[logl {name}] path={path} compile+first={first:.2f}s "
        f"steady={steady * 1e3:.2f}ms logL={float(logl)!r}")

    cfg_x = dataclasses.replace(cfg, use_pallas=False)
    ops_sites = (tips - 2) * sites
    ms_x = cases.chained_ms(program, cfg_x, args)
    cfg64, args64 = cases.with_dtype(cfg_x, args, jnp.float64)
    logl64 = engine.loglikelihood(program, cfg64, *args64)
    r64 = rel(logl, logl64)
    log(f"[logl {name}] f64 xla={float(logl64)!r} {path} rel={r64:.3e}")
    check(r64 <= 1e-5, f"{name}: {path} vs f64 logL rel {r64:.3e}")
    if not auto:
        # choose() routes this shape to XLA: the kernel is off its path
        log(f"[logl {name}] timing: xla={ms_x:.4f}ms "
            f"{ops_sites / ms_x * 1e3:.3e} site-updates/s")
        return

    logl_x = engine.loglikelihood(program, cfg_x, *args)
    r = rel(logl, logl_x)
    log(f"[logl {name}] kernel={float(logl)!r} xla={float(logl_x)!r} "
        f"rel={r:.3e}")
    check(r <= 5e-6, f"{name}: kernel vs XLA f32 logL rel {r:.3e}")
    rows_k = root_rows(program, cfg, args)
    rows_x = root_rows(program, cfg_x, args)
    flips, worst = 0, 0.0
    for i in range(0, len(rows_k), 2):
        # a site whose CLV sits within an ulp of the rescue threshold may
        # rescue on one path only; CLV * 2^-30k is the same either way.
        # Entries far below their site's largest are f32 subnormals whose
        # relative error is large and whose weight in the logL is nil, so
        # the error is taken relative to the site's largest entry.
        sk, sx = rows_k[i + 1], rows_x[i + 1]
        flips += int(np.sum(sk != sx))
        ck = rows_k[i] * cfg.scale_threshold ** sk.astype(np.float64)
        cx = rows_x[i] * cfg.scale_threshold ** sx.astype(np.float64)
        site_max = np.max(np.abs(cx), axis=(0, 1), keepdims=True)
        worst = max(worst, float(np.max(np.abs(ck - cx)
                                        / np.maximum(site_max, 1e-300))))
    log(f"[logl {name}] exported rows: max error {worst:.3e} of the "
        f"site's largest entry; scaler rows differ at {flips} of "
        f"{len(rows_k) // 2 * sites} sites")
    check(worst <= 1e-5, f"{name}: exported rows differ by {worst:.3e}")
    check(flips <= 1e-4 * sites, f"{name}: {flips} scaler rows differ")

    ms_k = cases.chained_ms(program, cfg, args)
    log(f"[logl {name}] timing: kernel={ms_k:.4f}ms xla={ms_x:.4f}ms "
        f"speedup={ms_x / ms_k:.2f}x kernel={ops_sites / ms_k * 1e3:.3e} "
        f"xla={ops_sites / ms_x * 1e3:.3e} site-updates/s")
    if name == "dna_256":
        mem = lowered.compile().memory_analysis()
        log(f"[logl {name}] memory_analysis: {mem}")
        stats = jax.devices()[0].memory_stats() or {}
        log(f"[logl {name}] peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use')}")


def phase_f64_parity(tips=64, sites=4096):
    import jax
    import jax.numpy as jnp

    from libpll2_jax import engine

    _, cfg, program, args = cases.make_case(tips, sites, 4, jnp.float64,
                                            seed=2)
    _, first, steady, logl_gpu = compile_and_time(
        engine.loglikelihood, program, cfg, *args)
    cpu = jax.devices("cpu")[0]
    logl_cpu = engine.loglikelihood(program, cfg,
                                    *jax.device_put(args, cpu))
    r = rel(logl_gpu, logl_cpu)
    log(f"[f64 parity] path=xla compile+first={first:.2f}s "
        f"steady={steady * 1e3:.2f}ms gpu={float(logl_gpu)!r} "
        f"cpu={float(logl_cpu)!r} rel={r:.3e}")
    check(r <= 1e-9, f"f64 GPU vs CPU rel {r:.3e}")


def phase_branch_lengths(tips=256, sites=65536):
    """Batched smoothing, f32 against f64, on simulated data and on random
    data (whose logL sits near the star-tree floor, sites * tips *
    ln(1/4)).  One FullTreeProgram per case serves both dtypes."""
    import jax.numpy as jnp

    from libpll2_jax import engine

    truth, _, chars, (subst, freqs, rates) = cases.simulated(tips, sites, 3)
    cfg = cases.config(truth, sites, 4, jnp.float32)
    raw = np.zeros((tips, sites), np.uint64)
    for n in truth.nodes[:tips]:
        raw[n.clv_index] = chars[n.label]
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    sim = (engine.make_model([subst], [freqs], rates, dtype=jnp.float32),
           jnp.full(2 * tips - 3, 0.1, jnp.float32),
           jnp.asarray(engine.pad_tipchars(raw, cfg)),
           jnp.asarray(pw, jnp.float32),
           jnp.asarray(np.full(cfg.sites_padded, -1, np.int32)))
    tree_r, cfg_r, _, rand = cases.make_case(tips, sites, 4, jnp.float32,
                                             seed=3)
    for label, tree, cfg_c, args in (("simulated", truth, cfg, sim),
                                     ("random", tree_r, cfg_r, rand)):
        full = engine.compile_tree_full(tree, cfg_c)
        out = {}
        for dtype in (jnp.float32, jnp.float64):
            cfg_d, args_d = cases.with_dtype(cfg_c, args, dtype)
            _, first, steady, (bl, logl) = compile_and_time(
                engine.optimize_branch_lengths, full, cfg_d, *args_d,
                rounds=2)
            out[dtype] = float(logl)
            log(f"[branch lengths {label} {np.dtype(dtype).name}] path=xla "
                f"compile+first={first:.2f}s steady={steady:.3f}s "
                f"logL={float(logl)!r}")
            check(bool(np.all(np.isfinite(np.asarray(bl)))),
                  f"{label}: non-finite bl")
        r = rel(out[jnp.float32], out[jnp.float64])
        log(f"[branch lengths {label}] f32 vs f64 rel={r:.3e} (star-tree "
            f"floor {sites * tips * np.log(0.25):.1f})")
        check(r <= 1e-5, f"{label}: smoothed logL f32 vs f64 rel {r:.3e}")


def phase_fit(tips=256, sites=16384, steps=5):
    import jax
    import jax.numpy as jnp

    from libpll2_jax import engine, fit
    from libpll2_jax.models.gamma import compute_gamma_cats
    from libpll2_jax.ops import partials_pallas_tree as ppt

    tree, cfg, program, args = cases.make_case(tips, sites, 4, jnp.float32,
                                         seed=4)
    _, _, tip, pw, inv = args
    full = engine.compile_tree_full(tree, cfg)
    rates = jnp.asarray(compute_gamma_cats(0.8, cases.RATE_CATS),
                        jnp.float32)
    params0 = fit.pack([[1.0, 2.0, 1.0, 1.0, 2.0, 1.0]], [[0.25] * 4],
                       np.asarray(program.default_branch_lengths))

    def grad_fn(cfg_g, full_g):
        return jax.jit(jax.grad(lambda p, tip, pw, inv: fit.loglikelihood_fn(
            program, cfg_g, p, rates, tip, pw, inv, full_program=full_g)))

    def norm(g):
        return float(jnp.sqrt(sum(jnp.sum(x.astype(jnp.float64) ** 2)
                                  for x in jax.tree_util.tree_leaves(g))))

    g_k = norm(grad_fn(cfg, full)(params0, tip, pw, inv))
    g_x = norm(grad_fn(dataclasses.replace(cfg, use_pallas=False), None)(
        params0, tip, pw, inv))
    r = rel(g_k, g_x)
    log(f"[fit] grad norm analytic VJP={g_k!r} XLA autodiff={g_x!r} "
        f"rel={r:.3e}")
    check(r <= 1e-4, f"fit: gradient norm rel {r:.3e}")

    lowered, first, steady, res = compile_and_time(
        fit.fit_model, program, cfg, params0, rates, tip, pw, inv,
        steps=steps, lr=0.02, full_program=full)
    auto = ppt.choose(program.sweep_prog, cfg, jax.default_backend())
    check(cases.took_kernel(lowered) == auto,
          "fit: forward path != choose()")
    trace = np.asarray(res.logl)
    log(f"[fit] path={'kernel' if auto else 'xla'} compile+first="
        f"{first:.2f}s steady={steady:.3f}s ({steps} Adam steps) "
        f"logL {float(trace[0])!r} -> {float(trace[-1])!r}")
    check(bool(np.all(np.isfinite(trace))) and trace[-1] > trace[0],
          "fit: logL did not rise")


def phase_search(tips=256, sites=4096, radius=5, rounds=3):
    from libpll2_jax import search_fast

    start, cfg, model, chars = cases.search_case(tips, sites, 5)
    t0 = time.perf_counter()
    _, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=rounds, radius=radius,
        smooth_every=2)
    total = time.perf_counter() - t0
    trace = np.asarray(stats["logl_trace"])
    rs = stats["round_secs"]
    log(f"[search] path=xla rounds={stats['rounds']} "
        f"moves={stats['moves']} first round (compile)={rs[0]:.2f}s "
        f"steady rounds={[round(x, 3) for x in rs[1:]]} total={total:.2f}s "
        f"logL {float(trace[0])!r} -> {float(trace[-1])!r}")
    for i, tm in enumerate(stats["phase_timings"][1:], start=2):
        phases = {k: round(v, 4) for k, v in tm.items()
                  if isinstance(v, float)}
        # jit cache sizes at round start: growth means the round compiled
        log(f"[search] round {i} phases(s): {phases} "
            f"programs cached (round, smooth, logL)={tm['cache']}")
    log(f"[search] round programs compiled in all: "
        f"{search_fast._spr_round_device._cache_size()}")
    check(bool(np.all(np.isfinite(trace))), "search: non-finite logL")
    check(bool(np.all(np.diff(trace) >= -1e-6 * np.abs(trace[1:]))),
          "search: logL decreased")
    check(stats["moves"] >= 1, "search: no move applied")


def phase_infer(tips=64, sites=2000):
    from libpll2_jax import infer

    _, _, chars, _ = cases.simulated(tips, sites, 6)
    letters = {1: "A", 2: "C", 4: "G", 8: "T"}
    seqs = {lab: "".join(letters[int(c)] for c in codes)
            for lab, codes in chars.items()}
    t0 = time.perf_counter()
    res = infer.infer_ml_tree(seqs, max_rounds=4, warmup_rounds=2,
                              fit_steps=20, radius=4)
    log(f"[infer] path=xla total (compile included)="
        f"{time.perf_counter() - t0:.2f}s logL={res.logl!r} "
        f"alpha={res.alpha:.3f} rounds={res.stats['search']['rounds']}")
    check(bool(np.isfinite(res.logl)), "infer: logL not finite")


def phase_sharded(n, tips=256, sites=65536, stips=256, ssites=4096,
                  radius=5):
    """Site-sharded logL (fused sweep under shard_map) and one sharded
    SPR round, each against one card."""
    import jax
    import jax.numpy as jnp

    from libpll2_jax import engine
    from libpll2_jax import search_fast as sf
    from libpll2_jax.parallel import sharding

    devices = jax.devices()[:n]
    check(len(devices) == n, f"need {n} devices, found {len(jax.devices())}")
    mesh = sharding.make_mesh(devices)

    _, cfg, program, args = cases.make_case(tips, sites, 4, jnp.float32)
    model, bl, tip, pw, inv = args
    logl_1 = engine.loglikelihood(program, cfg, *args)
    tip_s, pw_s, inv_s = sharding.shard_site_arrays(mesh, tip, pw, inv)
    with jax.set_mesh(mesh):
        lowered, first, steady, logl_n = compile_and_time(
            engine.loglikelihood, program, cfg, model, bl, tip_s, pw_s,
            inv_s)
        rows = jax.jit(lambda *a: engine._sweep(program, cfg, *a)[0]
                       ._clv_rows)(model, bl, tip_s, pw_s)
    path = "kernel" if cases.took_kernel(lowered) else "xla"
    r = rel(logl_n, logl_1)
    log(f"[sharded logl {tips}x{sites}] path={path} devices={n} "
        f"compile+first={first:.2f}s steady={steady * 1e3:.2f}ms "
        f"one-card={float(logl_1)!r} sharded={float(logl_n)!r} rel={r:.3e}")
    check(path == "kernel", "sharded logL did not take the kernel")
    check(len(rows.sharding.device_set) == n,
          f"sweep rows span {len(rows.sharding.device_set)} devices")
    check(r <= 1e-6, f"sharded logL rel {r:.3e}")

    start, scfg, smodel, chars = cases.search_case(stips, ssites, 5)
    prog = sf.compile_spr(start, scfg, radius=radius)
    cfgx = prog.cfg_ext
    tip2 = sf._tipchars_for(prog, chars)
    pw2, inv2 = sf._aux_arrays(prog)
    gdev = tuple((tuple(jnp.asarray(a) for a in g.ball_levels),
                  jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
                  jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges))
                 for g in prog.ball_groups)
    pslots = jnp.asarray(prog.pmatrix_slots)
    erow = jnp.asarray(prog.edge_rows)

    def round_moves(t, p, i):
        t0 = time.perf_counter()
        logl0, outs = sf._spr_round_device(
            cfgx, smodel, jnp.asarray(prog.level_ops), pslots,
            jnp.asarray(prog.branch_lengths, jnp.float32), t, p, i,
            erow[prog.root_edge], pslots[prog.root_edge], gdev,
            ball_slots=prog.ball_slots)
        logl0 = float(logl0)
        secs = time.perf_counter() - t0
        scores, _t3, cand_of, edge_of = sf._flatten_groups(
            prog.ball_groups, outs)
        chosen, _ = sf._select_improving(
            scores, cand_of, edge_of, logl0, 1e-6, len(prog.cand_hard),
            prog.cand_hard, prog.edge_endpoints, False)
        return logl0, scores, chosen, secs, outs

    l1, s1, c1, secs1, _ = round_moves(tip2, pw2, inv2)
    t_s, p_s, i_s = sharding.shard_site_arrays(mesh, tip2, pw2, inv2)
    check(len(t_s.sharding.device_set) == n, "SPR inputs not sharded")
    ln, sn, cn, secsn, outs = round_moves(t_s, p_s, i_s)
    fin = np.isfinite(s1)
    check(bool(np.array_equal(fin, np.isfinite(sn))), "finite masks differ")
    worst = float(np.max(np.abs(sn[fin] - s1[fin]) / np.abs(s1[fin])))
    log(f"[sharded spr round] devices={n} one-card={secs1:.2f}s "
        f"sharded={secsn:.2f}s (both incl. compile) logL0 {l1!r} vs "
        f"{ln!r} worst score rel={worst:.3e} moves one-card={len(c1)} "
        f"sharded={len(cn)}")
    check(worst <= 1e-5, f"sharded SPR scores rel {worst:.3e}")
    check(c1 == cn, "sharded SPR round selected other moves")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    opts = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found "
                 f"{devices[0].platform}")
    jax.config.update("jax_enable_x64", True)
    from libpll2_jax.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__} device_kind={devices[0].device_kind} "
        f"devices={len(devices)} compile cache={cache}")

    if opts.devices == 4:
        phases = [("sharded", lambda: phase_sharded(4))]
    else:
        phases = [
            ("logl dna_256", lambda: phase_logl("dna_256", 256, 65536, 4)),
            ("logl dna_1024", lambda: phase_logl("dna_1024", 1024, 16384,
                                                 4)),
            ("logl protein_128", lambda: phase_logl("protein_128", 128,
                                                    16384, 20)),
            ("f64 parity", phase_f64_parity),
            ("branch lengths", phase_branch_lengths),
            ("fit", phase_fit),
            ("search", phase_search),
            ("infer", phase_infer),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        log(f"[phase {name}] ok in {time.perf_counter() - t0:.2f}s")

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
