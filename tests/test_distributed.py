"""Multi-host runtime helpers on the CI virtual 8-device CPU mesh (the
single-process degenerate case of the pod path): global-array placement
must shard the site axis, initialize() must be a harmless no-op without a
coordinator, and the jitted engine must produce the identical logL on
globally-sharded inputs (exactness of per-site weighted sums under
sharding, SURVEY.md §2.6)."""
import jax
import jax.numpy as jnp
import numpy as np

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.parallel import distributed as D

from .test_parity_tree import random_newick, random_seqs


def test_initialize_noop_single_process():
    assert D.initialize() == 1
    assert jax.process_count() == 1


def test_global_mesh_and_placement():
    mesh = D.global_site_mesh()
    assert mesh.devices.size == 8
    arr = np.arange(8 * 128 * 2, dtype=np.float32).reshape(2, 8 * 128)
    g = D.make_global_site_array(mesh, arr)
    assert g.shape == arr.shape
    np.testing.assert_array_equal(np.asarray(g), arr)
    shard_shapes = {s.data.shape for s in g.addressable_shards}
    assert shard_shapes == {(2, 128)}
    sl = D.process_site_slice(8 * 128, mesh)
    assert (sl.start, sl.stop) == (0, 8 * 128)


def test_sharded_engine_logl_identical():
    rng = np.random.default_rng(31)
    n_tips, sites = 12, 8 * 128          # exactly one block per device
    newick = random_newick(n_tips, rng)
    seqs = random_seqs(n_tips, sites, rng)
    tree = T.parse_newick_string(newick)
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float64)
    program = engine.compile_tree(tree, cfg)
    model = engine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(0.8, 4), dtype=jnp.float64)
    raw = np.zeros((n_tips, cfg.sites), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = engine.pad_tipchars(raw, cfg)
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    inv = np.full(cfg.sites_padded, -1, np.int32)
    bl = jnp.asarray(program.default_branch_lengths, jnp.float64)

    plain = float(engine.loglikelihood(
        program, cfg, model, bl, jnp.asarray(tipchars),
        jnp.asarray(pw), jnp.asarray(inv)))

    mesh = D.global_site_mesh()
    tc_g, pw_g, inv_g = D.shard_engine_inputs(mesh, tipchars, pw, inv)
    sharded = float(engine.loglikelihood(
        program, cfg, model, bl, tc_g, pw_g, inv_g))
    np.testing.assert_allclose(sharded, plain, rtol=1e-12)


def test_real_multiprocess_bit_equality(tmp_path):
    """SURVEY §2.6 across a TRUE process boundary: 2 coordinator-connected
    processes (2 virtual CPU devices each -> a 4-device global mesh) run
    logL + all-branch (d1, d2) through parallel/distributed.py's actual
    multi-host path; results must be bit-identical between processes and
    match the single-process value."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    worker = repo / "tests" / "_distributed_worker.py"
    with socket.socket() as s:            # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    nproc = 2
    outs = [tmp_path / f"w{i}.npz" for i in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(nproc), str(port),
         str(outs[i])],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(nproc)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
        assert "WORKER_OK" in log, log

    res = [np.load(o) for o in outs]
    # per-host site ownership tiles the global axis
    assert (int(res[0]["slice_start"]), int(res[0]["slice_stop"])) == (0, 256)
    assert (int(res[1]["slice_start"]), int(res[1]["slice_stop"])) == (256, 512)
    # bit-identical across processes (same global XLA program)
    assert float(res[0]["logl"]) == float(res[1]["logl"])
    np.testing.assert_array_equal(res[0]["d1"], res[1]["d1"])
    np.testing.assert_array_equal(res[0]["d2"], res[1]["d2"])

    # single-process reference on the identical problem
    from .test_parity_tree import random_seqs
    rng = np.random.default_rng(31)
    n_tips, sites = 12, 2 * nproc * 128
    tree = T.parse_newick_string(random_newick(n_tips, rng))
    seqs = random_seqs(n_tips, sites, rng)
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n_tips - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float64)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    model = engine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(0.8, 4), dtype=jnp.float64)
    raw = np.zeros((n_tips, cfg.sites), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = engine.pad_tipchars(raw, cfg)
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    inv = np.full(cfg.sites_padded, -1, np.int32)
    plain = float(engine.loglikelihood(
        program, cfg, model,
        jnp.asarray(program.default_branch_lengths, jnp.float64),
        jnp.asarray(tipchars), jnp.asarray(pw), jnp.asarray(inv)))
    d1p, d2p = engine.branch_derivatives(
        full, cfg, model,
        jnp.asarray(full.default_branch_lengths, jnp.float64),
        jnp.asarray(tipchars), jnp.asarray(pw), jnp.asarray(inv))
    np.testing.assert_allclose(float(res[0]["logl"]), plain, rtol=1e-12)
    np.testing.assert_allclose(res[0]["d1"], np.asarray(d1p), rtol=1e-9)
    np.testing.assert_allclose(res[0]["d2"], np.asarray(d2p), rtol=1e-9)


def test_spr_round_site_sharded_matches_single_device():
    """The fused SPR round program (base sweep + ball recursion + Newton
    scoring) runs UNCHANGED on site-sharded inputs: every site-indexed
    op is elementwise or a weighted per-site reduction, so GSPMD inserts
    psums and the scores match the single-device run to reduction
    order (SURVEY.md §2.6 applied to the search layer)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    import libpll2_jax as pll
    from libpll2_jax import engine, search_fast as sf
    from libpll2_jax import tree as T
    from libpll2_jax.config import PartitionConfig
    from libpll2_jax.parallel import sharding

    from .test_parity_tree import random_newick
    from .test_search import FREQS, SUBST, simulate

    rng = np.random.default_rng(5)
    rates = pll.compute_gamma_cats(0.8, 4)
    tips, sites = 10, 128
    truth = T.parse_newick_string(random_newick(tips, rng))
    seqs = simulate(truth, sites, rng, rates)
    chars = {lab: (1 << s.astype(np.uint64)) for lab, s in seqs.items()}
    start = T.parse_newick_string(
        random_newick(tips, np.random.default_rng(9)))
    ren = dict(zip(sorted(n.label for n in start.nodes[:tips]),
                   sorted(chars)))
    for n in start.nodes[:tips]:
        n.label = ren[n.label]
    cfg = PartitionConfig(
        tips=tips, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=jnp.float64)
    model = engine.make_model([SUBST], [FREQS], rates, dtype=jnp.float64)
    prog = sf.compile_spr(start, cfg, radius=3)
    cfgx = prog.cfg_ext
    tipchars = sf._tipchars_for(prog, chars)
    pw, inv = sf._aux_arrays(prog)
    bl = jnp.asarray(prog.branch_lengths, cfgx.dtype)
    lops = jnp.asarray(prog.level_ops)
    pslots = jnp.asarray(prog.pmatrix_slots)
    gdev = tuple((tuple(jnp.asarray(a) for a in g.ball_levels),
                  jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
                  jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges))
                 for g in prog.ball_groups)
    rr = jnp.asarray(prog.edge_rows)[prog.root_edge]
    rs = pslots[prog.root_edge]

    def run(tip_a, pw_a, inv_a):
        return sf._spr_round_device(
            cfgx, model, lops, pslots, bl, tip_a, pw_a, inv_a, rr, rs,
            gdev, ball_slots=prog.ball_slots, newton_iters=2)

    l0, outs0 = run(tipchars, pw, inv)
    mesh = sharding.make_mesh(jax.devices()[:8])
    tip_s, pw_s, inv_s = sharding.shard_site_arrays(mesh, tipchars, pw,
                                                    inv)
    l1, outs1 = run(tip_s, pw_s, inv_s)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-12)
    for (a, _), (b, _) in zip(outs0, outs1):
        a, b = np.asarray(a), np.asarray(b)
        m = np.isfinite(a)
        np.testing.assert_allclose(a[m], b[m], rtol=1e-10)
        assert (np.isfinite(b) == m).all()
