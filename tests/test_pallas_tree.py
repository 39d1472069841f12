"""Fused Pallas tree sweep (interpret mode) must agree with the XLA level
path on the exported root rows — the kernel-variant parity matrix of the
reference (test/runtest.py) applied to the GPU kernel — and the path
choice must route each shape class as documented."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.ops import partials as partials_ops
from libpll2_jax.ops import partials_pallas_tree as ppt
from libpll2_jax.ops import pmatrix as pmatrix_ops
from libpll2_jax.tree.generate import balanced_newick

from .test_parity_tree import random_newick


def caterpillar_newick(n):
    s = "(t0:0.1,t1:0.2)"
    for i in range(2, n - 2):
        s = f"({s}:0.05,t{i}:0.1)"
    return f"({s}:0.05,t{n-2}:0.1,t{n-1}:0.1);"


def random_codes(n_tips, sites, states, rng):
    """One-hot states with ~10% ambiguous (random non-empty) masks."""
    codes = np.uint64(1) << rng.integers(0, states, (n_tips, sites),
                                         dtype=np.uint64)
    amb = rng.random((n_tips, sites)) < 0.1
    masks = rng.integers(1, 1 << states, (n_tips, sites), dtype=np.uint64)
    return np.where(amb, masks, codes)


def build(newick, sites, seed, rate_cats=4, scale_heavy=False, states=4,
          per_rate=False, site_block=128):
    rng = np.random.default_rng(seed)
    tree = T.parse_newick_string(newick)
    n_tips = tree.tip_count
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=states,
        sites=sites, rate_matrices=1, prob_matrices=2 * n_tips - 3,
        rate_cats=rate_cats, scale_buffers=tree.inner_count,
        dtype=jnp.float32, per_rate_scalers=per_rate,
        site_block=site_block)
    program = engine.compile_tree(tree, cfg)
    assert program.sweep_prog is not None
    if states == 20:
        from libpll2_jax.models.aa import aa_model
        subst, freqs = aa_model("lg")
    else:
        subst, freqs = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0], [0.3, 0.25, 0.2, 0.25]
    model = engine.make_model([subst], [freqs],
                              pll.compute_gamma_cats(0.8, rate_cats),
                              dtype=jnp.float32)
    raw = random_codes(n_tips, cfg.sites_alloc, states, rng)
    tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))

    bl = program.default_branch_lengths * (30.0 if scale_heavy else 1.0)
    num_slots = int(program.pmatrix_indices.max()) + 1
    pmats = jnp.zeros((num_slots, rate_cats, states, states), jnp.float32)
    new = pmatrix_ops.compute_pmatrices(
        jnp.asarray(bl, jnp.float32), model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=jnp.float32)
    pmats = pmats.at[jnp.asarray(program.pmatrix_indices)].set(new)
    return tree, cfg, program, tipchars, pmats


def run_xla(cfg, program, tipchars, pmats):
    R, S, Tp = cfg.rate_cats, cfg.states, cfg.sites_padded
    tip_clv = engine.expand_tipchars(tipchars, S, jnp.float32)
    clv0 = jnp.zeros((cfg.num_clvs + 1, R, S, Tp), jnp.float32)
    clv0 = clv0.at[:cfg.tips].set(
        jnp.broadcast_to(tip_clv[:, None], (cfg.tips, R, S, Tp)))
    if cfg.per_rate_scalers:
        scal0 = jnp.zeros((cfg.scale_buffers + 2, R, Tp), jnp.int32)
    else:
        scal0 = jnp.zeros((cfg.scale_buffers + 2, Tp), jnp.int32)
    return partials_ops.update_partials(
        clv0, scal0, pmats, jnp.asarray(program.level_ops), cfg)


def run_kernel(cfg, program, tipchars, pmats, interpret=True):
    prog = program.sweep_prog
    clv_rows, scal_rows = ppt.sweep(tipchars, pmats, prog, cfg,
                                    interpret=interpret)
    return prog, clv_rows, scal_rows


def scaler_row(cfg, scal_rows, row):
    return scal_rows[row] if cfg.per_rate_scalers else scal_rows[row, 0]


def assert_rows_match(cfg, program, tipchars, pmats, rtol=1e-6,
                      interpret=True):
    clv_x, scal_x = run_xla(cfg, program, tipchars, pmats)
    prog, clv_rows, scal_rows = run_kernel(cfg, program, tipchars, pmats,
                                           interpret=interpret)
    assert clv_rows.shape == (len(prog.exports), cfg.rate_cats, cfg.states,
                              cfg.sites_padded)
    for clv_idx, row in prog.export_clv_map.items():
        np.testing.assert_allclose(np.asarray(clv_rows[row]),
                                   np.asarray(clv_x[clv_idx]),
                                   rtol=rtol, atol=0)
    for scal_idx, row in prog.export_scaler_map.items():
        np.testing.assert_array_equal(
            np.asarray(scaler_row(cfg, scal_rows, row)),
            np.asarray(scal_x[scal_idx]))
    return clv_x, scal_x


@pytest.mark.parametrize("n_tips,sites,seed", [
    (8, 256, 0),
    (24, 384, 1),
    (40, 512, 2),
])
def test_vmem_matches_xla(n_tips, sites, seed):
    rng = np.random.default_rng(seed)
    newick = random_newick(n_tips, rng)
    _, cfg, program, tipchars, pmats = build(newick, sites, seed)
    assert_rows_match(cfg, program, tipchars, pmats)


@pytest.mark.parametrize(
    "shape,states,per_rate,heavy,sites,site_block,rate_cats", [
        ("balanced", 4, False, False, 256, 128, 4),
        ("caterpillar", 4, False, False, 256, 128, 4),
        ("random", 4, True, True, 384, 128, 4),
        ("balanced", 4, True, False, 192, 64, 4),
        # site counts that are not a multiple of the kernel's site block
        ("random", 4, False, False, 300, 1, 4),
        ("random", 4, True, True, 200, 8, 4),
        ("random", 20, False, False, 128, 128, 4),
        ("balanced", 20, True, True, 100, 4, 4),
        # rate category counts that are not a power of two (+G3, +R5)
        ("random", 4, False, True, 256, 128, 3),
        ("random", 4, True, True, 200, 8, 3),
        ("random", 20, True, False, 100, 4, 5),
    ])
def test_kernel_matches_xla(shape, states, per_rate, heavy, sites,
                            site_block, rate_cats):
    rng = np.random.default_rng(sites + states)
    n_tips = 16
    newick = {"balanced": lambda: balanced_newick(n_tips),
              "caterpillar": lambda: caterpillar_newick(n_tips),
              "random": lambda: random_newick(n_tips, rng)}[shape]()
    _, cfg, program, tipchars, pmats = build(
        newick, sites, states, rate_cats=rate_cats, scale_heavy=heavy,
        states=states, per_rate=per_rate, site_block=site_block)
    _, scal_x = assert_rows_match(cfg, program, tipchars, pmats,
                                  rtol=1e-6 if states == 4 else 2e-6)
    if heavy:
        assert int(np.asarray(scal_x[:cfg.scale_buffers]).max()) > 0


def test_vmem_scaling_fires():
    rng = np.random.default_rng(7)
    newick = random_newick(48, rng)
    _, cfg, program, tipchars, pmats = build(newick, 256, 7,
                                             scale_heavy=True)
    _, scal_x = assert_rows_match(cfg, program, tipchars, pmats)
    assert int(np.asarray(scal_x[:cfg.scale_buffers]).max()) > 0


def test_vmem_caterpillar_pool_small():
    """Sethi–Ullman allocation keeps the slot pool tiny on pathological
    topologies (caterpillar: O(1); balanced: O(log n)).  On a depth-62
    chain the f32 rescue decision can flip at sites whose CLV sits within
    an ulp of the threshold — CLV×2^k and scaler+k compensate exactly — so
    the parity check compares SCALING-COMPENSATED values (the quantity the
    corrected log-likelihood consumes, core_likelihood.c:196-198)."""
    tree, cfg, program, tipchars, pmats = build(caterpillar_newick(64),
                                                256, 3)
    assert program.sweep_prog.pool_size <= 4
    clv_x, scal_x = run_xla(cfg, program, tipchars, pmats)
    prog, clv_rows, scal_rows = run_kernel(cfg, program, tipchars, pmats)
    producer = {}
    from libpll2_jax.tree import create_operations, traverse
    ops, _, _ = create_operations(traverse(tree.vroot))
    for op in ops:
        producer[op.parent_clv_index] = op.parent_scaler_index
    for clv_idx, row in prog.export_clv_map.items():
        got = np.asarray(clv_rows[row]).astype(np.float64)
        want = np.asarray(clv_x[clv_idx]).astype(np.float64)
        srow = producer[clv_idx]
        sg = np.asarray(scal_rows[prog.export_scaler_map[srow], 0]
                        ).astype(np.float64)
        sw = np.asarray(scal_x[srow]).astype(np.float64)
        got *= 2.0 ** (-30.0 * sg)[None, None, :]
        want *= 2.0 ** (-30.0 * sw)[None, None, :]
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=0)


def test_schedule_rejects_non_forest():
    from libpll2_jax.partition import Operation
    # child 5 never produced and not a tip -> partial traversal -> None
    ops = [Operation(6, 0, 5, 0, 1, 0, -1, -1)]
    assert ppt.schedule(ops, tips=4, export_clvs=[6]) is None


def test_balanced_pool_logarithmic():
    tree = T.parse_newick_string(balanced_newick(256))
    cfg = PartitionConfig(
        tips=256, clv_buffers=tree.inner_count, states=4, sites=256,
        rate_matrices=1, prob_matrices=509, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=jnp.float32)
    program = engine.compile_tree(tree, cfg)
    assert program.sweep_prog.pool_size <= 12


def _choice(case):
    tree = T.parse_newick_string(balanced_newick(16))
    states = 20 if case.startswith("protein") else 4
    dtype = {"f64": jnp.float64, "bf16": jnp.bfloat16}.get(case,
                                                            jnp.float32)
    use_pallas = {"forced_off": False, "protein_forced": True}.get(case)
    rate_cats = {"rate_cats_3": 3, "rate_cats_5": 5}.get(case, 4)
    cfg = PartitionConfig(
        tips=16, clv_buffers=tree.inner_count, states=states, sites=256,
        rate_matrices=1, prob_matrices=29, rate_cats=rate_cats,
        scale_buffers=tree.inner_count, dtype=dtype, use_pallas=use_pallas)
    prog = engine.compile_tree(tree, cfg).sweep_prog
    if case == "non_forest":
        prog = None
    if case == "no_exports":
        # the root edge joins two tips: no inner row to export
        prog = dataclasses.replace(prog, exports=())
    backend = "cpu" if case == "cpu" else "gpu"
    return ppt.choose(prog, cfg, backend)


@pytest.mark.parametrize("case,want", [
    ("gpu_forest", True),
    ("cpu", False),
    ("f64", False),
    ("bf16", False),
    ("non_forest", False),
    ("no_exports", False),
    ("forced_off", False),
    ("protein", 20 in ppt.FAST_STATES),
    ("protein_forced", True),
    # the kernel pads the rate axis to a power of two
    ("rate_cats_3", True),
    ("rate_cats_5", True),
])
def test_choose(case, want):
    assert _choice(case) is want


def test_engine_never_picks_kernel_on_cpu():
    """On this backend the engine takes the XLA path even with the kernel
    forced on: no device path runs in interpret mode."""
    rng = np.random.default_rng(4)
    _, cfg, program, tipchars, _ = build(random_newick(10, rng), 256, 4)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    assert jax.default_backend() == "cpu"
    assert not ppt.choose(program.sweep_prog, cfg, jax.default_backend())
    model = engine.make_model([[1.0] * 6], [[0.25] * 4],
                              pll.compute_gamma_cats(0.8, 4),
                              dtype=jnp.float32)
    bl = jnp.asarray(program.default_branch_lengths, jnp.float32)
    view, _ = engine._sweep(program, cfg, model, bl, tipchars, None)
    assert isinstance(view, engine._StandardView)


def test_sweep_sharded_matches_single_device():
    """Under a 'sites' mesh the kernel runs per shard inside shard_map;
    rows must equal the one-device sweep, and the outputs span every
    device of the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libpll2_jax.parallel import sharding

    rng = np.random.default_rng(12)
    _, cfg, program, tipchars, pmats = build(random_newick(12, rng), 512,
                                             12, per_rate=True,
                                             scale_heavy=True)
    prog = program.sweep_prog
    want_clv, want_scal = ppt.sweep(tipchars, pmats, prog, cfg,
                                    interpret=True)
    mesh = sharding.make_mesh(jax.devices()[:4])
    tip_s = jax.device_put(tipchars,
                           NamedSharding(mesh, P(None, sharding.SITES_AXIS)))
    with jax.set_mesh(mesh):
        got_clv, got_scal = ppt.sweep(tip_s, pmats, prog, cfg,
                                      interpret=True)
    assert len(got_clv.sharding.device_set) == 4
    assert {s.data.shape[-1] for s in got_clv.addressable_shards} == {128}
    np.testing.assert_array_equal(np.asarray(got_clv), np.asarray(want_clv))
    np.testing.assert_array_equal(np.asarray(got_scal),
                                  np.asarray(want_scal))


def test_sweep_refuses_sharded_without_mesh():
    """XLA cannot split the kernel's custom call: site-sharded inputs with
    no 'sites' mesh in context must raise, not silently run the whole
    sweep on every device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libpll2_jax.parallel import sharding

    rng = np.random.default_rng(13)
    _, cfg, program, tipchars, pmats = build(random_newick(10, rng), 512, 13)
    mesh = sharding.make_mesh(jax.devices()[:4])
    tip_s = jax.device_put(tipchars,
                           NamedSharding(mesh, P(None, sharding.SITES_AXIS)))
    with pytest.raises(Exception, match="jax.set_mesh"):
        ppt.sweep(tip_s, pmats, program.sweep_prog, cfg, interpret=True)
    # replicated over the same devices is fine
    tip_r = jax.device_put(tipchars, NamedSharding(mesh, P()))
    clv, _ = ppt.sweep(tip_r, pmats, program.sweep_prog, cfg,
                       interpret=True)
    assert bool(jnp.all(jnp.isfinite(clv)))


@pytest.mark.parametrize("rate_cats,states,per_rate", [
    (4, 4, False),
    (3, 4, False),
    (3, 4, True),
    (1, 4, True),
    (5, 20, True),
])
def test_triton_lowering_accepts(rate_cats, states, per_rate):
    """The kernel as lowered for the GPU (Pallas to Triton, without
    ptxas): Triton needs power-of-two extents, a rule interpret mode does
    not check, so every shape choose() may send must lower."""
    import functools

    rng = np.random.default_rng(rate_cats)
    _, cfg, program, tipchars, pmats = build(
        random_newick(12, rng), 256, rate_cats, rate_cats=rate_cats,
        states=states, per_rate=per_rate)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    assert ppt.choose(program.sweep_prog, cfg, "gpu")
    fn = jax.jit(functools.partial(ppt.sweep, prog=program.sweep_prog,
                                   cfg=cfg))
    exp = jax.export.export(
        fn, platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(tipchars, pmats)
    assert ppt.KERNEL_NAME in exp.mlir_module()
