"""Entry-point contracts that hold without a GPU: the compile-cache
helper, chip_smoke.py refusing to run anywhere but on a GPU, and the
card-only tests (marker `gpu`), which skip here."""
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libpll2_jax.utils import cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_helper(env_set, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert calls == []                 # JAX reads the variable itself
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
        assert cache.enable_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_kernel_compiled_matches_xla(gpu):
    """The fused sweep as compiled for the card against the XLA level
    path on a small tree."""
    from .test_pallas_tree import (assert_rows_match, build,
                                   random_newick)
    from libpll2_jax.ops import partials_pallas_tree as ppt

    rng = np.random.default_rng(3)
    _, cfg, program, tipchars, pmats = build(random_newick(24, rng), 1000,
                                             3, per_rate=True,
                                             scale_heavy=True)
    assert ppt.choose(program.sweep_prog, cfg, jax.default_backend())
    clv, scal = ppt.sweep(tipchars, pmats, program.sweep_prog, cfg)
    assert clv.dtype == jnp.float32 and bool(jnp.all(jnp.isfinite(clv)))
    assert_rows_match(cfg, program, tipchars, pmats, rtol=1e-5,
                      interpret=False)


@pytest.mark.gpu
@pytest.mark.parametrize("per_rate", [False, True])
def test_engine_kernel_rate_cats_3(gpu, per_rate):
    """+G3, a rate category count that is not a power of two, through
    engine.loglikelihood on the card: the kernel path, against XLA."""
    import dataclasses

    from libpll2_jax import engine
    from libpll2_jax.ops import partials_pallas_tree as ppt

    from .test_engine import build_case

    tree, cfg, _, model, _, tip, pw, inv = build_case(n_tips=32, sites=1000,
                                                      rate_cats=3)
    cfg = dataclasses.replace(cfg, dtype=jnp.float32,
                              per_rate_scalers=per_rate)
    program = engine.compile_tree(tree, cfg)
    model = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, model)
    args = (model, jnp.asarray(program.default_branch_lengths, jnp.float32),
            jnp.asarray(tip), jnp.asarray(pw, jnp.float32), jnp.asarray(inv))
    assert ppt.choose(program.sweep_prog, cfg, jax.default_backend())
    lowered = engine.loglikelihood.lower(program, cfg, *args)
    assert ppt.KERNEL_NAME in lowered.as_text(debug_info=True)
    got = float(engine.loglikelihood(program, cfg, *args))
    want = float(engine.loglikelihood(
        program, dataclasses.replace(cfg, use_pallas=False), *args))
    assert np.isfinite(got)
    assert abs(got - want) <= 5e-6 * abs(want)
