"""Memory story for large alignments: residency accounting + the bf16 CLV
error budget (ROADMAP #9; reference analog: site repeats' memory win,
src/repeats.c / README.md:10)."""
import jax.numpy as jnp
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import engine
from libpll2_jax import tree as T
from libpll2_jax.config import PartitionConfig
from libpll2_jax.utils import memory as M

from .test_parity_tree import random_newick, random_seqs


def make_cfg(tips, dtype, sites=512):
    return PartitionConfig(
        tips=tips, clv_buffers=tips - 2, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=tips - 2, dtype=dtype)


def test_dense_accounting_matches_arrays():
    cfg = make_cfg(24, jnp.float32)
    # the dense path allocates exactly these arrays (engine._sweep XLA arm)
    clv = (cfg.num_clvs + 1) * 4 * 4 * cfg.sites_padded * 4
    scal = (cfg.scale_buffers + 2) * cfg.sites_padded * 4
    assert M.dense_clv_bytes(cfg) == clv + scal


def test_max_sites_monotone_and_consistent():
    # bf16 dense ~doubles f32 dense; fast path dwarfs both
    hbm = 80 * 1024 ** 3
    f64 = M.max_sites(256, dtype=jnp.float64, fast_path=False,
                      hbm_bytes=hbm)
    f32 = M.max_sites(256, dtype=jnp.float32, fast_path=False,
                      hbm_bytes=hbm)
    bf16 = M.max_sites(256, dtype=jnp.bfloat16, fast_path=False,
                       hbm_bytes=hbm)
    fast = M.max_sites(256, dtype=jnp.float32, fast_path=True,
                       hbm_bytes=hbm)
    assert f64 < f32 < bf16 < fast
    assert 1.8 < bf16 / f32 < 2.2
    # 4 B/site/tip + O(log n) pool rows vs 2*R*S*4 B/site/tip dense
    assert fast / f32 > 15
    # more taxa -> fewer sites; more memory -> more sites
    assert M.max_sites(1024, fast_path=True, hbm_bytes=hbm) < M.max_sites(
        64, fast_path=True, hbm_bytes=hbm)
    assert M.max_sites(256, hbm_bytes=hbm // 2) < fast
    table = M.max_sites_table(hbm)
    assert table.count("|") > 40 and "4096" in table


@pytest.mark.parametrize("tips,budget", [(24, 3e-4), (120, 3e-4)])
def test_bf16_clv_error_budget(tips, budget):
    """bf16 CLV storage (2x HBM headroom on the dense paths): with f32
    level accumulation the error is storage rounding only (~1e-4
    relative, flat in depth); f32 stays at ~1e-7."""
    rng = np.random.default_rng(tips)
    sites = 256
    newick = random_newick(tips, rng)
    seqs = random_seqs(tips, sites, rng)
    tree = T.parse_newick_string(newick)
    out = {}
    for dt in (jnp.float64, jnp.float32, jnp.bfloat16):
        cfg = PartitionConfig(
            tips=tips, clv_buffers=tree.inner_count, states=4, sites=sites,
            rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
            scale_buffers=tree.inner_count, dtype=dt, use_pallas=False)
        program = engine.compile_tree(tree, cfg)
        model = engine.make_model(
            [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
            pll.compute_gamma_cats(0.8, 4), dtype=dt)
        raw = np.zeros((tips, cfg.sites), dtype=np.uint64)
        for i, s in enumerate(seqs):
            raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
        tipchars = jnp.asarray(engine.pad_tipchars(raw, cfg))
        pw = np.zeros(cfg.sites_padded)
        pw[:sites] = 1.0
        inv = jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))
        bl = jnp.asarray(program.default_branch_lengths, dt)
        out[np.dtype(dt).name] = float(engine.loglikelihood(
            program, cfg, model, bl, tipchars, jnp.asarray(pw, dt), inv))
    f64 = out["float64"]
    assert abs(out["float32"] - f64) / abs(f64) < 1e-6
    assert abs(out["bfloat16"] - f64) / abs(f64) < budget
