"""Location of JAX's persistent compilation cache.

One helper for every entry point (tests, examples, bench.py,
chip_smoke.py), so that their processes share compiled programs.
"""
from __future__ import annotations

import os
import pathlib

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Return the cache directory in use.

    JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself and
    nothing is set here; otherwise the cache lives at <repo>/.jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
