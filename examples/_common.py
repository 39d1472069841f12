"""Shared bootstrap for the runnable examples.

Examples default to the CPU/float64 parity path (matching the printed
precision of the reference's examples/); set EXAMPLES_GPU=1 to run on
the GPU backend instead.
"""
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

from libpll2_jax.utils.cache import enable_compile_cache

enable_compile_cache()

if os.environ.get("EXAMPLES_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
