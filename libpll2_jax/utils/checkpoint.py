"""Checkpoint / resume for long-running optimizations.

The reference has no checkpointing (SURVEY.md §6: clients persist their
own state; the library's only serialization is newick export).  Here the
natural unit of persisted state is a pytree — fit.FitParams, optimizer
state, branch-length vectors — saved as a plain .npz of its leaves, with
the caller supplying the structure on restore.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np


def save(path, pytree) -> None:
    """Persist a pytree of arrays to `path` (directory)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(pytree)
    np.savez(path / "state.npz",
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    (path / "treedef.json").write_text(json.dumps(str(treedef)))


def restore(path, like):
    """Restore a pytree saved by save(); `like` provides the structure
    and the leaf dtypes."""
    data = np.load(Path(path) / "state.npz")
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    leaves = [np.asarray(data[f"leaf_{i}"], np.asarray(l).dtype)
              for i, l in enumerate(leaves_like)]
    return jax.tree_util.tree_unflatten(treedef, leaves)
