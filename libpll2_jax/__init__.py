"""libpll2_jax — phylogenetic likelihood engine for GPUs, in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of libpll-2
(the C library under RAxML-NG / ModelTest-NG / EPA-ng): Felsenstein-pruning
CLV updates, eigendecomposition-based P-matrices, root/edge log-likelihoods,
analytic branch-length derivatives, +Γ/+I/ascertainment-bias models, site
pattern compression and site repeats, parsimony, and tree objects with
SPR/NNI moves — organized as a functional core (ops/) under a familiar
partition API, with alignment sites sharded across device meshes.
"""
from . import constants
from . import engine
from . import fit
from . import infer, multipartition, search_fast
from .infer import InferenceResult, infer_ml_tree
from .config import PartitionConfig
from .constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE, AB_STAMATAKIS,
                        GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN, MAP_AA,
                        MAP_BIN, MAP_GT10, MAP_GT16, MAP_NT, MAPS,
                        SCALE_BUFFER_NONE, SHOW_BRANCH_LENGTH,
                        SHOW_CLV_INDEX, SHOW_LABEL, SHOW_PMATRIX_INDEX,
                        SHOW_SCALER_INDEX)
from .models.gamma import compute_gamma_cats
from .models.ratematrix import update_eigen
from .parsimony import FastParsimony, ParsBuildOp, Parsimony, ParsRecOp
from .partition import Operation, Partition, levelize_operations

__version__ = "0.1.0"

__all__ = [
    "infer", "infer_ml_tree", "InferenceResult",
    "Partition", "Operation", "PartitionConfig", "levelize_operations",
    "engine", "fit", "search_fast",
    "compute_gamma_cats", "update_eigen", "constants",
    "Parsimony", "FastParsimony", "ParsBuildOp", "ParsRecOp",
    "MAP_NT", "MAP_AA", "MAP_BIN", "MAP_GT10", "MAP_GT16", "MAPS",
    "GAMMA_RATES_MEAN", "GAMMA_RATES_MEDIAN", "SCALE_BUFFER_NONE",
    "AB_NONE", "AB_LEWIS", "AB_FELSENSTEIN", "AB_STAMATAKIS",
]
