"""Fused likelihood engine: tree topology compiled once, then P-matrices +
CLV sweep + log-likelihood (+ derivatives, + Newton) run as ONE jitted XLA
program.

This is the accelerator performance path.  The reference library executes
pmatrix/partials/likelihood as separate host-driven calls
(examples/unrooted/unrooted.c flow); here a topology is compiled host-side
into a `TreeProgram` (level-batched op tensor + branch/pmatrix layout) and
everything numeric — including the Newton branch-length iteration
(examples/newton/newton.c:31-100) — stays on device.

Sharding: all site-indexed tensors carry the site axis innermost; under a
`jax.sharding.Mesh` the engine shards that axis (data-parallel sites,
SURVEY.md §2.6) with the tree program, P-matrices and model replicated.  The
logL / (d1,d2) reductions are weighted per-site sums, so XLA inserts a psum
over the mesh — exactness is preserved.  The fused Pallas sweep is a
custom call XLA cannot partition: it runs per shard under shard_map when
the call is traced inside `jax.set_mesh(mesh)` (ops/partials_pallas_tree).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import PartitionConfig
from .ops import derivatives as derivatives_ops
from .ops import likelihood as likelihood_ops
from .ops import partials as partials_ops
from .ops import pmatrix as pmatrix_ops
from .ops import partials_pallas_tree
from .partition import levelize_operations
from .tree import create_operations, traverse
from .tree.utree import UTree


@dataclasses.dataclass(frozen=True, eq=False)
class TreeProgram:
    """Host-compiled static form of one topology.

    Hashes/compares by CONTENT (see _content_key) so jit caches hit when
    an identical topology is compiled again — tree searches revisit
    topologies constantly and would otherwise recompile every visit."""
    level_ops: np.ndarray          # [L, W, 8] int32 (padded; XLA path)
    sweep_prog: Optional[partials_pallas_tree.SweepProgram]
    pmatrix_indices: np.ndarray    # [E] int32: branch i -> pmatrix slot
    default_branch_lengths: np.ndarray  # [E] f64 (from the newick)
    root_clv: int
    root_scaler: int
    root_back_clv: int
    root_back_scaler: int
    root_pmatrix: int
    tip_count: int
    inner_count: int

    _hash: int = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def num_branches(self) -> int:
        return len(self.pmatrix_indices)

    def _content_key(self):
        vals = []
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                vals.append((f.name, v.shape, str(v.dtype),
                             v.tobytes()))
            elif isinstance(v, dict):
                vals.append((f.name, tuple(sorted(v.items()))))
            elif isinstance(v, object):
                vals.append((f.name, v))
            else:
                vals.append((f.name, v))
        return tuple(vals)

    def __eq__(self, other):
        return (type(other) is type(self)
                and self._content_key() == other._content_key())

    def __hash__(self):
        if self._hash is None:
            object.__setattr__(self, "_hash", hash(self._content_key()))
        return self._hash


def compile_tree(tree: UTree, cfg: PartitionConfig) -> TreeProgram:
    """Traverse + compile + levelize one topology."""
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    level_ops = levelize_operations(ops, cfg)
    root = tree.vroot
    # rows the logL/derivative reductions consume; tips are re-expanded
    # from tipchars instead of exported
    exports = [i for i in (root.clv_index, root.back.clv_index)
               if i >= cfg.tips]
    sweep_prog = partials_pallas_tree.schedule(ops, cfg.tips, exports)
    return TreeProgram(
        level_ops=level_ops,
        sweep_prog=sweep_prog,
        pmatrix_indices=np.asarray(pmat_idx, dtype=np.int32),
        default_branch_lengths=np.asarray(branches, dtype=np.float64),
        root_clv=root.clv_index,
        root_scaler=root.scaler_index,
        root_back_clv=root.back.clv_index,
        root_back_scaler=root.back.scaler_index,
        root_pmatrix=root.pmatrix_index,
        tip_count=tree.tip_count,
        inner_count=tree.inner_count,
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Model:
    """Replicated model parameters (eigen factors precomputed host-side)."""
    eigenvals: jax.Array       # [M, S]
    eigenvecs: jax.Array       # [M, S, S]
    inv_eigenvecs: jax.Array   # [M, S, S]
    frequencies: jax.Array     # [M, S]
    rates: jax.Array           # [R]
    rate_weights: jax.Array    # [R]
    prop_invar: jax.Array      # [M]
    params_indices: jax.Array  # [R] int32

    def tree_flatten(self):
        return ((self.eigenvals, self.eigenvecs, self.inv_eigenvecs,
                 self.frequencies, self.rates, self.rate_weights,
                 self.prop_invar, self.params_indices), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def cat_freqs(self):
        return self.frequencies[self.params_indices]

    @property
    def cat_pinv(self):
        return self.prop_invar[self.params_indices]


def make_model(subst_params, frequencies, rates, rate_weights=None,
               prop_invar=None, params_indices=None, dtype=jnp.float64
               ) -> Model:
    """Build a Model from raw parameters: eigendecompose each rate matrix
    host-side (models/ratematrix.py) and stack the factors.

    subst_params: [M, S*(S-1)/2]; frequencies: [M, S]; rates: [R].
    """
    from .models import ratematrix
    subst_params = np.atleast_2d(np.asarray(subst_params, dtype=np.float64))
    frequencies = np.atleast_2d(np.asarray(frequencies, dtype=np.float64))
    M, S = frequencies.shape
    R = len(rates)
    evals = np.zeros((M, S))
    evecs = np.zeros((M, S, S))
    inv_evecs = np.zeros((M, S, S))
    for m in range(M):
        freqs = ratematrix.normalize_frequencies(frequencies[m])
        frequencies[m] = freqs
        dec = ratematrix.update_eigen(subst_params[m], freqs)
        evals[m], evecs[m], inv_evecs[m] = dec
    if rate_weights is None:
        rate_weights = np.full(R, 1.0 / R)
    if prop_invar is None:
        prop_invar = np.zeros(M)
    if params_indices is None:
        params_indices = np.zeros(R, dtype=np.int32)
    return Model(
        eigenvals=jnp.asarray(evals, dtype),
        eigenvecs=jnp.asarray(evecs, dtype),
        inv_eigenvecs=jnp.asarray(inv_evecs, dtype),
        frequencies=jnp.asarray(frequencies, dtype),
        rates=jnp.asarray(rates, dtype),
        rate_weights=jnp.asarray(rate_weights, dtype),
        prop_invar=jnp.asarray(prop_invar, dtype),
        params_indices=jnp.asarray(params_indices, jnp.int32),
    )


def expand_tipchars(tipchars, states: int, dtype):
    """Bit-decode packed tip state masks [tips, T] int32 into 0/1 tip CLVs
    [tips, S, T] on device (cheap; avoids shipping dense CLVs to HBM)."""
    shifts = jnp.arange(states, dtype=tipchars.dtype)[None, :, None]
    bits = (tipchars[:, None, :] >> shifts) & 1
    return bits.astype(dtype)


def _sweep(program: TreeProgram, cfg: PartitionConfig, model: Model,
           branch_lengths, tipchars, pattern_weights):
    """P-matrices + full CLV sweep. Returns (clv, scalers, pmatrix).

    tipchars: packed bitmask states [tips, T] int32 (site axis shardable).
    """
    dtype = cfg.dtype
    R, S, T = cfg.rate_cats, cfg.states, tipchars.shape[-1]

    pmats = pmatrix_ops.compute_pmatrices(
        branch_lengths, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=dtype)                    # [E, R, S, S]
    # one slot per possible pmatrix index (= clv index space)
    num_slots = int(program.pmatrix_indices.max()) + 1
    pmatrix = jnp.zeros((num_slots, R, S, S), dtype)
    pmatrix = pmatrix.at[jnp.asarray(program.pmatrix_indices)].set(pmats)

    if partials_pallas_tree.choose(program.sweep_prog, cfg,
                                   jax.default_backend()):
        # fused sweep: tips stay packed, only root rows reach device memory
        clv_rows, scal_rows = partials_pallas_tree.sweep(
            tipchars, pmatrix, program.sweep_prog, cfg)
        return _TreeView(clv_rows, scal_rows, program.sweep_prog,
                         tipchars, cfg), pmatrix

    clv = jnp.zeros((cfg.num_clvs + 1, R, S, T), dtype)
    tip_clv = expand_tipchars(tipchars, S, dtype)             # [tips, S, T]
    clv = clv.at[:cfg.tips].set(
        jnp.broadcast_to(tip_clv[:, None, :, :], (cfg.tips, R, S, T)))
    if cfg.per_rate_scalers:
        scalers = jnp.zeros((cfg.scale_buffers + 2, R, T), jnp.int32)
    else:
        scalers = jnp.zeros((cfg.scale_buffers + 2, T), jnp.int32)

    clv, scalers = partials_ops.update_partials(
        clv, scalers, pmatrix, jnp.asarray(program.level_ops), cfg)
    return _StandardView(clv, scalers), pmatrix


class _StandardView:
    """Row accessors over standard-layout sweep results."""

    def __init__(self, clv, scalers):
        self._clv = clv
        self._scalers = scalers

    def clv_row(self, index: int):
        return self._clv[index]                               # [R, S, T]

    def scaler_row(self, index: int):
        return self._scalers[index]                           # [T] / [R, T]


class _TreeView:
    """Row accessors over fused-sweep results: only exported rows exist in
    device memory; tip rows are re-expanded from the packed bitmasks on
    demand."""

    def __init__(self, clv_rows, scal_rows, sweep_prog, tipchars,
                 cfg: PartitionConfig):
        self._clv_rows = clv_rows            # [E, R, S, T]
        self._scal_rows = scal_rows          # [E, SR, T]
        self._prog = sweep_prog
        self._tipchars = tipchars
        self._cfg = cfg

    def clv_row(self, index: int):
        cfg = self._cfg
        if index < cfg.tips:
            tip = expand_tipchars(self._tipchars[index:index + 1],
                                  cfg.states, cfg.dtype)[0]   # [S, T]
            return jnp.broadcast_to(
                tip[None], (cfg.rate_cats, cfg.states, tip.shape[-1]))
        return self._clv_rows[self._prog.export_clv_map[index]]

    def scaler_row(self, index: int):
        cfg = self._cfg
        if index in self._prog.export_scaler_map:
            row = self._scal_rows[self._prog.export_scaler_map[index]]
            return row if cfg.per_rate_scalers else row[0]
        if cfg.per_rate_scalers:
            return jnp.zeros((cfg.rate_cats, cfg.sites_padded), jnp.int32)
        return jnp.zeros(cfg.sites_padded, jnp.int32)


@functools.partial(jax.jit, static_argnames=("program", "cfg"))
def loglikelihood(program: TreeProgram, cfg: PartitionConfig, model: Model,
                  branch_lengths, tipchars, pattern_weights, invariant):
    """Full-tree log-likelihood, one XLA program.

    tipchars: [tips, T] int32 packed state bitmasks; pattern_weights: [T];
    invariant: [T] int32.
    """
    view, pmatrix = _sweep(program, cfg, model, branch_lengths,
                           tipchars, pattern_weights)
    return likelihood_ops.edge_loglikelihood(
        view.clv_row(program.root_clv),
        view.scaler_row(program.root_scaler if program.root_scaler >= 0
                        else cfg.scaler_zero),
        view.clv_row(program.root_back_clv),
        view.scaler_row(program.root_back_scaler
                        if program.root_back_scaler >= 0
                        else cfg.scaler_zero),
        pmatrix[program.root_pmatrix],
        model.cat_freqs, model.rate_weights, model.cat_pinv,
        invariant, pattern_weights, cfg)


@functools.partial(jax.jit, static_argnames=("program", "cfg", "newton_iters"))
def optimize_root_branch(program: TreeProgram, cfg: PartitionConfig,
                         model: Model, branch_lengths, tipchars,
                         pattern_weights, invariant,
                         newton_iters: int = 10):
    """One 'training step': CLV sweep, then on-device Newton optimization of
    the root branch length from analytic (d1, d2) (newton.c:31-100).

    Returns (new_branch_lengths, logl_before).
    """
    view, pmatrix = _sweep(program, cfg, model, branch_lengths,
                           tipchars, pattern_weights)
    rs = view.scaler_row(program.root_scaler if program.root_scaler >= 0
                         else cfg.scaler_zero)
    rbs = view.scaler_row(program.root_back_scaler
                          if program.root_back_scaler >= 0
                          else cfg.scaler_zero)
    root_clv = view.clv_row(program.root_clv)
    root_back_clv = view.clv_row(program.root_back_clv)

    logl = likelihood_ops.edge_loglikelihood(
        root_clv, rs, root_back_clv, rbs,
        pmatrix[program.root_pmatrix], model.cat_freqs, model.rate_weights,
        model.cat_pinv, invariant, pattern_weights, cfg)

    if cfg.per_rate_scalers:
        sp, sc = rs, rbs
        asc_scalers = None
    else:
        sp = sc = jnp.zeros((cfg.rate_cats, 1), jnp.int32)
        asc_scalers = rs + rbs
    sumtable = derivatives_ops.update_sumtable(
        root_clv, root_back_clv, sp, sc,
        model.eigenvecs[model.params_indices],
        model.inv_eigenvecs[model.params_indices],
        model.cat_freqs, cfg, asc_scalers=asc_scalers)

    # position of the root branch in the branch_lengths vector
    root_pos = int(np.nonzero(
        program.pmatrix_indices == program.root_pmatrix)[0][0])

    def newton_step(_, t):
        d1, d2 = derivatives_ops.likelihood_derivatives(
            sumtable, t, model.rates,
            model.eigenvals[model.params_indices], model.cat_pinv,
            model.rate_weights, model.cat_freqs, invariant,
            pattern_weights, cfg)
        # (d1, d2) are derivatives of -lnL.  Pure Newton only where the
        # surface is locally convex; otherwise halve/double along -d1
        # (the safeguard RAxML-style optimizers apply around
        # examples/newton/newton.c:66-93's bare iteration).
        newton = t - d1 / d2
        fallback = jnp.where(d1 > 0, t * 0.5, t * 2.0)
        t_new = jnp.where(d2 > 0, newton, fallback)
        return jnp.clip(t_new, 1e-8, 100.0)

    t_opt = jax.lax.fori_loop(0, newton_iters, newton_step,
                              branch_lengths[root_pos])
    new_bl = branch_lengths.at[root_pos].set(t_opt)
    return new_bl, logl


# --------------------------------------------------------------------------
# Bidirectional message passing + batched branch-length optimization
# --------------------------------------------------------------------------
#
# The reference library optimizes ONE branch at a time (sumtable + Newton,
# examples/newton/newton.c) and leaves the all-branches loop to clients
# (RAxML-NG's smoothing).  Batched re-design: every *directed* message
# msg(u->v) — the CLV of node u in the direction of neighbor v — is the
# same binary operation as a CLV update, so one level-batched sweep over an
# extended operation list computes ALL 2E directional CLVs; then every
# branch has both facing CLVs available and all E Newton optimizations run
# on device in one scan.


@dataclasses.dataclass(frozen=True, eq=False)
class FullTreeProgram:
    """All-directions message program for one topology (content-hashed,
    same rationale as TreeProgram)."""
    cfg_ext: PartitionConfig        # row space extended to message slots
    level_ops: np.ndarray           # [L, W, 8] int32
    pmatrix_indices: np.ndarray     # [E] branch i -> pmatrix slot
    default_branch_lengths: np.ndarray
    edge_rows: np.ndarray           # [E, 4] int32: rowA, scalA, rowB, scalB
    edge_colors: np.ndarray         # [E] int32 proper edge coloring
    n_colors: int
    root_edge: int                  # branch position of the vroot edge
    tip_count: int
    _hash: int = dataclasses.field(default=None, compare=False, repr=False)

    def _content_key(self):
        vals = []
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                vals.append((f.name, v.shape, str(v.dtype),
                             v.tobytes()))
            elif isinstance(v, dict):
                vals.append((f.name, tuple(sorted(v.items()))))
            elif isinstance(v, PartitionConfig):
                vals.append((f.name, v))
            else:
                vals.append((f.name, v))
        return tuple(vals)

    def __eq__(self, other):
        return (type(other) is type(self)
                and self._content_key() == other._content_key())

    def __hash__(self):
        if self._hash is None:
            object.__setattr__(self, "_hash", hash(self._content_key()))
        return self._hash


def compile_tree_full(tree: UTree, cfg: PartitionConfig) -> FullTreeProgram:
    """Compile msg(u->v) for every half-node g at an inner node u, where
    msg rows live after the tip rows; tips' messages are their tip CLVs."""
    from .partition import Operation
    from .tree.utree import UNode  # noqa: F401  (typing only)

    inner = [n for n in tree.nodes if n.next is not None]
    half_nodes = [g for n in inner for g in n.roundabout()]
    msg_row = {g.node_index: cfg.tips + k
               for k, g in enumerate(half_nodes)}
    msg_scaler = {g.node_index: k for k, g in enumerate(half_nodes)}
    n_msgs = len(half_nodes)

    cfg_ext = dataclasses.replace(cfg, clv_buffers=n_msgs,
                                  scale_buffers=n_msgs)

    def incoming(s):  # message arriving through half-node s (from s.back)
        if s.back.next is None:     # tip neighbor
            return s.back.clv_index, -1
        return msg_row[s.back.node_index], msg_scaler[s.back.node_index]

    # Kahn ordering: a message is ready once its two feeding messages are
    ready = {g.node_index: False for g in half_nodes}
    ops = []
    emitted = 0
    while emitted < n_msgs:
        progress = False
        for g in half_nodes:
            if ready[g.node_index]:
                continue
            sibs = [s for s in g.roundabout() if s is not g]
            deps = [s for s in sibs if s.back.next is not None]
            if any(not ready[s.back.node_index] for s in deps):
                continue
            (c1, s1), (c2, s2) = incoming(sibs[0]), incoming(sibs[1])
            ops.append(Operation(
                parent_clv_index=msg_row[g.node_index],
                child1_clv_index=c1, child2_clv_index=c2,
                child1_matrix_index=sibs[0].back.pmatrix_index,
                child2_matrix_index=sibs[1].back.pmatrix_index,
                parent_scaler_index=msg_scaler[g.node_index],
                child1_scaler_index=s1, child2_scaler_index=s2))
            ready[g.node_index] = True
            emitted += 1
            progress = True
        assert progress, "cyclic message dependencies (corrupt tree)"

    level_ops = levelize_operations(ops, cfg_ext)

    # branch list in the same order as compile_tree's pmatrix_indices
    trav = traverse(tree.vroot)
    _, branches, pmat_idx = create_operations(trav)
    by_pmatrix = {}
    seen = set()
    for n in tree.nodes:
        for g in ([n] if n.next is None else list(n.roundabout())):
            key = tuple(sorted((g.node_index, g.back.node_index)))
            if key in seen:
                continue
            seen.add(key)
            by_pmatrix[g.back.pmatrix_index] = g

    edge_rows = np.zeros((len(pmat_idx), 4), np.int32)
    for i, p in enumerate(pmat_idx):
        g = by_pmatrix[p]
        # canonical orientation: row A = the PARENT side of the edge (the
        # end whose clv_index differs from the template pmatrix index —
        # parse_utree.y assigns each edge the clv of its child-side end).
        # Values are orientation-invariant (reversibility: f_i P_ij =
        # f_j P_ji), but dlogL/dP as a MATRIX is not, and the analytic
        # VJP must match the orientation the forward sweep consumes P in
        # (parent_i = sum_j P_ij child_j).
        if g.clv_index == p:
            g = g.back                           # g is now the parent side
        a, sa = ((msg_row[g.node_index], msg_scaler[g.node_index])
                 if g.next is not None else (g.clv_index, -1))
        h = g.back
        b, sb = ((msg_row[h.node_index], msg_scaler[h.node_index])
                 if h.next is not None else (h.clv_index, -1))
        edge_rows[i] = (a, cfg_ext.scaler_zero if sa < 0 else sa,
                        b, cfg_ext.scaler_zero if sb < 0 else sb)

    # proper edge coloring (greedy; <= 4 colors on a binary tree): colors
    # partition the branches into sets with no shared endpoint, so a
    # simultaneous Newton step within one color class behaves like the
    # sequential smoothing loops of the reference's clients
    colors = np.full(len(pmat_idx), -1, np.int32)
    used_at: dict[int, set] = {}
    for i, p in enumerate(pmat_idx):
        g = by_pmatrix[p]
        a = min(h.node_index for h in ([g] if g.next is None
                                       else list(g.roundabout())))
        b = min(h.node_index for h in ([g.back] if g.back.next is None
                                       else list(g.back.roundabout())))
        taken = used_at.get(a, set()) | used_at.get(b, set())
        c = 0
        while c in taken:
            c += 1
        colors[i] = c
        used_at.setdefault(a, set()).add(c)
        used_at.setdefault(b, set()).add(c)

    root_edge = int(np.nonzero(
        np.asarray(pmat_idx) == tree.vroot.pmatrix_index)[0][0])
    return FullTreeProgram(
        cfg_ext=cfg_ext,
        level_ops=level_ops,
        pmatrix_indices=np.asarray(pmat_idx, np.int32),
        default_branch_lengths=np.asarray(branches, np.float64),
        edge_rows=edge_rows,
        edge_colors=colors,
        n_colors=int(colors.max()) + 1,
        root_edge=root_edge,
        tip_count=tree.tip_count,
    )


def _asc_scalers(scalers, rows, cfg: PartitionConfig):
    """Per-site scaler sum of an edge for the asc-bias phantom-column fold
    in update_sumtable (core_derivatives.c:884-892).  None when the
    correction does not need absolute phantom likelihoods."""
    from .constants import AB_FELSENSTEIN, AB_LEWIS
    if cfg.asc_bias in (AB_LEWIS, AB_FELSENSTEIN) \
            and not cfg.per_rate_scalers:
        return scalers[rows[1]] + scalers[rows[3]]
    return None


def _sweep_all(program: FullTreeProgram, cfg: PartitionConfig, model: Model,
               branch_lengths, tipchars):
    """Compute all directional messages; returns (clv, scalers, pmatrix)."""
    # the program fixes the row layout; the arithmetic (dtype, rescue
    # threshold and factor) is the call's, so one program serves any dtype
    cfg_ext = dataclasses.replace(
        cfg, clv_buffers=program.cfg_ext.clv_buffers,
        scale_buffers=program.cfg_ext.scale_buffers)
    dtype = cfg.dtype
    R, S, T = cfg.rate_cats, cfg.states, tipchars.shape[-1]

    pmats = pmatrix_ops.compute_pmatrices(
        branch_lengths, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=dtype)
    num_slots = int(program.pmatrix_indices.max()) + 1
    pmatrix = jnp.zeros((num_slots, R, S, S), dtype)
    pmatrix = pmatrix.at[jnp.asarray(program.pmatrix_indices)].set(pmats)

    clv = jnp.zeros((cfg_ext.num_clvs + 1, R, S, T), dtype)
    tip_clv = expand_tipchars(tipchars, S, dtype)
    clv = clv.at[:cfg.tips].set(
        jnp.broadcast_to(tip_clv[:, None, :, :], (cfg.tips, R, S, T)))
    if cfg.per_rate_scalers:
        scalers = jnp.zeros((cfg_ext.scale_buffers + 2, R, T), jnp.int32)
    else:
        scalers = jnp.zeros((cfg_ext.scale_buffers + 2, T), jnp.int32)
    clv, scalers = partials_ops.update_partials(
        clv, scalers, pmatrix, jnp.asarray(program.level_ops), cfg_ext)
    return clv, scalers, pmatrix


@functools.partial(jax.jit, static_argnames=("program", "cfg", "rounds",
                                             "newton_iters"))
def optimize_branch_lengths(program: FullTreeProgram, cfg: PartitionConfig,
                            model: Model, branch_lengths, tipchars,
                            pattern_weights, invariant,
                            rounds: int = 3, newton_iters: int = 10,
                            min_branch: float = 1e-8,
                            max_branch: float = 100.0):
    """Newton-optimize ALL branch lengths (batched smoothing).

    Each round recomputes every directional CLV once, then runs an
    independent Newton iteration on every branch from analytic (d1, d2)
    (core_derivatives.c:843-848 semantics) — a Jacobi-style simultaneous
    update of the reference clients' branch-smoothing loops.

    Returns (optimized_branch_lengths, logl_after).
    """
    dtype = cfg.dtype
    edge_rows = jnp.asarray(program.edge_rows)
    evecs = model.eigenvecs[model.params_indices]
    inv_evecs = model.inv_eigenvecs[model.params_indices]
    sp_zero = jnp.zeros((cfg.rate_cats, 1), jnp.int32)

    def optimize_class(bl, color_mask):
        """Re-sweep messages, then Newton-update the branches of one color
        class (no two share a node, so each sees up-to-date CLVs)."""
        clv, scalers, pmatrix = _sweep_all(program, cfg, model, bl,
                                           tipchars)

        def per_edge(args):
            rows, t0 = args
            clvp, clvc = clv[rows[0]], clv[rows[2]]
            # per-site scalers cancel in L'/L; per-rate relative scalers
            # must fold into the sumtable (core_derivatives.c:418-460)
            sp, sc = ((scalers[rows[1]], scalers[rows[3]])
                      if cfg.per_rate_scalers else (sp_zero, sp_zero))
            st = derivatives_ops.update_sumtable(
                clvp, clvc, sp, sc, evecs, inv_evecs,
                model.cat_freqs, cfg,
                asc_scalers=_asc_scalers(scalers, rows, cfg))

            def newton_step(_, t):
                d1, d2 = derivatives_ops.likelihood_derivatives(
                    st, t, model.rates,
                    model.eigenvals[model.params_indices], model.cat_pinv,
                    model.rate_weights, model.cat_freqs, invariant,
                    pattern_weights, cfg)
                newton = t - d1 / d2
                fallback = jnp.where(d1 > 0, t * 0.5, t * 2.0)
                t_new = jnp.where(d2 > 0, newton, fallback)
                return jnp.clip(t_new, min_branch, max_branch)

            return jax.lax.fori_loop(0, newton_iters, newton_step, t0)

        proposal = jax.lax.map(per_edge, (edge_rows, bl),
                               batch_size=32)
        return jnp.where(color_mask, proposal, bl).astype(dtype)

    colors = np.asarray(program.edge_colors)

    def one_round(bl, _):
        for c in range(program.n_colors):
            bl = optimize_class(bl, jnp.asarray(colors == c))
        return bl, None

    bl, _ = jax.lax.scan(one_round, branch_lengths, None, length=rounds)

    # final logL across the root edge with the optimized lengths
    clv, scalers, pmatrix = _sweep_all(program, cfg, model, bl, tipchars)
    ra, rsa, rb, rsb = program.edge_rows[program.root_edge]
    logl = likelihood_ops.edge_loglikelihood(
        clv[ra], scalers[rsa], clv[rb], scalers[rsb],
        pmatrix[program.pmatrix_indices[program.root_edge]],
        model.cat_freqs, model.rate_weights, model.cat_pinv,
        invariant, pattern_weights, cfg)
    return bl, logl


@functools.partial(jax.jit, static_argnames=("program", "cfg"))
def score_placements(program: FullTreeProgram, cfg: PartitionConfig,
                     model: Model, branch_lengths, tipchars,
                     pattern_weights, invariant,
                     sub_clv, sub_scaler, sub_branch_length):
    """Log-likelihood of regrafting a pruned subtree onto EVERY edge of
    the remainder tree, in one device program ([E]).

    `program` is compile_tree_full of the REMAINDER tree (after
    moves.prune_subtree); `sub_clv`/`sub_scaler` is the pruned subtree's
    CLV directed at the cut (tree.traverse_subtree + any partials path;
    sub_scaler shaped [T], or [R, T] under per_rate_scalers)
    and `sub_branch_length` its attachment branch.  Placement at edge e
    follows SPR semantics (utree_moves.c:119-254): the edge splits in
    half, the subtree keeps its branch — so score_placements[e] equals
    the full-tree logL after spr(...) onto e.  This is the batched inner
    loop of SPR rounds and EPA-style phylogenetic placement; the
    reference evaluates candidates one partial traversal at a time.
    """
    dtype = cfg.dtype
    clv, scalers, _ = _sweep_all(program, cfg, model, branch_lengths,
                                 tipchars)
    halves = pmatrix_ops.compute_pmatrices(
        branch_lengths * 0.5, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=dtype)                   # [E, R, S, S]
    p3 = pmatrix_ops.compute_pmatrices(
        jnp.asarray(sub_branch_length, dtype)[None], model.eigenvals,
        model.eigenvecs, model.inv_eigenvecs, model.rates,
        model.prop_invar, model.params_indices, dtype=dtype)[0]
    hi = jax.lax.Precision.HIGHEST
    sub_term = jnp.einsum("rij,rjt->rit", p3, sub_clv.astype(dtype),
                          precision=hi)
    edge_rows = jnp.asarray(program.edge_rows)

    def per_edge(args):
        rows, ph = args
        ta = jnp.einsum("rij,rjt->rit", ph, clv[rows[0]], precision=hi)
        tb = jnp.einsum("rij,rjt->rit", ph, clv[rows[2]], precision=hi)
        combined = ta * tb * sub_term                        # [R, S, T]
        scal = scalers[rows[1]] + scalers[rows[3]] + sub_scaler
        return likelihood_ops.root_loglikelihood(
            combined, scal, model.cat_freqs, model.rate_weights,
            model.cat_pinv, invariant, pattern_weights, cfg)

    return jax.lax.map(per_edge, (edge_rows, halves), batch_size=32)


@functools.partial(jax.jit, static_argnames=("program", "cfg"))
def branch_derivatives(program: FullTreeProgram, cfg: PartitionConfig,
                       model: Model, branch_lengths, tipchars,
                       pattern_weights, invariant):
    """(d1, d2) of -lnL w.r.t. EVERY branch length in one sweep ([E], [E]).

    The reference computes these one branch at a time
    (pll_update_sumtable + pll_compute_likelihood_derivatives); here the
    directional-message sweep makes all E pairs available at once.
    """
    edge_rows = jnp.asarray(program.edge_rows)
    evecs = model.eigenvecs[model.params_indices]
    inv_evecs = model.inv_eigenvecs[model.params_indices]
    sp_zero = jnp.zeros((cfg.rate_cats, 1), jnp.int32)
    clv, scalers, pmatrix = _sweep_all(program, cfg, model, branch_lengths,
                                       tipchars)

    def per_edge(args):
        rows, t = args
        sp, sc = ((scalers[rows[1]], scalers[rows[3]])
                  if cfg.per_rate_scalers else (sp_zero, sp_zero))
        st = derivatives_ops.update_sumtable(
            clv[rows[0]], clv[rows[2]], sp, sc, evecs, inv_evecs,
            model.cat_freqs, cfg,
            asc_scalers=_asc_scalers(scalers, rows, cfg))
        return derivatives_ops.likelihood_derivatives(
            st, t, model.rates, model.eigenvals[model.params_indices],
            model.cat_pinv, model.rate_weights, model.cat_freqs, invariant,
            pattern_weights, cfg)

    return jax.lax.map(per_edge, (edge_rows, branch_lengths),
                       batch_size=32)


@functools.partial(jax.jit, static_argnames=("program", "cfg"))
def all_edge_loglikelihoods(program: FullTreeProgram, cfg: PartitionConfig,
                            model: Model, branch_lengths, tipchars,
                            pattern_weights, invariant):
    """Edge logL evaluated across EVERY branch ([E]).  All entries must be
    equal (the likelihood is invariant to the evaluation edge) — the
    strongest whole-sweep self-check the message structure admits."""
    edge_rows = jnp.asarray(program.edge_rows)
    clv, scalers, pmatrix = _sweep_all(program, cfg, model, branch_lengths,
                                       tipchars)
    pmat_slots = jnp.asarray(program.pmatrix_indices)

    def per_edge(args):
        rows, slot = args
        return likelihood_ops.edge_loglikelihood(
            clv[rows[0]], scalers[rows[1]], clv[rows[2]], scalers[rows[3]],
            pmatrix[slot], model.cat_freqs, model.rate_weights,
            model.cat_pinv, invariant, pattern_weights, cfg)

    return jax.lax.map(per_edge, (edge_rows, pmat_slots),
                       batch_size=32)


# --------------------------------------------------------------------------
# Analytic reverse mode: custom VJP through the whole likelihood
# --------------------------------------------------------------------------
#
# The reference has no autodiff; this framework's model fitting (fit.py)
# uses jax.grad, which on the XLA path materializes every CLV for the
# reverse sweep.  The fused Pallas sweep keeps CLVs in registers, so XLA cannot
# differentiate through it — loglikelihood_analytic instead registers the
# ANALYTIC reverse pass, valid for any forward implementation:
#
#   * The likelihood can be evaluated across any edge e with the two
#     facing directional CLVs (messages): L_t = Σ_r rw_r [(1-p_r)
#     Σ_ij f_ri msg_a[r,i,t] P_e[r,i,j] msg_b[r,j,t] + p_r π_inv].
#     Differentiating THAT form in P_e gives the exact full-likelihood
#     gradient for every edge (the standard belief-propagation identity;
#     the reference's sumtable, core_derivatives.c:321-471, is this same
#     factorization specialized to d/dt).
#   * One directional-message sweep (compile_tree_full) therefore yields
#     dlogL/dP_e for ALL edges; branch-length and model gradients follow
#     by ordinary XLA autodiff through compute_pmatrices (a tiny closed-
#     form function), and the reduction-side gradients (frequencies, rate
#     weights, prop_invar) by autodiff of the root-edge reduction with
#     messages held fixed.
#
# Cost: forward = the fast path (the fused sweep on the GPU); backward = one message
# sweep (~3x forward) + E small einsums — no CLV materialization beyond
# the message rows, and per-site scalers cancel exactly (the coefficient
# folds thresh^{s_a+s_b} against the per-site log-likelihood).


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def loglikelihood_analytic(program: TreeProgram, full: FullTreeProgram,
                           cfg: PartitionConfig, model: Model,
                           branch_lengths, tipchars, pattern_weights,
                           invariant):
    """loglikelihood() with an analytic (message-based) reverse pass.

    Differentiable in (model, branch_lengths, pattern_weights) on ANY
    forward path, including the fused Pallas sweep.  Supports per-site and
    per-rate scalers, +I, and every ascertainment-bias correction (the
    per-edge reduction tail is differentiated by ordinary autodiff)."""
    return loglikelihood(program, cfg, model, branch_lengths, tipchars,
                         pattern_weights, invariant)


def _lla_fwd(program, full, cfg, model, branch_lengths, tipchars,
             pattern_weights, invariant):
    logl = loglikelihood(program, cfg, model, branch_lengths, tipchars,
                         pattern_weights, invariant)
    return logl, (model, branch_lengths, tipchars, pattern_weights,
                  invariant)


def _float0(x):
    return np.zeros(x.shape, dtype=jax.dtypes.float0)


def _lla_bwd(program, full, cfg, res, g):
    model, bl, tipchars, pw, inv = res
    dtype = cfg.dtype

    clv, scalers, pmatrix = _sweep_all(full, cfg, model, bl, tipchars)
    edge_rows = jnp.asarray(full.edge_rows)
    pmat_slots = jnp.asarray(full.pmatrix_indices)
    ra, rsa, rb, rsb = full.edge_rows[full.root_edge]
    root_slot = int(full.pmatrix_indices[full.root_edge])

    freqs = model.cat_freqs.astype(dtype)                          # [R, S]
    hi = jax.lax.Precision.HIGHEST

    def per_edge(args):
        # dlogL/dP_e by the belief-propagation identity: the edge-e
        # factorization L_t = reduce(Σ_ij π_i msg_a,i P_ij msg_b,j) holds
        # for EVERY edge with messages held fixed, so the true partial
        # derivative in P_e is the VJP of that form.  The reduction tail
        # (scaler undo — per-site or capped per-rate, +I mixing, asc-bias
        # corrections) is a cheap [R, T] function; ordinary autodiff of it
        # yields the per-(rate, site) cotangent `bar`, and the expensive
        # message factors stay analytic (core_derivatives.c:321-471 is
        # this same factorization specialized to d/dt).
        rows, slot = args
        msg_a = clv[rows[0]]                                       # [R,S,T]
        msg_b = clv[rows[2]]
        sa, sb = scalers[rows[1]], scalers[rows[3]]
        A = freqs[:, :, None] * msg_a                              # [R,S,T]
        apb = jnp.einsum("rit,rij,rjt->rt", A, pmatrix[slot].astype(dtype),
                         msg_b, precision=hi)                      # [R,T]

        def reduce_fn(apb_):
            return likelihood_ops.edge_reduce(
                apb_, sa, sb, model.cat_freqs, model.rate_weights,
                model.cat_pinv, inv, pw, cfg)

        _, rvjp = jax.vjp(reduce_fn, apb)
        bar, = rvjp(g)                                             # [R,T]
        return jnp.einsum("rt,rit,rjt->rij", bar, A, msg_b,
                          precision=hi)

    pmat_bar = jax.lax.map(per_edge, (edge_rows, pmat_slots),
                           batch_size=32)        # [E,R,S,S]

    def pm_fn(bl_, evals, evecs, inv_evecs, rates, pinv):
        return pmatrix_ops.compute_pmatrices(
            bl_, evals, evecs, inv_evecs, rates, pinv,
            model.params_indices, dtype=dtype)

    _, pm_vjp = jax.vjp(pm_fn, bl, model.eigenvals, model.eigenvecs,
                        model.inv_eigenvecs, model.rates, model.prop_invar)
    bl_bar, evals_bar, evecs_bar, ivecs_bar, rates_bar, pinv_bar_pm = \
        pm_vjp(pmat_bar.astype(dtype))

    # reduction-side gradients (messages and P held fixed); pattern
    # weights enter the likelihood only through the reduction, so pw_bar
    # is exact here too (including the asc-bias correction terms)
    def red_fn(frequencies, rate_weights, prop_invar, pw_):
        cat_freqs = frequencies[model.params_indices]
        cat_pinv = prop_invar[model.params_indices]
        return likelihood_ops.edge_loglikelihood(
            clv[ra], scalers[rsa], clv[rb], scalers[rsb],
            pmatrix[root_slot], cat_freqs, rate_weights, cat_pinv, inv,
            pw_, cfg)

    _, red_vjp = jax.vjp(red_fn, model.frequencies, model.rate_weights,
                         model.prop_invar, pw)
    freqs_bar, rw_bar, pinv_bar_red, pw_bar = red_vjp(g)

    model_bar = Model(
        eigenvals=evals_bar, eigenvecs=evecs_bar, inv_eigenvecs=ivecs_bar,
        frequencies=freqs_bar, rates=rates_bar, rate_weights=rw_bar,
        prop_invar=pinv_bar_pm + pinv_bar_red,
        params_indices=_float0(model.params_indices))
    return (model_bar, bl_bar, _float0(tipchars), pw_bar, _float0(inv))


loglikelihood_analytic.defvjp(_lla_fwd, _lla_bwd)


def pad_tipchars(tipchars: np.ndarray, cfg: PartitionConfig) -> np.ndarray:
    """Pad encoded tip characters [tips, sites or sites_alloc] (bitmask) to
    the engine's [tips, T] int32 input (padding columns = gap state so
    padded CLV entries are 1.0 and inert under scaling checks).

    Under ascertainment bias the phantom per-state columns are stamped with
    pure states (phantom site j observes state j at every tip,
    pll.c:1006-1018) whether or not the input carries them."""
    from .constants import AB_NONE, gap_state
    out = np.full((cfg.tips, cfg.sites_padded), gap_state(cfg.states),
                  dtype=np.int32)
    out[:, :tipchars.shape[1]] = tipchars.astype(np.int32)
    if cfg.asc_bias != AB_NONE:
        out[:, cfg.sites:cfg.sites + cfg.states] = \
            1 << np.arange(cfg.states, dtype=np.int32)
    return out
