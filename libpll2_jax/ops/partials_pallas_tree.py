"""Fused CLV tree sweep: one Triton-route Pallas kernel for the GPU.

The XLA level path (ops/partials.py) round-trips every CLV row through
device memory: it zero-fills the [N, R, S, T] slab, broadcasts the tips
into it, and each level gathers, contracts and scatters whole rows.  The
Felsenstein recursion (reference libpll-2 src/core_partials.c:612-765)
over ONE block of sites needs far less: under Sethi–Ullman evaluation
order its live set is O(depth) CLV tiles (schedule()).  So each program
instance of the kernel walks the whole operation list for one site block:

  * grid = site blocks only.  Blocks are independent, so they spread over
    the card's SMs with nothing carried between them.
  * A loop over the operation table (SweepProgram.ops, runtime data) reads
    two child tiles, computes the parent and writes it to its slot.  The
    slot pool is an output array, but a block only touches its own
    [slots, R, S, tb] columns, a few hundred KB that stay in L2 while the
    block runs.  One compiled loop body serves every topology; unrolling
    the topology instead (all slots in registers) took minutes to compile
    for 254 operations on the H100 (PERF.md).
  * A CLV tile is an [R, S, tb] tensor.  P @ child is a broadcast
    multiply and a sum over the child's states: S*S FMAs per rate and
    site on the CUDA cores, in full f32 (no TF32, no tensor cores: a 4x4
    product per rate is far below what a matrix unit needs).  P tiles are
    read per operation; the few hundred KB of P-matrices stay in L2.
    Triton tensors have power-of-two extents, so other state and rate
    category counts pad with zero P blocks; the padded CLV entries are 0
    and are sliced off the exported rows.
  * Tips never become CLVs in device memory: each block reads the packed
    state bitmasks ([tips, T] int32) and bit-expands them in registers
    (pll.c:959-1024 semantics, SURVEY.md §8.3#4).
  * The exported rows (the root edge's CLVs and scalers) are the slots
    schedule() never frees; they are sliced out of the pool at the end.

Underflow rescue is the XLA path's protocol (pll.h:96-104): per-site (or
per-rate) all-below-threshold test, parent counter = left + right +
rescue.

f32 only; f64 and bf16 stay on the XLA path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.sharding import PartitionSpec as P

from ..config import PartitionConfig
from ..parallel.sharding import SITES_AXIS

OP_COLS = 9
# columns: 0 parent_slot, 1 c1_tip_idx, 2 c1_slot, 3 c1_is_tip,
#          4 c2_tip_idx, 5 c2_slot, 6 c2_is_tip, 7 pmatrix1, 8 pmatrix2

# Sites per program instance and warps per program: each thread carries
# SITE_BLOCK / (32 * NUM_WARPS) sites of every live CLV in registers.
# 64 x 2 was the fastest of {64, 128, 256} x {2, 4, 8} at dna_256 on the
# H100 (PERF.md).
SITE_BLOCK = 64
NUM_WARPS = 2

KERNEL_NAME = "clv_tree_sweep"

# State counts for which the kernel beats the XLA path on the card; other
# state counts still run the kernel when cfg.use_pallas is True.
FAST_STATES = frozenset({4})


@dataclasses.dataclass(frozen=True, eq=False)
class SweepProgram:
    """Host-compiled slot-allocated schedule of one tree traversal.

    Hashes/compares by CONTENT so jit caches hit when the same topology
    is recompiled (SPR rounds revisit topologies constantly)."""
    ops: np.ndarray                    # [OPS, 9] int32
    pool_size: int
    exports: tuple                     # ((op_index, slot), ...) row-ordered
    export_clv_map: dict               # clv_index -> export row
    export_scaler_map: dict            # scaler_index -> export row
    _hash: int = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def n_ops(self) -> int:
        return self.ops.shape[0]

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


def schedule(ops: Sequence, tips: int, export_clvs: Sequence[int]
             ) -> Optional[SweepProgram]:
    """Sethi–Ullman slot allocation over an operation forest.

    ops: partition.Operation list (any topological order).  Returns None
    when the list is not a forest (a CLV written twice, or a child that is
    neither a tip nor produced here — e.g. partial traversals), in which
    case callers fall back to the XLA einsum path.
    """
    producer = {}
    for i, op in enumerate(ops):
        if op.parent_clv_index in producer:
            return None
        producer[op.parent_clv_index] = op
    if not producer:
        return None

    refcount: dict[int, int] = {}
    for op in ops:
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= tips:
                if c not in producer:
                    return None
                refcount[c] = refcount.get(c, 0) + 1

    exports = [c for c in dict.fromkeys(export_clvs) if c in producer]
    roots = [p for p in producer if refcount.get(p, 0) == 0]

    # need(): minimum live slots to evaluate a subtree (heavier child first)
    need: dict[int, int] = {}
    for root in roots:
        stack = [(root, False)]
        while stack:
            node, seen = stack.pop()
            if node < tips or node in need:
                continue
            op = producer[node]
            kids = [c for c in (op.child1_clv_index, op.child2_clv_index)
                    if c >= tips]
            if not seen:
                stack.append((node, True))
                stack.extend((k, False) for k in kids)
            else:
                ns = sorted((need[k] for k in kids), reverse=True)
                if len(ns) == 0:
                    need[node] = 1
                elif len(ns) == 1:
                    need[node] = max(ns[0], 2)  # child held + parent slot
                else:
                    inner = max(ns[0], ns[1] + 1)
                    need[node] = max(inner, 3)  # both held + parent slot

    no_free = set(exports)
    slot_of: dict[int, int] = {}
    free: list[int] = []
    next_slot = 0
    rows: list[list[int]] = []
    export_pos: dict[int, tuple[int, int]] = {}  # clv -> (op_index, slot)
    live_ref = dict(refcount)

    def alloc() -> int:
        nonlocal next_slot
        if free:
            return free.pop()
        s = next_slot
        next_slot += 1
        return s

    for root in roots:
        stack = [(root, False)]
        while stack:
            node, seen = stack.pop()
            if node < tips:
                continue
            op = producer[node]
            kids = [c for c in (op.child1_clv_index, op.child2_clv_index)
                    if c >= tips]
            if not seen:
                stack.append((node, True))
                # push lighter child first so the heavier pops (runs) first
                for k in sorted(kids, key=lambda k: need[k]):
                    stack.append((k, False))
                continue
            # children evaluated; emit this op.  Parent gets a FRESH slot
            # (never a child's), so a slot names one value for its whole
            # live range.
            p_slot = alloc()
            slot_of[node] = p_slot

            def enc(c):
                if c < tips:
                    return [c, 0, 1]
                return [0, slot_of[c], 0]

            rows.append([p_slot]
                        + enc(op.child1_clv_index)
                        + enc(op.child2_clv_index)
                        + [op.child1_matrix_index, op.child2_matrix_index])
            if node in no_free:
                export_pos[node] = (len(rows) - 1, p_slot)
            for c in kids:
                live_ref[c] -= 1
                if live_ref[c] == 0 and c not in no_free:
                    free.append(slot_of[c])

    export_clv_map = {}
    export_scaler_map = {}
    export_list = []
    for row, clv in enumerate(exports):
        export_clv_map[clv] = row
        sidx = producer[clv].parent_scaler_index
        if sidx is not None and sidx >= 0:
            export_scaler_map[sidx] = row
        export_list.append(export_pos[clv])

    return SweepProgram(
        ops=np.asarray(rows, dtype=np.int32).reshape(len(rows), OP_COLS),
        pool_size=next_slot,
        exports=tuple(export_list),
        export_clv_map=export_clv_map,
        export_scaler_map=export_scaler_map,
    )


def choose(prog: Optional[SweepProgram], cfg: PartitionConfig,
           backend: str) -> bool:
    """Path choice for one sweep: True runs the kernel, False the XLA
    level path.  The kernel only ever runs on the GPU backend, in f32, on
    a forest schedule; cfg.use_pallas False forces XLA, True takes the
    kernel for every such shape, None (auto) only where it was measured
    faster.  There is no size cap: the slot pool (O(log n) CLV rows) is
    far smaller than the XLA path's dense CLV slab."""
    if (backend != "gpu" or cfg.use_pallas is False or prog is None
            or not prog.exports or cfg.dtype != jnp.float32):
        return False
    return cfg.use_pallas is True or cfg.states in FAST_STATES


def _sweep_kernel(ops_ref, tip_ref, pmat_ref, pool_ref, spool_ref, *,
                  n_ops: int, per_rate: bool, thresh: float, factor: float,
                  tb: int, sites: int, interpret: bool):
    """One site block through every operation of the program.

    ops_ref [OPS, 9] int32 (SweepProgram.ops); tip_ref [tips, T] int32;
    pmat_ref [P, R, Sp, Sp] f32 (states padded to Sp with zeros).
    Outputs, used as the slot pool: pool_ref [slots, R, Sp, T] f32 and
    spool_ref [slots, SR, T] int32.  A block only touches its own
    columns, which stay in L2 while the block runs."""
    i32 = np.int32      # index dtypes must match under jax_enable_x64

    def whole(n):
        return pl.ds(i32(0), n)

    R, sp = pmat_ref.shape[1], pmat_ref.shape[-1]
    sr = spool_ref.shape[1]
    start = pl.program_id(0) * tb
    cols = pl.ds(start, tb)
    in_range = start + jnp.arange(tb, dtype=jnp.int32) < sites
    mask3 = in_range[None, None, :]
    shifts = jax.lax.broadcasted_iota(jnp.int32, (sp, tb), 0)

    def child(row, k):
        tip_idx, slot, is_tip = (ops_ref[row, i32(k + j)] for j in range(3))
        # padding columns load as all-ones (the gap state) and are never
        # stored; bits >= states meet zero P columns
        code = plgpu.load(tip_ref.at[tip_idx, cols], mask=in_range,
                          other=-1)
        bits = ((code[None, :] >> shifts) & 1).astype(jnp.float32)
        tile = plgpu.load(pool_ref.at[slot, whole(R), whole(sp), cols],
                          mask=mask3, other=0.0)
        scal = plgpu.load(spool_ref.at[slot, whole(sr), cols],
                          mask=in_range[None, :], other=0)
        tip = is_tip != 0
        return (jnp.where(tip, bits[None], tile),
                jnp.where(tip, jnp.zeros_like(scal), scal))

    def propagate(pm, clv):
        # P @ clv per rate as broadcast FMAs (CUDA cores, full f32)
        p = plgpu.load(pmat_ref.at[pm, whole(R), whole(sp), whole(sp)])
        return jnp.sum(p[:, :, :, None] * clv[:, None, :, :], axis=2)

    def body(w, carry):
        clv1, s1 = child(w, 1)
        clv2, s2 = child(w, 4)
        parent = (propagate(ops_ref[w, i32(7)], clv1)
                  * propagate(ops_ref[w, i32(8)], clv2))     # [R, Sp, tb]
        # all entries below threshold == max below threshold (CLVs >= 0;
        # padded states are 0)
        peak = jnp.max(parent, axis=1)                        # [R, tb]
        if not per_rate:
            peak = jnp.max(peak, axis=0, keepdims=True)       # [1, tb]
        mask = peak < thresh
        parent = jnp.where(mask[:, None, :], parent * factor, parent)
        p_slot = ops_ref[w, i32(0)]
        plgpu.store(pool_ref.at[p_slot, whole(R), whole(sp), cols], parent,
                    mask=mask3)
        plgpu.store(spool_ref.at[p_slot, whole(sr), cols],
                    mask.astype(jnp.int32) + s1 + s2,
                    mask=in_range[None, :])
        if not interpret:
            # a later operation may read these columns from other threads
            plgpu.debug_barrier()
        return carry

    jax.lax.fori_loop(i32(0), i32(n_ops), body, i32(0))


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _sweep_call(tipchars, pmatrix, *, prog: SweepProgram,
                cfg: PartitionConfig, tb: int, num_warps: int,
                interpret: bool):
    tips, T = tipchars.shape
    R, S = cfg.rate_cats, cfg.states
    rp, sp = _pow2(R), _pow2(S)            # power-of-two tile extents
    sr, srp = (R, rp) if cfg.per_rate_scalers else (1, 1)
    # zero P blocks: padded rates and states carry CLV 0, which neither
    # changes a site's maximum (CLVs >= 0) nor reaches the exported rows
    pmat = jnp.pad(pmatrix.astype(jnp.float32),
                   ((0, 0), (0, rp - R), (0, sp - S), (0, sp - S)))
    kernel = functools.partial(
        _sweep_kernel, n_ops=prog.n_ops, per_rate=cfg.per_rate_scalers,
        thresh=cfg.scale_threshold, factor=cfg.scale_factor, tb=tb,
        sites=T, interpret=interpret)
    nt = pl.cdiv(T, tb)
    pool, spool = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((prog.pool_size, rp, sp, T), jnp.float32),
            jax.ShapeDtypeStruct((prog.pool_size, srp, T), jnp.int32)),
        grid=(nt,),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        cost_estimate=pl.CostEstimate(
            flops=prog.n_ops * nt * tb * R * S * (4 * S + 1),
            bytes_accessed=tips * T * 4
            + prog.n_ops * 3 * (R * S + sr) * T * 4,
            transcendentals=0),
        name=KERNEL_NAME,
        interpret=interpret,
    )(jnp.asarray(prog.ops), tipchars.astype(jnp.int32), pmat)
    slots = np.asarray([slot for _op, slot in prog.exports], np.int32)
    return pool[slots, :R, :S], spool[slots, :sr]


def _refuse_sharded(sharding) -> None:
    """XLA cannot split the kernel's custom call: site-sharded inputs
    outside a 'sites' mesh would be gathered, and every device would run
    the whole sweep."""
    if len(sharding.device_set) > 1 and not sharding.is_fully_replicated:
        raise ValueError(
            f"fused sweep: site-sharded inputs ({sharding}) need the mesh "
            f"in context; trace the call inside jax.set_mesh(mesh)")


@functools.partial(jax.jit, static_argnames=("prog", "cfg", "interpret"))
def sweep(tipchars, pmatrix, prog: SweepProgram, cfg: PartitionConfig,
          interpret: bool = False):
    """Run the fused sweep.

    tipchars: [tips, T] int32 packed state bitmasks; pmatrix: [P, R, S, S].
    Returns (clv_rows [E, R, S, T] f32, scaler_rows [E, SR, T] int32) for
    the E exported rows (prog.export_clv_map order), SR = R under
    per-rate scalers, else 1.

    Under a mesh with a 'sites' axis (jax.set_mesh) the call runs per
    site shard inside shard_map: XLA does not partition a custom call.
    Site-sharded inputs without such a mesh raise when compiled."""
    call = functools.partial(_sweep_call, prog=prog, cfg=cfg,
                             tb=SITE_BLOCK, num_warps=NUM_WARPS,
                             interpret=interpret)
    mesh = jax.sharding.get_abstract_mesh()
    if SITES_AXIS not in mesh.axis_names or mesh.shape[SITES_AXIS] == 1:
        jax.debug.inspect_array_sharding(tipchars, callback=_refuse_sharded)
        return call(tipchars, pmatrix)
    return jax.shard_map(
        call, mesh=mesh,
        in_specs=(P(None, SITES_AXIS), P()),
        out_specs=(P(None, None, None, SITES_AXIS),
                   P(None, None, SITES_AXIS)),
        check_vma=False)(tipchars, pmatrix)
