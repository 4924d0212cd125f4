"""ZeRO-1 cross-replica sharded weight update for the dp mesh.

Reference: "Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training" (arXiv 2004.13336); the JAX package's
parallel/zero1.py, whose plan and program rewrite this module keeps.
Plain data parallelism all-reduces every gradient and then runs the same
weight update on every rank, holding W full copies of the optimizer
state. ZeRO-1 splits the update: each gradient is reduce-scattered over
the ranks, each rank updates only its 1/W shard of the parameter (with
shard-sized optimizer accumulators), and the updated shards are
all-gathered back into the replicated parameter.

This module is a PROGRAM-REWRITE pass. Each shardable optimizer op is
rewritten to run in a shard layout:

    grad  -> zero1_scatter(reduce) -> [1, shard]  (reduce-scatter; scale
                                                   folded)
    param -> zero1_scatter         -> [1, shard]  (this rank's slice of the
                                                   replicated param)
    opt_op(param_shard, grad_shard, accum_shard, ...) -> param_shard_out
    param_shard_out -> zero1_gather -> param      (all-gather, full shape)

The shard layout of a tensor of `numel` elements is its flat values,
zero-padded to W*shard, as W rows of `shard`: row r belongs to rank r. The
JAX package holds the whole [W, shard] array sharded on dim 0 over its
mesh; a rank of the port holds its row, [1, shard], and that is the W-times
optimizer-state memory cut. The accumulators named in
optimizer.ZERO1_SHARDABLE_SLOTS live permanently in that layout. Padding
lanes are zero and stay zero (the supported update rules are elementwise
and inert on zero input).

State crosses the boundary in the canonical FULL layout: the startup
program and convert.load_numpy_state leave full-layout accumulators,
which the first zero1 step converts to the rank's row
(Zero1Plan.ensure_scope_sharded), and convert.numpy_state gathers the
rows back (`full_layout`, a collective every rank calls), so state
written at dp=W restores onto any dp size.

fluid.io's save and load ops write what the JAX package's scope holds,
so the two packages' directories are byte-equal: a save gathers each
accumulator's rows into the whole [W, shard] array (`saved_layout`, a
collective every rank calls), and a load gives rank r row r of it
(`loaded_row`; ensure_scope_sharded too, for a load made before the
plan exists).
"""

import math

import numpy as np
import torch

from .. import flags
from ..core.framework import Operator, VarType, grad_var_name
from ..optimizer import ZERO1_SHARDABLE_SLOTS

__all__ = ["Zero1Plan", "build_plan", "apply", "apply_grad_scale",
           "to_shard_layout", "from_shard_layout", "registered_entry",
           "canonicalize_snapshot", "full_layout", "saved_layout",
           "loaded_row", "ensure_scope_unsharded", "reset_registry",
           "global_view"]

flags.define(
    "zero1", bool, False,
    "ZeRO-1 sharded weight update on the ParallelExecutor dp mesh "
    "(BuildStrategy.sharded_weight_update): reduce-scatter gradients, "
    "update a 1/N parameter shard per rank with shard-sized optimizer "
    "accumulators, all-gather the updated shards. Cuts optimizer-state "
    "memory ~Nx at dp=N and halves gradient collective bytes.")

DP_AXIS = "dp"


# ---------------------------------------------------------------------------
# layout conversion (the single definition of the shard layout)
# ---------------------------------------------------------------------------
def to_shard_layout(arr, parts):
    """Full-layout host array -> [parts, shard] zero-padded shard layout.
    Exact inverse of from_shard_layout for any input (pure pad/reshape)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1)
    pad = (-flat.shape[0]) % parts
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, dtype=arr.dtype)])
    return flat.reshape(parts, -1)


def from_shard_layout(arr, numel, shape):
    """[parts, shard] shard layout -> original full layout (drops pad)."""
    arr = np.asarray(arr)
    return arr.reshape(-1)[:numel].reshape(shape)


def _rank_row(t, parts, rank):
    """Row `rank` ([1, shard]) of a full-layout tensor's shard layout."""
    flat = t.reshape(-1)
    shard = -(-flat.shape[0] // parts)
    row = flat[rank * shard:(rank + 1) * shard]
    if row.shape[0] < shard:
        row = torch.cat([row, row.new_zeros(shard - row.shape[0])])
    return row.reshape(1, shard).clone()


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------
class _Entry:
    """One optimizer op's shard layout."""

    __slots__ = ("param", "grad", "op_type", "shape", "numel", "padded",
                 "shard", "dtype", "accums")

    def __init__(self, param, grad, op_type, shape, numel, parts, dtype,
                 accums):
        self.param = param
        self.grad = grad
        self.op_type = op_type
        self.shape = tuple(shape)
        self.numel = int(numel)
        self.padded = -(-self.numel // parts) * parts
        self.shard = self.padded // parts
        self.dtype = dtype
        # [(in_slot, out_slot, var_name, dtype)]
        self.accums = accums

    def describe(self, parts):
        itemsize = np.dtype(self.dtype).itemsize
        acc_itemsize = sum(np.dtype(d).itemsize for _, _, _, d in
                           self.accums) or 0
        return {
            "shape": list(self.shape),
            "numel": self.numel,
            "padded_numel": self.padded,
            "num_shards": parts,
            "shard_numel": self.shard,
            "param_shard_bytes": self.shard * itemsize,
            "accum_shard_bytes": self.shard * acc_itemsize,
            "accums": [name for _, _, name, _ in self.accums],
            # shard i of the flattened (padded) param is owned by dp rank i
            "owners": {str(i): [i * self.shard, (i + 1) * self.shard]
                       for i in range(parts)},
        }


class Zero1Plan:
    """Shard layout + byte accounting for a program's optimizer ops.

    Built for BOTH paths: the all-reduce path uses it only for the byte
    accounting and the GradientScaleStrategy rewrite; the zero1 path also
    drives the rewrite and the scope layout conversion. `mesh` is the
    parallel.mesh.Mesh whose rank r holds row r (None: rank 0)."""

    def __init__(self, parts, axis=DP_AXIS, mesh=None):
        self.parts = int(parts)
        self.axis = axis
        self.mesh = mesh
        self.entries = []          # [_Entry]
        self.skipped = []          # [(param, reason)] — not sharded
        self._by_accum = {}        # accum var name -> _Entry

    @property
    def rank(self):
        return self.mesh.rank if self.mesh is not None else 0

    # -- accounting ---------------------------------------------------------
    def optimizer_state_bytes(self, sharded):
        """Per-rank bytes of the plan's param-shaped accumulators."""
        total = 0
        for e in self.entries:
            for _, _, _, dtype in e.accums:
                item = np.dtype(dtype).itemsize
                total += (e.shard if sharded else e.numel) * item
        return total

    def collective_bytes(self, sharded):
        """Analytic per-rank per-step collective bytes on a ring of N
        ranks: all_reduce = 2(N-1)/N * B, reduce_scatter = all_gather =
        (N-1)/N * B. Returns {op: bytes} for the path in effect."""
        n = self.parts
        if n < 2:
            return {}
        grad_b = sum(e.padded * np.dtype(e.dtype).itemsize
                     for e in self.entries)
        if not sharded:
            return {"all_reduce": int(2 * (n - 1) / n * grad_b)}
        param_b = grad_b  # regathered params have the padded grad footprint
        return {
            "reduce_scatter": int((n - 1) / n * grad_b),
            "all_gather": int((n - 1) / n * param_b),
        }

    def describe(self):
        """Manifest rendering: param -> shard layout."""
        return {e.param: e.describe(self.parts) for e in self.entries}

    # -- scope layout -------------------------------------------------------
    def ensure_scope_sharded(self, scope):
        """Replace any full-layout accumulator in `scope` by this rank's
        row of its shard layout (startup programs and
        convert.load_numpy_state leave the canonical full layout). No-op
        for values already converted."""
        for e in self.entries:
            for _, _, name, _ in e.accums:
                v = scope.find_var(name)
                if v is None or tuple(v.shape) == (1, e.shard):
                    continue
                if tuple(v.shape) == (self.parts, e.shard):
                    # the whole shard layout, as a save writes it
                    scope.set_var(name, v[self.rank:self.rank + 1].clone())
                    continue
                if math.prod(v.shape) != e.numel:
                    continue  # stale var from another program; leave it
                scope.set_var(name, _rank_row(v, self.parts, self.rank))


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------
def build_plan(program, parts, axis=DP_AXIS, mesh=None):
    """Scan a program's optimizer ops into a Zero1Plan. Pure analysis — no
    rewrite. Unsupported updates land in plan.skipped with a reason and
    stay on the replicated path."""
    plan = Zero1Plan(parts, axis, mesh)
    gb = program.global_block()
    seen_params = set()
    for op in gb.ops:
        slots = ZERO1_SHARDABLE_SLOTS.get(op.type)
        if slots is None:
            continue
        pname = (op.inputs.get("Param") or [None])[0]
        gname = (op.inputs.get("Grad") or [None])[0]
        if not pname or not gname:
            continue
        pvar = gb.vars.get(pname)
        gvar = gb.vars.get(gname)

        def skip(reason):
            plan.skipped.append((pname, reason))

        if pvar is None or pvar.shape is None or any(
                d is None or d < 0 for d in pvar.shape or ()):
            skip("dynamic or unknown param shape")
            continue
        if pname in seen_params:
            skip("param updated by more than one optimizer op")
            continue
        if getattr(pvar, "sharding", None) is not None:
            skip("param carries a user set_sharding rule (mp-parallel)")
            continue
        if gvar is not None and (
                gvar.type == VarType.SELECTED_ROWS
                or getattr(gvar, "lod_level", 0)):
            skip("sparse/ragged gradient")
            continue
        accums = []
        ok = True
        for in_slot, out_slot in slots:
            names = op.inputs.get(in_slot) or []
            outs = op.outputs.get(out_slot) or []
            if not names or not outs or names[0] != outs[0]:
                ok = False
                break
            avar = gb.vars.get(names[0])
            if avar is None or tuple(avar.shape or ()) != tuple(pvar.shape):
                ok = False
                break
            accums.append((in_slot, out_slot, names[0], avar.dtype))
        if not ok:
            skip("accumulator wiring does not match the shardable contract")
            continue
        numel = int(np.prod(pvar.shape)) if pvar.shape else 1
        if numel <= 0:
            skip("empty param")
            continue
        seen_params.add(pname)
        e = _Entry(pname, gname, op.type, pvar.shape or (1,), numel, parts,
                   pvar.dtype, accums)
        plan.entries.append(e)
        for _, _, name, _ in accums:
            plan._by_accum[name] = e
    return plan


# ---------------------------------------------------------------------------
# the rewrite pass
# ---------------------------------------------------------------------------
def apply(program, parts, axis=DP_AXIS, grad_scale=1.0, mesh=None):
    """Clone `program` and rewrite every plannable optimizer op onto the
    shard layout. Returns (rewritten_program, plan). The original program
    is untouched (it keeps the full shapes that state crosses in).

    grad_scale is folded into the gradient reduce-scatter (the
    GradientScaleStrategy satellite): 1.0 for CoeffNumDevice/Customized
    (the loss is already the global batch's mean, so the summed
    gradients are its gradient), dp_size for One (sum semantics)."""
    clone = program.clone()
    plan = build_plan(clone, parts, axis, mesh)
    if not plan.entries:
        return clone, plan
    gb = clone.global_block()
    emap = {(e.op_type, e.param): e for e in plan.entries}
    new_ops = []
    for op in gb.ops:
        e = None
        if op.type in ZERO1_SHARDABLE_SLOTS:
            e = emap.get((op.type, (op.inputs.get("Param") or [None])[0]))
        if e is None:
            new_ops.append(op)
            continue
        gshard = e.grad + "@zero1_rs"
        pshard = e.param + "@zero1_shard"
        pupd = e.param + "@zero1_upd"
        for n, dt in ((gshard, (gb.vars.get(e.grad).dtype
                                if e.grad in gb.vars else e.dtype)),
                      (pshard, e.dtype), (pupd, e.dtype)):
            gb.create_var(name=n, shape=(1, e.shard), dtype=dt,
                          persistable=False)
        # the gradient the backward pass wrote holds each rank's part and
        # is reduce-scattered; one transformed after it (regularization,
        # clipping) was computed from the raw gradient, which
        # ParallelExecutor all-reduces first, so it is whole already
        new_ops.append(Operator(
            gb, "zero1_scatter", {"X": [e.grad]}, {"Out": [gshard]},
            {"parts": parts, "axis_name": axis,
             "reduce": e.grad == grad_var_name(e.param),
             "scale": float(grad_scale)}))
        # the param-side scatter sums nothing: each rank takes its slice
        new_ops.append(Operator(
            gb, "zero1_scatter", {"X": [e.param]}, {"Out": [pshard]},
            {"parts": parts, "axis_name": axis}))
        op.rename_input(e.param, pshard)
        op.rename_input(e.grad, gshard)
        op.rename_output(e.param, pupd)
        new_ops.append(op)
        new_ops.append(Operator(
            gb, "zero1_gather", {"X": [pupd]}, {"Out": [e.param]},
            {"numel": e.numel, "shape": list(e.shape),
             "axis_name": axis}))
        # accumulators live permanently in the shard layout: this rank's
        # row, its dim 0 pinned to the dp axis
        for _, _, name, _ in e.accums:
            avar = gb.vars[name]
            avar.shape = (1, e.shard)
            avar.sharding = (axis, None)
    gb.ops = new_ops
    clone._mutation += 1
    _register(plan)
    return clone, plan


def apply_grad_scale(program, plan, scale):
    """All-reduce-path GradientScaleStrategy: clone `program` and insert a
    full-size per-gradient `scale` op before each optimizer op — the cost
    zero1 folds into its reduce-scatter."""
    clone = program.clone()
    gb = clone.global_block()
    targets = {(e.op_type, e.param): e for e in plan.entries}
    new_ops = []
    for op in gb.ops:
        e = None
        if op.type in ZERO1_SHARDABLE_SLOTS:
            e = targets.get((op.type, (op.inputs.get("Param") or [None])[0]))
        if e is None:
            new_ops.append(op)
            continue
        scaled = e.grad + "@scaled"
        gb.create_var(name=scaled, shape=e.shape, dtype=e.dtype,
                      persistable=False)
        new_ops.append(Operator(
            gb, "scale", {"X": [e.grad]}, {"Out": [scaled]},
            {"scale": float(scale)}))
        op.rename_input(e.grad, scaled)
        new_ops.append(op)
    gb.ops = new_ops
    clone._mutation += 1
    return clone


# ---------------------------------------------------------------------------
# process-wide registry: state conversion needs to recognize shard-layout
# accumulator values without a handle on the ParallelExecutor
# ---------------------------------------------------------------------------
_REGISTRY = {}  # accum var name -> (Zero1Plan, _Entry)


def _register(plan):
    for e in plan.entries:
        for _, _, name, _ in e.accums:
            _REGISTRY[name] = (plan, e)


def registered_entry(name):
    """(plan, entry) for an accumulator var sharded by an applied zero1
    pass in this process, or None."""
    return _REGISTRY.get(name)


def reset_registry():
    _REGISTRY.clear()


def canonicalize_snapshot(snap):
    """Convert gathered shard-layout ([parts, shard]) accumulator arrays in
    a {name: np.ndarray} snapshot to the canonical full layout. Returns
    (snap, zero1_manifest_section), the section None when nothing in the
    snapshot was shard-laid-out. The conversion is an exact unpad."""
    zinfo = {}
    out = dict(snap)
    for name, arr in snap.items():
        reg = _REGISTRY.get(name)
        if reg is None:
            continue
        plan, e = reg
        if tuple(arr.shape) != (plan.parts, e.shard):
            continue
        out[name] = from_shard_layout(arr, e.numel, e.shape)
        zinfo.setdefault(e.param, e.describe(plan.parts))
    return out, (zinfo or None)


def full_layout(name, value):
    """`value` (a scope tensor of var `name`) in its full layout: a
    registered accumulator's [1, shard] row is all-gathered over its
    plan's mesh — a collective every rank of it must call — and unpadded;
    anything else comes back as it is."""
    reg = _REGISTRY.get(name)
    if reg is None:
        return value
    plan, e = reg
    if tuple(value.shape) != (1, e.shard) or tuple(value.shape) == e.shape:
        return value
    from ..ops.collective_ops import all_gather

    rows = all_gather(value, plan.mesh)
    return rows.reshape(-1)[:e.numel].reshape(e.shape)


def saved_layout(name, value):
    """`value` (a scope tensor of var `name`) as a save writes it: a
    registered accumulator's [1, shard] row becomes the whole [W, shard]
    array, all-gathered over its plan's mesh (a collective every rank of
    it must call), which is what the JAX package's scope holds and its
    save writes; anything else comes back as it is."""
    reg = _REGISTRY.get(name)
    if reg is None:
        return value
    plan, e = reg
    if tuple(value.shape) != (1, e.shard) or plan.parts == 1:
        return value
    from ..ops.collective_ops import all_gather

    return all_gather(value, plan.mesh).reshape(plan.parts, e.shard)


def loaded_row(name, value):
    """What a load puts in the scope for var `name`: this rank's row of a
    registered accumulator's [W, shard] array (a file `saved_layout`
    wrote), `value` itself otherwise."""
    reg = _REGISTRY.get(name)
    if reg is None:
        return value
    plan, e = reg
    if plan.parts == 1 or tuple(value.shape) != (plan.parts, e.shard):
        return value
    return value[plan.rank:plan.rank + 1].clone()


def ensure_scope_unsharded(scope, program):
    """Undo the shard layout for accumulators in `scope` that `program`'s
    ops read or write — the FLAGS_zero1=0 (or BuildStrategy flip) path
    after a sharded run in the same process. A program that holds an
    accumulator's var but no op on it (a pipeline's forward or backward
    cell) leaves it as it is. Every rank calls it (a gather). Cheap no-op
    when zero1 never ran."""
    if not _REGISTRY:
        return
    touched = {n for b in program.blocks for op in b.ops
               for n in op.input_arg_names() + op.output_arg_names()}
    for name in list(_REGISTRY):
        if name not in touched:
            continue
        v = scope.find_var(name)
        if v is not None:
            scope.set_var(name, full_layout(name, v))


def global_view(program, zplan):
    """A clone of the zero1-rewritten `program` whose shard-layout vars
    hold the JAX package's [W, shard] shapes (this rank holds [1, shard]
    of each): the view the ShardingPlan, FLAGS_verify and the overlap
    schedule's cost model read."""
    view = program.clone()
    gb = view.global_block()
    for e in zplan.entries:
        names = [name for _, _, name, _ in e.accums] + [
            e.grad + "@zero1_rs", e.param + "@zero1_shard",
            e.param + "@zero1_upd"]
        for name in names:
            var = gb.vars.get(name)
            if var is not None:
                var.shape = (zplan.parts, e.shard)
    return view
