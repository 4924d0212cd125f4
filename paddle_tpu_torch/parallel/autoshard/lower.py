"""The port's partitioner: a total ShardingPlan lowered to one rank's
program.

The JAX package never computes a sharded op itself: it places sharded
state as NamedSharding, constrains op outputs, and XLA's SPMD partitioner
adds every collective. The port runs one process per rank and has no
partitioner, so `lower` writes the program this rank runs over the plan's
`mp` axis (the dp axis keeps its own machinery: ParallelExecutor's feed
split, the ops' global-batch reductions over OpContext.dp and the
gradient all-reduce or zero1):

  * every var the plan shards over mp gets its local shape in the var
    desc (dim d of the plan's spec divided by the axis size), so the
    fusion pass, the peak-HBM estimate, the step and the state placement
    see what the rank holds;
  * an op whose operands the plan lays out compatibly runs its own kernel
    on the local tensors ("local"): the elementwise and activation family
    when its operands agree; mul/matmul with the output's columns sharded
    (column parallel), or with the contracting dim sharded on both
    operands (row parallel: a local product, then an `all_reduce` (sum)
    over mp, which is what GSPMD inserts where rules.py keeps the output
    replicated); conv2d on a Cout-sharded filter; batch_norm on
    channel-sharded input (the statistics stay the channel's own, summed
    over the dp sub-group only); lookup_table on a row-sharded table
    (`shard_lookup_table`: a masked local gather, then an `all_reduce`);
    the optimizer ops, elementwise on the local shards; and the grad ops
    of these. A grad op whose forward op ran locally and took an input
    replicated over mp gives this rank's part of that input's gradient:
    an `all_reduce` (sum) over mp follows it (Megatron's f/g pair);
  * every other op touching an mp-sharded var takes the generic lowering,
    which is always correct: each sharded input is all-gathered over mp
    (`shard_gather`), the op runs on whole values, and each sharded output
    keeps this rank's slice (`shard_slice`). reshape and every op with a
    shape attribute, softmax and the losses over a sharded class dim, and
    dropout take it; dropout then draws the whole mask from the random
    stream every rank shares and keeps its slice, so all ranks must run
    the same ops in the same order, which they do: every rank lowers one
    plan the same way. The plan's reshard edges land here too, as the
    gathers of the vars they name.

Every collective the lowering adds is an op of the program (`all_reduce`
with axis_name "mp", `shard_gather`, `shard_lookup_table`); under NCCL it
is captured with the step, under gloo it runs on the interpreter, as the
other collective ops do. `Lowering.collectives` lists them with the bytes
each moves a step (plan.transition_bytes' ring model; 2(n-1)/n of the
value for an all-reduce). Sub-blocks (while, conditional_block) that
touch an mp-sharded var are refused.

The registry below keeps, per persistable var, its local layout, so that
the scope's state crosses the boundary in the canonical full layout, as
zero1's does: `ensure_scope_local` slices what a startup program or a
restore left whole, and `full_value` gathers a local value over mp (a
collective every rank of the axis calls) for checkpoints, saves and
convert.numpy_state.
"""

import itertools

import torch

from ...core.framework import OP_ROLE_ATTR_NAME, Operator
from ...optimizer import ZERO1_SHARDABLE_SLOTS
from .plan import _DTYPE_BYTES, _numel, transition_bytes
from .spec import canon

__all__ = ["Lowering", "lower", "mp_dims", "register_lowering",
           "ensure_scope_local", "full_value", "local_entry",
           "reset_registry", "MP_AXIS"]

MP_AXIS = "mp"
DP_AXIS = "dp"

# elementwise ops whose every operand has X's shape (and their grads)
_SAME_SHAPE = frozenset({
    "relu", "sigmoid", "tanh", "abs", "exp", "sqrt", "square", "log",
    "softsign", "softplus", "ceil", "floor", "round", "reciprocal",
    "leaky_relu", "elu", "relu6", "hard_sigmoid", "swish", "scale",
    "cast", "clip", "assign", "brelu", "soft_relu", "stanh", "pow",
    "thresholded_relu", "hard_shrink", "softshrink", "tanh_shrink",
    "logsigmoid", "sum", "dropout_grad"})
_BINARY = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow"})
_OPTIMIZERS = frozenset(ZERO1_SHARDABLE_SLOTS) | {"ftrl", "lars_momentum"}
# the dp collectives act elementwise on whatever layout the rank holds
_DP_COLLECTIVES = frozenset({"all_reduce", "broadcast"})


def mp_dims(plan, axis=MP_AXIS):
    """{var name: the dim the plan shards over `axis`} of every var the
    plan shards over it."""
    dims = {}
    for name, spec in plan.specs.items():
        for d, ax in enumerate(canon(spec) or ()):
            if ax == axis:
                dims[name] = d
    return dims


class Lowering:
    """What `lower` wrote: `program`, this rank's program; `local`
    {var: (dim, global shape, local shape)} of every var sharded over the
    axis; `collectives` [{"op", "kind", "var", "bytes"}] of the
    collectives it added, in program order; `modes` {op type: {"local":
    n, "generic": n}}; and the plan's digest."""

    def __init__(self, program, plan, axis, size):
        self.program = program
        self.axis = axis
        self.size = size
        self.local = {}
        self.collectives = []
        self.modes = {}
        self.digest = plan.digest()

    def collective_counts(self):
        """{kind: [count, bytes a step]} of the added collectives."""
        out = {}
        for c in self.collectives:
            row = out.setdefault(c["kind"], [0, 0])
            row[0] += 1
            row[1] += int(c["bytes"])
        return out

    def describe(self):
        return {
            "axis": self.axis, "size": self.size, "digest": self.digest,
            "local_vars": len(self.local),
            "collectives": {k: {"count": n, "bytes": b} for k, (n, b)
                            in sorted(self.collective_counts().items())},
            "modes": {t: dict(m) for t, m in sorted(self.modes.items())},
        }


def _sub_blocks(op):
    return [v for v in op.attrs.values()
            if hasattr(v, "ops") and hasattr(v, "vars")]


def _block_names(block):
    names = set()
    for op in block.ops:
        names.update(op.input_arg_names())
        names.update(op.output_arg_names())
        for sub in _sub_blocks(op):
            names |= _block_names(sub)
    return names


class _Writer:
    """The walk over one block's ops."""

    def __init__(self, block, plan, axis, size, dims, lowering):
        self.gb = block
        self.plan = plan
        self.axis = axis
        self.size = size
        self.dims = dims
        self.low = lowering
        self.fresh = itertools.count()

    # -- the plan's view --------------------------------------------------
    def md(self, name):
        """The mp dim of `name`, or None (replicated over mp; "" too)."""
        return self.dims.get(name) if name else None

    def shape(self, name):
        return self.plan.shapes.get(name)

    def rank(self, name):
        s = self.shape(name)
        return None if s is None else len(s)

    def _bytes_gather(self, name):
        spec = canon(self.plan.spec_of(name)) or ()
        whole = tuple(None if a == self.axis else a for a in spec)
        return transition_bytes(self.shape(name),
                                self.plan.dtypes.get(name, "float32"),
                                spec, whole, self.plan.mesh_axes)

    def _bytes_reduce(self, name):
        n = self.size
        nbytes = _numel(self.shape(name), self.plan.mesh_axes) \
            * _DTYPE_BYTES.get(self.plan.dtypes.get(name, "float32"), 4)
        spec = canon(self.plan.spec_of(name)) or ()
        for ax in spec:  # the rank's value is its share of the other axes
            if ax is not None and ax != self.axis:
                nbytes //= int(self.plan.mesh_axes.get(ax, 1))
        return int(2 * (n - 1) / n * nbytes)

    def _note(self, op_type, mode):
        row = self.low.modes.setdefault(op_type, {"local": 0, "generic": 0})
        row[mode] += 1

    def _collective(self, op_type, kind, var, nbytes):
        self.low.collectives.append({"op": op_type, "kind": kind,
                                     "var": var, "bytes": int(nbytes)})

    def _all_reduce(self, op, names):
        """all_reduce (sum) over the axis of each of `names`, in place."""
        ops = []
        role = op.attrs.get(OP_ROLE_ATTR_NAME)
        for n in names:
            if not n:
                continue
            ops.append(Operator(self.gb, "all_reduce", {"X": [n]},
                                {"Out": [n]},
                                {"reduction": "sum", "axis_name": self.axis,
                                 OP_ROLE_ATTR_NAME: role}))
            self._collective(op.type, "all_reduce", n, self._bytes_reduce(n))
        return ops

    # -- the walk -----------------------------------------------------------
    def rewrite(self, ops):
        out = []
        for op in ops:
            names = set(op.input_arg_names()) | set(op.output_arg_names())
            subs = _sub_blocks(op)
            for sub in subs:
                names |= _block_names(sub)
            if not any(self.md(n) is not None for n in names):
                out.append(op)
                continue
            if subs:
                touched = sorted(n for n in names if self.md(n) is not None)
                raise NotImplementedError(
                    f"autoshard lowering: op {op.type!r} holds a sub-block "
                    f"and touches vars sharded over {self.axis!r} "
                    f"({touched[:4]}); control flow over mp-sharded vars "
                    f"is not lowered")
            local = self.local_form(op)
            if local is not None:
                self._note(op.type, "local")
                out.extend(local)
            else:
                self._note(op.type, "generic")
                out.extend(self.generic(op))
        return out

    def generic(self, op):
        """Gather every sharded input over the axis, run `op` on whole
        values, keep this rank's slice of each sharded output."""
        role = op.attrs.get(OP_ROLE_ATTR_NAME)
        pre, post = [], []

        def whole_var(n):
            v = self.gb.vars.get(n)
            full = f"{n}@{self.axis}_whole.{next(self.fresh)}"
            self.gb.create_var(
                name=full, shape=self.shape(n),
                dtype=v.dtype if v is not None else "float32",
                lod_level=getattr(v, "lod_level", 0), persistable=False)
            return full

        for n in dict.fromkeys(op.input_arg_names()):
            d = self.md(n)
            if d is None:
                continue
            full = whole_var(n)
            pre.append(Operator(self.gb, "shard_gather", {"X": [n]},
                                {"Out": [full]},
                                {"axis_name": self.axis, "dim": d,
                                 "parts": self.size,
                                 OP_ROLE_ATTR_NAME: role}))
            self._collective(op.type, "all_gather", n, self._bytes_gather(n))
            op.rename_input(n, full)
        for n in dict.fromkeys(op.output_arg_names()):
            d = self.md(n)
            if d is None:
                continue
            full = whole_var(n)
            op.rename_output(n, full)
            post.append(Operator(self.gb, "shard_slice", {"X": [full]},
                                 {"Out": [n]},
                                 {"axis_name": self.axis, "dim": d,
                                  "parts": self.size,
                                  OP_ROLE_ATTR_NAME: role}))
        return pre + [op] + post

    # -- the local forms --------------------------------------------------
    def local_form(self, op):
        """[ops] running `op` on the local tensors (with the collectives
        it needs after it), or None where the plan's layouts need the
        generic lowering."""
        t = op.type
        base = t[:-len("_grad")] if t.endswith("_grad") else t
        grad = t.endswith("_grad")
        if t in _SAME_SHAPE or (grad and base in _SAME_SHAPE):
            return self._same_shape(op)
        if base in ("softmax",):
            return self._softmax(op)
        if base in _BINARY:
            return self._binary(op, grad)
        if base == "mul":
            return self._mul(op, grad)
        if base == "matmul":
            return self._matmul(op, grad)
        if base == "conv2d":
            return self._conv2d(op, grad)
        if base == "batch_norm":
            return self._batch_norm(op)
        if base == "lookup_table":
            return self._lookup_table(op, grad)
        if t in _OPTIMIZERS:
            return self._optimizer(op)
        if t in _DP_COLLECTIVES and op.attrs.get("axis_name", DP_AXIS) \
                != self.axis:
            return self._same_shape(op)
        return None

    def _agree(self, names):
        """Every one of `names` (empties skipped) has one mp dim and one
        rank."""
        names = [n for n in names if n]
        dims = {self.md(n) for n in names}
        ranks = {self.rank(n) for n in names}
        return len(dims) == 1 and len(ranks) == 1

    def _same_shape(self, op):
        names = op.input_arg_names() + op.output_arg_names()
        return [op] if self._agree(names) else None

    def _softmax(self, op):
        names = op.input_arg_names() + op.output_arg_names()
        if not self._agree(names):
            return None
        n = next(n for n in names if n)
        if self.md(n) == self.rank(n) - 1:
            return None  # the class dim: the generic lowering
        return [op]

    def _binary(self, op, grad):
        x = (op.input("X") or [""])[0]
        y = (op.input("Y") or [""])[0]
        outs = op.input("Out@GRAD") if grad else op.output("Out")
        dx = (op.output("X@GRAD") or [""])[0] if grad else ""
        dy = (op.output("Y@GRAD") or [""])[0] if grad else ""
        if not x or not y or not self._agree([x, dx] + list(outs)):
            return None
        if dy and self.md(dy) != self.md(y):
            return None
        d, e = self.md(x), self.md(y)
        xr, yr = self.rank(x), self.rank(y)
        if xr is None or yr is None:
            return None
        axis = op.attrs.get("axis", -1)
        if axis is None or axis < 0:
            axis = xr - yr
        ysh = self.shape(y) or ()
        if d is None:
            return None  # only Y sharded: the generic lowering
        if e is not None:
            if axis + e != d or (e < len(ysh) and ysh[e] == 1):
                return None
            return [op]
        j = d - axis
        if 0 <= j < yr and (j >= len(ysh) or ysh[j] != 1):
            return None  # Y whole along X's sharded dim: disagree
        # Y broadcasts over the sharded dim: its grad is this rank's part
        return [op] + (self._all_reduce(op, [dy]) if grad else [])

    def _mul(self, op, grad):
        x = (op.input("X") or [""])[0]
        y = (op.input("Y") or [""])[0]
        o = ((op.input("Out@GRAD") if grad else op.output("Out"))
             or [""])[0]
        dx = (op.output("X@GRAD") or [""])[0] if grad else ""
        dy = (op.output("Y@GRAD") or [""])[0] if grad else ""
        if not (x and y and o):
            return None
        if (dx and self.md(dx) != self.md(x)) or \
                (dy and self.md(dy) != self.md(y)):
            return None
        xnc = op.attrs.get("x_num_col_dims", 1) or 1
        ync = op.attrs.get("y_num_col_dims", 1) or 1
        mx, my, mo = self.md(x), self.md(y), self.md(o)
        if mx is None and my is not None and my >= ync \
                and mo == xnc + (my - ync):
            # column parallel: X's gradient is this rank's part
            return [op] + (self._all_reduce(op, [dx]) if grad else [])
        if mx == xnc and my == 0 and mo is None:
            # row parallel: the product is this rank's part of the sum
            return [op] + ([] if grad else self._all_reduce(op, [o]))
        if mx is not None and mx < xnc and my is None and mo == mx:
            # X's rows sharded: Y's gradient is this rank's part
            return [op] + (self._all_reduce(op, [dy]) if grad else [])
        return None

    def _matmul(self, op, grad):
        x = (op.input("X") or [""])[0]
        y = (op.input("Y") or [""])[0]
        o = ((op.input("Out@GRAD") if grad else op.output("Out"))
             or [""])[0]
        dx = (op.output("X@GRAD") or [""])[0] if grad else ""
        dy = (op.output("Y@GRAD") or [""])[0] if grad else ""
        xr, yr, orr = self.rank(x), self.rank(y), self.rank(o)
        if not (x and y and o) or (xr, yr, orr) != (2, 2, 2):
            return None
        if (dx and self.md(dx) != self.md(x)) or \
                (dy and self.md(dy) != self.md(y)):
            return None
        tx = bool(op.attrs.get("transpose_X", False))
        ty = bool(op.attrs.get("transpose_Y", False))
        xm, xk = (1, 0) if tx else (0, 1)
        yk, yn = (1, 0) if ty else (0, 1)
        mx, my, mo = self.md(x), self.md(y), self.md(o)
        if mx is None and my == yn and mo == 1:
            return [op] + (self._all_reduce(op, [dx]) if grad else [])
        if mx == xk and my == yk and mo is None:
            return [op] + ([] if grad else self._all_reduce(op, [o]))
        if mx == xm and my is None and mo == 0:
            return [op] + (self._all_reduce(op, [dy]) if grad else [])
        return None

    def _conv2d(self, op, grad):
        x = (op.input("Input") or [""])[0]
        w = (op.input("Filter") or [""])[0]
        o = ((op.input("Output@GRAD") if grad else op.output("Output"))
             or [""])[0]
        dx = (op.output("Input@GRAD") or [""])[0] if grad else ""
        dw = (op.output("Filter@GRAD") or [""])[0] if grad else ""
        if not (x and w and o) or int(op.attrs.get("groups", 1) or 1) != 1:
            return None
        c_ax = 3 if op.attrs.get("data_format", "NCHW") == "NHWC" else 1
        if self.md(x) is None and self.md(w) == 0 and self.md(o) == c_ax \
                and (not dx or self.md(dx) is None) \
                and (not dw or self.md(dw) == 0):
            return [op] + (self._all_reduce(op, [dx]) if grad else [])
        return None

    def _batch_norm(self, op):
        x = (op.input("X") or [""])[0]
        if not x:
            return None
        nhwc = op.attrs.get("data_layout", "NCHW") == "NHWC"
        xr = self.rank(x)
        if xr is None:
            return None
        c = xr - 1 if nhwc else 1
        # the batch statistics a layer's desc leaves shapeless (the plan
        # cannot shard them) are per channel: they stay the rank's
        stats = [n for slot in ("SavedMean", "SavedVariance")
                 for n in op.output(slot) if n and self.rank(n) is None]
        for n in op.input_arg_names() + op.output_arg_names():
            if not n or n in stats:
                continue
            want = c if self.rank(n) == xr else 0
            if self.md(n) != want:
                return None
        for n in stats:
            self.dims[n] = 0
        return [op]

    def _lookup_table(self, op, grad):
        w = (op.input("W") or [""])[0]
        ids = (op.input("Ids") or [""])[0]
        o = ((op.input("Out@GRAD") if grad else op.output("Out"))
             or [""])[0]
        dw = (op.output("W@GRAD") or [""])[0] if grad else ""
        if not (w and ids and o) or self.md(w) != 0 \
                or self.md(ids) is not None or self.md(o) is not None \
                or (dw and self.md(dw) != 0):
            return None
        if op.attrs.get("is_sparse", False) or \
                op.attrs.get("is_distributed", False):
            return None
        role = op.attrs.get(OP_ROLE_ATTR_NAME)
        attrs = dict(op.attrs, axis_name=self.axis)
        attrs[OP_ROLE_ATTR_NAME] = role
        new = Operator(self.gb, "shard_lookup_table_grad" if grad
                       else "shard_lookup_table",
                       {k: list(v) for k, v in op.inputs.items()},
                       {k: list(v) for k, v in op.outputs.items()}, attrs)
        new.fwd_op = op.fwd_op
        if not grad:
            self._collective(op.type, "all_reduce", o, self._bytes_reduce(o))
        return [new]

    def _optimizer(self, op):
        p = (op.input("Param") or [""])[0]
        if not p:
            return None
        want, shape = self.md(p), self.shape(p)
        for n in op.input_arg_names() + op.output_arg_names():
            if not n:
                continue
            if self.shape(n) == shape:
                if self.md(n) != want:
                    return None
            elif self.md(n) is not None:
                return None
        return [op]


def lower(program, plan, axis=MP_AXIS):
    """Lowering of `program` (the resolved program the plan was built on)
    for one rank of the plan's `axis`. With an axis of one rank, or a
    plan that shards nothing over it, the program comes back as it is.
    Raises NotImplementedError for a plan sharding a var over a mesh axis
    other than dp and `axis`, and ValueError for a static dim the axis
    does not divide."""
    size = int(plan.mesh_axes.get(axis, 1))
    for name, spec in plan.specs.items():
        for ax in canon(spec) or ():
            if ax not in (None, DP_AXIS, axis) \
                    and int(plan.mesh_axes.get(ax, 1)) > 1:
                raise NotImplementedError(
                    f"autoshard lowering: {name!r} is sharded over mesh "
                    f"axis {ax!r}; the port lowers the {axis!r} axis (the "
                    f"dp axis runs on ParallelExecutor's own path)")
    dims = mp_dims(plan, axis) if size > 1 else {}
    if not dims:
        low = Lowering(program, plan, axis, size)
        return low
    clone = program.clone()
    low = Lowering(clone, plan, axis, size)
    blocks = clone.blocks
    for block in blocks:
        for name, var in block.vars.items():
            d = dims.get(name)
            if d is None or var.shape is None or d >= len(var.shape):
                continue
            shape = list(var.shape)
            if shape[d] is not None and shape[d] >= 0:
                if shape[d] % size:
                    raise ValueError(
                        f"autoshard lowering: dim {d} of {name!r} (shape "
                        f"{tuple(var.shape)}) is not divisible by mesh "
                        f"axis {axis!r} (size {size})")
                shape[d] //= size
            low.local[name] = (d, tuple(var.shape), tuple(shape))
            var.shape = tuple(shape)
            # the desc now holds the rank's layout: what is left of the
            # annotation is the dp axis's (zero1's accumulators)
            if getattr(var, "sharding", None) is not None:
                rest = tuple(None if a == axis else a for a in var.sharding)
                var.sharding = rest if any(a is not None for a in rest) \
                    else None
    gb = clone.global_block()
    writer = _Writer(gb, plan, axis, size, dims, low)
    gb.ops = writer.rewrite(gb.ops)
    clone._mutation += 1
    return low


# ---------------------------------------------------------------------------
# the scope's layout: per persistable var, this rank's slice of the axis
# ---------------------------------------------------------------------------
_REGISTRY = {}  # var name -> (MeshAxis, dim, global shape, local shape)


def register_lowering(low, mesh_axis):
    """Record the local layout of `low`'s persistable vars on `mesh_axis`
    (this rank's parallel.mesh.MeshAxis of the lowered axis)."""
    gb = low.program.global_block()
    for name, (d, whole, local) in low.local.items():
        var = gb.vars.get(name)
        if var is not None and var.persistable:
            _REGISTRY[name] = (mesh_axis, d, whole, local)


def local_entry(name):
    """(MeshAxis, dim, global shape, local shape) of a registered var, or
    None."""
    return _REGISTRY.get(name)


def reset_registry():
    _REGISTRY.clear()


def _is_whole(value, whole, local):
    shape = tuple(value.shape)
    return len(shape) == len(whole) and shape != local and all(
        w < 0 or s == w for s, w in zip(shape, whole))


def ensure_scope_local(scope, low):
    """Replace every value of `low`'s persistable vars that `scope` holds
    whole (a startup program's, a restore's, convert.load_numpy_state's)
    by this rank's slice; a value already local stays."""
    gb = low.program.global_block()
    for name, (d, whole, local) in low.local.items():
        var = gb.vars.get(name)
        if var is None or not var.persistable:
            continue
        entry = _REGISTRY.get(name)
        v = scope.find_var(name)
        if entry is None or not isinstance(v, torch.Tensor) \
                or not _is_whole(v, whole, local):
            continue
        axis = entry[0]
        k = v.shape[d] // axis.size
        scope.set_var(name, v.narrow(d, axis.rank * k, k).clone(
            memory_format=torch.contiguous_format))


def full_value(name, value):
    """`value` (a scope tensor of var `name`) in its full layout: a
    registered var's local slice is all-gathered over its axis (a
    collective every rank of the axis must call); anything else comes
    back as it is."""
    entry = _REGISTRY.get(name)
    if entry is None or not isinstance(value, torch.Tensor):
        return value
    axis, d, whole, local = entry
    if tuple(value.shape) != local or tuple(value.shape) == whole:
        return value
    from ...ops.collective_ops import gather_dim

    return gather_dim(value, axis, d)

