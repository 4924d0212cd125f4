"""Control flow: comparison and logical ops, `while`, `conditional_block`,
IfElse's row split and merge, the tensor arrays, the rank-table family,
the recurrent ops, and feed, fetch, print, assert_op and get_places
(reference operators/{while,conditional_block,compare,logical,
split_lod_tensor,merge_lod_tensor,tensor_array_read_write,
lod_tensor_to_array,array_to_lod_tensor,shrink_rnn_memory,
max_sequence_len,recurrent,print}_op.cc and framework/lod_rank_table.cc;
the JAX package's paddle_tpu/ops/control_flow_ops.py).

How each runs in the port:
  * `while` reads its condition on the host after every trip, as the
    reference's while_op.cc does, so it is a host-sync op
    (executor_core.HOST_SYNC_OPS): a program holding one runs on the
    interpreter, prepared and cached. `while_grad` replays the loop from
    the entry-time snapshots under autograd.
  * `conditional_block` runs its sub-block at every step and keeps, per
    written name, `where(pred, new, old)`, as `lax.cond` gives it in the
    JAX package: a step that holds one stays capturable (piecewise_decay's
    Switch on the headline), and the graph and the interpreter compute
    the same thing. A name the block makes gets zeros where the predicate
    is false, as the JAX package's false branch does. This relies on the
    sub-block's kernels being pure: every registered kernel is, except
    the fused updates, which the fusion pass makes in the global block
    only. A sub-block holding a host or host-sync op keeps the program on
    the interpreter (executor_core.capture_blocker) and there the
    predicate is read on the host and the block runs only when it holds,
    as in the reference; a name it would have made stays unwritten.
    Its grad takes the vjp through the block and then selects the grads,
    as lax.cond's vjp gives them, so the NaN or Inf of an untaken
    branch's derivative (a guarded division) reaches no grad.
  * `split_lod_tensor` and `merge_lod_tensor` give IfElse the reference
    Fluid's per-row branches: each branch's block takes only its rows.
    The JAX package has neither (ROADMAP §3 reference fault 10). They
    find the rows on the host (host-sync ops).
  * the tensor-array and rank-table ops read an index or the lengths on
    the host (host-sync ops, the JAX package's no_trace ops).
  * `recurrent` (StaticRNN) and `dynamic_recurrent` (DynamicRNN) run a
    static trip count (the input's leading dim; the SeqTensor's flat
    token count) as one Python loop, which a CUDA graph captures whole.
    Their grads are derived (make_vjp_kernel): every operand comes in
    through `ins` (the Closure and static_inputs slots carry the
    sub-block's reads), so autograd sees the whole data dependence.

The comparisons broadcast X and Y as numpy does and give a bool tensor,
which no gradient passes through (set_stop_gradient_outputs), so the
backward walk never routes a cotangent into a condition.
"""

import numpy as np
import torch

from .. import flags
from ..core import executor_core
from ..core.places import CPUPlace, CUDAPlace
from ..core.registry import (SeqTensor, register_grad_maker,
                             register_op, set_lazy_inputs,
                             set_stop_gradient_outputs)
from .util import first, many, out


def _cmp(fn):
    def kernel(ctx, ins, attrs):
        return out(Out=fn(first(ins, "X"), first(ins, "Y")))

    return kernel


for _name, _fn in [
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("logical_and", torch.logical_and),
    ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    register_op(_name)(_cmp(_fn))


@register_op("logical_not")
def logical_not_op(ctx, ins, attrs):
    return out(Out=torch.logical_not(first(ins, "X")))


for _name in ("less_than", "less_equal", "greater_than", "greater_equal",
              "equal", "not_equal", "logical_and", "logical_or",
              "logical_xor", "logical_not"):
    set_stop_gradient_outputs(_name, ["Out"])


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _while_written(block):
    """Sub-block output names in first-write order (legacy descs with an
    empty Out list derive the carried set from the block itself)."""
    written, seen = [], set()
    for sub_op in block.ops:
        for n in sub_op.output_arg_names():
            if n and n not in seen:
                seen.add(n)
                written.append(n)
    return written


def _is_float(v):
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _refuse_ragged(opname, named_values):
    for n, v in named_values:
        if isinstance(v, SeqTensor):
            raise NotImplementedError(
                f"{opname}: ragged (LoD) state {n!r} is not supported; "
                f"pad to dense first")


def _vjp(finals, gouts, leaves):
    """torch.autograd.grad of `finals` ({name: tensor}) with the
    cotangents `gouts` ({name: grad or None}; None is zero) into the
    leaves ({name: leaf}): {name: grad}, zeros where no path reaches."""
    ys, cots = [], []
    for n, y in finals.items():
        g = gouts.get(n)
        if g is None or not y.requires_grad:
            continue
        ys.append(y)
        cots.append(_cotangent_like(g, y))
    names = list(leaves)
    grads = torch.autograd.grad(
        ys, [leaves[n] for n in names], cots, allow_unused=True) \
        if ys else [None] * len(names)
    return {n: torch.zeros_like(leaves[n]) if g is None else g.detach()
            for n, g in zip(names, grads)}


def _cotangent_like(g, y):
    """The cotangent `g` in y's dtype and shape."""
    g = g.data if isinstance(g, SeqTensor) else g
    return g.to(y.dtype).reshape(y.shape)


def _assemble_grads(names, primary, secondary, skip=()):
    """Positional grad list for an output slot: primary dict wins, then
    secondary; names in `skip` (synthesized zero-inits) yield None."""
    grads = []
    for n in names:
        if n in primary and n not in skip:
            grads.append(primary[n])
        elif n in secondary:
            grads.append(secondary[n])
        else:
            grads.append(None)
    return grads


def _leaves(values):
    return {n: v.detach().requires_grad_(True) for n, v in values.items()}


def _host_true(v):
    """A condition tensor read on the host (one wait for the device)."""
    return bool(v.reshape(()))


# ---------------------------------------------------------------------------
# while (reference while_op.cc:35)
# ---------------------------------------------------------------------------
set_stop_gradient_outputs(
    "while", ["InitStates", "InputSnapshots", "StepScopes"])
set_stop_gradient_outputs(
    "conditional_block",
    ["InitStates", "InputSnapshots", "CondSnapshots", "Scope"])


@register_op("while", lod_aware=True)
def while_op(ctx, ins, attrs):
    """Run the sub-block while the condition holds, reading it on the host
    before every trip. The carried state is the Out names that exist
    before the loop (and the condition); the sub-block reads every other
    name from the env. InitStates and InputSnapshots are the entry-time
    values of the carried state and of every read, which while_grad
    replays from (the reference keeps step scopes instead)."""
    op = ctx.current_op
    env = ctx.env
    block = attrs["sub_block"]
    cond_name = op.input("Condition")[0]

    out_names = list(op.output("Out") or [])
    carried_src = out_names if out_names else _while_written(block)
    carried = [n for n in carried_src if n in env]
    if cond_name not in carried:
        carried = [cond_name] + carried
    inits = {n: env[n] for n in carried}
    carry = dict(inits)
    while _host_true(carry[cond_name]):
        local = dict(env)
        local.update(carry)
        ctx.run_block(block, local)
        carry = {n: local[n] for n in carried}
    env.update(carry)
    ret = {}
    if op.output("InitStates"):
        ret["InitStates"] = [inits.get(n) for n in out_names]
    if op.output("InputSnapshots"):
        ret["InputSnapshots"] = [inits.get(n, env.get(n))
                                 for n in op.input("X")]
    return ret


@register_grad_maker("while")
def while_grad_maker(op, gout, gin):
    """The gradient of a loop needs a trip bound (the JAX package's
    wording and rule): while_grad replays at most max_trip_count trips.
    Refuse loudly otherwise, never a silent [None] gradient (reference
    trains While via WhileGradOp, while_op.cc:95,220)."""
    if "max_trip_count" not in op.attrs:
        raise RuntimeError(
            "gradient through op 'while' requires a trip bound: build the "
            "loop with layers.While(cond, max_trip_count=N). "
            "lax.while_loop is not reverse-differentiable; while_grad "
            "lowers to a bounded masked lax.scan of N iterations "
            "(reference while_op.cc:95 WhileGradOp replays saved step "
            "scopes instead)")
    out_names = op.output("Out") or []
    if not op.output("InitStates"):
        raise RuntimeError(
            "gradient through op 'while' needs its InitStates snapshot "
            "outputs; this program was built by an old While layer — "
            "rebuild it (layers.While now declares them)")
    return [dict(
        type="while_grad",
        inputs={
            "X": op.input("X"),
            "Condition": op.input("Condition"),
            "InitStates": op.output("InitStates"),
            "InputSnapshots": op.output("InputSnapshots") or [],
            "Out@GRAD": [g or "" for g in gout.get("Out", [])],
        },
        outputs={"X@GRAD": gin.get("X", [])},
        attrs={
            "sub_block": op.attrs["sub_block"],
            "max_trip_count": op.attrs["max_trip_count"],
            "out_names": list(out_names),
        },
    )]


@register_op("while_grad", lod_aware=True)
def while_grad_op(ctx, ins, attrs):
    """Replay the loop from its entry-time snapshots under autograd and
    pull the cotangents back with torch.autograd.grad. Differentiable
    inputs: float carried inits and float closure vars; int and bool
    carries (counters, the condition) ride the replay without a gradient,
    as in the reference (while_grad emits no grad for Condition).

    The replay reads its own condition on the host before every trip, as
    the forward did, and stops where the forward stopped, after n trips,
    or at max_trip_count: min(n, max_trip_count) trips. n is not stored
    anywhere; the replay from the same snapshots counts it again. The JAX
    package runs all max_trip_count trips of a masked scan instead, whose
    trips past n return their carry exactly, so the values are the same.
    Under FLAGS_check_nan_inf a condition still true after max_trip_count
    trips (a forward that ran longer than its bound, whose replayed
    trajectory is cut) raises FloatingPointError naming max_trip_count."""
    op = ctx.current_op
    block = attrs["sub_block"]
    trips = int(attrs["max_trip_count"])
    out_names = list(attrs["out_names"])
    cond_name = op.input("Condition")[0]

    x_names = list(op.input("X"))
    x_vals = dict(zip(x_names, ins.get("X", [])))
    for n, sv in zip(x_names, ins.get("InputSnapshots") or []):
        if sv is not None:
            x_vals[n] = sv  # entry-time value: immune to later overwrites
    inits = {n: v for n, v in zip(out_names, ins.get("InitStates", []))
             if v is not None}
    gouts = dict(zip(out_names, ins.get("Out@GRAD", [])))
    _refuse_ragged("while_grad", list(inits.items()) + list(x_vals.items()))

    # closure = read-only parent vars; carried = Out names (replayed state)
    closure = {n: v for n, v in x_vals.items()
               if n not in inits and v is not None}
    const_closure = {n: v for n, v in closure.items() if not _is_float(v)}
    const_init = {n: v for n, v in inits.items() if not _is_float(v)}
    with torch.enable_grad():
        leaf_init = _leaves({n: v for n, v in inits.items()
                             if _is_float(v)})
        leaf_closure = _leaves({n: v for n, v in closure.items()
                                if _is_float(v)})
        carry = dict(const_init)
        carry.update(leaf_init)
        for _ in range(trips):
            if cond_name in carry and not _host_true(carry[cond_name]):
                break
            local = dict(const_closure)
            local.update(leaf_closure)
            local.update(carry)
            if cond_name not in local and cond_name in ctx.env:
                local[cond_name] = ctx.env[cond_name]
            ctx.run_block(block, local)
            carry = {n: local[n] for n in carry}
        else:
            if cond_name in carry and flags.get("check_nan_inf") \
                    and bool(carry[cond_name].any()):
                raise FloatingPointError(
                    f"while_grad: condition {cond_name!r} is still true "
                    f"after max_trip_count={trips} replay steps — the "
                    f"forward loop ran longer than its declared bound, so "
                    f"the replayed gradient trajectory is truncated. Raise "
                    f"max_trip_count on the While layer.")
        leaves = dict(leaf_init)
        leaves.update(leaf_closure)
        grads = _vjp({n: carry[n] for n in leaf_init}, gouts, leaves)
    g_init = {n: grads[n] for n in leaf_init}
    g_closure = {n: grads[n] for n in leaf_closure}
    return {"X@GRAD": _assemble_grads(x_names, g_init, g_closure)}


# ---------------------------------------------------------------------------
# conditional_block (reference conditional_block_op.cc)
# ---------------------------------------------------------------------------
def _predicate(cond, attrs):
    """The block's predicate, a 0-d bool tensor on the device."""
    if attrs.get("is_scalar_condition", False):
        return cond.reshape(())
    return cond.all()


def _select(pred, new, old):
    """where(pred, new, old); `old` None (a name the block made) is zeros
    of new's shape and dtype, as the JAX package's false branch gives."""
    if isinstance(new, SeqTensor):
        if old is None:
            old = SeqTensor(None, None)
        return SeqTensor(_select(pred, new.data, old.data),
                         _select(pred, new.lengths, old.lengths))
    if old is None:
        return torch.where(pred, new, torch.zeros_like(new))
    if not isinstance(new, torch.Tensor) or not isinstance(
            old, torch.Tensor) or new.shape != old.shape \
            or new.dtype != old.dtype:
        raise TypeError(
            f"conditional_block: the block writes {_describe(new)} over "
            f"{_describe(old)}; both branches must give one type and shape")
    return torch.where(pred, new, old)


def _describe(v):
    if isinstance(v, torch.Tensor):
        return f"{v.dtype}{tuple(v.shape)}"
    return type(v).__name__


def _on_host(block):
    """Whether the block holds a host or host-sync op: then its program
    runs on the interpreter and the predicate is read on the host."""
    return executor_core.capture_blocker(block.ops) is not None


@register_op("conditional_block", lod_aware=True)
def conditional_block_op(ctx, ins, attrs):
    """Run the sub-block; keep its writes where the predicate holds (the
    module docstring). InitStates, InputSnapshots and CondSnapshots are
    the entry-time values of the written state, of every read and of the
    predicate, which the grad replays from."""
    op = ctx.current_op
    env = ctx.env
    block = attrs["sub_block"]
    cond = [v for v in ins.get("X", []) if v is not None][0]
    pred = _predicate(cond, attrs)
    written = _while_written(block)
    out_names = list(op.output("Out") or [])
    inits = {n: env.get(n) for n in out_names}
    entry = {n: env.get(n) for n in op.input("Input")}
    cond_entry = {n: env.get(n) for n in op.input("X")}
    if _on_host(block):
        if _host_true(pred):
            local = dict(env)
            ctx.run_block(block, local)
            env.update({n: local[n] for n in written})
    else:
        local = dict(env)
        # an untaken branch may compute NaN/Inf that the select drops:
        # check what the block leaves in the env, not its inner ops
        check, ctx.check_nan_inf = ctx.check_nan_inf, False
        try:
            ctx.run_block(block, local)
        finally:
            ctx.check_nan_inf = check
        result = {n: _select(pred, local[n], env.get(n)) for n in written}
        if check:
            executor_core.check_values_finite(
                result.items(), context=" after op 'conditional_block'")
        env.update(result)
    ret = {}
    if op.output("InitStates"):
        ret["InitStates"] = [inits.get(n) for n in out_names]
    if op.output("InputSnapshots"):
        ret["InputSnapshots"] = [entry.get(n) for n in op.input("Input")]
    if op.output("CondSnapshots"):
        ret["CondSnapshots"] = [cond_entry.get(n) for n in op.input("X")]
    return ret


@register_grad_maker("conditional_block")
def conditional_block_grad_maker(op, gout, gin):
    """reference conditional_block_op.cc ConditionalBlockGradOp: the taken
    branch differentiates through the sub-block; the untaken branch is the
    identity to the pre-op value. Needs the InitStates snapshots; old
    descs without them refuse loudly instead of returning silent [None]
    grads."""
    if not op.output("InitStates"):
        raise RuntimeError(
            "gradient through op 'conditional_block' needs its InitStates "
            "snapshot outputs; this program was built by an old "
            "ConditionalBlock layer — rebuild it")
    return [dict(
        type="conditional_block_grad",
        inputs={
            "X": (op.output("CondSnapshots") or op.input("X")),
            "Input": op.input("Input"),
            "InitStates": op.output("InitStates"),
            "InputSnapshots": op.output("InputSnapshots") or [],
            "Out@GRAD": [g or "" for g in gout.get("Out", [])],
        },
        outputs={"Input@GRAD": gin.get("Input", [])},
        attrs={
            "sub_block": op.attrs["sub_block"],
            "is_scalar_condition": op.attrs.get("is_scalar_condition",
                                                False),
            "out_names": list(op.output("Out") or []),
        },
    )]


@register_op("conditional_block_grad", lod_aware=True)
def conditional_block_grad_op(ctx, ins, attrs):
    """Take the vjp through the block with the incoming cotangents, then
    select the grads under the entry-time predicate, as lax.cond's vjp
    gives them: the reads get where(pred, g_block, 0) and the written
    state where(pred, g_block, dOut). The cotangent passes through the
    block on both branches, but an untaken branch's grads are dropped by
    the select, so a NaN or Inf that the block's derivative makes there
    (a guarded division or sqrt) never reaches them. On the host path (a
    block with a host op) an untaken block is not replayed."""
    op = ctx.current_op
    block = attrs["sub_block"]
    out_names = list(attrs["out_names"])
    cond = [v for v in ins.get("X", []) if v is not None][0]
    pred = _predicate(cond, attrs)

    in_names = list(op.input("Input"))
    in_vals = dict(zip(in_names, ins.get("Input", [])))
    for n, sv in zip(in_names, ins.get("InputSnapshots") or []):
        if sv is not None:
            in_vals[n] = sv  # entry-time value: immune to later overwrites
    inits = {n: v for n, v in zip(out_names, ins.get("InitStates", []))
             if v is not None}
    gouts = dict(zip(out_names, ins.get("Out@GRAD", [])))
    _refuse_ragged("conditional_block_grad",
                   list(inits.items()) + list(in_vals.items()))

    # every float output with an incoming cotangent flows through the
    # replay, whether or not it had a pre-op value: a var first made
    # INSIDE the block has no init; the forward's false branch gave zeros
    # for it, so the replay starts it at zeros too (its init grad is
    # dropped below: there is no producer before the op)
    tracked, synthesized = {}, set()
    for n in out_names:
        g = gouts.get(n)
        if n in inits and _is_float(inits[n]):
            tracked[n] = inits[n]
        elif g is not None and _is_float(g):
            tracked[n] = torch.zeros_like(g)
            synthesized.add(n)
    const_init = {n: v for n, v in inits.items() if n not in tracked}
    # reads that are ALSO outputs take their value from the init snapshot
    reads = {n: v for n, v in in_vals.items()
             if n not in tracked and n not in const_init and v is not None}
    const_reads = {n: v for n, v in reads.items() if not _is_float(v)}
    # the untaken branch's grads: dOut to the state, zeros to the reads
    g_init = {n: torch.zeros_like(v) if gouts.get(n) is None
              else _cotangent_like(gouts[n], v) for n, v in tracked.items()}
    g_reads = {n: torch.zeros_like(v) for n, v in reads.items()
               if _is_float(v)}
    if not (_on_host(block) and not _host_true(pred)):
        with torch.enable_grad():
            leaf_init = _leaves(tracked)
            leaf_reads = _leaves({n: v for n, v in reads.items()
                                  if _is_float(v)})
            local = dict(const_reads)
            local.update(const_init)
            local.update(leaf_reads)
            local.update(leaf_init)
            for n, v in ctx.env.items():
                local.setdefault(n, v)
            # the replay computes what the forward's untaken branch did:
            # its NaN/Inf is dropped by the select below
            check, ctx.check_nan_inf = ctx.check_nan_inf, False
            try:
                ctx.run_block(block, local)
            finally:
                ctx.check_nan_inf = check
            leaves = dict(leaf_init)
            leaves.update(leaf_reads)
            grads = _vjp({n: local[n] for n in leaf_init}, gouts, leaves)
        g_init = {n: torch.where(pred, grads[n], g) for n, g in g_init.items()}
        g_reads = {n: torch.where(pred, grads[n], g)
                   for n, g in g_reads.items()}
    return {"Input@GRAD": _assemble_grads(
        in_names, g_init, g_reads, skip=synthesized)}


# ---------------------------------------------------------------------------
# IfElse's row split and merge (reference split_lod_tensor_op.cc,
# merge_lod_tensor_op.cc; host-sync ops: the rows are found on the host)
# ---------------------------------------------------------------------------
def _mask_rows(mask):
    """(true rows, false rows) of a [B, 1] mask, as index tensors."""
    m = mask.reshape(-1).bool()
    return (torch.nonzero(m).reshape(-1),
            torch.nonzero(torch.logical_not(m)).reshape(-1))


@register_op("split_lod_tensor", lod_aware=True)
def split_lod_tensor_op(ctx, ins, attrs):
    """X's rows where Mask holds (OutTrue) and where it does not
    (OutFalse), each in row order."""
    x, mask = first(ins, "X"), first(ins, "Mask")
    _refuse_ragged("split_lod_tensor", [("X", x)])
    rows_true, rows_false = _mask_rows(mask)
    return out(OutTrue=x.index_select(0, rows_true.to(x.device)),
               OutFalse=x.index_select(0, rows_false.to(x.device)))


@register_op("merge_lod_tensor", lod_aware=True)
def merge_lod_tensor_op(ctx, ins, attrs):
    """The inverse of split_lod_tensor: Out's rows where Mask holds come
    from InTrue in order, the others from InFalse. A side that no row
    takes may be unmade (its branch did not run): lazy inputs."""
    mask = first(ins, "Mask")
    in_true, in_false = first(ins, "InTrue"), first(ins, "InFalse")
    _refuse_ragged("merge_lod_tensor", [("InTrue", in_true),
                                        ("InFalse", in_false)])
    rows_true, rows_false = _mask_rows(mask)
    like = in_true if in_true is not None else in_false
    merged = like.new_zeros((mask.shape[0],) + tuple(like.shape[1:]))
    for rows, part in ((rows_true, in_true), (rows_false, in_false)):
        if rows.numel():
            merged = merged.index_copy(0, rows.to(like.device), part)
    return out(Out=merged)


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------
class TensorArray:
    """LOD_TENSOR_ARRAY runtime value: a Python list of tensors (None
    where nothing was written), indexed by host ints."""

    def __init__(self, items=None):
        self.items = list(items or [])

    def write(self, i, value):
        while len(self.items) <= i:
            self.items.append(None)
        self.items[i] = value

    def read(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def _index(ctx, i, what):
    """A scalar or [1] index tensor as a host int. The tensor-array ops
    are host-sync ops, so this never runs inside a capture; a write whose
    index would have to be read there raises with the JAX package's
    wording for a traced index."""
    if not isinstance(i, torch.Tensor):
        return int(i)
    if not ctx.eager and what == "write":
        raise NotImplementedError(
            "tensor-array write with a traced index: use StaticRNN/"
            "DynamicRNN (recurrent ops) for in-loop array writes")
    return int(i.reshape(-1)[0])


@register_op("write_to_array", lod_aware=True)
def write_to_array_op(ctx, ins, attrs):
    out_name = ctx.current_op.output("Out")[0]
    arr = ctx.env.get(out_name)
    if not isinstance(arr, TensorArray):
        arr = TensorArray()
    arr.write(_index(ctx, first(ins, "I"), "write"), first(ins, "X"))
    ctx.env[out_name] = arr
    return {}


@register_op("read_from_array", lod_aware=True)
def read_from_array_op(ctx, ins, attrs):
    arr, i = first(ins, "X"), first(ins, "I")
    if not ctx.eager:  # a device index: gather from the stacked items
        return out(Out=torch.stack(arr.items).index_select(
            0, i.reshape(-1).long()).reshape(arr.items[0].shape))
    return out(Out=arr.read(_index(ctx, i, "read")))


# tensor-array gradients (reference tensor_array_read_write.cc): the grad
# of a write READS the grad array at I; the grad of a read WRITES
# (accumulates) dOut into the grad array at I
@register_grad_maker("write_to_array")
def write_to_array_grad_maker(op, gout, gin):
    return [dict(
        type="write_to_array_grad",
        inputs={"OutGrad": gout["Out"], "I": op.input("I"),
                "X": op.input("X")},
        outputs={"X@GRAD": gin.get("X", [])},
        attrs={},
    )]


@register_op("write_to_array_grad", lod_aware=True)
def write_to_array_grad_op(ctx, ins, attrs):
    garr = first(ins, "OutGrad")
    idx = _index(ctx, first(ins, "I"), "read")
    if isinstance(garr, TensorArray) and idx < len(garr.items) \
            and garr.items[idx] is not None:
        g = garr.items[idx]
        # CONSUME the slot: reverse order visits the program's LAST write
        # first; an earlier write the forward overwrote must see zero
        # (its value never reached any read)
        garr.items[idx] = None
    else:
        g = torch.zeros_like(first(ins, "X"))  # never read
    return {"X@GRAD": [g]}


@register_grad_maker("read_from_array")
def read_from_array_grad_maker(op, gout, gin):
    return [dict(
        type="read_from_array_grad",
        inputs={"OutGrad": gout["Out"], "I": op.input("I")},
        outputs={"X@GRAD": gin.get("X", [])},
        attrs={},
    )]


@register_op("read_from_array_grad", lod_aware=True)
def read_from_array_grad_op(ctx, ins, attrs):
    """Accumulates into the grad ARRAY in place (reads of one slot sum
    their cotangents), as write_to_array updates the env in place."""
    g = first(ins, "OutGrad")
    out_name = ctx.current_op.output("X@GRAD")[0]
    arr = ctx.env.get(out_name)
    if not isinstance(arr, TensorArray):
        arr = TensorArray()
    idx = _index(ctx, first(ins, "I"), "read")
    while len(arr.items) <= idx:
        arr.items.append(None)
    arr.items[idx] = g if arr.items[idx] is None else arr.items[idx] + g
    ctx.env[out_name] = arr
    return {}


@register_op("lod_array_length")
def lod_array_length_op(ctx, ins, attrs):
    return out(Out=torch.full((1,), len(first(ins, "X")), dtype=torch.int64,
                              device=ctx.device))


# ---------------------------------------------------------------------------
# rank tables and the LoD reshuffles (host-sync ops)
# ---------------------------------------------------------------------------
@register_op("lod_rank_table", lod_aware=True)
def lod_rank_table_op(ctx, ins, attrs):
    """reference framework/lod_rank_table.cc: (sequence index, length)
    sorted by length, longest first, ties in index order."""
    x = first(ins, "X")
    lengths = x.lengths if isinstance(x, SeqTensor) else torch.ones(
        (x.shape[0],), dtype=torch.int32, device=x.device)
    order = torch.argsort(-lengths, stable=True)
    return out(Out=(order, lengths[order]))


@register_op("max_sequence_len", lod_aware=True)
def max_sequence_len_op(ctx, ins, attrs):
    _, lengths = first(ins, "RankTable")
    return out(Out=lengths.max().to(torch.int64))


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _offsets(lengths):
    offs = np.zeros(len(lengths) + 1, np.int64)
    offs[1:] = np.cumsum(lengths)
    return offs


def _take(x, rows):
    return x.index_select(0, torch.as_tensor(
        np.asarray(rows, np.int64), device=x.device))


@register_op("lod_tensor_to_array", lod_aware=True)
def lod_tensor_to_array_op(ctx, ins, attrs):
    """Bucket a ragged batch into per-step slices: item t holds, in rank
    order, the t-th token of every sequence longer than t."""
    x = first(ins, "X")
    order, lengths = (_host(v) for v in first(ins, "RankTable"))
    offs = _offsets(_host(x.lengths))
    arr = TensorArray()
    for t in range(int(lengths.max()) if len(lengths) else 0):
        arr.write(t, _take(x.data, [offs[i] + t
                                    for i in order[lengths > t]]))
    return out(Out=arr)


@register_op("array_to_lod_tensor", lod_aware=True)
def array_to_lod_tensor_op(ctx, ins, attrs):
    arr = first(ins, "X")
    order, lengths = (_host(v) for v in first(ins, "RankTable"))
    B = len(order)
    chunks = {i: [] for i in range(B)}
    for t in range(len(arr)):
        live = [i for i in range(B) if lengths[i] > t]
        for row, i in enumerate(live):
            chunks[i].append(arr.items[t][row])
    by_orig = {int(o): chunks[pos] for pos, o in enumerate(order)}
    datas = [torch.stack(by_orig[i]) for i in range(B) if by_orig[i]]
    lens = [len(by_orig[i]) for i in range(B)]
    data = torch.cat(datas) if datas else torch.zeros((0,),
                                                      device=ctx.device)
    return out(Out=SeqTensor(data, torch.as_tensor(
        lens, dtype=torch.int32, device=data.device)))


@register_op("reorder_lod_tensor_by_rank", lod_aware=True)
def reorder_lod_tensor_by_rank_op(ctx, ins, attrs):
    """Reorder a batch of sequences into rank-table order; when X carries
    no LoD, reorder its rows (each row a length-1 sequence). Reference
    operators/reorder_lod_tensor_by_rank_op.cc:38-66. The RankTable may
    come from another sequence than X."""
    x = first(ins, "X")
    order = _host(first(ins, "RankTable")[0])
    if isinstance(x, SeqTensor):
        lens = _host(x.lengths)
        offs = _offsets(lens)
        rows = np.concatenate([np.arange(offs[i], offs[i + 1])
                               for i in order]) \
            if len(order) else np.zeros((0,), np.int64)
        return out(Out=SeqTensor(_take(x.data, rows), torch.as_tensor(
            lens[order], dtype=torch.int32, device=x.data.device)))
    return out(Out=_take(x, order))


@register_op("reorder_lod_tensor_by_rank_grad", lod_aware=True)
def reorder_lod_tensor_by_rank_grad_op(ctx, ins, attrs):
    """Scatter the gradient back to the original order."""
    g = first(ins, "Out@GRAD")
    order = _host(first(ins, "RankTable")[0])
    pos_of_orig = np.argsort(order, kind="stable")
    if isinstance(g, SeqTensor):
        lens_sorted = _host(g.lengths)
        offs = _offsets(lens_sorted)
        rows = np.concatenate([np.arange(offs[p], offs[p + 1])
                               for p in pos_of_orig]) \
            if len(order) else np.zeros((0,), np.int64)
        return {"X@GRAD": [SeqTensor(_take(g.data, rows), torch.as_tensor(
            lens_sorted[pos_of_orig], dtype=torch.int32,
            device=g.data.device))]}
    return {"X@GRAD": [_take(g, pos_of_orig)]}


@register_grad_maker("reorder_lod_tensor_by_rank")
def reorder_lod_tensor_by_rank_grad_maker(op, gout, gin):
    return [dict(
        type="reorder_lod_tensor_by_rank_grad",
        inputs={"Out@GRAD": gout["Out"], "RankTable": op.input("RankTable")},
        outputs={"X@GRAD": gin["X"]},
        attrs=dict(op.attrs),
    )]


@register_op("shrink_rnn_memory", lod_aware=True)
def shrink_rnn_memory_op(ctx, ins, attrs):
    """The memory's rows of the sequences still alive at step I."""
    x = first(ins, "X")
    t = int(_host(first(ins, "I")).reshape(-1)[0])
    alive = int((_host(first(ins, "RankTable")[1]) > t).sum())
    return out(Out=x[:alive])


# ---------------------------------------------------------------------------
# feed / fetch / print / asserts / places
# ---------------------------------------------------------------------------
@register_op("feed", lod_aware=True)
def feed_op(ctx, ins, attrs):
    """The feed value named by Out (feeds are keyed by target var name),
    else the `col`-th feed."""
    col = attrs.get("col", 0)
    val = ctx.feed.get(ctx.current_op.output("Out")[0])
    if val is None:
        vals = list(ctx.feed.values())
        val = vals[col] if col < len(vals) else None
    return out(Out=val)


@register_op("fetch", lod_aware=True)
def fetch_op(ctx, ins, attrs):
    """Nothing to do: the executor returns its fetch list's values."""
    return {}


@register_op("print", lod_aware=True)
def print_op(ctx, ins, attrs):
    """reference print_op.cc: print `message` and the value on the host
    (a host-sync op); summarize > 0 shows the first N elements only."""
    x = first(ins, "In")
    data = x.data if isinstance(x, SeqTensor) else x
    summarize = int(attrs.get("summarize", -1) or -1)
    shown = data.reshape(-1)[:summarize] if summarize > 0 else data
    if shown.dtype == torch.bfloat16:
        shown = shown.float()
    print(attrs.get("message", "") + " " + str(shown.detach().cpu().numpy()))
    return out(Out=x)


@register_op("assert_op")
def assert_op(ctx, ins, attrs):
    return {}


@register_op("get_places")
def get_places_op(ctx, ins, attrs):
    """`device_count` places (0: every CUDA card, or 1), CPUPlaces for
    device_type "CPU", else CUDAPlaces."""
    count = attrs.get("device_count", 0) or torch.cuda.device_count() or 1
    if attrs.get("device_type", "AUTO") == "CPU":
        return out(Out=[CPUPlace()] * count)
    return out(Out=[CUDAPlace(i) for i in range(count)])


# ---------------------------------------------------------------------------
# recurrent (StaticRNN) and dynamic_recurrent (DynamicRNN)
# ---------------------------------------------------------------------------
@register_op("recurrent", lod_aware=True)
def recurrent_op(ctx, ins, attrs):
    """The StaticRNN body once for each row of the inputs' leading dim.
    Every operand comes from `ins` (inputs, boots and the Closure slot
    that carries the sub-block's parent-visible reads, weights included)
    and the outputs are RETURNED, stacked [T, ...], not written to the
    env, so the derived grad (<recurrent>_grad) sees the whole data
    dependence: an undeclared closure read would get a zero gradient."""
    env = ctx.env
    block = attrs["sub_block"]
    closure = {n: v for n, v in zip(attrs.get("closure_names", []),
                                    ins.get("Closure", []))
               if v is not None}
    xs = many(ins, "inputs")
    carry = list(many(ins, "initial_states"))
    ys = []
    for t in range(xs[0].shape[0]):
        local = dict(env)
        local.update(closure)
        local.update(zip(attrs["ex_states"], carry))
        local.update(zip(attrs["step_input_names"], (x[t] for x in xs)))
        ctx.run_block(block, local)
        carry = [local[n] for n in attrs["states"]]
        ys.append([local[n] for n in attrs["step_output_names"]])
    return {"outputs": [torch.stack(y) for y in zip(*ys)]}


@register_op("dynamic_recurrent", lod_aware=True)
def dynamic_recurrent_op(ctx, ins, attrs):
    """DynamicRNN: the body over the padded [T, B, ...] view of ragged
    inputs, with the rows of finished sequences masked. The reference
    shrinks the live batch each step by rank-table bucketing
    (control_flow.py:1317, recurrent_op.cc StepScopes); the port keeps a
    static [B] batch and T = the inputs' flat token count, the JAX
    package's trip count: the same math, fixed shapes."""
    from .sequence_ops import padded_to_seq, seq_to_padded

    env = ctx.env
    block = attrs["sub_block"]
    seq_ins = many(ins, "inputs")
    closure = dict(zip(attrs.get("closure_names", []),
                       ins.get("Closure", [])))
    # declared static inputs must ALSO come from ins or their gradients
    # are silently zero (the same undeclared-read class as Closure)
    closure.update(zip(attrs.get("static_input_names", []),
                       ins.get("static_inputs", [])))
    closure = {n: v for n, v in closure.items() if v is not None}
    if not seq_ins or not isinstance(seq_ins[0], SeqTensor):
        raise ValueError("DynamicRNN needs ragged (lod_level 1) inputs")
    lengths = seq_ins[0].lengths
    B = int(lengths.shape[0])
    T = ntokens = seq_ins[0].ntokens
    padded = [seq_to_padded(s, T).transpose(0, 1) for s in seq_ins]
    dtype = padded[0].dtype

    mem_init_names = attrs["mem_init_names"]
    declared = dict(zip([n for n in mem_init_names if n],
                        many(ins, "initial_states")))
    carry = []
    for i, name in enumerate(mem_init_names):
        if name:
            carry.append(declared.get(name, env.get(name)))
        else:
            carry.append(torch.full(
                [B] + list(attrs["mem_shapes"][i]), attrs["mem_values"][i],
                dtype=dtype, device=padded[0].device))
    ys = []
    for t in range(T):
        local = dict(env)
        local.update(closure)
        local.update(zip(attrs["pre_mem_names"], carry))
        local.update(zip(attrs["step_input_names"], (p[t] for p in padded)))
        ctx.run_block(block, local)
        mask = (t < lengths).to(dtype)
        new_carry = []
        for i, nm in enumerate(attrs["new_mem_names"]):
            new_v = local[nm] if nm else carry[i]
            m = mask.reshape((B,) + (1,) * (new_v.ndim - 1))
            new_carry.append(m * new_v + (1 - m) * carry[i])
        carry = new_carry
        ys.append([local[n] for n in attrs["step_output_names"]])
    # re-raggedify each output, [T, B, ...] -> a SeqTensor aligned to the
    # input; RETURNED (not an env side effect) so the derived grad sees it
    return {"outputs": [padded_to_seq(torch.stack(y).transpose(0, 1),
                                      lengths, ntokens)
                        for y in zip(*ys)]}


# state vars first made INSIDE a conditional block have no value at op
# entry: their inputs come in as None
set_lazy_inputs("conditional_block", "conditional_block_grad")
# while_grad: InitStates/InputSnapshots entries for sub-block-local names
# are never made (their snapshot is None by construction)
set_lazy_inputs("while_grad")
# merge_lod_tensor and its grad: the branch no row takes never ran
set_lazy_inputs("merge_lod_tensor", "merge_lod_tensor_grad")
