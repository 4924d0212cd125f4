"""Operator registry: op type -> torch kernel (+ grad maker metadata).

Reference parity: paddle/fluid/framework/op_registry.h:129-167
(REGISTER_OPERATOR / REGISTER_OP_*_KERNEL) and grad_op_desc_maker.h:34.

A "kernel" is a plain function on tensors
    fn(ctx, ins: {slot: [values]}, attrs: {str: any}) -> {slot: [values]}
that the Executor's op-by-op interpreter calls once per op per step.
Values are torch tensors (or SeqTensor: flat ragged data + lengths).

Gradients: an op either registers an explicit `<type>_grad` kernel, or
the generic fallback derives the grad kernel from the forward kernel: it
re-runs the forward on detached leaves under autograd and takes
torch.autograd.grad of the outputs that carry a cotangent. Ops with
randomness or side effects must register explicit grads.
"""

import torch

from . import dtypes


class SeqTensor:
    """The LoD representation inside a step (1 nesting level): data
    [N, ...] flat tokens (N >= sum(lengths); the tail rows are padding, as
    create_bucketed_seq_tensor makes them), lengths int32 [B] per-sequence
    token counts, on the data's device.

    `host_lengths` is a numpy copy of the lengths that a feed built on the
    host carries, or None: the step reads it, never the device tensor, to
    check a length cap (rnn_ops.check_cap), so that no check waits for the
    device."""

    def __init__(self, data, lengths, host_lengths=None):
        self.data = data
        self.lengths = lengths
        self.host_lengths = host_lengths

    @property
    def batch(self):
        return self.lengths.shape[0]

    @property
    def ntokens(self):
        return self.data.shape[0]

    def offsets(self):
        """[B+1] int32 exclusive scan of the lengths (the LoD offsets)."""
        cum = torch.cumsum(self.lengths, 0, dtype=torch.int32)
        return torch.cat([cum.new_zeros(1), cum])

    def segment_ids(self):
        """[N] int32: each token's sequence index; padding rows get B."""
        cum = torch.cumsum(self.lengths, 0, dtype=torch.int32)
        pos = torch.arange(self.ntokens, dtype=torch.int32,
                           device=cum.device)
        return torch.searchsorted(cum, pos, right=True, out_int32=True)

    def token_mask(self):
        """[N] bool: True for real (non-padding) tokens."""
        return self.segment_ids() < self.batch

    def __repr__(self):
        return (f"SeqTensor(data={tuple(self.data.shape)}, "
                f"B={tuple(self.lengths.shape)})")


def seq_data(x):
    return x.data if isinstance(x, SeqTensor) else x


class OpDef:
    def __init__(self, type, fn, lod_aware=False):
        self.type = type
        self.fn = fn
        self.lod_aware = lod_aware
        self.grad_maker = None  # custom IR-level grad maker (backward.py)
        self.stop_gradient_outputs = ()  # output slots never differentiated


_registry = {}


def register_op(type, lod_aware=False, override=False):
    """Decorator: register the forward (or explicit grad) kernel for `type`.
    A second registration for the same type raises unless override=True."""

    def deco(fn):
        prev = _registry.get(type)
        if prev is not None and prev.fn is not None and not override:
            raise ValueError(
                f"kernel for op type {type!r} registered twice "
                f"(existing: {prev.fn.__module__}.{prev.fn.__qualname__}, "
                f"new: {fn.__module__}.{fn.__qualname__}); pass "
                f"override=True if shadowing is intended")
        if prev is not None:  # keep grad makers etc. attached to the stub
            prev.fn = fn
            prev.lod_aware = lod_aware
        else:
            _registry[type] = OpDef(type, fn, lod_aware=lod_aware)
        return fn

    return deco


def register_grad_maker(type):
    """Decorator: custom IR-level grad maker for op `type`.

    fn(op, grad_out_names: {out_slot: [grad names or None]},
       grad_in_names: {in_slot: [grad names or None]}) -> [op_desc dicts]
    See backward.py for the default maker.
    """

    def deco(fn):
        _get_or_stub(type).grad_maker = fn
        return fn

    return deco


def set_stop_gradient_outputs(type, slots):
    _get_or_stub(type).stop_gradient_outputs = tuple(slots)


def _get_or_stub(type):
    if type not in _registry:
        _registry[type] = OpDef(type, None)
    return _registry[type]


def get_op_def(type):
    op_def = _registry.get(type)
    if op_def is not None and op_def.fn is not None:
        return op_def
    return None


def lookup(type):
    """Resolve a kernel for `type`; derives `<T>_grad` from `<T>`."""
    op_def = get_op_def(type)
    if op_def is not None:
        return op_def
    if type.endswith("_grad"):
        fwd = get_op_def(type[: -len("_grad")])
        if fwd is not None:
            stub = _get_or_stub(type)  # keeps a pre-registered grad maker
            stub.fn = make_vjp_kernel(fwd)
            stub.lod_aware = True
            return stub
    raise NotImplementedError(
        f"No kernel registered for op type {type!r}: it is not yet ported "
        f"to paddle_tpu_torch (tests/test_torch_op_coverage.py lists the "
        f"types still missing and the roadmap item that owns each)")


# ---------------------------------------------------------------------------
# Generic derived gradient kernel.
#
# Convention for the auto grad op `<T>_grad` (emitted by backward.py's default
# grad maker):
#   inputs  = original input slots (original values)
#           + f"{out_slot}@GRAD" slots with incoming output grads (may be
#             absent -> treated as zeros)
#   outputs = f"{in_slot}@GRAD" slots (parallel to inputs; empty name = skip)
#   attrs   = original forward attrs
# ---------------------------------------------------------------------------
def _is_diff(v):
    x = seq_data(v)
    return isinstance(x, torch.Tensor) and dtypes.is_float(x.dtype)


def _cotangent(o, g):
    """Cotangent for primal output o. Tolerates scalar-vs-[1]-style
    mismatches (fluid loss vars are shape [1]) by reshaping only when the
    shapes differ by unit dims alone; anything else raises in autograd."""
    g = seq_data(g).to(o.dtype)
    gs, os_ = tuple(g.shape), tuple(o.shape)
    if gs != os_ and tuple(d for d in gs if d != 1) == tuple(
            d for d in os_ if d != 1):
        g = g.reshape(os_)
    return g


def _wanted(ctx):
    """{(slot, i)} of the inputs whose grads the running grad op writes
    (non-empty `{slot}@GRAD` output names); every differentiable input
    when the kernel runs outside an executor."""
    op = getattr(ctx, "current_op", None)
    if op is None:
        return None
    return {(slot[: -len("@GRAD")], i)
            for slot, names in op.outputs.items() if slot.endswith("@GRAD")
            for i, n in enumerate(names) if n}


def make_vjp_kernel(fwd_def):
    fwd_fn = fwd_def.fn
    stop = set(fwd_def.stop_gradient_outputs)

    def grad_kernel(ctx, ins, attrs):
        grad_outs, prim_ins = {}, {}
        for slot, vals in ins.items():
            if slot.endswith("@GRAD"):
                grad_outs[slot[: -len("@GRAD")]] = vals
            else:
                prim_ins[slot] = vals
        wanted = _wanted(ctx)
        leaves = {}  # (slot, i) -> detached leaf requiring grad
        full = {}
        for slot, vals in prim_ins.items():
            row = []
            for i, v in enumerate(vals):
                data = seq_data(v)
                if _is_diff(v) and (wanted is None or (slot, i) in wanted):
                    data = data.detach().requires_grad_(True)
                    leaves[(slot, i)] = data
                if fwd_def.lod_aware and isinstance(v, SeqTensor):
                    row.append(SeqTensor(data, v.lengths))
                else:
                    row.append(data)
            full[slot] = row
        result = {}
        if not leaves:
            return result
        with torch.enable_grad():
            outs = fwd_fn(ctx, full, attrs)
            ys, cots = [], []
            for slot, vals in outs.items():
                if slot in stop:
                    continue
                gs = grad_outs.get(slot) or []
                for i, o in enumerate(vals):
                    o = seq_data(o)
                    g = gs[i] if i < len(gs) else None
                    if g is None or o is None or not o.requires_grad:
                        continue
                    ys.append(o)
                    cots.append(_cotangent(o, g))
            grads = torch.autograd.grad(
                ys, list(leaves.values()), cots, allow_unused=True) \
                if ys else [None] * len(leaves)
        for ((slot, i), leaf), g in zip(leaves.items(), grads):
            g = torch.zeros_like(leaf) if g is None else g.detach()
            orig = prim_ins[slot][i]
            if isinstance(orig, SeqTensor):
                g = SeqTensor(g, orig.lengths)
            result.setdefault(f"{slot}@GRAD",
                              [None] * len(prim_ins[slot]))[i] = g
        return result

    return grad_kernel


# ---------------------------------------------------------------------------
# Kernel-call wrapper used by the executor: the mixed-precision policy
# (amp.py), SeqTensor auto-unwrap for non-lod-aware kernels + LoD
# propagation (reference ShareLoD semantics).
# ---------------------------------------------------------------------------
def run_kernel(op_def, ctx, ins, attrs):
    from .. import amp

    ins = amp.apply_policy(op_def.type, ins)
    if op_def.lod_aware:
        return op_def.fn(ctx, ins, attrs)
    first_lengths = first_n = None
    plain_ins = {}
    for slot, vals in ins.items():
        unwrapped = []
        for v in vals:
            if isinstance(v, SeqTensor):
                if first_lengths is None:
                    first_lengths, first_n = v.lengths, v.ntokens
                unwrapped.append(v.data)
            else:
                unwrapped.append(v)
        plain_ins[slot] = unwrapped
    outs = op_def.fn(ctx, plain_ins, attrs)
    if first_lengths is None:
        return outs
    return {slot: [SeqTensor(v, first_lengths)
                   if isinstance(v, torch.Tensor) and v.ndim >= 1
                   and v.shape[0] == first_n else v
                   for v in vals]
            for slot, vals in outs.items()}
