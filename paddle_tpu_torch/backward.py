"""IR-level autodiff: append_backward / calc_gradient.

Reference parity: python/paddle/fluid/backward.py (append_backward:434,
_addup_repetitive_outputs_:123, _remove_no_grad_branch_:173,
calc_gradient:604) + framework/grad_op_desc_maker.h.

Walks the block's ops in reverse, asking each op for its grad ops. Ops with a
registered custom grad maker (registry.register_grad_maker) emit those; every
other op gets the DEFAULT maker, whose `<type>_grad` op is executed by the
generic torch.autograd kernel (core/registry.py make_vjp_kernel) — so the gradient
program is still an explicit IR (inspectable, transpilable, serializable)
while the grad math itself is derived from the forward kernel, exact by
construction. Repeated-use grads are deduped with `sum` ops exactly like the
reference.
"""

from .core.framework import (
    Operator,
    Parameter,
    Variable,
    OpRole,
    OP_ROLE_ATTR_NAME,
    OP_ROLE_VAR_ATTR_NAME,
    grad_var_name,
)
from .core import registry
from . import unique_name

__all__ = ["append_backward", "calc_gradient"]


def _strip_grad_suffix(name):
    pos = name.find("@GRAD")
    return name[:pos] if pos != -1 else name


def _default_grad_maker(op, gout, gin):
    """Emit `<type>_grad` following the auto-vjp convention."""
    inputs = {slot: list(names) for slot, names in op.inputs.items()}
    for slot, names in op.outputs.items():
        g = gout.get(slot)
        if g is not None and any(x for x in g):
            inputs[f"{slot}@GRAD"] = [x or "" for x in g]
    outputs = {f"{slot}@GRAD": list(names) for slot, names in gin.items()}
    attrs = {k: v for k, v in op.attrs.items() if k != OP_ROLE_VAR_ATTR_NAME}
    return [dict(type=op.type + "_grad", inputs=inputs, outputs=outputs, attrs=attrs)]


def _compute_reach(block, targets, no_grad):
    """Vars whose grads are needed: backward-reachable from targets, not
    crossing stop-gradient vars (reference _remove_no_grad_branch_)."""
    reach = set(targets)
    for op in reversed(block.ops):
        if set(op.output_arg_names()) & reach:
            for n in op.input_arg_names():
                if n and n not in no_grad:
                    reach.add(n)
    return reach


def _collect_no_grad(block, no_grad_set):
    no_grad = set(no_grad_set or [])
    for name, var in block.vars.items():
        if var.stop_gradient:
            no_grad.add(name)
    return no_grad


def _append_backward_ops(block, target_names, no_grad, grad_map, checkpoint_segments=None):
    """Emit grad ops for one block in reverse order. Returns grad_map
    (fwd var name -> grad var name)."""
    reach = _compute_reach(block, target_names, no_grad)

    def need_grad(name):
        return name and name not in no_grad and name in reach

    for op in reversed(block.ops):
        op_def = registry._registry.get(op.type)
        stop_slots = op_def.stop_gradient_outputs if op_def else ()
        gout = {}
        has_gout = False
        for slot, names in op.outputs.items():
            if slot in stop_slots:
                gout[slot] = [None] * len(names)
                continue
            gs = [grad_map.get(n) for n in names]
            gout[slot] = gs
            if any(gs):
                has_gout = True
        if not has_gout:
            continue
        gin = {}
        wants = False
        for slot, names in op.inputs.items():
            outs = []
            for n in names:
                if need_grad(n):
                    outs.append(None)  # filled below with fresh/canonical name
                    wants = True
                else:
                    outs.append("")
            if any(o is None for o in outs):
                gin[slot] = outs
        if not wants:
            continue

        # assign grad var names; dedup repeated contributions with sum ops.
        # In-place vars (read AND written by this op, e.g. a While's carried
        # state) REPLACE instead of sum: the existing grad_map entry is the
        # grad w.r.t. the post-op value, which this op already consumed via
        # gout — summing it with the new pre-op grad would double-count.
        # REPLACE is only sound when that consumption actually happened: the
        # var must sit in a NON-stop-gradient output slot with a live gout
        # entry. A var written only through a stop-gradient slot (e.g. a
        # batch-norm-style MeanOut aliasing its Mean input) fed the op no
        # cotangent, so its downstream grad must still SUM via @RENAME.
        consumed = set()
        for slot, names in op.outputs.items():
            if slot in stop_slots:
                continue
            for n, g in zip(names, gout.get(slot, [])):
                if g is not None:
                    consumed.add(n)
        pre_seen = set()  # in-place vars already assigned a @PRE by THIS op
        pending_sums = []  # (out_name, [parts])
        for slot, outs in gin.items():
            names = op.inputs[slot]
            for i, o in enumerate(outs):
                if o is None:
                    v = names[i]
                    canonical = grad_var_name(v)
                    if v in grad_map and v in consumed and v not in pre_seen:
                        # first occurrence: the old entry (grad w.r.t. the
                        # post-op value) was consumed via gout — REPLACE
                        fresh = unique_name.generate(canonical + "@PRE")
                        outs[i] = fresh
                        grad_map[v] = fresh
                        pre_seen.add(v)
                    elif v in grad_map and v in pre_seen:
                        # same op reads v through another slot too: its
                        # cotangents still SUM — into a fresh name, since
                        # `canonical` may be the live post-op grad
                        fresh = unique_name.generate(canonical + "@PRE")
                        total = unique_name.generate(canonical + "@PRE")
                        outs[i] = fresh
                        pending_sums.append((total, [grad_map[v], fresh]))
                        grad_map[v] = total
                    elif v in grad_map:
                        fresh = unique_name.generate(canonical + "@RENAME")
                        outs[i] = fresh
                        pending_sums.append((canonical, [grad_map[v], fresh]))
                        grad_map[v] = canonical
                    else:
                        outs[i] = canonical
                        grad_map[v] = canonical
            gin[slot] = [o if o is not None else "" for o in outs]

        maker = op_def.grad_maker if op_def and op_def.grad_maker else _default_grad_maker
        grad_descs = maker(op, gout, gin)
        with block.program.backward_role_guard():
            for d in grad_descs:
                attrs = dict(d.get("attrs") or {})
                attrs[OP_ROLE_ATTR_NAME] = OpRole.Backward
                g_op = block.append_op(d["type"], d.get("inputs"),
                                       d.get("outputs"), attrs)
                # the forward op this grad op came from: the dataflow
                # check's PTA031 pairs them by it (a deep copy of the
                # program, clone included, keeps the reference)
                g_op.fwd_op = op
            for canonical, parts in pending_sums:
                block.append_op(
                    "sum", {"X": parts}, {"Out": [canonical]},
                    {OP_ROLE_ATTR_NAME: OpRole.Backward},
                )

        # role-var bookkeeping for param grads (transpiler/PE rely on this)
        new_ops = block.ops[-(len(grad_descs) + len(pending_sums)) :]
        role_vars = []
        for slot, names in op.inputs.items():
            for n in names:
                var = block.vars.get(n)
                if isinstance(var, Parameter) and n in grad_map:
                    role_vars.extend([n, grad_map[n]])
        if role_vars:
            for g_op in new_ops:
                g_op.attrs[OP_ROLE_VAR_ATTR_NAME] = role_vars

    return grad_map


def _create_grad_vars(block, grad_map):
    for fwd_name, g_name in grad_map.items():
        if g_name not in block.vars:
            fwd = block.vars.get(fwd_name)
            block.create_var(
                name=g_name,
                shape=fwd.shape if fwd is not None else None,
                dtype=fwd.dtype if fwd is not None else "float32",
                lod_level=fwd.lod_level if fwd is not None else 0,
            )


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None,
                    checkpoints=None):
    """Append backward ops computing d(loss)/d(params).

    Returns [(param, grad_var)] like the reference (backward.py:434).
    `checkpoints`: optional list of Variables to use as rematerialization
    boundaries (TPU extension; reference has no gradient checkpointing).
    """
    assert isinstance(loss, Variable)
    block = loss.block
    program = block.program
    no_grad = _collect_no_grad(block, no_grad_set)

    loss_grad = grad_var_name(loss.name)
    with program.backward_role_guard():
        op = block.append_op(
            "fill_constant",
            {},
            {"Out": [loss_grad]},
            {
                "shape": list(loss.shape) if loss.shape else [],
                "value": 1.0,
                "dtype": loss.dtype,
            },
        )
        op.attrs[OP_ROLE_ATTR_NAME] = OpRole.Backward | OpRole.Loss
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype)

    grad_map = {loss.name: loss_grad}
    _append_backward_ops(block, {loss.name}, no_grad, grad_map)
    _create_grad_vars(block, grad_map)

    if parameter_list is not None:
        params = [
            block.var_recursive(p) if isinstance(p, str) else p for p in parameter_list
        ]
    else:
        params = [
            v
            for v in block.program.global_block().vars.values()
            if isinstance(v, Parameter) and v.trainable
        ]
    params_and_grads = []
    for p in params:
        if p.name in grad_map:
            params_and_grads.append((p, block.var(grad_map[p.name])))
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of targets w.r.t. inputs (reference backward.py:604)."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    block = targets[0].block
    program = block.program
    no_grad = _collect_no_grad(block, no_grad_set)
    # inputs must receive grads even if flagged stop_gradient
    for v in inputs:
        no_grad.discard(v.name)

    grad_map = {}
    with program.backward_role_guard():
        for t, tg in zip(targets, target_gradients):
            g_name = grad_var_name(t.name)
            if tg is None:
                block.append_op(
                    "fill_constant",
                    {},
                    {"Out": [g_name]},
                    {"shape": list(t.shape) if t.shape else [], "value": 1.0, "dtype": t.dtype},
                )
            else:
                block.append_op("assign", {"X": [tg]}, {"Out": [g_name]})
            block.create_var(name=g_name, shape=t.shape, dtype=t.dtype)
            grad_map[t.name] = g_name

    _append_backward_ops(block, {t.name for t in targets}, no_grad, grad_map)
    _create_grad_vars(block, grad_map)

    grads = []
    for v in inputs:
        g = grad_map.get(v.name)
        grads.append(block.var(g) if g else None)
    return grads
