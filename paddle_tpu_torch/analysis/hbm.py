"""Liveness-based peak-HBM estimation per replica.

Model: a step's resident bytes are (a) every persistable var — params,
optimizer accumulators, lr scalars live for the whole step — plus (b) the
transient vars (activations, grads, feeds) alive at the current op. A
transient is alive from the op that defines it (feeds: from step entry)
through its last read; fetch targets stay alive to the end of the step.
Peak is the maximum over op indices of resident transient bytes, plus the
persistable floor — the same first-order model XLA's buffer assignment
minimizes, so the estimate tracks (not matches) the allocator's peak.

Sharding-aware per-replica accounting:
  * a var's bytes divide by the product of mesh-axis sizes named in its
    spec — the autoshard plan's spec wins, else the var's own
    `set_sharding` annotation;
  * zero1-rewritten programs need no special casing: the rewrite already
    reshapes accumulators to [parts, shard] and pins dim 0 to the dp
    axis, so the divide-by-axis rule yields the per-replica shard;
  * dynamic dims (None/-1) substitute `nominal_batch` (default: the mesh
    device count, autoshard's convention) so estimates stay comparable.

Measured counterpart: `measured_live_bytes(values)` sums the bytes of the
tensors this process holds — one rank, one card: the
`hbm_live_bytes_per_replica` gauge the estimate is held against (within
2x) in the tests and on the card.

The estimate is the JAX package's (paddle_tpu/analysis/hbm.py), byte for
byte on the same program.
"""

import numpy as np
import torch

from .verifier import sub_blocks

__all__ = ["estimate_peak_hbm", "measured_live_bytes", "render_table"]


def _dtype_bytes(dtype):
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        return 2 if str(dtype) == "bfloat16" else 4


def _shard_divisor(name, var, mesh_axes, aplan):
    if not mesh_axes:
        return 1
    spec = None
    if aplan is not None:
        spec = aplan.spec_of(name)
    if spec is None and var is not None:
        spec = getattr(var, "sharding", None)
    if not spec:
        return 1
    div = 1
    for ax in spec:
        if ax is not None:
            div *= int(mesh_axes.get(ax, 1))
    return max(1, div)


def _var_bytes(name, var, mesh_axes, aplan, nominal_batch):
    if var is None or var.shape is None:
        return 0
    numel = 1
    for d in var.shape:
        d = -1 if d is None else int(d)
        numel *= nominal_batch if d < 0 else d
    total = numel * _dtype_bytes(var.dtype)
    return total // _shard_divisor(name, var, mesh_axes, aplan)


def estimate_peak_hbm(program, mesh_axes=None, aplan=None,
                      fetch_names=None, nominal_batch=None):
    """Sweep block 0's op list and return the estimate dict."""
    mesh_axes = dict(mesh_axes or {})
    if nominal_batch is None:
        nominal_batch = 1
        for s in mesh_axes.values():
            nominal_batch *= int(s)
        nominal_batch = max(1, nominal_batch)
    gb = program.global_block()
    ops = gb.ops

    def var_of(name):
        return gb.vars.get(name) if name in gb.vars \
            else (gb.var_recursive(name)
                  if gb.has_var_recursive(name) else None)

    # -- persistable floor --------------------------------------------------
    from ..core.framework import Parameter
    param_bytes = opt_state_bytes = 0
    for name, var in gb.vars.items():
        if not var.persistable:
            continue
        b = _var_bytes(name, var, mesh_axes, aplan, nominal_batch)
        if isinstance(var, Parameter):
            param_bytes += b
        else:
            opt_state_bytes += b

    # -- transient liveness -------------------------------------------------
    # first def / last use per transient name; sub-block uses pin the name
    # live across the whole parent op
    first_def, last_use = {}, {}

    def note_use(name, i):
        last_use[name] = max(last_use.get(name, i), i)

    def note_def(name, i):
        first_def.setdefault(name, i)

    def sub_names(block):
        names = set()
        for op in block.ops:
            names.update(op.input_arg_names())
            names.update(op.output_arg_names())
            for sb in sub_blocks(op):
                names.update(sub_names(sb))
        return names

    n_ops = len(ops)
    for i, op in enumerate(ops):
        for name in op.input_arg_names():
            note_use(name, i)
        for name in op.output_arg_names():
            note_def(name, i)
            note_use(name, i)
        for sb in sub_blocks(op):
            for name in sub_names(sb):
                note_use(name, i)
                if name not in gb.vars:
                    continue  # sub-block local: charged at the parent op
                note_def(name, i)
    for name in (fetch_names or ()):
        note_use(name, max(0, n_ops - 1))

    transients = {}
    feed_bytes = 0
    for name in set(first_def) | set(last_use):
        var = var_of(name)
        if var is None or var.persistable:
            continue
        b = _var_bytes(name, var, mesh_axes, aplan, nominal_batch)
        if b <= 0:
            continue
        # never-defined reads are feeds/inputs: alive from step entry
        lo = first_def.get(name, 0)
        hi = last_use.get(name, n_ops - 1)
        transients[name] = (lo, hi, b)
        if name not in first_def or var.is_data:
            feed_bytes += b

    peak_transient = peak_idx = 0
    live_at_peak = 0
    for i in range(max(1, n_ops)):
        cur = sum(b for lo, hi, b in transients.values() if lo <= i <= hi)
        if cur > peak_transient:
            peak_transient, peak_idx = cur, i
            live_at_peak = sum(
                1 for lo, hi, _ in transients.values() if lo <= i <= hi)

    top = sorted(
        ((b, name) for name, (lo, hi, b) in transients.items()
         if lo <= peak_idx <= hi), reverse=True)[:8]
    return {
        "peak_bytes_per_replica": param_bytes + opt_state_bytes
        + peak_transient,
        "param_bytes": param_bytes,
        "optimizer_state_bytes": opt_state_bytes,
        "peak_transient_bytes": peak_transient,
        "feed_bytes": feed_bytes,
        "peak_op_index": peak_idx,
        "peak_op_type": ops[peak_idx].type if ops else None,
        "live_vars_at_peak": live_at_peak,
        "top_live_at_peak": [{"var": n, "bytes": b} for b, n in top],
        "mesh_axes": mesh_axes,
        "nominal_batch": nominal_batch,
        "n_transients": len(transients),
    }


def measured_live_bytes(values):
    """Bytes this process holds for `values` (tensors, SeqTensors — data
    and lengths — or numpy arrays): one rank's share, which under the
    port's data parallelism is one card's. Each storage counts once, so a
    view of a tensor already counted adds nothing."""
    flat = []
    for v in values:
        if hasattr(v, "lengths") and hasattr(v, "data"):  # a SeqTensor
            flat += [v.data, v.lengths]
        else:
            flat.append(v)
    seen = set()
    total = 0
    for v in flat:
        if isinstance(v, torch.Tensor):
            storage = v.untyped_storage()
            key = (v.device.type, v.device.index, storage.data_ptr())
            if key not in seen:
                seen.add(key)
                total += storage.nbytes()
        elif hasattr(v, "nbytes"):
            total += int(v.nbytes)
    return total


def render_table(est):
    """CLI table for one estimate dict."""
    def mb(b):
        return f"{b / 1e6:10.3f} MB"

    mesh = "x".join(f"{k}={v}"
                    for k, v in sorted(est.get("mesh_axes", {}).items())) \
        or "single"
    lines = [
        f"peak-HBM estimate per replica (mesh [{mesh}], nominal batch "
        f"{est['nominal_batch']}):",
        f"  parameters        {mb(est['param_bytes'])}",
        f"  optimizer state   {mb(est['optimizer_state_bytes'])}",
        f"  peak transients   {mb(est['peak_transient_bytes'])}  "
        f"(at op#{est['peak_op_index']} {est['peak_op_type']}, "
        f"{est['live_vars_at_peak']} live)",
        f"  TOTAL             {mb(est['peak_bytes_per_replica'])}",
    ]
    for row in est.get("top_live_at_peak", ())[:4]:
        lines.append(f"    live at peak: {row['var']:<28} "
                     f"{mb(row['bytes'])}")
    return "\n".join(lines)
