"""Per-op cost attribution: the compile probe's total mapped back to
ProgramDesc ops.

The compile probe (monitor.compile_probe) reports ONE aggregate FLOP count
per prepared step — true but unactionable when the question is "which
layer do I shard / fuse / shrink". The mapping back is analytic: estimate
each ProgramDesc op's FLOPs from its operand/result shapes (the standard
2*M*K*N-style counts), then scale every estimate so they sum to the
measured total. Shares are exact under the estimator; absolute FLOPs
inherit the probe's measurement.

Executors register the Program behind each prepared-step fingerprint
(register_program, weakref — attribution must not extend program
lifetime), so slowest_ops() can join monitor.compile_info()'s measured
totals with the op graph after the fact: the slowest_ops block in
flight-recorder manifests. A copy of the JAX package's
paddle_tpu/trace/costs.py, where the measured total is XLA's HLO cost
analysis.
"""

import weakref

from .. import monitor

__all__ = ["register_program", "registered_fingerprints", "op_costs",
           "attribute_costs", "slowest_ops", "format_ops_table"]

_programs = {}  # fingerprint -> weakref.ref(Program)

# ops that move/bookkeep but do no arithmetic worth attributing
_FREE_OPS = frozenset((
    "feed", "fetch", "fill_constant", "shape", "read", "read_from_array",
    "write_to_array", "increment", "assign", "share_lod", "print",
))

# per-element arithmetic weight for ops whose cost ~ output size; the
# default (1 flop/elem) covers the elementwise/copy family
_ELEM_WEIGHTS = {
    "softmax": 5.0, "log_softmax": 5.0, "sigmoid": 4.0, "tanh": 4.0,
    "exp": 4.0, "log": 4.0, "sqrt": 2.0, "rsqrt": 2.0,
    "batch_norm": 8.0, "layer_norm": 8.0, "group_norm": 8.0,
    "dropout": 2.0, "cross_entropy": 5.0,
    "softmax_with_cross_entropy": 10.0, "sigmoid_cross_entropy_with_logits":
    8.0, "swish": 4.0, "gelu": 8.0, "elu": 3.0, "selu": 3.0,
}


def register_program(fingerprint, program):
    """Remember (weakly) which Program a prepared-step fingerprint was
    built from; called by the executors on every prepared-step miss."""
    if fingerprint is None or program is None:
        return
    try:
        _programs[str(fingerprint)] = weakref.ref(program)
    except TypeError:
        pass


def registered_fingerprints():
    """Fingerprints whose Program is still alive."""
    return [fp for fp, ref in list(_programs.items())
            if ref() is not None]


def _numel(shape, batch):
    n = 1
    for d in shape or ():
        d = batch if (d is None or int(d) < 0) else int(d)
        n *= max(1, d)
    return max(1, n)


def _shape_of(block, name, batch):
    var = block.vars.get(name)
    if var is None and hasattr(block, "var_recursive"):
        try:
            var = block.var_recursive(name)
        except Exception:
            var = None
    return None if var is None else (var.shape or ())


def _estimate(block, op, batch):
    """Analytic FLOPs for one op (forward form); returns float."""
    t = op.type
    outs = op.output_arg_names()
    out_elems = _numel(_shape_of(block, outs[0], batch), batch) \
        if outs else 1

    if t in ("mul", "matmul", "matmul_v2"):
        # X [.., K] x Y [K, N]: 2*M*K*N with M = numel(X)/K
        xs = op.input("X") or op.input_arg_names()[:1]
        ys = op.input("Y") or op.input_arg_names()[1:2]
        x_shape = _shape_of(block, xs[0], batch) if xs else None
        y_shape = _shape_of(block, ys[0], batch) if ys else None
        if x_shape and y_shape:
            k = max(1, _numel(y_shape[:1], batch))
            m = _numel(x_shape, batch) / k
            n = _numel(y_shape, batch) / k
            return 2.0 * m * k * n
        return 2.0 * out_elems
    if t in ("conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d"):
        fs = op.input("Filter")
        f_shape = _shape_of(block, fs[0], batch) if fs else None
        if f_shape and len(f_shape) >= 3:
            # [Cout, Cin/groups, kh, kw]: 2 * out * Cin_g * prod(k)
            per_out = 2.0
            for d in f_shape[1:]:
                per_out *= max(1, int(d) if d is not None and d > 0 else 1)
            return out_elems * per_out
        return 2.0 * out_elems
    if t in ("pool2d", "pool3d"):
        k = op.attrs.get("ksize") or []
        kk = 1.0
        for d in k:
            kk *= max(1, int(d))
        if op.attrs.get("global_pooling"):
            ins = op.input("X")
            in_shape = _shape_of(block, ins[0], batch) if ins else None
            if in_shape and len(in_shape) >= 2:
                kk = _numel(in_shape, batch) / max(1, out_elems)
        return out_elems * kk
    if t.startswith("reduce_") or t in ("mean", "sum"):
        ins = op.input("X") or op.input_arg_names()[:1]
        in_shape = _shape_of(block, ins[0], batch) if ins else None
        return float(_numel(in_shape, batch)) if in_shape is not None \
            else float(out_elems)
    if t in ("lookup_table", "gather", "concat", "split", "transpose",
             "reshape", "squeeze", "unsqueeze", "cast", "scale", "pad"):
        return float(out_elems)
    if t in ("pipeline_send", "pipeline_recv", "zero1_gather",
             "all_gather", "broadcast"):
        # pure data movement: attribute the moved elements
        return float(out_elems)
    if t in ("zero1_scatter", "all_reduce", "reduce_scatter"):
        # ring reduction: ~one add per input element around the ring
        ins = op.input("X") or op.input_arg_names()[:1]
        in_shape = _shape_of(block, ins[0], batch) if ins else None
        return float(_numel(in_shape, batch)) if in_shape is not None \
            else float(out_elems)
    if t == "fused_elementwise":
        # the collapsed chain does every sub-op's arithmetic in one pass
        subs = op.attrs.get("sub_types") or ()
        return sum(_ELEM_WEIGHTS.get(s, 1.0) for s in subs) * out_elems
    if t in ("fused_sgd_update", "fused_momentum_update",
             "fused_adam_update"):
        # per-element update cost x total bucket payload
        per = {"fused_sgd_update": 2.0, "fused_momentum_update": 5.0,
               "fused_adam_update": 12.0}[t]
        total = 0.0
        for nm in (op.input("Param") or []):
            total += _numel(_shape_of(block, nm, batch), batch)
        return per * max(1.0, total)
    if t.endswith("_grad"):
        # grad ops roughly mirror the forward cost for input grads plus
        # a comparable pass for parameter grads
        fwd = _OpProxy(op, t[:-len("_grad")])
        return 2.0 * _estimate(block, fwd, batch)
    return _ELEM_WEIGHTS.get(t, 1.0) * out_elems


class _OpProxy:
    """An op view with a substituted type (grad -> forward estimation)."""

    __slots__ = ("_op", "type")

    def __init__(self, op, type_):
        self._op = op
        self.type = type_

    def __getattr__(self, name):
        return getattr(self._op, name)


def op_costs(program, batch_size=1):
    """Analytic per-op FLOP estimates over the global block:
    [{"index", "op", "out", "flops_est"}] in program order."""
    gb = program.global_block()
    batch = max(1, int(batch_size))
    rows = []
    for i, op in enumerate(gb.ops):
        if op.type in _FREE_OPS:
            continue
        try:
            est = float(_estimate(gb, op, batch))
        except Exception:
            est = 0.0
        outs = op.output_arg_names()
        rows.append({"index": i, "op": op.type,
                     "out": outs[0] if outs else "", "flops_est": est})
    return rows


def attribute_costs(program, total_flops=None, batch_size=1):
    """Per-op attribution, most expensive first. Each row carries
    `share` (of the analytic total — exact under the estimator) and
    `flops` (share scaled onto the measured total when given, else the
    raw estimate)."""
    rows = op_costs(program, batch_size=batch_size)
    est_total = sum(r["flops_est"] for r in rows) or 1.0
    scale = (float(total_flops) / est_total) if total_flops else 1.0
    for r in rows:
        r["share"] = r["flops_est"] / est_total
        r["flops"] = r["flops_est"] * scale
    rows.sort(key=lambda r: -r["flops_est"])
    return rows


def slowest_ops(fingerprint=None, batch_size=1, top=10):
    """The slowest-ops report joining a registered Program with its
    measured compile info: {"fingerprint", "total_flops", "wall_s",
    "measured", "ops": [...top rows...]}. Picks the registered
    fingerprint with the largest measured FLOPs when none is named;
    None when nothing usable is registered."""
    info = monitor.compile_info()
    live = {fp: ref() for fp, ref in _programs.items()
            if ref() is not None}
    if not live:
        return None
    if fingerprint is None:
        def measured(fp):
            return info.get(fp, {}).get("flops") or 0.0
        fingerprint = max(live, key=measured)
    fingerprint = str(fingerprint)
    program = live.get(fingerprint)
    if program is None:
        return None
    ci = info.get(fingerprint, {})
    total = ci.get("flops")
    rows = attribute_costs(program, total_flops=total,
                           batch_size=batch_size)
    return {
        "fingerprint": fingerprint,
        "total_flops": total,
        "wall_s": ci.get("wall_s"),
        "measured": total is not None,
        "ops": [dict(r) for r in rows[:max(1, int(top))]],
    }


def _fmt_flops(v):
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def format_ops_table(report):
    """Human-readable slowest-ops table from a slowest_ops() report."""
    if not report:
        return "no compiled program registered (run a step first)"
    src = "flop-counter probe" if report["measured"] \
        else "analytic estimate (no probe total measured)"
    lines = [f"fingerprint {report['fingerprint']}  "
             f"total_flops="
             f"{_fmt_flops(report['total_flops'] or 0.0)}  [{src}]"]
    if report.get("wall_s") is not None:
        lines[0] += f"  compile_wall_s={report['wall_s']:.3f}"
    lines.append(f"{'#':>3} {'op':<28}{'output':<28}"
                 f"{'flops':>10}{'share':>8}{'cum':>8}")
    cum = 0.0
    for i, r in enumerate(report["ops"], 1):
        cum += r["share"]
        lines.append(f"{i:>3} {r['op']:<28}{r['out'][:27]:<28}"
                     f"{_fmt_flops(r['flops']):>10}"
                     f"{r['share']:>8.1%}{cum:>8.1%}")
    return "\n".join(lines)
