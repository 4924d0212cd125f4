"""Static overlap scheduler: critical path + gradient-bucketing plan.

The counterpart of paddle_tpu/analysis/schedule.py, over the port's IR.
It joins the SSA dependency graph (`analysis.dataflow`) with the two
cost models the port owns, the analytic FLOPs model (`trace.costs`) for
compute nodes and the ring-bytes model of the zero1 collectives (the
(n-1)/n ring factors of `parallel.zero1.Zero1Plan.collective_bytes`) for
communication nodes:

  * **critical path**: the longest dependency path through the graph,
    each node costed in milliseconds (compute = flops / peak_flops, comm
    = ring bytes / link bandwidth). `serial_ms - critical_path_ms` is the
    headroom a perfect overlap schedule could reclaim;
  * **overlap plan**: which `zero1_scatter(grad)` reduce-scatters can
    LEGALLY hoist from the optimizer tail up to just after their gradient
    producer, overlapping the reduce with the remaining backward compute,
    bucketed under a bytes threshold the way DDP buckets gradients: a
    bucket fires when the last of its gradients is ready;
  * **apply_plan**: the reordering on a CLONE, made only after the PTA03x
    hazard detector ran on the source and on the reordered program; a
    program with any dataflow hazard is REJECTED
    (ProgramVerificationError), never silently reordered.

`FLAGS_overlap_plan=1` lets ParallelExecutor apply the plan to the
zero1-resolved program when it prepares a step (under zero1 at dp >= 2);
the plan's digest joins the prepared key, so toggling the flag or a new
plan prepares anew. There each hoisted bucket's reduce-scatters are
issued asynchronously and waited for before the first op that reads
their shard (ops/collective_ops.py). Three monitor gauges record the
result: `dataflow_critical_path_ms`, `overlap_hoistable_bytes`,
`overlap_bucket_count`.

The cost model's knobs default to one H100 SXM's data-sheet figures, the
ones `parallel/autoshard/search.py` uses: 989.4 dense bf16 TFLOP/s
(`monitor.mfu.CHIP_PEAK_TFLOPS`) and NVLink's 450 GB/s each way. Both are
parameters; given the JAX package's (197e12, 1.8e11) the report is the
JAX package's. The schedule is a *relative* instrument: the same knobs
apply to every node, and the buckets depend on bytes only.
"""

import hashlib

import numpy as np

from .. import flags
from ..monitor.mfu import CHIP_PEAK_TFLOPS
from ..trace import costs as _costs
from .dataflow import build_graph, check_hazards, DATAFLOW_CODES
from .diagnostics import ProgramVerificationError, Report

__all__ = ["ScheduleReport", "OverlapPlan", "analyze", "build_overlap_plan",
           "apply_plan", "record_gauges", "DEFAULT_BUCKET_BYTES",
           "DEFAULT_PEAK_FLOPS", "DEFAULT_ICI_BYTES_PER_S"]

flags.define(
    "overlap_plan", bool, False,
    "Apply the static overlap schedule (analysis.schedule) to the "
    "resolved program at ParallelExecutor compile time: hoist the legal "
    "zero1_scatter reduce-scatters up into the backward section, bucketed "
    "under FLAGS_overlap_bucket_bytes. Off by default; the reordering is "
    "rejected (never applied) when the dataflow hazard detector finds any "
    "PTA03x code. Compile-cache-keyed: toggling recompiles.")

flags.define(
    "overlap_bucket_bytes", int, 4 << 20,
    "Bucket threshold for the overlap plan's gradient reduce-scatter "
    "hoisting: scatters accumulate into a bucket until adding the next "
    "would exceed this many bytes; each bucket is hoisted to the point "
    "where the last of its gradients is produced.")

DEFAULT_BUCKET_BYTES = 4 << 20
# one H100 SXM (700 W): dense bf16 peak (monitor.mfu table) and NVLink's
# 450 GB/s each way; the names keep the JAX package's
DEFAULT_PEAK_FLOPS = CHIP_PEAK_TFLOPS["H100 80GB HBM3"] * 1e12
DEFAULT_ICI_BYTES_PER_S = 450e9

_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                "float16": 2, "bfloat16": 2, "uint8": 1, "int8": 1,
                "bool": 1}


def _dtype_bytes(var):
    name = str(getattr(var, "dtype", "float32")).replace("torch.", "")
    return _DTYPE_BYTES.get(name, 4)


def _collective_bytes(graph, node, mesh_axes):
    """On-wire ring bytes for one collective node (0 for compute nodes),
    using the same (n-1)/n ring formulas as Zero1Plan.collective_bytes."""
    op = node.op
    if op.type not in ("zero1_scatter", "zero1_gather", "all_reduce",
                       "all_gather", "reduce_scatter", "broadcast"):
        return 0.0
    gb = graph.block
    axis = op.attrs.get("axis_name", "dp")
    n = int((mesh_axes or {}).get(axis, 1))
    if n < 2:
        return 0.0
    ins = op.input_arg_names()
    name = ins[0] if ins else None
    var = gb.var_recursive(name) \
        if name and gb.has_var_recursive(name) else None
    if var is None or not getattr(var, "shape", None):
        return 0.0
    numel = int(np.prod([int(d) for d in var.shape]))
    if op.type == "zero1_gather" and int(var.shape[0]) == 1:
        # a rank's program holds its [1, shard] row of the JAX package's
        # [n, shard] (parallel.zero1.global_view holds the whole)
        numel *= n
    elif op.type == "zero1_scatter":
        parts = int(op.attrs.get("parts", n))
        numel = -(-numel // parts) * parts  # zero-pad to the shard layout
    b = numel * _dtype_bytes(var)
    if op.type == "all_reduce":
        return 2.0 * (n - 1) / n * b
    # reduce-scatter / all-gather / broadcast: one ring pass
    return (n - 1) / n * b


class OverlapPlan:
    """The hoisting decision: which grad reduce-scatters move where.

    buckets: [{"bucket", "ops" (original op idxs), "bytes",
               "insert_after" (op idx whose completion fires the bucket)}]
    order:   full permutation of block-0 op indices (new execution order)
    """

    def __init__(self, buckets, order, bucket_bytes, n_ops):
        self.buckets = buckets
        self.order = order
        self.bucket_bytes = int(bucket_bytes)
        self.n_ops = int(n_ops)

    @property
    def moves(self):
        """(op idx, insert_after idx) pairs for every hoisted scatter."""
        return [(i, b["insert_after"]) for b in self.buckets
                for i in b["ops"]]

    @property
    def hoistable_bytes(self):
        return sum(b["bytes"] for b in self.buckets)

    def digest(self):
        h = hashlib.sha1()
        h.update(repr((self.order, self.bucket_bytes,
                       self.n_ops)).encode())
        return h.hexdigest()[:16]

    def to_dict(self):
        return {
            "n_buckets": len(self.buckets),
            "n_moves": len(self.moves),
            "hoistable_bytes": self.hoistable_bytes,
            "bucket_bytes": self.bucket_bytes,
            "buckets": [dict(b) for b in self.buckets],
            "digest": self.digest(),
        }


class ScheduleReport:
    """analyze() result: costs, critical path, and the overlap plan."""

    def __init__(self, graph, node_ms, critical_path, plan, mesh_axes,
                 knobs):
        self.graph = graph
        self.node_ms = node_ms              # per-node cost, ms
        self.critical_path = critical_path  # node idx list, start to end
        self.plan = plan
        self.mesh_axes = dict(mesh_axes or {})
        self.knobs = knobs

    @property
    def critical_path_ms(self):
        return sum(self.node_ms[i] for i in self.critical_path)

    @property
    def serial_ms(self):
        return sum(self.node_ms)

    @property
    def comm_ms(self):
        return sum(ms for n, ms in zip(self.graph.nodes, self.node_ms)
                   if n.collectives)

    @property
    def compute_ms(self):
        return self.serial_ms - self.comm_ms

    def to_dict(self):
        g = self.graph
        return {
            "n_ops": len(g.nodes),
            "n_edges": g.n_edges(),
            "mesh_axes": self.mesh_axes,
            "knobs": dict(self.knobs),
            "critical_path_ms": self.critical_path_ms,
            "serial_ms": self.serial_ms,
            "compute_ms": self.compute_ms,
            "comm_ms": self.comm_ms,
            "overlap_headroom_ms": self.serial_ms - self.critical_path_ms,
            "critical_path": [
                {"op_idx": i, "op": g.nodes[i].op.type,
                 "ms": self.node_ms[i]}
                for i in self.critical_path],
            "overlap": self.plan.to_dict(),
        }

    def render(self):
        d = self.to_dict()
        lines = [
            f"schedule: {d['n_ops']} ops / {d['n_edges']} edges  "
            f"mesh={self.mesh_axes or '{}'}",
            f"  critical path {d['critical_path_ms']:.6g} ms over "
            f"{len(self.critical_path)} ops  (serial {d['serial_ms']:.6g} "
            f"ms = compute {d['compute_ms']:.6g} + comm "
            f"{d['comm_ms']:.6g}; headroom "
            f"{d['overlap_headroom_ms']:.6g} ms)",
            f"  overlap plan: {len(self.plan.buckets)} bucket(s), "
            f"{len(self.plan.moves)} hoisted scatter(s), "
            f"{self.plan.hoistable_bytes} B under "
            f"{self.plan.bucket_bytes} B/bucket",
        ]
        for b in self.plan.buckets:
            ops_s = ", ".join(f"op#{i}" for i in b["ops"])
            lines.append(
                f"    bucket {b['bucket']}: [{ops_s}] {b['bytes']} B -> "
                f"fires after op#{b['insert_after']}")
        hot = sorted(
            ((self.node_ms[i], i) for i in self.critical_path),
            reverse=True)[:5]
        for ms, i in hot:
            if ms <= 0:
                continue
            lines.append(
                f"    critical: op#{i}({self.graph.nodes[i].op.type}) "
                f"{ms:.6g} ms")
        return "\n".join(lines)


def _node_costs_ms(graph, mesh_axes, batch_size, peak_flops,
                   ici_bytes_per_s):
    flops_by_idx = {
        r["index"]: r["flops_est"]
        for r in _costs.op_costs(graph.program, batch_size=batch_size)}
    node_ms = []
    for node in graph.nodes:
        comm_b = _collective_bytes(graph, node, mesh_axes)
        if comm_b > 0:
            node_ms.append(comm_b / ici_bytes_per_s * 1e3)
        else:
            node_ms.append(
                float(flops_by_idx.get(node.idx, 0.0)) / peak_flops * 1e3)
    return node_ms


def _critical_path(graph, node_ms):
    """Longest-cost path through the DAG; returns the node index chain."""
    order = graph.topo_order()
    finish = [0.0] * len(graph.nodes)
    best_pred = [None] * len(graph.nodes)
    for i in order:
        start = 0.0
        for p in graph.preds[i]:
            if finish[p] > start:
                start = finish[p]
                best_pred[i] = p
        finish[i] = start + node_ms[i]
    if not finish:
        return []
    end = max(range(len(finish)), key=finish.__getitem__)
    path, cur = [], end
    while cur is not None:
        path.append(cur)
        cur = best_pred[cur]
    return list(reversed(path))


def build_overlap_plan(graph, bucket_bytes=None):
    """Bucketed hoisting plan for the grad-shard reduce-scatters.

    A `zero1_scatter` whose Out is a `@zero1_rs` grad shard depends only
    on its gradient producer (plus anti-deps); its earliest legal slot is
    right after its latest predecessor.  Scatters are taken in
    grad-readiness order and packed into buckets under `bucket_bytes`;
    each bucket is hoisted to just after the last producer among its
    members — the bucket "fires" when all its gradients exist, exactly
    DDP's gradient-bucketing contract."""
    if bucket_bytes is None:
        bucket_bytes = int(flags.get("overlap_bucket_bytes")) \
            or DEFAULT_BUCKET_BYTES
    movable = []
    for node in graph.nodes:
        if node.op.type != "zero1_scatter":
            continue
        out = (node.op.outputs.get("Out") or [""])[0]
        if not out.endswith("@zero1_rs"):
            continue
        ready = max(graph.preds[node.idx], default=-1)
        if ready < 0 or ready + 1 >= node.idx:
            continue  # already as early as it can be
        ins = node.op.input_arg_names()
        var = graph.block.var_recursive(ins[0]) \
            if ins and graph.block.has_var_recursive(ins[0]) else None
        numel = int(np.prod([int(d) for d in var.shape])) \
            if var is not None and getattr(var, "shape", None) else 0
        parts = int(node.op.attrs.get("parts", 1))
        padded = -(-numel // parts) * parts if parts > 1 else numel
        movable.append(
            (ready, node.idx, padded * _dtype_bytes(var)))
    movable.sort()

    buckets, cur = [], None
    for ready, idx, nbytes in movable:
        if cur is None or (cur["bytes"] + nbytes > bucket_bytes
                           and cur["ops"]):
            cur = {"bucket": len(buckets), "ops": [], "bytes": 0,
                   "insert_after": -1}
            buckets.append(cur)
        cur["ops"].append(idx)
        cur["bytes"] += nbytes
        cur["insert_after"] = max(cur["insert_after"], ready)

    n = len(graph.nodes)
    moved = {i for b in buckets for i in b["ops"]}
    # position keys: unmoved op i at (i, 0); a hoisted scatter right after
    # its bucket's insert point, bucket order preserved
    keyed = [((i, 0, 0), i) for i in range(n) if i not in moved]
    for b in buckets:
        for seq, i in enumerate(b["ops"]):
            keyed.append(((b["insert_after"], 1, seq), i))
    order = [i for _, i in sorted(keyed)]
    plan = OverlapPlan(buckets, order, bucket_bytes, n)

    # the construction is legal by design; verify anyway (cheap) so a
    # future edit cannot ship an order that violates an edge
    pos = {op_i: p for p, op_i in enumerate(order)}
    for u in range(n):
        for v in graph.succs[u]:
            if pos[u] >= pos[v]:
                raise AssertionError(
                    f"overlap plan violates dependency op#{u} -> op#{v}")
    return plan


def _require_hazard_free(program, feed_names, what):
    report = Report(level="full", context=f"overlap-{what}")
    check_hazards(program, report, feed_names=feed_names)
    if any(d.code in DATAFLOW_CODES for d in report.errors()):
        raise ProgramVerificationError(report)


def apply_plan(program, plan=None, feed_names=None):
    """Reorder block-0 ops per the overlap plan, on a clone.

    Refuses (ProgramVerificationError) when the source program carries any
    PTA03x hazard — an unsafe program is never silently reordered — and
    re-checks the reordered clone before returning it.  Returns
    (program, plan) unchanged when there is nothing to hoist."""
    _require_hazard_free(program, feed_names, "source")
    graph = build_graph(program, feed_names=feed_names)
    if plan is None:
        plan = build_overlap_plan(graph)
    if not plan.moves:
        return program, plan
    if plan.n_ops != len(graph.nodes):
        raise ValueError(
            f"overlap plan was built for {plan.n_ops} ops, program has "
            f"{len(graph.nodes)}")
    clone = program.clone()
    gb = clone.global_block()
    gb.ops = [gb.ops[i] for i in plan.order]
    clone._mutation += 1
    _require_hazard_free(clone, feed_names, "reordered")
    return clone, plan


def analyze(program, mesh_axes=None, feed_names=None, batch_size=1,
            bucket_bytes=None, peak_flops=DEFAULT_PEAK_FLOPS,
            ici_bytes_per_s=DEFAULT_ICI_BYTES_PER_S):
    """Build the graph, cost it, and plan the overlap. Raises
    ProgramVerificationError on a program with PTA03x hazards (there is
    no meaningful schedule for an unsatisfiable dependence graph)."""
    report = Report(level="full", context="schedule")
    graph = check_hazards(program, report, feed_names=feed_names)
    if any(d.code in DATAFLOW_CODES for d in report.errors()):
        raise ProgramVerificationError(report)
    node_ms = _node_costs_ms(graph, mesh_axes, batch_size, peak_flops,
                             ici_bytes_per_s)
    cpath = _critical_path(graph, node_ms)
    plan = build_overlap_plan(graph, bucket_bytes=bucket_bytes)
    return ScheduleReport(
        graph, node_ms, cpath, plan, mesh_axes,
        {"batch_size": batch_size, "peak_flops": peak_flops,
         "ici_bytes_per_s": ici_bytes_per_s,
         "bucket_bytes": plan.bucket_bytes})


def record_gauges(sched_report, context=None):
    """Publish the three overlap gauges from a ScheduleReport (unlabeled,
    like the autoshard plan gauges, so dryruns/green_gate can read them
    back without label plumbing)."""
    del context  # labels would fork the series; keep them unlabeled
    from .. import monitor

    reg = monitor.registry()
    reg.gauge(
        "dataflow_critical_path_ms",
        help="longest dependency path through the SSA graph, analytic ms",
    ).set(float(sched_report.critical_path_ms))
    reg.gauge(
        "overlap_hoistable_bytes",
        help="grad reduce-scatter bytes the overlap plan hoists into the "
             "backward section",
    ).set(float(sched_report.plan.hoistable_bytes))
    reg.gauge(
        "overlap_bucket_count",
        help="number of gradient buckets in the overlap plan",
    ).set(float(len(sched_report.plan.buckets)))
    # the analytic compute/comm split: the fleet collector joins these
    # with the measured step time into fleet_overlap_efficiency (comm
    # hidden under compute — obs/timeline.overlap_efficiency)
    reg.gauge(
        "dataflow_serial_ms",
        help="analytic serial cost of the whole step (compute + comm)",
    ).set(float(sched_report.serial_ms))
    reg.gauge(
        "dataflow_compute_ms",
        help="analytic compute share of the serial step cost",
    ).set(float(sched_report.compute_ms))
    reg.gauge(
        "dataflow_comm_ms",
        help="analytic collective share of the serial step cost",
    ).set(float(sched_report.comm_ms))
