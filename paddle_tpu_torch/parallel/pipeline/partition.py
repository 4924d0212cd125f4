"""Stage partitioning: min-cut the dependency graph into pipeline stages.

The counterpart of paddle_tpu/parallel/pipeline/partition.py; the same
plans, digests and diagnostics for the same programs.

The forward ops of the global block form a sequence in program order
(program order is always a valid topological order — the dataflow graph
asserts as much). A p-stage partition is p-1 cut points in that sequence:

  * stage balance — each forward op is weighted by its analytic FLOPs
    (``trace.costs.op_costs``) times 3, the forward plus its ~2x backward
    twin, and a linear-partition DP first finds the minimal achievable
    max-stage weight;
  * cut cost — every non-persistable var defined before a cut and read
    after it must be shipped across the pp boundary (activation forward +
    its gradient backward, so 2x its bytes). A second DP picks, among all
    partitions within ``balance_slack`` of the balance optimum, the one
    with the fewest total boundary bytes.

Backward ops then inherit the stage of their paired forward op, optimizer
ops the stage that owns their Param, and ``check_partition`` verifies the
result: a same-phase dependency running from a later stage to an earlier
one (PTA040) or a boundary var rewritten after its send (PTA041) makes
the split illegal.
"""

import hashlib
import json

import numpy as np

from ...backward import _strip_grad_suffix
from ...core.framework import OpRole, OP_ROLE_ATTR_NAME
from ...trace.costs import op_costs

__all__ = ["StagePlan", "partition", "check_partition", "op_phase",
           "PHASE_FWD", "PHASE_BWD", "PHASE_OPT"]

PHASE_FWD = "fwd"
PHASE_BWD = "bwd"
PHASE_OPT = "opt"

# excluded from stage programs entirely: feeding/fetching is by name
_PSEUDO_OPS = frozenset(("feed", "fetch"))


def op_phase(op):
    """fwd / bwd / opt bucket for one op, from its OpRole attr."""
    role = op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)
    if role == OpRole.Backward:
        return PHASE_BWD
    if role == OpRole.Optimize:
        return PHASE_OPT
    return PHASE_FWD  # Forward, Forward|Loss, RPC


def _dtype_bytes(dtype):
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        return 2 if str(dtype) == "bfloat16" else 4


def _var_bytes(var, nominal_batch):
    if var is None or var.shape is None:
        return 0.0
    numel = 1
    for d in var.shape:
        d = -1 if d is None else int(d)
        numel *= nominal_batch if d < 0 else max(1, d)
    return float(numel) * _dtype_bytes(var.dtype)


class StagePlan:
    """A stage assignment for one program: op index -> stage."""

    __slots__ = ("n_stages", "axis", "assignment", "phases", "stage_flops",
                 "boundaries", "cut_bytes", "max_stage_flops")

    def __init__(self, n_stages, assignment, phases, stage_flops,
                 boundaries, cut_bytes, axis="pp"):
        self.n_stages = int(n_stages)
        self.axis = axis
        self.assignment = dict(assignment)   # op idx -> stage
        self.phases = list(phases)           # op idx -> phase
        self.stage_flops = list(stage_flops)
        self.boundaries = list(boundaries)   # [{var, src, dst, bytes}]
        self.cut_bytes = float(cut_bytes)
        self.max_stage_flops = max(stage_flops) if stage_flops else 0.0

    def stage_of(self, op_idx):
        return self.assignment.get(op_idx)

    def balance(self):
        """max/mean stage FLOPs — 1.0 is a perfectly balanced split."""
        if not self.stage_flops or not sum(self.stage_flops):
            return 1.0
        mean = sum(self.stage_flops) / len(self.stage_flops)
        return self.max_stage_flops / mean if mean else 1.0

    def digest(self):
        payload = {"n": self.n_stages, "axis": self.axis,
                   "a": sorted(self.assignment.items())}
        return hashlib.sha1(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]

    def to_dict(self):
        return {
            "n_stages": self.n_stages,
            "axis": self.axis,
            "digest": self.digest(),
            "stage_flops": [float(f) for f in self.stage_flops],
            "balance": float(self.balance()),
            "cut_bytes": float(self.cut_bytes),
            "boundaries": [dict(b) for b in self.boundaries],
            "ops_per_stage": [
                sum(1 for s in self.assignment.values() if s == k)
                for k in range(self.n_stages)],
        }

    def describe(self):
        lines = [f"pipeline plan: {self.n_stages} stages on '{self.axis}' "
                 f"(digest {self.digest()})"]
        for s in range(self.n_stages):
            nops = sum(1 for v in self.assignment.values() if v == s)
            lines.append(f"  stage {s}: {nops:3d} ops  "
                         f"{self.stage_flops[s] / 1e6:10.2f} MFLOP")
        lines.append(f"  balance {self.balance():.3f}  boundary "
                     f"{self.cut_bytes / 1e3:.1f} KB/microbatch "
                     f"({len(self.boundaries)} vars)")
        return "\n".join(lines)


def _linear_partition_minmax(weights, p):
    """Minimal achievable max-interval sum splitting `weights` into p
    contiguous intervals (classic linear-partition DP)."""
    n = len(weights)
    pre = [0.0]
    for w in weights:
        pre.append(pre[-1] + w)

    def span(a, b):  # sum of weights[a:b]
        return pre[b] - pre[a]

    INF = float("inf")
    f = [[INF] * (p + 1) for _ in range(n + 1)]
    f[0][0] = 0.0
    for j in range(1, n + 1):
        for s in range(1, min(p, j) + 1):
            for t in range(s - 1, j):
                cand = max(f[t][s - 1], span(t, j))
                if cand < f[j][s]:
                    f[j][s] = cand
    return f[n][p]


def _min_cut_partition(weights, cut_bytes, p, cap):
    """Among partitions with every interval sum <= cap, minimize total cut
    bytes; returns the list of cut positions (cut k = boundary after
    element k) or None when infeasible."""
    n = len(weights)
    pre = [0.0]
    for w in weights:
        pre.append(pre[-1] + w)
    INF = float("inf")
    g = [[INF] * (p + 1) for _ in range(n + 1)]
    back = [[None] * (p + 1) for _ in range(n + 1)]
    g[0][0] = 0.0
    for j in range(1, n + 1):
        for s in range(1, min(p, j) + 1):
            for t in range(s - 1, j):
                if pre[j] - pre[t] > cap:
                    continue
                cost = g[t][s - 1] + (cut_bytes[t - 1] if t > 0 else 0.0)
                if cost < g[j][s]:
                    g[j][s] = cost
                    back[j][s] = t
    if g[n][p] == INF:
        return None
    cuts, j, s = [], n, p
    while s > 1:
        t = back[j][s]
        cuts.append(t - 1)  # cut after forward position t-1
        j, s = t, s - 1
    cuts.reverse()
    return cuts


def partition(program, n_stages, feed_names=None, batch_size=1,
              balance_slack=0.25):
    """Build a StagePlan splitting `program` into `n_stages` stages.

    Raises ValueError when the program has fewer forward ops than stages.
    `balance_slack` widens the allowed max-stage weight over the balance
    optimum so the byte-minimizing DP has room to pick cheaper cuts."""
    n_stages = int(n_stages)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    gb = program.global_block()
    ops = gb.ops
    phases = [op_phase(op) for op in ops]
    fwd_idx = [i for i, op in enumerate(ops)
               if phases[i] == PHASE_FWD and op.type not in _PSEUDO_OPS]
    if len(fwd_idx) < n_stages:
        raise ValueError(
            f"cannot split {len(fwd_idx)} forward ops into {n_stages} "
            f"pipeline stages")
    cost_by_idx = {r["index"]: r["flops_est"]
                   for r in op_costs(program, batch_size=batch_size)}
    # forward weight carries its ~2x backward twin so stage balance
    # reflects the full fwd+bwd residence of the stage
    weights = [max(cost_by_idx.get(i, 0.0), 1.0) * 3.0 for i in fwd_idx]
    nf = len(fwd_idx)

    # -- per-cut boundary bytes ------------------------------------------
    # an activation defined at forward position a with last forward read at
    # position b crosses every cut a <= k < b; 2x bytes for its gradient
    pos_of = {i: k for k, i in enumerate(fwd_idx)}
    def_pos, last_read = {}, {}
    for k, i in enumerate(fwd_idx):
        op = ops[i]
        for n in op.input_arg_names():
            if n in def_pos:
                last_read[n] = max(last_read.get(n, k), k)
        for n in op.output_arg_names():
            v = gb.vars.get(n)
            if n not in def_pos and v is not None and not v.persistable:
                def_pos[n] = k
    add_at = [0.0] * (nf + 1)
    rem_at = [0.0] * (nf + 1)
    nominal = max(1, int(batch_size))
    var_cross_bytes = {}
    for n, a in def_pos.items():
        b = last_read.get(n, a)
        if b <= a:
            continue
        nbytes = 2.0 * _var_bytes(gb.vars.get(n), nominal)
        var_cross_bytes[n] = nbytes
        add_at[a] += nbytes
        rem_at[b] += nbytes
    cut_bytes = [0.0] * max(1, nf - 1)
    cur = 0.0
    for k in range(nf - 1):
        cur -= rem_at[k]
        cur += add_at[k]
        cut_bytes[k] = cur

    # -- choose cuts ------------------------------------------------------
    if n_stages == 1:
        cuts = []
    else:
        mstar = _linear_partition_minmax(weights, n_stages)
        cap = mstar * (1.0 + float(balance_slack))
        cuts = _min_cut_partition(weights, cut_bytes, n_stages, cap)
        if cuts is None:  # slack too tight under ties; fall back to exact
            cuts = _min_cut_partition(weights, cut_bytes, n_stages, mstar)
        assert cuts is not None, "linear-partition DP disagrees with itself"

    stage_of_pos = [0] * nf
    s = 0
    cut_set = set(cuts)
    for k in range(nf):
        stage_of_pos[k] = s
        if k in cut_set:
            s += 1

    # -- fold every op onto a stage --------------------------------------
    assignment = {}
    first_writer = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names():
            first_writer.setdefault(n, i)
    for i in fwd_idx:
        assignment[i] = stage_of_pos[pos_of[i]]

    def fwd_stage_of_var(name):
        w = first_writer.get(name)
        return assignment.get(w) if w is not None else None

    last = n_stages - 1
    for i, op in enumerate(ops):
        if i in assignment or op.type in _PSEUDO_OPS:
            continue
        ph = phases[i]
        if ph == PHASE_BWD:
            cands = []
            for n in op.input_arg_names() + op.output_arg_names():
                f = _strip_grad_suffix(n) if "@GRAD" in n else n
                st = fwd_stage_of_var(f)
                if st is not None:
                    cands.append(st)
            assignment[i] = max(cands) if cands else last
        elif ph == PHASE_OPT:
            p_in = op.input("Param")
            st = None
            if p_in:
                # the stage whose forward consumes the param owns its update
                pname = p_in[0]
                reads = [assignment[j] for j in fwd_idx
                         if pname in ops[j].input_arg_names()]
                st = max(reads) if reads else None
                if st is None:
                    for g in op.input("Grad"):
                        st = fwd_stage_of_var(_strip_grad_suffix(g))
                        if st is not None:
                            break
            if st is None:
                cands = [fwd_stage_of_var(n)
                         for n in op.input_arg_names()]
                cands = [c for c in cands if c is not None]
                st = max(cands) if cands else 0
            assignment[i] = st
        else:  # residual forward-phase pseudo ops
            cands = [fwd_stage_of_var(n) for n in op.input_arg_names()]
            cands = [c for c in cands if c is not None]
            assignment[i] = max(cands) if cands else 0
    for i, op in enumerate(ops):
        if op.type in _PSEUDO_OPS and i not in assignment:
            # feed-type ops follow their first consumer, fetch their source
            outs = set(op.output_arg_names())
            users = [assignment[j] for j, o in enumerate(ops)
                     if j in assignment and outs & set(o.input_arg_names())]
            srcs = [fwd_stage_of_var(n) for n in op.input_arg_names()]
            srcs = [c for c in srcs if c is not None]
            assignment[i] = min(users) if users else \
                (max(srcs) if srcs else 0)

    # -- stats + boundary list -------------------------------------------
    stage_flops = [0.0] * n_stages
    for i, st in assignment.items():
        stage_flops[st] += cost_by_idx.get(i, 0.0)
    boundaries = []
    total_cut = 0.0
    for n, a in sorted(def_pos.items()):
        b = last_read.get(n, a)
        src, dst = stage_of_pos[a], stage_of_pos[b]
        if dst > src:
            nbytes = var_cross_bytes.get(n, 0.0)
            boundaries.append({"var": n, "src": src, "dst": dst,
                               "bytes": nbytes})
            total_cut += nbytes
    return StagePlan(n_stages, assignment, phases, stage_flops,
                     boundaries, total_cut)


def check_partition(program, plan, report, graph=None, feed_names=None):
    """Emit PTA040/PTA041 diagnostics for an illegal stage split.

    PTA040: a same-phase raw def-use edge runs against the pipeline
    direction (forward data flowing to an EARLIER stage, or gradient data
    flowing to a LATER one) — no 1F1B order can satisfy it.
    PTA041: a var that crosses a stage boundary has more than one SSA
    version, so the receiving stage would observe a stale copy."""
    from ...analysis.dataflow import DependencyGraph

    if graph is None:
        graph = DependencyGraph(program, feed_names=feed_names)
    ops = program.global_block().ops
    phases = plan.phases
    for node in graph.nodes:
        u = node.idx
        su = plan.stage_of(u)
        if su is None:
            continue
        for v, kinds in graph.succs[u].items():
            if "raw" not in kinds:
                continue
            sv = plan.stage_of(v)
            if sv is None or phases[u] != phases[v]:
                continue
            bad = (phases[u] == PHASE_FWD and sv < su) or \
                  (phases[u] == PHASE_BWD and sv > su)
            if bad:
                report.add(
                    "PTA040",
                    f"{phases[u]} dependency op#{u}({ops[u].type}) -> "
                    f"op#{v}({ops[v].type}) runs from stage {su} to stage "
                    f"{sv} against the pipeline direction",
                    op_idx=v, op_type=ops[v].type, block_idx=0)
    boundary_vars = {b["var"] for b in plan.boundaries}
    for name in sorted(boundary_vars):
        writers = [n.idx for n in graph.nodes if name in n.writes]
        if len(writers) > 1:
            report.add(
                "PTA041",
                f"boundary var {name!r} is written by ops "
                f"{writers} — versions after the first would be stale on "
                f"the receiving stage",
                var=name, op_idx=writers[1],
                op_type=ops[writers[1]].type, block_idx=0)
    return report
