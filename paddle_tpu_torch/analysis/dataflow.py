"""SSA-style def-use dependency graph over ProgramDesc + hazard detection.

The reference ParallelExecutor owes its multi-device schedule to an SSA
graph built from the ProgramDesc (`parallel_executor.cc`: each variable
write creates a new version node, ops depend on the exact versions they
read). This module rebuilds that substrate as a *static* analysis on the
Python IR:

  * one graph node per block-0 op, with per-op read/write sets resolved to
    **versioned** variables (name, version).  Version 0 is the value at
    step entry (persistables, feeds, runtime vars); each write bumps the
    version.  Reads bind to the version current at the op's program point,
    so the graph edges are exact def-use (RAW) dependencies, plus the
    anti-dependencies (WAR) and output-dependencies (WAW) that make any
    topological order semantics-preserving;
  * ops carrying Block-valued attrs (while/cond) are **summarized**, not
    skipped: the sub-tree's reads/writes of names that resolve in the
    parent scope escape onto the parent node, so control-flow bodies
    participate in versioning, hazard detection, and scheduling;
  * in-place updates (op writes a name it reads) tag their WAW edge
    ``inplace``; persistable updates by Optimize-role ops / zero1_gather
    tag their WAR edges ``donation`` — these are the edges XLA's buffer
    donation turns from advisory into load-bearing;
  * alias (view) outputs declared in ``COLLECTIVE_RW`` below
    (zero1_scatter/gather Out is a pad/reshape view of X) are tracked with
    the root version they were created from, so a read of a stale view
    after the root buffer's donated update is detectable (PTA034) even
    though no *name* is reused.

Hazards (append-only PTA03x codes, `full` verify level):

  PTA030 — cyclic def-use dependency.  A forward reference (op reads a
    name only defined later) binds to its future definition, creating a
    back edge; a genuine cycle means NO execution order satisfies the
    def-use relation.
  PTA031 — WAR hazard in SSA terms: a grad op reads a LATER version of a
    forward value than its paired forward op consumed (the versioned
    generalization of PTA011 — works through sub-block writes).
  PTA032 — WAW hazard: a persistable written more than once per step.
    Under donation both writes target the same donated buffer; one update
    is silently lost and replicas may disagree on which.
  PTA033 — collective-order divergence: a zero1 scatter/update/gather
    group whose members are NOT connected by dependency paths.  PTA012
    checks flat-list index order; reordering passes preserve only the
    dependency structure, so a group member reachable by index but not by
    path would float freely and diverge across replicas.
  PTA034 — donation-aliasing race: an op reads a view (alias) of a
    persistable created before the persistable's donated update, after
    that update ran.  The flat name-based PTA010 cannot see it: the view
    has a different name than the donated root.

The graph also exposes topo orders (deterministically seeded variants for
the schedule-equivalence property test), reachability, and per-var live
ranges — the inputs `analysis.schedule` joins with the FLOPs/ring-bytes
cost models to plan collective/compute overlap.
"""

import random

from ..core.framework import Block, OpRole, VarType
from .verifier import COLLECTIVE_OPS, _RUNTIME_VAR_TYPES, op_role, sub_blocks

__all__ = ["Node", "DependencyGraph", "build_graph", "check_hazards",
           "VIEW_OPS", "DATAFLOW_CODES"]

DATAFLOW_CODES = ("PTA030", "PTA031", "PTA032", "PTA033", "PTA034")

# Declared read/write/alias sets per collective op type, a copy of the
# JAX package's ops/collective_ops.py COLLECTIVE_RW (that module is bound to
# its backend). aliases: output slot -> input slot where Out is a VIEW of
# the input buffer — reading the view after the root buffer was updated is
# the PTA034 race.
COLLECTIVE_RW = {
    "all_reduce":         {"reads": ("X",), "writes": ("Out",),
                           "aliases": {}, "pending": "axis_name"},
    "all_gather":         {"reads": ("X",), "writes": ("Out",),
                           "aliases": {}, "pending": "axis_name"},
    "reduce_scatter":     {"reads": ("X",), "writes": ("Out",),
                           "aliases": {}, "pending": "axis_name"},
    "broadcast":          {"reads": ("X",), "writes": ("Out",),
                           "aliases": {}, "pending": "axis_name"},
    "collective_permute": {"reads": ("X",), "writes": ("Out",),
                           "aliases": {}, "pending": "axis_name"},
    "zero1_scatter":      {"reads": ("X",), "writes": ("Out",),
                           "aliases": {"Out": "X"}, "pending": "axis_name"},
    "zero1_gather":       {"reads": ("X",), "writes": ("Out",),
                           "aliases": {"Out": "X"}, "pending": "axis_name"},
    "pipeline_send":      {"reads": ("X",), "writes": ("Out",),
                           "aliases": {}, "pending": "axis_name"},
    "pipeline_recv":      {"reads": ("X",), "writes": ("Out",),
                           "aliases": {}, "pending": "axis_name"},
}

# Plain view-producing ops (Out aliases X) outside the collective set.
VIEW_OPS = {"reshape": ("Out", "X"), "squeeze": ("Out", "X"),
            "unsqueeze": ("Out", "X")}

_ZERO1_SUFFIXES = ("@zero1_rs", "@zero1_shard", "@zero1_upd")


def _alias_pairs(op):
    """(out_name, in_name) pairs where the output is a declared view of
    the input, from COLLECTIVE_RW and the reshape family."""
    pairs = []
    rw = COLLECTIVE_RW.get(op.type)
    if rw:
        for out_slot, in_slot in rw["aliases"].items():
            outs = op.outputs.get(out_slot) or []
            ins = op.inputs.get(in_slot) or []
            if outs and ins and outs[0] and ins[0]:
                pairs.append((outs[0], ins[0]))
    elif op.type in VIEW_OPS:
        out_slot, in_slot = VIEW_OPS[op.type]
        outs = op.outputs.get(out_slot) or []
        ins = op.inputs.get(in_slot) or []
        if outs and ins and outs[0] and ins[0]:
            pairs.append((outs[0], ins[0]))
    return pairs


class Node:
    """One block-0 op in the dependency graph."""

    __slots__ = ("idx", "op", "reads", "writes", "role", "summarized",
                 "collectives")

    def __init__(self, idx, op):
        self.idx = idx
        self.op = op
        self.reads = {}       # name -> version bound at this program point
        self.writes = {}      # name -> version this op creates
        self.role = op_role(op)
        self.summarized = False   # True when sub-blocks were folded in
        self.collectives = []     # [(depth, op_type, out_name)] incl. nested

    def __repr__(self):
        return f"<Node #{self.idx} {self.op.type}>"


def _summarize_sub(block, parent, reads, writes, colls, depth):
    """Collect the names a sub-block tree reads/writes that resolve in the
    parent scope (escape), plus any collectives it issues."""
    for op in block.ops:
        if op.type in COLLECTIVE_OPS:
            o = op.output_arg_names()
            colls.append((depth, op.type, o[0] if o else ""))
        for name in op.input_arg_names():
            if name and name not in block.vars \
                    and parent.has_var_recursive(name):
                reads.add(name)
            elif name and name in block.vars:
                pass  # sub-block local
            elif name and parent.has_var_recursive(name):
                reads.add(name)
        for name in op.output_arg_names():
            if name and name not in block.vars \
                    and parent.has_var_recursive(name):
                writes.add(name)
        for sb in sub_blocks(op):
            sreads, swrites = set(), set()
            _summarize_sub(sb, block, sreads, swrites, colls, depth + 1)
            # names escaping the inner block that are also non-local here
            for name in sreads:
                if name not in block.vars and parent.has_var_recursive(name):
                    reads.add(name)
            for name in swrites:
                if name not in block.vars and parent.has_var_recursive(name):
                    writes.add(name)


class DependencyGraph:
    """SSA def-use graph over a program's global block.

    nodes[i] corresponds to global_block().ops[i]; preds/succs hold
    {neighbor index: set of edge kinds} with kinds drawn from
    {"raw", "war", "waw", "inplace", "donation"}.  Back edges (a RAW edge
    from a later op to an earlier reader, created by forward references)
    make the graph cyclic — detected, never silently dropped.
    """

    def __init__(self, program, feed_names=None):
        self.program = program
        self.block = program.global_block()
        self.feed_names = set(feed_names) if feed_names is not None else None
        self.nodes = []
        self.preds = []   # idx -> {pred idx: kinds}
        self.succs = []   # idx -> {succ idx: kinds}
        # (name, version) -> defining node idx (version >= 1)
        self.def_node = {}
        # (name, version) -> [reader node idxs]
        self.readers = {}
        # view name -> (root name, root version at creation, creator idx)
        self.alias_of = {}
        # persistable name -> [updating node idxs] (donating updates)
        self.updates = {}
        self._versions = {}
        self._build()

    # ---- construction ----------------------------------------------------

    def _external(self, name, first_writer):
        """True when version 0 of `name` exists at step entry."""
        var = self.block.var_recursive(name) \
            if self.block.has_var_recursive(name) else None
        if var is not None and (var.persistable or var.is_data
                                or var.type in _RUNTIME_VAR_TYPES):
            return True
        if self.feed_names is not None:
            return name in self.feed_names
        # feeds unknown: a name no op writes is assumed to be a feed
        return name not in first_writer

    def _edge(self, src, dst, kind):
        if src == dst:
            return
        self.succs[src].setdefault(dst, set()).add(kind)
        self.preds[dst].setdefault(src, set()).add(kind)

    def _build(self):
        gb = self.block
        for i, op in enumerate(gb.ops):
            node = Node(i, op)
            if op.type in COLLECTIVE_OPS:
                o = op.output_arg_names()
                node.collectives.append((0, op.type, o[0] if o else ""))
            self.nodes.append(node)
            self.preds.append({})
            self.succs.append({})

        # fold sub-blocks into their parent node's read/write sets
        sub_reads, sub_writes = {}, {}
        for node in self.nodes:
            sbs = sub_blocks(node.op)
            if not sbs:
                continue
            node.summarized = True
            reads, writes = set(), set()
            for sb in sbs:
                _summarize_sub(sb, gb, reads, writes, node.collectives, 1)
            sub_reads[node.idx], sub_writes[node.idx] = reads, writes

        first_writer = {}
        for node in self.nodes:
            for name in node.op.output_arg_names():
                if name:
                    first_writer.setdefault(name, node.idx)
            for name in sub_writes.get(node.idx, ()):
                first_writer.setdefault(name, node.idx)

        versions = self._versions
        for node in self.nodes:
            i = node.idx
            reads = [n for n in node.op.input_arg_names() if n]
            reads += sorted(sub_reads.get(i, ()))
            writes = [n for n in node.op.output_arg_names() if n]
            writes += sorted(sub_writes.get(i, ()))
            read_set = []
            for name in reads:
                if name in node.reads:
                    continue
                read_set.append(name)
            # ---- reads bind before this op's own writes -------------------
            for name in read_set:
                v = versions.get(name, 0)
                if v == 0 and not self._external(name, first_writer) \
                        and name in first_writer and first_writer[name] > i:
                    # forward reference: the value this op needs is only
                    # produced later — a back edge (cycle candidate)
                    fut = first_writer[name]
                    node.reads[name] = 1
                    self._edge(fut, i, "raw")
                    self.readers.setdefault((name, 1), []).append(i)
                else:
                    node.reads[name] = v
                    if v > 0:
                        self._edge(self.def_node[(name, v)], i, "raw")
                    self.readers.setdefault((name, v), []).append(i)
                # alias shadow-read: reading a view touches its root buffer
                root = self.alias_of.get(name)
                if root is not None:
                    rname, _, _ = root
                    rv = versions.get(rname, 0)
                    self.readers.setdefault((rname, rv), []).append(i)
            # ---- writes -------------------------------------------------
            donating = node.role == OpRole.Optimize \
                or node.op.type == "zero1_gather"
            seen_w = set()
            for name in writes:
                if name in seen_w:
                    continue
                seen_w.add(name)
                vold = versions.get(name, 0)
                var = gb.var_recursive(name) \
                    if gb.has_var_recursive(name) else None
                persist = var is not None and var.persistable
                inplace = name in node.reads
                # anti-dependencies: every reader of the dying version must
                # run before this write
                for r in self.readers.get((name, vold), ()):
                    kinds = {"war"}
                    if donating and persist:
                        kinds.add("donation")
                    for k in kinds:
                        self._edge(r, i, k)
                # output dependency on the previous writer
                if vold > 0:
                    self._edge(self.def_node[(name, vold)], i,
                               "inplace" if inplace else "waw")
                vnew = vold + 1
                versions[name] = vnew
                node.writes[name] = vnew
                self.def_node[(name, vnew)] = i
                if donating and persist:
                    self.updates.setdefault(name, []).append(i)
            # ---- view outputs: remember the root version they froze ------
            for out_name, in_name in _alias_pairs(node.op):
                root = self.alias_of.get(in_name)
                if root is not None:
                    rname, rver, _ = root
                else:
                    rname, rver = in_name, versions.get(in_name, 0)
                var = gb.var_recursive(rname) \
                    if gb.has_var_recursive(rname) else None
                if var is not None and var.persistable:
                    self.alias_of[out_name] = (rname, rver, i)

    # ---- queries ---------------------------------------------------------

    def n_edges(self):
        return sum(len(s) for s in self.succs)

    def edge_kind_counts(self):
        counts = {}
        for s in self.succs:
            for kinds in s.values():
                for k in kinds:
                    counts[k] = counts.get(k, 0) + 1
        return counts

    def cycle_nodes(self):
        """Node indices on at least one cycle (empty when acyclic)."""
        indeg = [len(p) for p in self.preds]
        ready = [i for i, d in enumerate(indeg) if d == 0]
        seen = 0
        while ready:
            u = ready.pop()
            seen += 1
            for v in self.succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if seen == len(self.nodes):
            return []
        return [i for i, d in enumerate(indeg) if d > 0]

    @property
    def has_cycle(self):
        return bool(self.cycle_nodes())

    def topo_order(self, seed=None):
        """One topological order; program order when seed is None (stable
        Kahn, smallest index first), a deterministically shuffled variant
        otherwise.  Raises ValueError on a cyclic graph."""
        rng = random.Random(seed) if seed is not None else None
        indeg = [len(p) for p in self.preds]
        ready = sorted(i for i, d in enumerate(indeg) if d == 0)
        order = []
        while ready:
            if rng is None:
                u = ready.pop(0)
            else:
                u = ready.pop(rng.randrange(len(ready)))
            order.append(u)
            for v in sorted(self.succs[u]):
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
            if rng is None:
                ready.sort()
        if len(order) != len(self.nodes):
            raise ValueError(
                f"graph is cyclic; {len(self.nodes) - len(order)} ops "
                f"unschedulable (see PTA030)")
        return order

    def topo_orders(self, k=3, max_seeds=64):
        """Up to `k` DISTINCT topological orders (first is program order),
        generated from deterministic seeds — the raw material for the
        schedule-equivalence property test."""
        orders = [tuple(self.topo_order())]
        seen = set(orders)
        for seed in range(max_seeds):
            if len(orders) >= k:
                break
            o = tuple(self.topo_order(seed=seed))
            if o not in seen:
                seen.add(o)
                orders.append(o)
        return [list(o) for o in orders]

    def reachable(self, src, dst, kinds=None):
        """True when a dependency path src -> dst exists; `kinds` (a set)
        restricts the walk to edges carrying one of those kinds — e.g.
        {"raw"} asks whether dst actually CONSUMES data src produced, not
        merely whether anti-dependencies order them."""
        if src == dst:
            return True
        stack, seen = [src], {src}
        while stack:
            u = stack.pop()
            for v, ek in self.succs[u].items():
                if kinds is not None and not (ek & kinds):
                    continue
                if v == dst:
                    return True
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return False

    def live_ranges(self):
        """{name: (first_def op idx or None, last_use op idx)} over block
        0, where sub-block uses count against the summarizing parent op."""
        out = {}
        for node in self.nodes:
            for name in node.reads:
                first, last = out.get(name, (None, -1))
                out[name] = (first, max(last, node.idx))
            for name in node.writes:
                first, last = out.get(name, (None, -1))
                out[name] = (node.idx if first is None else first,
                             max(last, node.idx))
        return out

    def collective_nodes(self):
        return [n for n in self.nodes if n.collectives]

    def zero1_groups(self):
        """param name -> {"rs"/"pshard"/"upd"/"gather": node idx},
        discovered through sub-block summaries (a nested member maps to
        its summarizing parent node)."""
        groups = {}
        for node in self.nodes:
            for _, ctype, out_name in node.collectives:
                if ctype == "zero1_scatter":
                    if out_name.endswith("@zero1_rs"):
                        key = out_name[:-len("@zero1_rs")]
                        # grad-shard scatters are keyed by the GRAD name;
                        # strip it so they join their param's group
                        if key.endswith("@GRAD"):
                            key = key[:-len("@GRAD")]
                        groups.setdefault(key, {})["rs"] = node.idx
                    elif out_name.endswith("@zero1_shard"):
                        groups.setdefault(
                            out_name[:-len("@zero1_shard")],
                            {})["pshard"] = node.idx
                elif ctype == "zero1_gather" and out_name:
                    groups.setdefault(out_name, {})["gather"] = node.idx
            for name, _ in node.writes.items():
                if name.endswith("@zero1_upd"):
                    groups.setdefault(
                        name[:-len("@zero1_upd")], {})["upd"] = node.idx
        return groups

    def summary(self):
        kinds = self.edge_kind_counts()
        return {
            "n_nodes": len(self.nodes),
            "n_edges": self.n_edges(),
            "edge_kinds": kinds,
            "n_summarized": sum(1 for n in self.nodes if n.summarized),
            "n_collectives": sum(
                len(n.collectives) for n in self.nodes),
            "n_aliases": len(self.alias_of),
            "has_cycle": self.has_cycle,
            "n_versioned_vars": len(
                {name for name, _ in self.def_node}),
        }


def build_graph(program, feed_names=None):
    return DependencyGraph(program, feed_names=feed_names)


# ---- hazard detection (PTA03x) -------------------------------------------


def check_hazards(program, report, feed_names=None, donate_state=True,
                  graph=None):
    """PTA030-PTA034 over the dependency graph; returns the graph so
    callers (CLI, scheduler) can reuse it."""
    if graph is None:
        graph = build_graph(program, feed_names=feed_names)
    gb = graph.block

    # PTA030: cyclic def-use
    cyc = graph.cycle_nodes()
    if cyc:
        ops_desc = ", ".join(
            f"op#{i}({graph.nodes[i].op.type})" for i in cyc[:6])
        if len(cyc) > 6:
            ops_desc += f", ... {len(cyc) - 6} more"
        report.add(
            "PTA030",
            f"cyclic def-use dependency among {len(cyc)} op(s): "
            f"{ops_desc}; no execution order satisfies it",
            block_idx=0, op_idx=min(cyc),
            op_type=graph.nodes[min(cyc)].op.type)

    # PTA031: grad op reads a later version than its paired forward op
    fwd_reads = {}  # (op type, name) -> [versions read by forward nodes]
    for node in graph.nodes:
        if node.op.type.endswith("_grad"):
            continue
        for name, v in node.reads.items():
            fwd_reads.setdefault((node.op.type, name), []).append(v)
    for node in graph.nodes:
        if node.role != OpRole.Backward \
                or not node.op.type.endswith("_grad"):
            continue
        base = node.op.type[:-5]
        for name, vg in node.reads.items():
            if name.endswith("@GRAD"):
                continue
            vfs = fwd_reads.get((base, name))
            if not vfs:
                continue
            # compare against the LATEST version any forward op of the
            # base type consumed: if the grad sees a version newer than
            # every candidate pairing, the value was overwritten between
            # forward and backward
            vf = max(vfs)
            if vg > vf:
                report.add(
                    "PTA031",
                    f"grad op reads {name!r} at SSA version {vg}, but "
                    f"its paired forward {base!r} op consumed version "
                    f"{vf}; an intervening write overwrote the value "
                    f"backward needs (WAR hazard)",
                    block_idx=0, op_idx=node.idx,
                    op_type=node.op.type, var=name)

    # PTA032: persistable written more than once per step
    writers = {}
    for node in graph.nodes:
        for name in node.writes:
            var = gb.var_recursive(name) \
                if gb.has_var_recursive(name) else None
            if var is not None and var.persistable:
                writers.setdefault(name, []).append(node.idx)
    for name, ws in sorted(writers.items()):
        if len(ws) < 2:
            continue
        desc = ", ".join(
            f"op#{i}({graph.nodes[i].op.type})" for i in ws)
        report.add(
            "PTA032",
            f"persistable {name!r} is written {len(ws)} times per step "
            f"({desc}); under buffer donation the earlier update is lost "
            f"(WAW hazard)",
            block_idx=0, op_idx=ws[1],
            op_type=graph.nodes[ws[1]].op.type, var=name)

    # PTA033: zero1 group members must be linked by dependency paths
    for key, g in sorted(graph.zero1_groups().items()):
        if "upd" not in g:
            continue
        upd = g["upd"]
        for member, label in (("rs", "grad-shard zero1_scatter"),
                              ("pshard", "param-shard zero1_scatter")):
            m = g.get(member)
            if m is not None and not graph.reachable(m, upd, {"raw"}):
                report.add(
                    "PTA033",
                    f"{label} for {key!r} at op#{m} has no data-dependency "
                    f"path to the shard update at op#{upd}; the update "
                    f"does not consume its shard, so a reordering pass "
                    f"could float it freely and replicas would diverge on "
                    f"collective order",
                    block_idx=0, op_idx=m,
                    op_type=graph.nodes[m].op.type, var=key)
        gather = g.get("gather")
        if gather is not None and not graph.reachable(upd, gather, {"raw"}):
            report.add(
                "PTA033",
                f"zero1_gather for param {key!r} at op#{gather} does not "
                f"consume the shard update at op#{upd} (no data-dependency "
                f"path); it would regather a stale shard and collective "
                f"order diverges across replicas",
                block_idx=0, op_idx=gather, op_type="zero1_gather",
                var=key)

    # PTA034: stale view of a donated buffer read after its update
    for node in graph.nodes:
        for name, _ in sorted(node.reads.items()):
            root = graph.alias_of.get(name)
            if root is None:
                continue
            rname, rver, created = root
            for u in graph.updates.get(rname, ()):
                if created < u < node.idx:
                    sev_note = "" if donate_state else \
                        " (donate_state is off here, but the stale view " \
                        "remains)"
                    report.add(
                        "PTA034",
                        f"op reads {name!r}, a view of persistable "
                        f"{rname!r} captured at op#{created} (version "
                        f"{rver}), after op#{u}"
                        f"({graph.nodes[u].op.type}) donated/overwrote "
                        f"the root buffer{sev_note}",
                        block_idx=0, op_idx=node.idx,
                        op_type=node.op.type, var=name)
                    break
    return graph
