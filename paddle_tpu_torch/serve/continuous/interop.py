"""Opara-style inter-op parallelism for inference programs.

Opara (PAPERS.md: arXiv 2312.10351) observes that an inference graph
usually contains branches with no data dependence on each other —
parallel heads, mixture experts, multi-task towers — and that running
them as one sequential program leaves the overlap on the table. The
dataflow graph (analysis/dataflow.py) already exposes exactly this
structure: two fetch targets whose backward closures over the SSA
def-use edges are disjoint can be dispatched as independent sub-steps.

`independent_branches` partitions a program's fetch targets into such
groups. `InterOpRunner` runs one executor call per group, each on a
CUDA stream of its own: the step the executor prepared for that fetch
list (dead code eliminated down to the branch) replays its captured
graph on the current stream, which is the branch's, so the branches'
device work overlaps; the caller's stream waits for every branch once,
when it reads the results back. Each branch's step is a separate
prepared entry with its own captured graph, so the runner warms every
(branch, shape) pair up front and the zero-steady-state-capture
contract holds unchanged. On the CPU the branches run one after the
other.

Measured overlap is reported through the overlap-efficiency gauge
(`fleet_overlap_efficiency`): the critical branch plays the "compute"
role, the off-critical-path branch time is the "comm" to hide under it.

A port of the JAX package's paddle_tpu/serve/continuous/interop.py.
"""

import time

import torch

from ... import monitor
from ...analysis.dataflow import build_graph
from ...obs.timeline import overlap_efficiency

__all__ = ["independent_branches", "InterOpRunner", "overlap_efficiency"]


def _closure(graph, start):
    """All node indices reachable backward from `start` over preds
    (every edge kind — any ordering constraint couples the branches)."""
    seen = set()
    stack = [start]
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        stack.extend(p for p in graph.preds[i] if p not in seen)
    return seen


def _def_node(graph, name):
    """Index of the node producing the final version of `name`, or None
    when no op writes it (a passthrough feed)."""
    best = None
    for node in graph.nodes:
        if name in node.writes:
            best = node.idx
    return best


def independent_branches(program, feed_names, fetch_names):
    """Partition fetch targets into dataflow-independent groups.

    Returns a list of lists of POSITIONS into `fetch_names`, in first-
    appearance order. Fetches whose backward closures share any op are
    grouped together; a single group means the program has no inter-op
    parallelism to exploit.
    """
    graph = build_graph(program, feed_names=feed_names)
    closures = []
    for name in fetch_names:
        d = _def_node(graph, str(name))
        closures.append(_closure(graph, d) if d is not None else set())
    groups = []  # [(node_set, [positions])]
    for pos, cl in enumerate(closures):
        merged = None
        for g in groups:
            if g[0] & cl:
                if merged is None:
                    g[0].update(cl)
                    g[1].append(pos)
                    merged = g
                else:  # this fetch bridges two groups: fold them
                    merged[0].update(g[0])
                    merged[1].extend(g[1])
                    g[0].clear()
                    g[1].clear()
        if merged is None:
            groups.append([set(cl), [pos]])
    return [sorted(g[1]) for g in groups if g[1]]


def _fence(outs):
    """Wait for `outs` (host copies: the overlap window ends here)."""
    for o in outs:
        if isinstance(o, torch.Tensor):
            o.cpu()


class InterOpRunner:
    """Dispatch a program's independent fetch branches concurrently.

    Drop-in for the single `exe.run(...)` a serving step makes: run()
    returns device tensors aligned with `fetch_vars`, but issues one
    sub-step per branch, each on its own CUDA stream, overlapping their
    device work. `gauge_label` names the fleet_overlap_efficiency series
    this runner reports under.
    """

    def __init__(self, exe, program, scope, fetch_vars, groups,
                 gauge_label="interop"):
        self.exe = exe
        self.program = program
        self.scope = scope
        self.fetch_vars = list(fetch_vars)
        self.groups = [list(g) for g in groups]
        self.gauge_label = gauge_label
        dev = exe.device
        self.streams = ([torch.cuda.Stream(dev) for _ in self.groups]
                        if dev.type == "cuda" else None)
        # per-branch solo cost (ms), measured during warm(); the serial
        # estimate sum(costs) vs the measured overlapped wall time is
        # what the efficiency gauge joins
        self.branch_cost_ms = [None] * len(self.groups)
        self.last_efficiency = None

    @property
    def parallel(self):
        return len(self.groups) > 1

    def _run_branch(self, bi, feed):
        fetches = [self.fetch_vars[i] for i in self.groups[bi]]
        if self.streams is None:
            return self.exe.run(self.program, feed=feed, fetch_list=fetches,
                                scope=self.scope, return_numpy=False)
        stream = self.streams[bi]
        caller = torch.cuda.current_stream(self.exe.device)
        stream.wait_stream(caller)  # the feeds were made on the caller's
        with torch.cuda.stream(stream):
            res = self.exe.run(self.program, feed=feed, fetch_list=fetches,
                               scope=self.scope, return_numpy=False)
        for t in feed.values():  # read on the branch's stream
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(stream)
        for o in res:  # made on the branch's stream, read on the caller's
            if isinstance(o, torch.Tensor):
                o.record_stream(caller)
        return res

    def _join(self):
        if self.streams is not None:
            caller = torch.cuda.current_stream(self.exe.device)
            for s in self.streams:
                caller.wait_stream(s)

    def run(self, feed):
        """Device tensors in fetch_vars order; branches dispatched
        without an intermediate fence, joined on the caller's stream."""
        outs = [None] * len(self.fetch_vars)
        t0 = time.perf_counter()
        parts = [(g, self._run_branch(bi, feed))
                 for bi, g in enumerate(self.groups)]
        self._join()
        for g, res in parts:
            for i, o in zip(g, res):
                outs[i] = o
        if self.parallel and all(c is not None for c in self.branch_cost_ms):
            _fence(outs)  # the overlap window ends here
            self._report((time.perf_counter() - t0) * 1000.0)
        return outs

    def _report(self, measured_ms):
        critical = max(self.branch_cost_ms)
        hidden = sum(self.branch_cost_ms) - critical
        eff = overlap_efficiency(critical, hidden, measured_ms)
        if eff is None:
            return
        self.last_efficiency = eff
        monitor.registry().gauge(
            "fleet_overlap_efficiency",
            help="fraction of off-critical-path work hidden under the "
                 "critical path",
            replica=self.gauge_label).set(eff)

    def warm(self, feed):
        """Prepare and capture every branch at this feed shape and
        (re)measure the per-branch solo cost the efficiency gauge needs.
        Three passes on a card: the first runs eagerly, the second
        captures the branch's graph, the third times its replay (one
        pass prepares and one times on the CPU)."""
        passes = 2 if self.streams is not None else 1
        for bi in range(len(self.groups)):
            for _ in range(passes):
                res = self._run_branch(bi, feed)
                self._join()
                _fence(res)
            t0 = time.perf_counter()
            res = self._run_branch(bi, feed)
            self._join()
            _fence(res)
            self.branch_cost_ms[bi] = (time.perf_counter() - t0) * 1000.0
