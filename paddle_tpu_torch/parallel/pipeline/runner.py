"""PipelineRunner: host-driven 1F1B execution of the stage programs.

The counterpart of paddle_tpu/parallel/pipeline/runner.py. The runner
splits each step's feeds into ``n_microbatches`` along axis 0, drives the
per-(stage, phase) sub-programs in the 1F1B event order from
``schedule.schedule_1f1b``, moves boundary values between stages through
their ``@PPIN``/``@PPOUT`` interface vars, accumulates parameter
gradients across microbatches (sum x 1/m, in float32), and finally runs
each stage's optimizer cell once against the shared scope.

Unlike the JAX package's numpy staging, every value stays on the
executor's device as a torch tensor: the feeds move there once a step,
each cell's fetches come back as tensors (`return_numpy=False`) and are
fed to the cells that read them. An interface var keeps the dtype its
producer wrote (under bf16 AMP a var declared float32 may carry bf16):
the cell's var takes that dtype before the cell's first run, so the feed
is not cast. Each cell is a program of its own, run through the port's
Executor (prepared, verified and captured once, then replayed).

dp x pp: with ``parallel_executor=`` (one ParallelExecutor, or an object
whose ``get(stage_program)`` returns the one for a cell, as in the JAX
package) each cell runs through that ParallelExecutor on this rank's
rows. Microbatch mb is rows [mb*B/m, (mb+1)*B/m) of the global batch, as
in the JAX package, and the rank keeps its dp share of each. Boundary
values stay on the rank: nothing is gathered between cells (a ResNet-50
boundary at microbatch 32 is ~25 MB of bf16). The forward cells' `mean`
and batch norm take their global moments over dp; the backward cells
hold no gradient collective, so the microbatches' gradients accumulate
locally (f32, the JAX order), and the optimizer cell all-reduces the
accumulated gradients once a step (or reduce-scatters them under zero1)
before its update. Only the caller's fetches come back as the global
batch.

Executed through a plain Executor the stage boundary ops are identities
(off the mesh), so a pipeline replay is bitwise equal to the same
microbatched loop with ``n_stages=1``, on the card too: the gradients
accumulate in the JAX order, acc = g0; acc = acc + g_i; acc * (1/m).

Per-event times (CUDA events on a card, the host clock on the CPU) feed
``schedule.simulate_schedule`` to report the measured bubble fraction
next to the analytic (p-1)/(m+p-1) bound.
"""

import numpy as np
import torch

from ...core import dtypes
from ...core.framework import GRAD_VAR_SUFFIX
from ...core.scope import global_scope
from ..ring import _Clock
from .partition import PHASE_BWD, PHASE_FWD, PHASE_OPT, partition
from .rewrite import PP_IN_SUFFIX, PP_OUT_SUFFIX, build_stage_programs
from .schedule import analytic_bubble, schedule_1f1b, simulate_schedule

__all__ = ["PipelineRunner"]

_KIND_PHASE = {"F": PHASE_FWD, "B": PHASE_BWD}


def _split_microbatches(feed, m, device):
    """Move every feed value to `device` once and split it into m equal
    chunks along axis 0 (views)."""
    outs = [dict() for _ in range(m)]
    for name, val in feed.items():
        t = val if isinstance(val, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(val))
        if t.ndim == 0 or t.shape[0] % m:
            raise ValueError(
                f"feed {name!r} (shape {tuple(t.shape)}) not splittable "
                f"into {m} microbatches along axis 0")
        t = t.to(device)
        for mb, chunk in enumerate(t.split(t.shape[0] // m)):
            outs[mb][name] = chunk
    return outs


class PipelineRunner:
    """Partition + rewrite + 1F1B-execute one training program.

    The caller runs the startup program into `scope` first; persistable
    state stays there across steps, exactly as with a plain Executor.
    `place` is the Executor's (the card, CUDAPlace(0), unless the caller
    passes another); with `parallel_executor` the cells run on its
    Executor, in its scope (module docstring: dp x pp), and `place` is
    not used."""

    def __init__(self, program, n_stages, loss_name=None, feed_names=(),
                 n_microbatches=1, fetch_names=None, scope=None, plan=None,
                 batch_size=1, parallel_executor=None, check=True,
                 place=None):
        self.n_stages = int(n_stages)
        self.n_microbatches = int(n_microbatches)
        if self.n_stages < 1 or self.n_microbatches < 1:
            raise ValueError("n_stages and n_microbatches must be >= 1")
        self.loss_name = loss_name
        self.feed_names = list(feed_names)
        self.scope = scope if scope is not None else global_scope()
        user_fetches = list(fetch_names or ())
        if loss_name and loss_name not in user_fetches:
            user_fetches.insert(0, loss_name)
        self.plan = plan if plan is not None else partition(
            program, self.n_stages, feed_names=self.feed_names,
            batch_size=batch_size)
        self.stages = build_stage_programs(
            program, self.plan, feed_names=self.feed_names,
            fetch_names=user_fetches, check=check)
        # Executor imported at construction time: executor.py transitively
        # imports the parallel package that owns this module
        from ...executor import Executor

        self._pe = parallel_executor
        if parallel_executor is None:
            self._exe = Executor(place)
        else:
            # the cells' values live on the ParallelExecutors' card
            self._exe = self._pe_of(next(iter(self.stages.values())))._exe
        self._clock = _Clock(self._exe.device)
        self._typed = set()  # cells whose interface dtypes are settled
        self.last_report = None
        from . import register_pipeline  # package registry (late import)
        register_pipeline({
            "stages": self.n_stages,
            "microbatches": self.n_microbatches,
            "digest": self.plan.digest(),
            "bubble_analytic": analytic_bubble(self.n_stages,
                                               self.n_microbatches),
        })

    # -- one sub-program execution ----------------------------------------
    def _adopt_dtypes(self, sp, feed):
        """Before a cell's first run: each interface var it is fed takes
        the dtype of the tensor its producer wrote, so the feed keeps it
        (under AMP a var declared float32 may carry bf16)."""
        key = (sp.stage, sp.phase)
        if key in self._typed:
            return
        gb = sp.program.global_block()
        for n, val in feed.items():
            var = gb.vars.get(n)
            if n in self.feed_names or var is None \
                    or not isinstance(val, torch.Tensor):
                continue
            want = dtypes.canonicalize(val.dtype)
            if var.dtype is None or dtypes.canonicalize(var.dtype) != want:
                var.dtype = want
                sp.program._mutation += 1
        self._typed.add(key)

    def _pe_of(self, sp):
        """The ParallelExecutor that runs cell `sp` (dp x pp)."""
        pe = self._pe
        return pe.get(sp) if callable(getattr(pe, "get", None)) else pe

    def _run_cell(self, sp, feed):
        self._adopt_dtypes(sp, feed)
        if self._pe is not None:
            return self._pe_of(sp)._run_cell(sp.program, feed,
                                             sp.fetch_names)
        vals = self._exe.run(sp.program, feed=feed,
                             fetch_list=sp.fetch_names, scope=self.scope,
                             return_numpy=False)
        return dict(zip(sp.fetch_names, vals))

    def _cell_feed(self, sp, mb_feed, values, mb):
        feed = {}
        for n in sp.data_feeds:
            if n in mb_feed:
                feed[n] = mb_feed[n]
            else:
                feed[n] = values[(n, mb)]
        for n, src in sp.boundary_in.items():
            feed[n + PP_IN_SUFFIX] = values[(n, mb)]
        for n in sp.local_in:
            feed[n] = values[(n, mb)]
        return feed

    def _ready(self, sp, mb_feed, values, mb):
        for n in sp.data_feeds:
            if n not in mb_feed and (n, mb) not in values:
                return False
        for n in sp.boundary_in:
            if (n, mb) not in values:
                return False
        for n in sp.local_in:
            if (n, mb) not in values:
                return False
        return True

    def _store_outputs(self, sp, got, values, mb):
        for n in sp.boundary_out:
            values[(n, mb)] = got[n + PP_OUT_SUFFIX]
        for n in sp.local_out:
            values[(n, mb)] = got[n]

    # -- one optimizer pass against accumulated grads ----------------------
    def _run_opt(self, values):
        m = self.n_microbatches
        inv_m = 1.0 / m  # a float32 multiply: the scalar rounds to f32
        for (stage, phase), sp in sorted(self.stages.items()):
            if phase != PHASE_OPT:
                continue
            feed = {}
            names = (list(sp.data_feeds) + list(sp.boundary_in)
                     + list(sp.local_in))
            for n in names:
                if n.endswith(GRAD_VAR_SUFFIX):
                    acc = values[(n, 0)].float()
                    for mb in range(1, m):
                        acc = acc + values[(n, mb)].float()
                    val = acc * inv_m
                else:
                    val = values[(n, m - 1)]
                if n in sp.boundary_in:
                    feed[n + PP_IN_SUFFIX] = val
                else:
                    feed[n] = val
            self._run_cell(sp, feed)

    # -- the step ----------------------------------------------------------
    def run(self, feed, fetch_list=None):
        """One training step: returns {loss, fetches, bubble_fraction,
        bubble_measured, bubble_analytic, makespan_s, plan} (loss and
        fetches as float32 numpy). `fetch_list` defaults to the fetches
        given at construction."""
        m, p = self.n_microbatches, self.n_stages
        mb_feeds = _split_microbatches(
            {n: feed[n] for n in self.feed_names if n in feed}, m,
            self._exe.device)
        if self._pe is not None:
            # this rank's dp share of each microbatch's rows
            pe = self._pe_of(next(iter(self.stages.values())))
            mb_feeds = [pe._local_feed(f, 0) for f in mb_feeds]
        values = {}            # (var name, mb) -> tensor on the device
        per_mb_fetch = {}      # (fetch name, mb) -> tensor on the device
        owner = {}             # fetch name -> the cell that makes it
        events = schedule_1f1b(p, m)
        pos = [0] * p
        marks = []             # (kind, stage, start mark, end mark)
        total = sum(len(ev) for ev in events)
        ran = 0
        fwd_done = set()
        clock = self._clock
        while ran < total:
            progressed = False
            for s in range(p):
                if pos[s] >= len(events[s]):
                    continue
                kind, mb = events[s][pos[s]]
                sp = self.stages.get((s, _KIND_PHASE[kind]))
                if sp is None:  # stage has no ops in this phase
                    if kind == "F":
                        fwd_done.add((s, mb))
                    pos[s] += 1
                    ran += 1
                    progressed = True
                    continue
                if kind == "B" and (s, mb) not in fwd_done:
                    continue
                if not self._ready(sp, mb_feeds[mb], values, mb):
                    continue
                t0 = clock.mark()
                got = self._run_cell(
                    sp, self._cell_feed(sp, mb_feeds[mb], values, mb))
                marks.append((kind, s, t0, clock.mark()))
                self._store_outputs(sp, got, values, mb)
                for n in sp.user_fetches:
                    per_mb_fetch[(n, mb)] = got[n]
                    owner[n] = sp
                if kind == "F":
                    fwd_done.add((s, mb))
                pos[s] += 1
                ran += 1
                progressed = True
            if not progressed:
                stuck = [(s, events[s][pos[s]]) for s in range(p)
                         if pos[s] < len(events[s])]
                raise RuntimeError(
                    f"pipeline deadlock; stages waiting on {stuck}")
        self._run_opt(values)

        # loss / fetches: mean over microbatches, accumulated in float32
        # exactly like the gradients so an n_stages=1 replay is bitwise
        inv_m = 1.0 / m
        fetches = {}
        for n in sorted({k[0] for k in per_mb_fetch}):
            acc = per_mb_fetch[(n, 0)].float()
            for mb in range(1, m):
                acc = acc + per_mb_fetch[(n, mb)].float()
            acc = acc * inv_m
            if self._pe is not None:
                # a batch-leading fetch comes back as the global batch
                acc = self._pe_of(owner[n])._gathered(
                    owner[n].program, n, acc, 0, None)
            fetches[n] = acc.cpu().numpy()
        loss = fetches.get(self.loss_name) if self.loss_name else None

        # structural bubble: unit-cost simulation of the executed event
        # order (this is what the (p-1)/(m+p-1) bound describes);
        # measured bubble: the same simulation over the cells' times on
        # the device's timeline, which also carry the host's dispatch
        # where the device waits for it
        clock.sync()
        durations = {}
        for kind, s, a, b in marks:
            durations.setdefault((kind, s), []).append(clock.seconds(a, b))
        struct = simulate_schedule(events)
        mean_durs = {k: sum(v) / len(v) for k, v in durations.items()}
        sim = simulate_schedule(events, mean_durs) if mean_durs else struct
        self.last_report = {
            "loss": loss,
            "fetches": fetches,
            "n_stages": p,
            "n_microbatches": m,
            "bubble_fraction": struct["bubble_fraction"],
            "bubble_measured": sim["bubble_fraction"],
            "bubble_analytic": analytic_bubble(p, m),
            "makespan_s": sim["makespan"],
            "plan": self.plan.to_dict(),
        }
        from ... import monitor

        reg = monitor.registry()
        reg.gauge("pipeline_stages",
                  help="pipeline-parallel stage count").set(float(p))
        reg.gauge("pipeline_microbatches",
                  help="1F1B microbatches per step").set(float(m))
        reg.gauge("pipeline_bubble_fraction",
                  help="structural 1F1B bubble fraction of the executed "
                       "schedule").set(float(struct["bubble_fraction"]))
        reg.gauge("pipeline_bubble_measured",
                  help="device-timeline 1F1B bubble fraction (includes "
                       "host dispatch the device waits for)"
                  ).set(float(sim["bubble_fraction"]))
        reg.gauge("pipeline_bubble_analytic",
                  help="analytic 1F1B bubble bound (p-1)/(m+p-1)"
                  ).set(float(analytic_bubble(p, m)))
        return self.last_report
