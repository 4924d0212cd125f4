"""Python Executor (reference python/paddle/fluid/executor.py:181).

run() executes the program's global block as one step
(core/executor_core.py::build_step_fn): persistable state comes from the
Scope, feeds become tensors on the device, every op's torch kernel runs in
program order, and the persistable vars the program writes go back to the
Scope. Where the step runs is decided once per prepared program, before
anything is captured (`step_mode`):
  * "graph" — a CUDA place and a step with no host op
    (executor_core.capture_blocker): the first step runs eagerly on a side
    stream, the next is captured as a CUDA graph over the scope's own
    tensors (executor_core.compile_step_fn), and every step after is one
    replay of it, written back into the scope tensors in place;
  * "interpreter" — the CPU, a step the rule keeps out of a graph, or
    FLAGS_cuda_graph off: every step interprets the op list in Python.
`iters=K` runs K steps over the leading axis of the feeds
(executor_core.build_multi_step_fn) and stacks the fetches [K, ...]. With
FLAGS_fuse the fusion pass rewrites a clone of the program once per
(program, mutation, feeds, fetches) and that clone runs. Under
`amp.auto_cast()` the ops run in bf16 where the policy says so; the amp
fingerprint is part of every cache key. Random ops draw from one
executor_core.RandomStream per (Executor, program), seeded once from
`program.random_seed`, on either path.
"""

import weakref

import numpy as np
import torch

from . import amp, flags, fusion
from .core import dtypes, executor_core
from .core.framework import Variable, default_main_program
from .core.lod_tensor import LoDTensor
from .core.places import CUDAPlace, device_for
from .core.scope import global_scope

__all__ = ["Executor", "as_numpy"]

flags.define(
    "cuda_graph", bool, True,
    "On a CUDA place, run a step that executor_core.capture_blocker "
    "passes as one replay of a captured CUDA graph. Off: every step goes "
    "through the interpreter, which Executor.step_mode then reports (to "
    "compare the two paths).")


def as_numpy(value):
    """A fetched tensor (or list of them) as numpy, on the host. numpy has
    no bfloat16: a bf16 value (an activation or mask under amp) comes back
    widened to float32, which holds it exactly."""
    if isinstance(value, (list, tuple)):
        return [as_numpy(v) for v in value]
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.detach().cpu().numpy()


class _Graph:
    """The captured step of one prepared program in one scope: None until
    the step after its eager warm-up step."""

    def __init__(self):
        self.warm = False
        self.captured = None


class Executor:
    """Runs Programs on one Place: the first CUDA card unless the caller
    passes another (CPUPlace() runs on the host). Asking for a CUDA place
    where there is none raises here, at construction."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = device_for(self.place)
        # program -> executor_core.RandomStream; a program that is gone
        # drops its own
        self._rngs = weakref.WeakKeyDictionary()
        self._prepared = {}
        self._modes = {}   # program id -> "graph" / "interpreter"
        # scope -> {prepared key: _Graph}; a scope that is gone drops its own
        self._graphs = weakref.WeakKeyDictionary()
        self._stream = None  # side stream of warm-up steps and captures

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True, iters=None):
        """Run the program once — or, with `iters=K`, K steps. For iters,
        `feed` is either a list of K per-step feed dicts or one dict whose
        arrays carry a leading [K] axis; fetches come back stacked with a
        leading [K] axis. `feed_var_name`, `fetch_var_name` and
        `use_program_cache` are accepted for API parity."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed if feed is not None else {}
        if isinstance(feed, (list, tuple)) and iters is None:
            iters = len(feed)
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        if iters is None:
            feeds = self._feed_values(program, feed)
            run_step = self._stepper(program, scope, feeds, fetch_names)
            outs = run_step(feeds)
            if self.step_mode(program) == "graph":
                # the graph's fetch tensors are overwritten by its next replay
                outs = [t.clone() for t in outs]
        else:
            stacked = self._stack_steps(program, feed, iters)
            step0 = {n: t[0] for n, t in stacked.items()}
            run_step = self._stepper(program, scope, step0, fetch_names)
            outs = executor_core.build_multi_step_fn(run_step, iters)(stacked)
        return as_numpy(outs) if return_numpy else outs

    def step_mode(self, program):
        """"graph" or "interpreter": how the last run of `program` ran its
        steps (see the module docstring)."""
        return self._modes[id(program)]

    # ------------------------------------------------------------------
    def _to_device(self, value, var):
        if isinstance(value, LoDTensor):
            if value.lod():
                raise NotImplementedError(
                    "ragged (LoD) feeds wait for the sequence slice of the "
                    "port")
            value = value.numpy()
        if isinstance(value, torch.Tensor):
            t = value.to(self.device)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value)).to(self.device)
        if var is not None and var.dtype is not None:
            t = t.to(dtypes.to_torch(var.dtype))
        return t

    def _feed_values(self, program, feed):
        gb = program.global_block()
        return {n: self._to_device(v, gb.vars.get(n)) for n, v in feed.items()}

    def _stack_steps(self, program, feed, iters):
        """list of K dicts, or one dict of [K, ...] arrays -> one dict of
        [K, ...] device tensors (a stacked feed moves to the device once)."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if isinstance(feed, (list, tuple)):
            if len(feed) != iters:
                raise ValueError(
                    f"iters={iters} but feed has {len(feed)} step dicts")
            steps = [self._feed_values(program, f) for f in feed]
            return {n: torch.stack([s[n] for s in steps]) for n in steps[0]}
        stacked = self._feed_values(program, feed)
        for n, t in stacked.items():
            if t.ndim == 0 or t.shape[0] != iters:
                raise ValueError(
                    f"feed {n!r} leading axis {tuple(t.shape)[:1]} != iters "
                    f"{iters} (pre-stacked feeds carry [K, ...])")
        return stacked

    def _prepare(self, program, feeds, fetch_names):
        """key, (program to run, FusionPlan or None, step), cached per
        (program id, mutation, fusion flags, amp policy, feeds' names,
        shapes and dtypes, fetches): FLAGS_fuse rewrites a clone once, and
        repeat steps reuse it."""
        fuse = flags.get("fuse")
        specs = tuple(sorted((n, tuple(t.shape), str(t.dtype))
                             for n, t in feeds.items()))
        key = (id(program), program._mutation, fuse,
               flags.get("fuse_bucket_mb"), amp.fingerprint(), specs,
               tuple(fetch_names))
        hit = self._prepared.get(key)
        if hit is None:
            run_prog, plan = program, None
            if fuse:
                run_prog, plan = fusion.apply(program, feed_names=list(feeds),
                                              fetch_names=fetch_names)
            step = executor_core.build_step_fn(
                run_prog, fetch_names,
                executor_core.written_persistables(run_prog), self.place)
            hit = (run_prog, plan, step)
            self._prepared[key] = hit
        return key, hit

    def _stepper(self, program, scope, feeds, fetch_names):
        """run_step(feeds) -> fetch tensors, one step of `program` each
        call, on the path its prepared entry chose."""
        key, (run_prog, _, step) = self._prepare(program, feeds, fetch_names)
        mode = self._modes[id(program)] = self._mode_of(step)
        if mode == "interpreter":
            return lambda f: self._interpret(program, run_prog, step, scope,
                                             f)
        graph = self._graphs.setdefault(scope, {}).setdefault(key, _Graph())
        if graph.captured is not None:
            graph.captured.sync_scope(scope)

        def run_step(f):
            if graph.captured is None:
                stream = self._side_stream()
                stream.wait_stream(torch.cuda.current_stream(self.device))
                if not graph.warm:
                    # the first step runs eagerly on the side stream the
                    # capture will use: a real step, after which cuDNN
                    # plans, cuBLAS workspaces and autograd's threads exist
                    with torch.cuda.stream(stream):
                        outs = self._interpret(program, run_prog, step,
                                               scope, f)
                    torch.cuda.current_stream(self.device).wait_stream(
                        stream)
                    graph.warm = True
                    return outs
                state_in, written = executor_core.collect_state_names(
                    run_prog, scope)
                graph.captured = executor_core.compile_step_fn(
                    step, scope, state_in, written, f, self._rng(program),
                    stream)
            return graph.captured.run(f)

        return run_step

    def _mode_of(self, step):
        """The path a prepared step takes (module docstring), decided
        before any capture."""
        if (self.device.type == "cuda" and step.blocker is None
                and flags.get("cuda_graph")):
            return "graph"
        return "interpreter"

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _rng(self, program):
        """The random stream of `program` on this executor, seeded from
        its random_seed at the program's first run."""
        rng = self._rngs.get(program)
        if rng is None:
            rng = self._rngs[program] = executor_core.RandomStream(
                self.device, program.random_seed)
        return rng

    def _interpret(self, program, run_prog, step, scope, feeds):
        """One step through the interpreter, its state read from and
        written back to the scope."""
        state_in, written = executor_core.collect_state_names(run_prog, scope)
        mut = {n: scope.find_var(n) for n in state_in if n in written}
        const = {n: scope.find_var(n) for n in state_in if n not in written}
        fetches, new_mut = step(mut, const, feeds, self._rng(program))
        for n in written:
            if n in new_mut:
                scope.var(n)
                scope.set_var(n, new_mut[n])
        return fetches
