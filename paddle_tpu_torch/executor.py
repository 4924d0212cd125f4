"""Python Executor (reference python/paddle/fluid/executor.py:181).

run() interprets the program op by op (core/executor_core.py) on the
Place's device: persistable state comes from the Scope, feeds become
tensors on the device, every op's torch kernel runs in program order, and
the persistable vars the program writes go back to the Scope. `iters=K`
runs K such steps over the leading axis of the feeds and stacks the
fetches [K, ...]. With FLAGS_fuse the fusion pass rewrites a clone of the
program once per (program, mutation, feeds, fetches) and that clone runs.
"""

import numpy as np
import torch

from . import flags, fusion
from .core import dtypes, executor_core
from .core.framework import Variable, default_main_program
from .core.lod_tensor import LoDTensor
from .core.places import CUDAPlace, device_for
from .core.scope import global_scope

__all__ = ["Executor", "as_numpy"]


def as_numpy(value):
    if isinstance(value, (list, tuple)):
        return [as_numpy(v) for v in value]
    return value.detach().cpu().numpy()


class Executor:
    """Runs Programs on one Place: the first CUDA card unless the caller
    passes another (CPUPlace() runs on the host). Asking for a CUDA place
    where there is none raises here, at construction."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = device_for(self.place)
        self._step_counter = {}
        self._prepared = {}

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
            outs = self._run_step(program, scope,
                                  self._feed_values(program, feed),
                                  fetch_names)
        else:
            steps = self._split_steps(program, feed, iters)
            per_step = [self._run_step(program, scope, f, fetch_names)
                        for f in steps]
            outs = [torch.stack([s[i] for s in per_step])
                    for i in range(len(fetch_names))]
        return as_numpy(outs) if return_numpy else outs

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

    def _split_steps(self, program, feed, iters):
        """list of K dicts, or one dict of [K, ...] arrays -> K step feeds
        of device tensors (a stacked feed moves to the device once)."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if isinstance(feed, (list, tuple)):
            if len(feed) != iters:
                raise ValueError(
                    f"iters={iters} but feed has {len(feed)} step dicts")
            return [self._feed_values(program, f) for f in feed]
        stacked = self._feed_values(program, feed)
        for n, t in stacked.items():
            if t.ndim == 0 or t.shape[0] != iters:
                raise ValueError(
                    f"feed {n!r} leading axis {tuple(t.shape)[:1]} != iters "
                    f"{iters} (pre-stacked feeds carry [K, ...])")
        return [{n: t[k] for n, t in stacked.items()} for k in range(iters)]

    def _prepare(self, program, feed_names, fetch_names):
        """(program to run, FusionPlan or None, live ops), cached per
        (program id, mutation, fusion flags, feeds, fetches): FLAGS_fuse
        rewrites a clone once, and repeat steps reuse it."""
        fuse = flags.get("fuse")
        key = (id(program), program._mutation, fuse,
               flags.get("fuse_bucket_mb"), tuple(sorted(feed_names)),
               tuple(fetch_names))
        hit = self._prepared.get(key)
        if hit is None:
            run_prog, plan = program, None
            if fuse:
                run_prog, plan = fusion.apply(program, feed_names=feed_names,
                                              fetch_names=fetch_names)
            ops = executor_core.dead_code_eliminate(
                run_prog.global_block().ops,
                list(fetch_names) + executor_core.written_persistables(run_prog))
            hit = (run_prog, plan, ops)
            self._prepared[key] = hit
        return hit

    def _run_step(self, program, scope, feed_vals, fetch_names):
        run_prog, _, ops = self._prepare(program, list(feed_vals),
                                         fetch_names)
        state_in, written = executor_core.collect_state_names(run_prog, scope)
        env = {n: scope.find_var(n) for n in state_in}
        env.update(feed_vals)
        step = self._step_counter.get(id(program), 0)
        self._step_counter[id(program)] = step + 1
        ctx = executor_core.OpContext(
            self.place, executor_core.step_generator(
                self.device, program.random_seed, step))
        with torch.no_grad():
            executor_core.run_ops(ops, env, ctx)
        for n in written:
            if n in env:
                scope.var(n)
                scope.set_var(n, env[n])
        return [executor_core.env_get(env, n) for n in fetch_names]
