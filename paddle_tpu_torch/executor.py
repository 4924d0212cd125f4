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
`program.random_seed`, on either path. A program holding a host op (the
file IO ops of fluid.io) runs on the interpreter and is prepared afresh at
every run, as the JAX package runs such programs eagerly, uncached.
Prepared steps live in a cache.CompileCache (`_prepared`): an LRU under
FLAGS_compile_cache_cap whose eviction drops the entry's captured graphs
with it, and, under FLAGS_compile_cache_dir, a persistent store of
prepared plans that a later process reads instead of running the fusion
pass. FLAGS_verify checks the program to run (analysis.ensure_verified)
when a prepare misses, before anything of it is launched; a program with
a host op, run uncached, is not verified, as the JAX package does not
verify its eager runs. `compile_cache_info()` gives the cache's payload,
which the serving engine reads; `last_prepare` the host seconds of the
last prepare that missed, by part.

`feed` may be a datapipe.DataPipe (anything with next_feed()), as in the
JAX package (paddle_tpu/executor.py:357-370): the run pulls the pipe's
next staged chunk under the monitor's `feed_wait` phase, `iters` defaults
to the pipe's chunk size, and the chunk's transfer-engine markers
(datapipe.pop_markers) are honoured. A feed under a WireSpec keeps its
wire dtype (uint8 pixels) up to the step, which decodes it first
(WireSpec.wrap_step), inside the captured graph on the card; the spec's
fingerprint keys the prepared step and its graph. A program with a host
op decodes at feed time instead. The chunk's stream waits for its copy
(ChunkLease.wait), and after the run the chunk goes back to the feeder's
ring (ChunkLease.release, an event on the run's stream past the last fill
that read it).

The run-time instruments hook in as in the JAX package
(paddle_tpu/executor.py): one monitor.enabled() check a run, a StepRecord
with the phases feed_encode, compile (the prepare, the first eager step
of a prepared program and the capture), dispatch (the replays' or the
interpreter's enqueue time) and fetch_readback, the prepared key marked
hit or miss; FLAGS_monitor_hlo_cost counts the first eager step's FLOPs
(monitor.compile_probe). FLAGS_health adds the grads to the step's
fetches and its stats rows to the step (health/stats.py), so they ride
the captured graph. FLAGS_benchmark waits for the run's last event after
the run, and FLAGS_check_nan_inf checks every op of an eager step, and a
captured step's fetches and written state once after its replays. None
of them waits for the card inside a step.

`run(..., async_fetch=True)` returns one FetchFuture a fetch: the run's
fetches are copied on its stream into pinned host buffers, an event after
them, so the caller can enqueue the next run before reading this one (a
captured step's own fetch tensors are overwritten by its next replay: the
copies are made at run time). FLAGS_debug_nans sends a run to the
interpreter, which traps the first op that writes NaN/Inf
(executor_core.trap_non_finite) before its writes reach the scope; the
flag may flip between runs, and a program goes back to its captured graph
when it is off. Every run passes the resilience hooks of the JAX package:
the hang watchdog armed over the run up to and including the fetch
readback (resilience/watchdog.py), and inside it chaos.on_run("executor")
before anything of the run is touched.
"""

import base64
import json
import sys
import time
import weakref

import numpy as np
import torch

from . import amp, analysis, flags, fusion, health, monitor
from . import cache as _cache
from .core import dtypes, executor_core
from .core.framework import Program, Variable, default_main_program
from .core.lod_tensor import LoDTensor
from .core.places import CUDAPlace, device_for
from .core.registry import SeqTensor
from .core.scope import global_scope
from .datapipe.transfer import pull_feed, staged_feed
from .resilience import chaos as _chaos
from .resilience import watchdog as _watchdog
from .trace import costs as _trace_costs

__all__ = ["Executor", "FetchFuture", "as_numpy", "fetch_var"]

flags.define(
    "cuda_graph", bool, True,
    "On a CUDA place, run a step that executor_core.capture_blocker "
    "passes as one replay of a captured CUDA graph. Off: every step goes "
    "through the interpreter, which Executor.step_mode then reports (to "
    "compare the two paths).")
flags.define(
    "donate_feed_buffers", bool, True,
    "Give a staged DataPipe chunk's device ring slot back to its feeder as "
    "soon as the run that read it is enqueued (ChunkLease.release), so the "
    "next transfer refills it. Off: the run keeps the chunk's tensors "
    "readable after run() — the slot leaves the ring and the feeder "
    "allocates a fresh one (debugging). Values are the same either way.")


def as_numpy(value):
    """A fetched tensor (or list of them) as numpy, on the host. numpy has
    no bfloat16: a bf16 value (an activation or mask under amp) comes back
    widened to float32, which holds it exactly. A ragged value (SeqTensor)
    comes back as a LoDTensor (`to_lod_tensor`), as in the reference."""
    if isinstance(value, (list, tuple)):
        return [as_numpy(v) for v in value]
    if isinstance(value, SeqTensor):
        return to_lod_tensor(value)
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.detach().cpu().numpy()


def to_lod_tensor(value):
    """A SeqTensor as a host LoDTensor: its data (padding rows included)
    and the offsets of its lengths. A stacked one (iters=K, lengths
    [K, B]) gives a list of K LoDTensors, one a step."""
    lengths = value.lengths.cpu().numpy()
    if lengths.ndim == 2:
        return [to_lod_tensor(executor_core.step_slice(value, k))
                for k in range(lengths.shape[0])]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).tolist()
    return LoDTensor(as_numpy(value.data), [offsets])


def fetch_var(name, scope=None, return_numpy=True):
    """The value of var `name` in `scope` (the global scope by default):
    numpy, a SeqTensor's flat data, as the JAX package returns it; with
    return_numpy=False the scope's own value."""
    scope = scope or global_scope()
    v = scope.find_var(name)
    if v is None:
        raise ValueError(f"Variable {name!r} is not found in scope")
    if not return_numpy:
        return v
    if isinstance(v, SeqTensor):
        v = v.data
    if isinstance(v, LoDTensor):
        return v.numpy()
    if isinstance(v, torch.Tensor):
        return as_numpy(v)
    return np.asarray(v)


def _pinned_copy(value, stream):
    """`value` (a fetched tensor or SeqTensor) copied into pinned host
    memory on `stream`, without waiting; a CPU value as it is."""
    if isinstance(value, SeqTensor):
        return SeqTensor(_pinned_copy(value.data, stream),
                         _pinned_copy(value.lengths, stream),
                         value.host_lengths)
    if not isinstance(value, torch.Tensor) or value.device.type != "cuda":
        return value
    host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(value, non_blocking=True)
    return host


class FetchFuture:
    """One fetch of a run(async_fetch=True) (the JAX package's
    FetchFuture). The run has been enqueued; its fetch was copied into
    pinned host memory on the run's stream, with an event after the copy.

    value    — the fetch on the device: a tensor of its own, valid after
               later runs (a captured step's fetches are copies)
    done()   — True once the host copy has landed (no blocking)
    result() — wait for the copy and return the host value (numpy, as
               return_numpy=True gives it); cached after the first call
    """

    __slots__ = ("_value", "_host", "_event", "_result")

    def __init__(self, value, host, event):
        self._value = value
        self._host = host
        self._event = event
        self._result = None

    @property
    def value(self):
        return self._value

    def done(self):
        return self._event is None or self._event.query()

    def result(self):
        if self._result is None:
            if self._event is not None:
                self._event.synchronize()
            self._result = as_numpy(self._host)
        return self._result


def fetch_futures(outs, device):
    """A FetchFuture for each of `outs`, the fetches of a run on `device`:
    copied to pinned host memory on the current stream, one event after
    the copies."""
    if device.type != "cuda":
        return [FetchFuture(o, o, None) for o in outs]
    stream = torch.cuda.current_stream(device)
    hosts = [_pinned_copy(o, stream) for o in outs]
    event = torch.cuda.Event()
    event.record(stream)
    return [FetchFuture(o, h, event) for o, h in zip(outs, hosts)]


def _host_lengths(seq):
    """A fed SeqTensor's lengths as numpy where the host has them without
    waiting for the device: its own host copy, or lengths held on the host;
    None for lengths only on a card."""
    if seq.host_lengths is not None:
        return seq.host_lengths
    lengths = seq.lengths
    if isinstance(lengths, torch.Tensor):
        if lengths.device.type != "cpu":
            return None
        lengths = lengths.numpy()
    return np.asarray(lengths, np.int32)


def _has_host_ops(program):
    """Whether an op of `program` is a host op (executor_core.HOST_OPS):
    the program runs on the interpreter, unprepared."""
    return any(op.type in executor_core.HOST_OPS
               for b in program.blocks for op in b.ops)


def _block_touched_names(block):
    names = set()
    for op in block.ops:
        names.update(op.input_arg_names())
        names.update(op.output_arg_names())
    return names


# the FLAGS_verify levels in order: an L2 entry verified at a level covers
# the levels below it
_VERIFY_RANK = {lvl: i for i, lvl in enumerate(analysis.LEVELS)}


def _encode_plan(run_prog, plan):
    """The L2 payload of a prepared step: the program the fusion pass
    rewrote and its FusionPlan's fields, as JSON; both None when the pass
    left the program as it was."""
    return json.dumps({
        "program": run_prog.to_dict() if plan is not None else None,
        "plan": None if plan is None else {
            "chains": plan.chains, "buckets": plan.buckets,
            "skipped": plan.skipped, "n_ops_before": plan.n_ops_before,
            "n_ops_after": plan.n_ops_after,
            "bucket_bytes": plan.bucket_bytes},
    }, sort_keys=True).encode("utf-8")


def _decode_plan(payload):
    """(program to run or None, FusionPlan or None) from an L2 payload."""
    d = json.loads(payload.decode("utf-8"))
    if d["plan"] is None:
        return None, None
    return Program.from_dict(d["program"]), fusion.FusionPlan(**d["plan"])


def _has_reader_ops(program):
    return any(op.type in executor_core.READER_OPS
               for b in program.blocks for op in b.ops)


class _Graph:
    """The captured step of one prepared program in one scope: None until
    the step after its eager warm-up step."""

    def __init__(self, times=None):
        self.warm = False
        self.captured = None
        self.times = times  # the prepare's Executor.last_prepare dict


class _Run:
    """One run of a prepared program: `step(feeds)` runs one of its steps;
    `mode` is its step mode; `written` the persistables it writes; `hplan`
    its HealthPlan or None; `key` and `fingerprint` its prepared key and
    the key's monitor fingerprint, `miss` whether the prepare missed;
    `probe` the compile probe its first eager step runs under, or None.
    Its steps count `compile_s`, the host seconds spent on a prepared
    program's first eager step or on a capture, and `eager_first`, the
    steps that were such a first step; the rest of their time is
    dispatch. `iters` and `t_dispatch` (perf_counter at its first step)
    are set by Executor._run."""

    def __init__(self, mode, written, hplan, key, fingerprint, miss, probe,
                 times=None):
        self.step = None
        self.times = times
        self.mode = mode
        self.written = written
        self.hplan = hplan
        self.key = key
        self.fingerprint = fingerprint
        self.miss = miss
        self.probe = probe
        self.compile_s = 0.0
        self.eager_first = 0
        self.iters = None
        self.t_dispatch = None


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
        # prepared key -> (program to run, FusionPlan or None, step); its
        # hits are cached prepares and replays, its misses prepares and
        # captures
        self._prepared = _cache.CompileCache("executor",
                                             on_evict=self._evicted)
        self._modes = {}   # program id -> "graph" / "interpreter"
        # scope -> {prepared key: _Graph}; a scope that is gone drops its
        # own, and an evicted prepared key its graphs
        self._graphs = weakref.WeakKeyDictionary()
        # host seconds of the last prepare that missed, by part: l2_load,
        # fusion, verify, step_build, then first_step and capture as its
        # first steps run; "level" is "l2" when the plan came from the store
        self.last_prepare = None
        self._stream = None  # side stream of warm-up steps and captures
        # the data-parallel group the steps run over (OpContext.dp): set by
        # the ParallelExecutor that drives this executor; None otherwise
        self.dp = None
        # the digest of the autoshard plan the ParallelExecutor lowered the
        # steps' programs by (parallel/autoshard/lower.py), or None
        self.plan_digest = None
        # program id -> steps run (the health ledger's step index)
        self._step_counter = {}
        # prepared key -> host seconds of its compile work (compile_info)
        self._compile_s = {}

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True, iters=None,
            async_fetch=False):
        """Run the program once — or, with `iters=K`, K steps. For iters,
        `feed` is either a list of K per-step feed dicts or one dict whose
        arrays carry a leading [K] axis; fetches come back stacked with a
        leading [K] axis. `feed` may also be a DataPipe, whose next chunk
        the run pulls (iters defaults to its chunk size; its StopIteration
        propagates when it is exhausted). `async_fetch=True` returns a
        FetchFuture a fetch instead (return_numpy is then ignored).
        `feed_var_name`, `fetch_var_name` and `use_program_cache` are
        accepted for API parity."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        # the ONE per-step monitor flag check; mon stays None when off and
        # every telemetry site below is gated on `mon is not None`
        mon = monitor.step_begin("executor") if monitor.enabled() else None
        feed, iters, pipe = pull_feed(feed, iters, mon)
        with _watchdog.armed("executor"):
            # fault injection (a no-op unless a ChaosMonkey is installed),
            # before the chunk's lease is waited on or released: a retried
            # run finds the feed as it was
            _chaos.on_run("executor")
            outs, done = self._run_fetched(program, scope, feed, fetch_list,
                                           iters, mon, return_numpy,
                                           async_fetch)
        if mon is not None:
            monitor.step_end(mon, iters=done.iters, datapipe=pipe)
        return outs

    def _run_fetched(self, program, scope, feed, fetch_list, iters, mon,
                     return_numpy, async_fetch):
        """The body of run() that the watchdog watches: the run and its
        fetches' readback (futures under async_fetch)."""
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        with staged_feed(feed, self.device) as (feed, wire, keep):
            outs, done = self._run(program, scope, feed, fetch_names, iters,
                                   mon, wire=wire)
            outs = keep(outs)
        if flags.get("benchmark"):
            self._benchmark(done, len(outs))
        if flags.get("check_nan_inf") and done.mode == "graph":
            # per-op blame cannot exist inside one replay: check the
            # fetches and the written state once, after the run
            executor_core.check_values_finite(
                list(zip(fetch_names, outs)) + [
                    (n, scope.find_var(n)) for n in done.written
                    if scope.has_var(n)],
                context=(" after compiled step" if done.iters is None
                         else f" after compiled {done.iters}-step scan"))
        if async_fetch:
            outs = fetch_futures(outs, self.device)
        elif return_numpy:
            if mon is not None:
                with mon.timed("fetch_readback"):
                    outs = as_numpy(outs)
            else:
                outs = as_numpy(outs)
        return outs, done

    def _run(self, program, scope, feed, fetch_names, iters, mon,
             kind="executor", wire=None, verify=None):
        """One run of `program` (K steps with `iters`): (fetch tensors,
        its _Run). The monitor's phases land on `mon` (None: off); health
        records carry `kind`. Feeds that `wire` (a datapipe WireSpec)
        covers are decoded in the step, or at feed time in a program
        with a host op. `verify` is the context FLAGS_verify checks the
        program in ({mesh_axes, zplan, context}; a ParallelExecutor's)."""
        feed = feed if feed is not None else {}
        if isinstance(feed, (list, tuple)) and iters is None:
            iters = len(feed)
        # walked only where it decides something: a wire, or iters
        host = (wire is not None or iters is not None) \
            and _has_host_ops(program)
        if iters is not None and host and _has_reader_ops(program):
            raise ValueError(
                "iters requires a program without reader ops (a reader's "
                "read op runs step by step on the host)")
        eager_wire, wire = (wire, None) if host else (None, wire)
        t_enc = time.perf_counter()
        if iters is None:
            feeds = first = self._feed_values(program, feed, wire,
                                              eager_wire)
        else:
            stacked = self._stack_steps(program, feed, iters, wire,
                                        eager_wire)
            first = {n: executor_core.step_slice(t, 0)
                     for n, t in stacked.items()}
        if mon is not None:
            mon.phase("feed_encode", time.perf_counter() - t_enc)
        tp = time.perf_counter()
        done = self._stepper(program, scope, first, fetch_names, iters,
                             mon, wire, verify)
        prepare_s = time.perf_counter() - tp
        done.iters = iters
        done.t_dispatch = tc = time.perf_counter()
        if iters is None:
            outs = done.step(feeds)
            if done.mode == "graph":
                # the graph's fetch tensors are overwritten by its next
                # replay
                outs = [executor_core.clone_value(t) for t in outs]
        else:
            outs = executor_core.build_multi_step_fn(done.step, iters)(
                stacked)
        if mon is not None:
            call_s = time.perf_counter() - tc
            if done.times is not None and done.times.get("level") == "l2":
                # warm start: the plan read from FLAGS_compile_cache_dir
                mon.phase("cache_load", prepare_s)
                prepare_s = 0.0
            if done.miss or done.compile_s:
                compile_s = prepare_s + done.compile_s
                mon.phase("compile", compile_s)
                total = self._compile_s[done.key] = \
                    self._compile_s.get(done.key, 0.0) + compile_s
                monitor.record_compile(done.fingerprint, wall_s=total)
            if (iters or 1) > done.eager_first:
                mon.phase("dispatch", call_s - done.compile_s)
        step0 = self._step_counter.get(id(program), 0)
        self._step_counter[id(program)] = step0 + (iters or 1)
        if done.hplan is not None:
            stats = outs.pop()
            health.on_step(step0, iters, stats, fetch_names, outs, mon=mon,
                           kind=kind, labels=done.hplan.labels)
        return outs, done

    def _benchmark(self, done, n_fetches):
        """FLAGS_benchmark: wait for the run's last event (never inside a
        capture: the run has returned), then set the gauge and histogram
        of its wall time from the first dispatch and print it with the
        card's peak memory, as the JAX package does."""
        mem = ""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
            peak = torch.cuda.max_memory_allocated(self.device)
            mem = f" peak_hbm={peak / 1e6:.1f}MB"
        reg = monitor.registry()
        g = reg.gauge("benchmark_run_ms",
                      help="FLAGS_benchmark fenced wall time per run")
        g.set((time.perf_counter() - done.t_dispatch) * 1000.0)
        reg.histogram("benchmark_run_ms_hist",
                      help="FLAGS_benchmark fenced wall time "
                           "distribution").observe(g.value)
        print(f"[paddle_tpu] run: {g.value:.3f}"
              f" ms (fetches={n_fetches}){mem}", file=sys.stderr)

    def step_mode(self, program):
        """"graph" or "interpreter": how the last run of `program` ran its
        steps (see the module docstring)."""
        return self._modes[id(program)]

    def compile_cache_info(self):
        """The compile cache's payload (cache.CompileCache.info), as the
        JAX package gives it: "entries" counts the prepared steps plus
        their captured CUDA graphs, "hits" the prepares found cached plus
        the replays, "misses" the prepares plus the captures, "evictions"
        the prepared steps FLAGS_compile_cache_cap evicted (with their
        graphs), "l2" the persistent store's counters. The serving engine
        diffs "entries" across its warm-up to count steady-state
        compiles."""
        info = self._prepared.info()
        info["entries"] += sum(
            g.captured is not None for graphs in self._graphs.values()
            for g in graphs.values())
        return info

    def _evicted(self, key, entry):
        """A prepared step the cap evicted: its captured graphs go with it
        (the CapturedStep holds the CUDA graph, its static feed and fetch
        buffers and, through them, its private memory pool)."""
        for graphs in self._graphs.values():
            graphs.pop(key, None)
        self._compile_s.pop(key, None)

    def _l2_extra(self):
        """Device context folded into the persistent-cache digest (the
        mesh is in the prepared key's tail, which the digest takes in)."""
        return (("device", self.device.type, self.device.index),)

    def _mesh_key(self):
        """(axis sizes, backend, autoshard plan digest) of the group the
        steps run over, or () without one: part of the prepared key, so a
        plan rewritten for one world (its collectives, its zero1 layout,
        its tensor-parallel lowering) is never loaded by a rank of
        another, and an elastic resize takes a clean miss."""
        if self.dp is None:
            return ()
        return (tuple((str(a), int(n)) for a, n in self.dp.shape.items()),
                self.dp.backend, self.plan_digest)

    def captured_steps(self, program, scope=None):
        """[CapturedStep] of `program`'s steps captured in `scope` (the
        global scope by default), one per feed signature, at the program's
        current mutation."""
        scope = scope if scope is not None else global_scope()
        return [g.captured for key, g in self._graphs.get(scope, {}).items()
                if key[0] == id(program) and key[1] == program._mutation
                and g.captured is not None]

    # ------------------------------------------------------------------
    def _to_device(self, value, var):
        """A feed value on the device: a LoDTensor with a LoD becomes a
        SeqTensor (data, int32 lengths, and the lengths as numpy for the
        step's cap checks), a SeqTensor moves as it is; the data takes the
        var's declared dtype."""
        if isinstance(value, LoDTensor):
            if value.lod():
                offs = value.last_level_offsets()
                lengths = np.diff(np.asarray(offs)).astype(np.int32)
                value = SeqTensor(value.numpy(), lengths, lengths)
            else:
                value = value.numpy()
        if isinstance(value, SeqTensor):
            return SeqTensor(self._to_device(value.data, var),
                             self._tensor(value.lengths).to(torch.int32),
                             _host_lengths(value))
        t = self._tensor(value)
        if var is not None and var.dtype is not None:
            t = t.to(dtypes.to_torch(var.dtype))
        return t

    def _tensor(self, value):
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)

    def _feed_values(self, program, feed, wire=None, eager_wire=None):
        """Feed values on the device. A dense feed that `wire` covers keeps
        its wire dtype (the step decodes it); one that `eager_wire` covers
        is decoded here."""
        gb = program.global_block()
        vals = {}
        for n, v in feed.items():
            var = gb.vars.get(n)
            dense = not isinstance(v, (SeqTensor, LoDTensor))
            if dense and wire is not None and n in wire:
                vals[n] = self._tensor(v)
                continue
            if dense and eager_wire is not None and n in eager_wire:
                v = eager_wire[n].decode(
                    self._tensor(v), var.dtype if var is not None else None)
            vals[n] = self._to_device(v, var)
        return vals

    def _stack_steps(self, program, feed, iters, wire=None, eager_wire=None):
        """list of K dicts, or one dict of [K, ...] arrays -> one dict of
        [K, ...] device tensors (a stacked feed moves to the device once).
        Ragged feeds ride too: the K steps' SeqTensors (from
        create_bucketed_seq_tensor, or LoDTensors of one token total) stack
        data and lengths componentwise when they share one shape; a dict
        takes a SeqTensor pre-stacked on both."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if isinstance(feed, (list, tuple)):
            if len(feed) != iters:
                raise ValueError(
                    f"iters={iters} but feed has {len(feed)} step dicts")
            steps = [self._feed_values(program, f, wire, eager_wire)
                     for f in feed]
            return {n: self._stack(n, [s[n] for s in steps], iters)
                    for n in steps[0]}
        for n, v in feed.items():
            if isinstance(v, LoDTensor) and v.lod():
                raise ValueError(
                    f"iters > 1 takes ragged feeds as per-step LIST dicts "
                    f"(bucketed to one shape, see "
                    f"fluid.create_bucketed_seq_tensor); a single "
                    f"pre-stacked LoDTensor ({n!r}) is not supported")
        stacked = self._feed_values(program, feed, wire, eager_wire)
        for n, t in stacked.items():
            if isinstance(t, SeqTensor):
                if t.data.shape[:1] != (iters,) \
                        or t.lengths.shape[:1] != (iters,):
                    raise ValueError(
                        f"stacked SeqTensor feed {n!r} must carry a leading "
                        f"[K={iters}] axis on data and lengths, got "
                        f"{tuple(t.data.shape)} / {tuple(t.lengths.shape)}")
            elif t.ndim == 0 or t.shape[0] != iters:
                raise ValueError(
                    f"feed {n!r} leading axis {tuple(t.shape)[:1]} != iters "
                    f"{iters} (pre-stacked feeds carry [K, ...])")
        return stacked

    @staticmethod
    def _stack(name, vals, iters):
        ragged = [isinstance(v, SeqTensor) for v in vals]
        if not any(ragged):
            return torch.stack(vals)
        if not all(ragged):
            raise ValueError(f"feed {name!r} mixes ragged and dense values "
                             f"across the {iters} steps")
        shapes = {(tuple(v.data.shape), tuple(v.lengths.shape))
                  for v in vals}
        if len(shapes) != 1:
            raise ValueError(
                f"iters > 1 needs ONE static shape per feed, but ragged "
                f"feed {name!r} varies across steps ({sorted(shapes)}); "
                f"bucket-and-pad first (fluid.create_bucketed_seq_tensor)")
        hosts = [v.host_lengths for v in vals]
        return SeqTensor(
            torch.stack([v.data for v in vals]),
            torch.stack([v.lengths for v in vals]),
            None if any(h is None for h in hosts) else np.stack(hosts))

    def _prepare(self, program, feeds, fetch_names, wire=None, mon=None,
                 verify=None):
        """key, (program to run, FusionPlan or None, step), level — cached
        per (program id, mutation, fusion flags, amp policy, feeds' names,
        shapes and dtypes, fetches, health plan, wire spec); level is "l1"
        on a hit, "l2" when the plan came from FLAGS_compile_cache_dir,
        else None. A miss runs the fusion pass (FLAGS_fuse rewrites a
        clone once, and repeat steps reuse it) or reads its result from
        the store, checks the program to run under FLAGS_verify, and
        builds the step. Under a WireSpec the step decodes the covered
        feeds first (WireSpec.wrap_step). Under FLAGS_health the step also
        fetches the grads and returns their stats rows last
        (HealthPlan.wrap_step). `verify` is the check's context (_run)."""
        fuse = flags.get("fuse")
        hplan = health.plan_if_enabled(program)
        specs = tuple(sorted(
            (n, "seq", tuple(t.data.shape), str(t.data.dtype),
             tuple(t.lengths.shape)) if isinstance(t, SeqTensor)
            else (n, tuple(t.shape), str(t.dtype))
            for n, t in feeds.items()))
        key = (id(program), program._mutation, fuse,
               flags.get("fuse_bucket_mb"), amp.fingerprint(), specs,
               tuple(fetch_names),
               ("health", hplan.digest if hplan is not None else None),
               ("wire", wire.fingerprint() if wire is not None else None),
               ("mesh",) + self._mesh_key())
        cache = self._prepared
        hit = cache.get(key, count_miss=False)
        if hit is not None:
            return key, hit, "l1"
        # a program with a host op (save, load, ...) is a one-off, run
        # uncached and unverified, as the JAX package runs it eagerly
        uncached = _has_host_ops(program)
        times = {}
        clock = time.perf_counter
        digest = loaded = None
        if not uncached and cache.l2_enabled():
            t0 = clock()
            digest = cache.l2_digest(program, key[2:],
                                     extra=self._l2_extra())
            loaded = cache.l2_load(digest, _decode_plan, mon=mon)
            times["l2_load"] = clock() - t0
        if loaded is not None:
            (run_prog, plan), meta = loaded
            run_prog = run_prog if run_prog is not None else program
            verified = meta.get("verified", "off")
            times["level"] = "l2"
        else:
            t0 = clock()
            run_prog, plan = program, None
            if fuse:
                run_prog, plan = fusion.apply(
                    program, feed_names=list(feeds), fetch_names=fetch_names)
            times["fusion"] = clock() - t0
            verified = "off"
        level = flags.get("verify")
        # an unknown level ranks above all: ensure_verified names it
        if not uncached and _VERIFY_RANK.get(level, len(_VERIFY_RANK)) \
                > _VERIFY_RANK.get(verified, 0):
            t0 = clock()
            analysis.ensure_verified(
                run_prog, feed_names=list(feeds),
                fetch_names=list(fetch_names),
                donate_state=not flags.get("debug_nans"),
                **(verify or {"context": "executor"}))
            times["verify"] = clock() - t0
            verified = level
        t0 = clock()
        run_plan = health.plan_for(run_prog) if hplan is not None else None
        step = executor_core.build_step_fn(
            run_prog, list(fetch_names) + (
                run_plan.fetch_names if run_plan is not None else []),
            executor_core.written_persistables(run_prog), self.place,
            dp=self.dp)
        if wire is not None:
            gb = program.global_block()
            step = wire.wrap_step(step, var_dtypes={
                n: gb.vars[n].dtype for n in wire
                if n in gb.vars and gb.vars[n].dtype is not None})
        if run_plan is not None:
            step = run_plan.wrap_step(step, len(fetch_names))
        step.hplan = run_plan
        times["step_build"] = clock() - t0
        hit = (run_prog, plan, step)
        if uncached:
            return key, hit, None
        self.last_prepare = times
        cache.misses += 1
        if digest is not None and loaded is None:
            # the counterpart of the JAX package's aot_sink: the plan is
            # stored once, after the prepare that computed it
            cache.l2_put(digest, _encode_plan(run_prog, plan),
                         meta={"verified": verified})
        cache.put(key, hit, mon=mon)
        return key, hit, times.get("level")

    def _stepper(self, program, scope, feeds, fetch_names, iters=None,
                 mon=None, wire=None, verify=None):
        """A _Run whose step(feeds) runs one step of `program` each call,
        on the path its prepared entry chose. `mon` gets the prepared
        key's cache outcome (a program with a host op, run uncached, gets
        kind "executor_eager" instead); on a miss with
        FLAGS_monitor_hlo_cost the first eager step runs under the compile
        probe, which counts `iters` steps' FLOPs from it."""
        key, (run_prog, _, step), level = self._prepare(
            program, feeds, fetch_names, wire, mon, verify)
        mode = self._modes[id(program)] = self._mode_of(step)
        uncached = level is None and _has_host_ops(program)
        # an L2 hit builds and captures its step as a miss does
        miss = level != "l1" and not uncached
        fp = probe = None
        if mon is not None:
            fp = monitor.fingerprint_of(key)
            if uncached:
                mon.kind = "executor_eager"
            else:
                mon.mark_cache(level is not None, fingerprint=fp,
                               level=level)
            if miss:
                _trace_costs.register_program(fp, run_prog)
                if flags.get("monitor_hlo_cost"):
                    probe = monitor.compile_probe(fp, iters or 1)
        done = _Run(mode, executor_core.written_persistables(run_prog),
                    step.hplan, key, fp, miss, probe,
                    self.last_prepare if miss else None)

        def first_step(f):
            """The prepared program's first eager step: compile work,
            under the probe when there is one."""
            t0 = time.perf_counter()
            probe, done.probe = done.probe, None
            if probe is None:
                outs = self._interpret(program, run_prog, step, scope, f)
            else:
                with probe:
                    outs = self._interpret(program, run_prog, step, scope,
                                           f)
            spent = time.perf_counter() - t0
            done.compile_s += spent
            done.eager_first += 1
            if done.times is not None:
                done.times["first_step"] = spent
            return outs

        def interpret(f):
            if done.miss and not done.eager_first:
                return first_step(f)
            return self._interpret(program, run_prog, step, scope, f)

        if mode == "interpreter":
            done.step = interpret
            return done
        graph = self._graphs.setdefault(scope, {}).setdefault(
            key, _Graph(done.times))
        if graph.captured is not None:
            graph.captured.sync_scope(scope)

        def run_step(f):
            # a worker thread's current card is card 0 unless it is set
            if self.device.type != "cuda":
                return run_graph(f)
            with torch.cuda.device(self.device):
                return run_graph(f)

        def run_graph(f):
            if graph.captured is None:
                stream = self._side_stream()
                stream.wait_stream(torch.cuda.current_stream(self.device))
                if not graph.warm:
                    # the first step runs eagerly on the side stream the
                    # capture will use: a real step, after which cuDNN
                    # plans, cuBLAS workspaces and autograd's threads exist
                    with torch.cuda.stream(stream):
                        outs = first_step(f)
                    torch.cuda.current_stream(self.device).wait_stream(
                        stream)
                    graph.warm = True
                    return outs
                t0 = time.perf_counter()
                state_in, written = executor_core.collect_state_names(
                    run_prog, scope)
                graph.captured = executor_core.compile_step_fn(
                    step, scope, state_in, written, f, self._rng(program),
                    stream)
                self._prepared.misses += 1
                spent = time.perf_counter() - t0
                done.compile_s += spent
                if graph.times is not None:
                    graph.times["capture"] = spent
            else:
                self._prepared.hits += 1
            return graph.captured.run(f)

        done.step = run_step
        return done

    def _mode_of(self, step):
        """The path a prepared step takes (module docstring), decided at
        every run, before any capture: FLAGS_debug_nans and FLAGS_cuda_graph
        may flip between runs."""
        if (self.device.type == "cuda" and step.blocker is None
                and flags.get("cuda_graph") and not flags.get("debug_nans")
                and not self._host_collectives()):
            return "graph"
        return "interpreter"

    def _host_collectives(self):
        """Whether the steps' collectives go over gloo (ranks sharing one
        card): gloo's host calls cannot be captured in a CUDA graph."""
        return self.dp is not None and self.dp.backend == "gloo"

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

    def rng_state(self, program):
        """The state of `program`'s random stream on this executor, as a
        checkpoint manifest holds it (JSON): on a card the generator's
        seed and Philox offset, on the CPU its Mersenne Twister state
        (base64)."""
        state = self._rng(program).generator.get_state()
        if self.device.type == "cuda":
            seed, offset = (int(v) for v in state.view(torch.int64))
            return {"device": "cuda", "seed": seed, "offset": offset}
        return {"device": "cpu", "state": base64.b64encode(
            state.numpy().tobytes()).decode("ascii")}

    def set_rng_state(self, program, state):
        """Put `program`'s random stream back in `state` (rng_state's): the
        next step, interpreted or replayed, draws on from there. The
        generator is the one a captured step registered with its graph,
        whose every replay reads its seed and offset."""
        if state.get("device") != self.device.type:
            raise ValueError(
                f"random stream state of a {state.get('device')} run "
                f"cannot seed this executor's {self.device.type} stream")
        if state["device"] == "cuda":
            raw = torch.tensor([state["seed"], state["offset"]],
                               dtype=torch.int64).view(torch.uint8)
        else:
            raw = torch.frombuffer(bytearray(base64.b64decode(
                state["state"])), dtype=torch.uint8)
        self._rng(program).generator.set_state(raw)

    def _interpret(self, program, run_prog, step, scope, feeds):
        """One step through the interpreter, its state read from and
        written back to the scope. A fetch that shares memory with a
        persistable the step wrote comes back as a copy."""
        state_in, written = executor_core.collect_state_names(run_prog, scope)
        mut = {n: scope.find_var(n) for n in state_in if n in written}
        const = {n: scope.find_var(n) for n in state_in if n not in written}
        fetches, new_mut = step(mut, const, feeds, self._rng(program),
                                scope=scope)
        for n in written:
            # a value the step left as it read it goes back to nobody: a
            # pserver's blocks (listen_and_serv) write the scope itself
            if n in new_mut and new_mut[n] is not mut.get(n):
                scope.var(n)
                scope.set_var(n, new_mut[n])
        return executor_core.unshared(
            fetches, [new_mut[n] for n in written if n in new_mut])

    def run_block_eager(self, block, scope):
        """Run one block's ops eagerly against `scope` on this executor's
        place (reference listen_and_serv_op.cc ParallelExecuteBlocks: a
        nested Executor::RunPreparedContext on a sub-block; the JAX
        package's Executor.run_block_eager). Only durable vars are written
        back: persistable ones, or ones already in the scope; a block's
        temporaries (grad.merged) stay out."""
        env = {}
        for n in _block_touched_names(block):
            v = scope.find_var(n)
            if v is not None:
                env[n] = self._to_device(v, None) \
                    if isinstance(v, LoDTensor) else v
        ctx = executor_core.OpContext(self.place, self._rng(block.program),
                                      scope=scope)
        with torch.no_grad():
            executor_core.run_ops(block.ops, env, ctx)
        gb = block.program.global_block()
        for op in block.ops:
            for n in op.output_arg_names():
                if n not in env:
                    continue
                var = block.vars.get(n) or gb.vars.get(n)
                if (var is not None and var.persistable) or \
                        scope.find_var(n) is not None:
                    scope.var(n)
                    scope.set_var(n, env[n])
