"""Iteration-level (continuous) batching: requests join and leave a
RUNNING batch at every model step.

The one-shot batcher (serve/engine.py) owns a request for exactly one
dispatch — fine for fixed-shape inference, pathological for
autoregressive decode: a K-step stream either holds the server for K
dispatches while short requests queue behind it, or the client drives
the loop and eats K round trips. `ContinuousServer` schedules at
iteration granularity instead (Orca-style): each turn of the step loop
admits pending requests into free state slots, gathers every active
slot into one batch, runs ONE model step, scatters the next-state rows
back, and evicts the requests that just produced their last token —
no drain-the-batch barrier anywhere. A short request admitted while a
long stream is mid-decode rides the very next step.

Shapes come from the slot ladder (slots.py): a step over k active
slots pads to the smallest ladder rung >= k, so after start() warms
every (model, rung) pair — its prepared step and, on a card, its
captured CUDA graph — no step ever prepares or captures: the serving
engine's zero-steady-state-capture contract (counted, under the JAX
package's name, in stats()["steady_state_compiles"]), now over slot
counts instead of row counts.

Multi-model: one server hosts N named models, each with its own
Executor (own compile cache), scope, slot bank and SLO target. The
step loop picks the model to service by weighted least-lag: the model
whose time since last service is largest relative to its SLO goes
first, so a 10 ms-SLO model is stepped ~10x as often as a 100 ms one
under contention and a cold model cannot starve a hot one.

A model step:
    feed   = bank.gather(lane_index)          # slot rows, pad=scratch
    outs   = exe.run(program, feed, fetches,  # the rung's captured graph
                     return_numpy=False)      # fetches stay on the card
    bank.scatter(lane_index, next_state)      # state feeds round-trip
    evict slots whose step counter hit the request's K

Only the n_out output fetches travel to the host. Gather/scatter move
rows verbatim, so a K-step decode through the running batch is bitwise
identical to the same request replayed solo through a plain Executor at
the same rung (one live row, the rest the bank's zero pad rows) — the
decode-parity test pins this with a one-rung ladder (slot_buckets=(R,)).
Across rungs the port is not bitwise: torch's matmul on the CPU, and
cuBLAS on a card, may give one row other bits at another row count
(ROADMAP §3), where the JAX package's XLA kernels do not.

The step loop runs on a thread of its own. Captures happen in start(),
in the caller's thread, before the loop starts; the loop only replays
(captures are thread-local: executor_core.CapturedStep).

A port of the JAX package's paddle_tpu/serve/continuous/scheduler.py.
"""

import threading
import time
from collections import deque

import numpy as np

from ... import monitor
from ...core.framework import Program, Variable
from ...core.scope import Scope
from ...executor import Executor, as_numpy
from ...trainer import check_and_get_place
from ..buckets import bucket_for
from ..engine import (SERVE_MS_BUCKETS, ServeError, ServerClosed,
                      ServerDraining, ServerOverloaded, UnknownModel,
                      _resolve)
from .interop import InterOpRunner, independent_branches
from .slots import SlotBank

__all__ = ["ContinuousConfig", "ContinuousServer"]


class ContinuousConfig:
    """Tuning knobs for one ContinuousServer.

    max_slots        decode state slots per model — the widest step batch
                     and the cap on concurrently-decoding requests.
    slot_buckets     explicit slot ladder; None = powers of two.
    max_pending      admission bound on queued-but-unslotted requests per
                     model (ServerOverloaded beyond it). None = 8x slots.
    max_steps        hard cap on any request's step count.
    default_slo_ms   SLO for models that don't declare one; also the
                     least-lag weight for those models.
    idle_wait_ms     step-loop sleep when no model has work.
    """

    def __init__(self, max_slots=8, slot_buckets=None, max_pending=None,
                 max_steps=4096, default_slo_ms=100.0, idle_wait_ms=2.0):
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.slot_buckets = slot_buckets
        self.max_pending = (8 * self.max_slots if max_pending is None
                            else int(max_pending))
        self.max_steps = int(max_steps)
        self.default_slo_ms = float(default_slo_ms)
        self.idle_wait_ms = float(idle_wait_ms)


class _CRequest:
    __slots__ = ("feed", "steps", "seed", "future", "t_submit", "t_join")

    def __init__(self, feed, steps, seed):
        from concurrent.futures import Future

        self.feed = feed
        self.steps = steps
        self.seed = seed
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.t_join = None


class _Model:
    """One hosted model: program + executor + scope + slot bank + SLO."""

    def __init__(self, name, program, feed_names, fetch_list, state,
                 place, scope, slo_ms, rng_feed, interop, config):
        if not isinstance(program, Program):
            raise TypeError("program must be a Program")
        self.name = name
        self.program = program
        self.place = place
        self.scope = scope if scope is not None else Scope()
        self.exe = Executor(place)
        self.slo_ms = slo_ms
        self.rng_feed = rng_feed
        self.config = config
        gb = program.global_block()
        self.feed_names = list(feed_names)
        self._feed_vars = {n: gb.var(n) for n in self.feed_names}
        if rng_feed is not None and rng_feed not in self._feed_vars:
            raise ValueError(f"rng_feed {rng_feed!r} not in feed_names")
        # output fetches (the per-step token row the prefix accumulates)
        self.out_vars = [v if isinstance(v, Variable) else gb.var(str(v))
                         for v in fetch_list]
        out_names = [v.name for v in self.out_vars]
        # state map: feed name -> fetch name round-tripped each step
        self.state = dict(state or {})
        for fn, gn in self.state.items():
            if fn not in self._feed_vars:
                raise ValueError(f"state feed {fn!r} not in feed_names")
            if not gb.has_var_recursive(gn):
                raise ValueError(f"state fetch {gn!r} not in program")
        # combined fetch list: outputs first, then state fetches that
        # are not already outputs
        self.fetch_vars = list(self.out_vars)
        for gn in self.state.values():
            if gn not in out_names and gn not in \
                    [v.name for v in self.fetch_vars]:
                self.fetch_vars.append(gb.var(gn))
        self._fetch_pos = {v.name: i for i, v in enumerate(self.fetch_vars)}
        self.n_out = len(self.out_vars)
        # the bank holds EVERY feed var except the host-computed rng key
        specs = {}
        for n in self.feed_names:
            if n == rng_feed:
                continue
            specs[n] = (self._example_shape(n), self._feed_dtype(n))
        self.bank = SlotBank(config.max_slots, specs,
                             slot_buckets=config.slot_buckets, place=place)
        self.pending = deque()
        self.runner = None
        if interop:
            groups = independent_branches(
                program, self.feed_names,
                [v.name for v in self.fetch_vars])
            if len(groups) > 1:
                self.runner = InterOpRunner(
                    self.exe, program, self.scope, self.fetch_vars,
                    groups, gauge_label=f"interop:{name}")
        self.last_service_t = None
        self.steps_total = 0
        self.warm_entries = 0
        # per-model tallies next to the process-global registry series
        # (same idiom as Server._own)
        self._own = {n: monitor.Counter(n) for n in
                     ("requests", "rejected", "completed",
                      "slo_violations")}
        self._own_request_ms = monitor.Histogram(
            f"serve_request_ms[{name}]", buckets=SERVE_MS_BUCKETS)

    # mirrors Server's shape helpers so serve/http._json_feed can build
    # feeds against a resolved model exactly like against a Server
    def _example_shape(self, name):
        var = self._feed_vars[name]
        shape = list(var.shape or [])[1:]
        return tuple(1 if (d is None or d < 0) else int(d) for d in shape)

    def _feed_dtype(self, name):
        return self._feed_vars[name].dtype or "float32"

    def normalize_row(self, feed):
        """One example per request — a continuous slot holds ONE
        sequence. Accepts the example shaped like the feed var minus the
        batch axis, or with a leading axis of exactly 1."""
        if not isinstance(feed, dict):
            raise ValueError("feed must be a dict of {feed_name: array}")
        out = {}
        for n in self.feed_names:
            if n == self.rng_feed:
                continue
            if n not in feed:
                raise ValueError(f"feed missing [{n!r}]")
            shape, dtype = self._example_shape(n), self._feed_dtype(n)
            v = np.asarray(feed[n])
            if v.shape == (1,) + shape:
                v = v[0]
            elif v.shape != shape:
                raise ValueError(
                    f"feed {n!r} shape {v.shape} matches neither one "
                    f"example {shape} nor [1, *example]")
            out[n] = v.astype(dtype) if str(v.dtype) != dtype else v
        extra = [n for n in feed
                 if n not in self._feed_vars or n == self.rng_feed]
        if extra:
            raise ValueError(f"unknown feed names {extra}")
        return out

    def cache_entries(self):
        return self.exe.compile_cache_info()["entries"]

    def run_step(self, feed):
        """Device tensors in fetch_vars order for one warmed step."""
        if self.runner is not None:
            return self.runner.run(feed)
        return self.exe.run(self.program, feed=feed,
                            fetch_list=self.fetch_vars, scope=self.scope,
                            return_numpy=False)

    def queue_depth(self):
        return len(self.pending) + len(self.bank.active_slots())


class ContinuousServer:
    """N named models, one iteration-level step loop.

        srv = ContinuousServer(place=fluid.CPUPlace())
        srv.add_model("chat", prog, ["x"], [y], state={"x": y.name},
                      slo_ms=50.0)
        srv.start()                          # warms every (model, rung)
        fut = srv.submit({"x": row}, model="chat", steps=16)
        tokens, = fut.result()               # [16, *out_shape]
        srv.stop()

    submit() takes ONE example per request (a slot holds one sequence);
    the Future resolves to per-fetch arrays stacked over the K steps.
    steps=1 is plain one-shot inference through the same machinery.
    """

    is_continuous = True

    def __init__(self, place=None, config=None):
        self.place = check_and_get_place(place)
        self.config = config or ContinuousConfig()
        self.models = {}
        self.default_model = None
        self._cond = threading.Condition()
        self._thread = None
        self._stop_flag = False
        self._ready = False
        self._draining = False
        self._drained = threading.Event()

    # -- model registry --------------------------------------------------
    def add_model(self, name, program, feed_names, fetch_list, state=None,
                  slo_ms=None, scope=None, rng_feed=None, interop=False):
        """Host `name` on this server. `state` maps feed name -> fetch
        name round-tripped between steps; feeds not in `state` are
        static per-request conditioning. Must be called before start()."""
        if self._ready or self._thread is not None:
            raise ServeError("add_model() must precede start()")
        if name in self.models:
            raise ServeError(f"model {name!r} already hosted")
        m = _Model(str(name), program, feed_names, fetch_list, state,
                   self.place, scope,
                   float(slo_ms) if slo_ms is not None
                   else self.config.default_slo_ms,
                   rng_feed, interop, self.config)
        self.models[m.name] = m
        if self.default_model is None:
            self.default_model = m.name
        return m

    def resolve_model(self, name=None):
        """-> the hosted _Model; UnknownModel on a name this server does
        not host (the HTTP 404 path)."""
        if not self.models:
            raise ServeError("no models hosted (call add_model first)")
        if name is None:
            return self.models[self.default_model]
        m = self.models.get(str(name))
        if m is None:
            raise UnknownModel(
                f"unknown model {name!r}; hosting "
                f"{sorted(self.models)}")
        return m

    # -- lifecycle -------------------------------------------------------
    def start(self, warm=True, loop=True):
        """Warm every (model, slot-rung) step plus the bank's
        gather/scatter shapes, then start the step loop. After this no
        admissible step prepares or captures. `loop=False` skips the
        background thread: the caller drives step_once() instead — tests
        and drills use it to make join/leave ordering deterministic."""
        if self._ready:
            raise ServeError("server already started")
        if self._stop_flag:
            raise ServerClosed("server was stopped")
        if not self.models:
            raise ServeError("no models hosted (call add_model first)")
        for m in self.models.values():
            if warm:
                self._warm_model(m)
            m.warm_entries = m.cache_entries()
        self._ready = True
        if loop:
            self._thread = threading.Thread(target=self._loop,
                                            name="serve-continuous",
                                            daemon=True)
            self._thread.start()
        self._gauge("serve_ready").set(1)
        return self

    def _warm_model(self, m):
        """Each rung's step until it is what every later step of that rung
        replays: once, and on a card a second time, which captures the
        rung's CUDA graph (the first runs eagerly; the interop runner
        warms each branch the same way)."""
        t0 = time.perf_counter()
        m.bank.warm()
        for b in m.bank.rungs:
            idx = np.full(b, m.bank.scratch, dtype=np.int32)
            feed = m.bank.gather(idx)
            if m.rng_feed is not None:
                feed[m.rng_feed] = m.bank.rng_rows(idx)
            if m.runner is not None:
                m.runner.warm(feed)
            else:
                graphs = len(m.exe.captured_steps(m.program, m.scope))
                self._warm_run(m, feed)
                if m.exe.step_mode(m.program) == "graph":
                    self._warm_run(m, feed)
                    if len(m.exe.captured_steps(m.program, m.scope)) \
                            != graphs + 1:
                        raise ServeError(
                            f"model {m.name!r}: rung {b} ran in graph mode "
                            f"but no CUDA graph was captured")
            if m.state:
                m.bank.scatter(idx, {fn: m.bank.gather(idx)[fn]
                                     for fn in m.state})
        self._gauge("serve_warmup_ms", model=m.name,
                    help="slot-rung warm-up (run and capture) wall "
                         "time").set((time.perf_counter() - t0) * 1000.0)

    @staticmethod
    def _warm_run(m, feed):
        for o in m.exe.run(m.program, feed=feed, fetch_list=m.fetch_vars,
                           scope=m.scope, return_numpy=False):
            as_numpy(o)  # fence: the step ran NOW

    def __enter__(self):
        if not self._ready:
            self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        return False

    def ready(self):
        return self._ready and not self._stop_flag and not self._draining

    def draining(self):
        return self._draining and not self._stop_flag

    def state(self):
        if self._stop_flag:
            return "stopped"
        if self._draining:
            return "draining"
        if self._ready:
            return "serving"
        return "created"

    def drain(self, timeout=30.0):
        """Lame-duck: stop admitting, finish every pending and in-slot
        request (each to its full K steps), then stop clean."""
        if self._stop_flag:
            return True
        if not self._ready:
            raise ServeError("server not started")
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        self._gauge("serve_draining").set(1)
        if self._thread is None:
            # loopless (step_once-driven) mode: run the backlog down
            # inline — same semantics, synchronous
            deadline = time.perf_counter() + float(timeout)
            while self._has_work() and time.perf_counter() < deadline:
                self.step_once()
            ok = not self._has_work()
            if ok:
                self._drained.set()
        else:
            ok = self._drained.wait(timeout=float(timeout))
        if ok:
            with self._cond:
                self._stop_flag = True
                self._ready = False
                self._cond.notify_all()
            t = self._thread
            if t is not None:
                t.join(timeout=10.0)
            monitor.registry().counter(
                "serve_drains_total",
                help="lame-duck drains completed").inc()
        self._gauge("serve_draining").set(0)
        self._gauge("serve_ready").set(0)
        return ok

    def stop(self):
        """Stop now: fail pending and in-slot requests with
        ServerClosed, join the loop."""
        with self._cond:
            if self._stop_flag:
                return
            self._stop_flag = True
            self._ready = False
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
        for m in self.models.values():
            while m.pending:
                _resolve(m.pending.popleft().future,
                         exc=ServerClosed("server stopped"))
            for slot in list(m.bank.active_slots()):
                req = m.bank.requests[slot]
                if req is not None:
                    _resolve(req.future,
                             exc=ServerClosed("server stopped"))
                m.bank.release(slot)
        self._gauge("serve_ready").set(0)

    # -- request path ----------------------------------------------------
    def submit(self, feed, model=None, steps=1, seed=0):
        """Enqueue one sequence; the Future resolves to the model's
        output fetches as numpy arrays stacked over the K steps
        ([K, *example])."""
        m = self.resolve_model(model)
        if self._stop_flag:
            raise ServerClosed("server is stopped")
        if self._draining:
            raise ServerDraining("server is draining")
        if not self._ready:
            raise ServeError("server not started (call start() first)")
        steps = int(steps)
        if not 1 <= steps <= self.config.max_steps:
            raise ValueError(
                f"steps must be in [1, {self.config.max_steps}], "
                f"got {steps}")
        vals = m.normalize_row(feed)
        req = _CRequest(vals, steps, int(seed))
        reg = monitor.registry()
        with self._cond:
            if len(m.pending) >= self.config.max_pending:
                m._own["rejected"].inc()
                reg.counter("serve_rejected_total",
                            help="requests rejected by admission "
                                 "control").inc()
                reg.counter("serve_rejected_total",
                            model=m.name).inc()
                raise ServerOverloaded(
                    f"model {m.name!r} pending at "
                    f"{len(m.pending)}/{self.config.max_pending}")
            m.pending.append(req)
            self._cond.notify_all()
        m._own["requests"].inc()
        reg.counter("serve_requests_total",
                    help="requests admitted to the serve queue").inc()
        reg.counter("serve_requests_total", model=m.name).inc()
        self._queue_gauges(m)
        return req.future

    def infer(self, feed, model=None, steps=1, seed=0, timeout=None):
        return self.submit(feed, model=model, steps=steps,
                           seed=seed).result(timeout=timeout)

    # -- step loop -------------------------------------------------------
    def _loop(self):
        while True:
            with self._cond:
                while not self._stop_flag and not self._has_work():
                    if self._draining:
                        self._drained.set()
                        return
                    self._cond.wait(self.config.idle_wait_ms / 1000.0)
                if self._stop_flag:
                    return
            self._admit()
            m = self._pick()
            if m is not None:
                self._step(m)

    def _has_work(self):
        return any(m.pending or m.bank.active_slots()
                   for m in self.models.values())

    def _admit(self):
        """Join protocol: move pending requests into free slots. Runs
        every loop turn, so a request admitted while other slots are
        mid-decode rides the very next step."""
        now = time.perf_counter()
        for m in self.models.values():
            while m.bank.free_slots:
                with self._cond:
                    if not m.pending:
                        break
                    req = m.pending.popleft()
                slot = m.bank.alloc(req, seed=req.seed)
                m.bank.write_row(slot, req.feed)
                req.t_join = now
                self._queue_gauges(m)

    def _pick(self):
        """Weighted least-lag: the model whose time since last service
        is largest relative to its SLO is stepped next."""
        now = time.perf_counter()
        best, best_score = None, None
        for m in self.models.values():
            if not m.bank.active_slots():
                continue
            anchor = m.last_service_t
            if anchor is None:
                anchor = min(
                    (m.bank.requests[s].t_submit
                     for s in m.bank.active_slots()
                     if m.bank.requests[s] is not None),
                    default=now)
            score = ((now - anchor) * 1000.0) / m.slo_ms
            if best_score is None or score > best_score:
                best, best_score = m, score
        return best

    def _step(self, m):
        active = m.bank.active_slots()
        bucket = bucket_for(len(active), m.bank.rungs)
        idx = m.bank.lane_index(bucket)
        feed = m.bank.gather(idx)
        if m.rng_feed is not None:
            feed[m.rng_feed] = m.bank.rng_rows(idx)
        try:
            outs = m.run_step(feed)
            if m.state:
                m.bank.scatter(
                    idx, {fn: outs[m._fetch_pos[gn]]
                          for fn, gn in m.state.items()})
            host = [np.asarray(as_numpy(o)) for o in outs[:m.n_out]]
        except BaseException as e:  # noqa: BLE001 — fail the slots
            for slot in list(active):
                req = m.bank.requests[slot]
                if req is not None:
                    _resolve(req.future, exc=e)
                m.bank.release(slot)
            m.last_service_t = time.perf_counter()
            return
        reg = monitor.registry()
        reg.counter("serve_model_steps_total",
                    help="continuous scheduler steps per model",
                    model=m.name).inc()
        reg.counter("serve_batches_total", help="batches dispatched",
                    bucket=str(bucket)).inc()
        done = time.perf_counter()
        for lane, slot in enumerate(active):
            req = m.bank.requests[slot]
            if req is None:
                continue
            m.bank.append_outputs(slot, [h[lane] for h in host])
            m.bank.steps[slot] += 1
            if m.bank.steps[slot] >= req.steps:
                # leave protocol: eviction on completion frees the slot
                # for the next _admit, mid-stream for everyone else
                result = m.bank.take_prefix(slot)
                m.bank.release(slot)
                if _resolve(req.future, result=result):
                    self._record(m, req, done)
        m.last_service_t = time.perf_counter()
        m.steps_total += 1

    # -- metrics ---------------------------------------------------------
    def _gauge(self, name, help="", **labels):
        return monitor.registry().gauge(name, help=help, **labels)

    def _queue_gauges(self, m):
        rows = m.queue_depth()
        self._gauge("serve_queue_rows",
                    help="rows currently queued").set(
            sum(mm.queue_depth() for mm in self.models.values()))
        self._gauge("serve_queue_rows", model=m.name).set(rows)

    def _record(self, m, req, done):
        reg = monitor.registry()
        total_ms = (done - req.t_submit) * 1000.0
        m._own["completed"].inc()
        m._own_request_ms.observe(total_ms)
        reg.histogram("serve_request_ms",
                      help="submit-to-result request latency",
                      buckets=SERVE_MS_BUCKETS).observe(total_ms)
        reg.histogram("serve_request_ms", buckets=SERVE_MS_BUCKETS,
                      model=m.name).observe(total_ms)
        if m.slo_ms is not None and total_ms > m.slo_ms:
            m._own["slo_violations"].inc()
            reg.counter("serve_slo_violations_total",
                        help="requests exceeding their model's "
                             "slo_ms").inc()
            reg.counter("serve_slo_violations_total",
                        model=m.name).inc()

    # -- visibility ------------------------------------------------------
    def step_once(self):
        """One synchronous turn of the scheduler — admit, pick, step.
        Public so tests and drills drive join/leave deterministically
        (the background loop does exactly this)."""
        self._admit()
        m = self._pick()
        if m is not None:
            self._step(m)
        return m.name if m is not None else None

    def model_stats(self, name):
        m = self.resolve_model(name)
        pct = m._own_request_ms.percentiles(50, 95, 99)
        return {
            "slo_ms": m.slo_ms,
            "queue_rows": m.queue_depth(),
            "pending": len(m.pending),
            "active_slots": len(m.bank.active_slots()),
            "slots": m.bank.capacity,
            "slot_buckets": list(m.bank.rungs),
            "requests": m._own["requests"].value,
            "completed": m._own["completed"].value,
            "rejected": m._own["rejected"].value,
            "steps": m.steps_total,
            "p50_ms": pct[50], "p95_ms": pct[95], "p99_ms": pct[99],
            "slo_violations": m._own["slo_violations"].value,
            "compile_entries": m.cache_entries(),
            "steady_state_compiles": m.cache_entries() - m.warm_entries,
            "interop_branches": (len(m.runner.groups)
                                 if m.runner is not None else 1),
        }

    def stats(self):
        per_model = {n: self.model_stats(n) for n in self.models}
        entries = sum(s["compile_entries"] for s in per_model.values())
        warm = sum(m.warm_entries for m in self.models.values())
        return {
            "ready": self.ready(),
            "state": self.state(),
            "draining": self.draining(),
            "continuous": True,
            "default_model": self.default_model,
            "queue_rows": sum(s["queue_rows"]
                              for s in per_model.values()),
            "requests": sum(s["requests"] for s in per_model.values()),
            "rejected": sum(s["rejected"] for s in per_model.values()),
            "slo_violations": sum(s["slo_violations"]
                                  for s in per_model.values()),
            "p99_ms": max((s["p99_ms"] for s in per_model.values()
                           if s["p99_ms"] == s["p99_ms"]), default=None),
            "compile_entries": entries,
            "steady_state_compiles": entries - warm,
            "models": per_model,
        }
