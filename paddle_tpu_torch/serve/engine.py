"""Serving engine: dynamic batching onto one captured CUDA graph per
batch bucket.

The card wins throughput when every dispatch is (a) large enough to
amortize the per-dispatch overhead and (b) a shape whose step is already
captured. `Server` provides both: `submit(feed)` enqueues one request
into a thread-safe admission-controlled queue and returns a Future; a
batcher thread coalesces pending requests up to `max_batch` rows or
`max_wait_ms`, pads the coalesced batch to the bucket ladder
(serve/buckets.py), and round-robins the padded batches across replica
executors — one per card — each of which ran every bucket until its step
was a captured CUDA graph before the server reported ready. Workers
replay the bucket's graph, slice each request's rows back out of the
batch result and resolve its Future, stamping queue/pad/dispatch/readback
phase latencies plus p50/p95/p99 SLO tracking into the monitor registry.

Warm-up: the executor runs a feed shape's first step eagerly and captures
the second (executor.py), so `_warmup` runs each (replica, bucket) once,
and again where the executor's step mode is "graph", after which that
bucket's graph must exist. On the CPU (CPUPlace) every step is
interpreted and one run prepares the bucket.

Zero-steady-state-compile contract: after `start()` returns, dispatches
of any admissible batch replay an already-captured graph — asserted by
`stats()["steady_state_compiles"]` staying 0 (it diffs the executors'
compile_cache_info()["entries"], prepared steps plus captured graphs,
across the warm-up). A new key after warm-up — amp toggled, the program
mutated — is a new prepare and capture and counts. It requires the feed
vars' non-batch dims to be fully specified (the usual `layers.data`
case); requests must match those dims exactly.

A port of the JAX package's paddle_tpu/serve/engine.py: the same queue,
batcher, worker, lifecycle and stats; the replicas are cards
(CUDAPlace(i)) and their executors capture CUDA graphs.
"""

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from .. import monitor
from .. import trace as _trace
from ..core.framework import Program, Variable
from ..core.places import CPUPlace, CUDAPlace, device_for
from ..core.scope import Scope, scope_guard
from ..executor import Executor, as_numpy
from ..trainer import check_and_get_place
from .buckets import bucket_for, ladder, pad_rows

__all__ = ["ServeConfig", "Server", "ModelSet", "ServeError",
           "ServerOverloaded", "ServerClosed", "ServerDraining",
           "UnknownModel", "SERVE_MS_BUCKETS"]

# serving latencies live well below training-step scale: extend the
# monitor's default ms ladder downward so sub-ms queue/pad phases and
# single-digit-ms p50s land in resolving buckets instead of one bin
SERVE_MS_BUCKETS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 3.0, 5.0, 7.5, 10.0,
                    15.0, 20.0, 30.0, 50.0, 75.0, 100.0, 200.0, 500.0,
                    1000.0, 2000.0, 5000.0, float("inf"))


def _resolve(future, result=None, exc=None):
    """Resolve `future` if still pending; returns whether it was resolved.

    Clients own the Future and may cancel it (a `result(timeout)` caller
    giving up does exactly that), so a plain set_result/set_exception can
    raise InvalidStateError — which must never escape into the batcher or
    a worker thread."""
    try:
        if future.done():
            return False
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


class ServeError(RuntimeError):
    """Base class for serving-engine errors."""


class ServerOverloaded(ServeError):
    """Admission control rejected the request (queue at max_queue_rows)."""


class ServerClosed(ServeError):
    """The server was stopped before (or while) the request was served."""


class ServerDraining(ServerClosed):
    """The server is lame-duck: finishing queued/in-flight work but no
    longer admitting. Subclasses ServerClosed so every existing "server
    is going away" handler (HTTP 503, router failover) already does the
    right thing; the distinct type lets frontends add the
    `Connection: close` hint."""


class UnknownModel(ServeError):
    """The request named a model this server does not host — the HTTP
    frontend's 404 (deterministic, never retried by the fleet router)."""


class ServeConfig:
    """Tuning knobs for one Server.

    max_batch        largest batch (in rows) one dispatch carries; also
                     the top rung of the bucket ladder.
    max_wait_ms      how long the batcher holds an underfull batch open
                     for more requests before flushing it. The knob is
                     the latency/throughput trade: 0 serves every request
                     solo (lowest latency, worst QPS), larger values fill
                     buckets at light load.
    buckets          explicit bucket ladder (rows); None = powers of two
                     up to max_batch.
    max_queue_rows   admission-control bound on queued rows; submit()
                     raises ServerOverloaded beyond it (bounded
                     backpressure instead of unbounded latency).
                     None = 8 * max_batch.
    replicas         executor replicas the batcher round-robins over, one
                     per card (CUDAPlace(i)); parameters are copied to
                     each replica's card at start(). On a CPUPlace every
                     replica runs on the host.
    dispatch_depth   formed batches allowed in flight per replica before
                     the batcher blocks (keeps the device queue shallow
                     while still overlapping host batching with device
                     compute).
    slo_ms           latency objective; requests slower than this count
                     into serve_slo_violations_total. None = untracked.
    """

    def __init__(self, max_batch=8, max_wait_ms=2.0, buckets=None,
                 max_queue_rows=None, replicas=1, dispatch_depth=2,
                 slo_ms=None):
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.buckets = ladder(self.max_batch, buckets)
        self.max_queue_rows = (8 * self.max_batch if max_queue_rows is None
                               else int(max_queue_rows))
        if self.max_queue_rows < self.max_batch:
            raise ValueError(
                f"max_queue_rows {self.max_queue_rows} < max_batch "
                f"{self.max_batch}: the queue could never fill one batch")
        self.replicas = int(replicas)
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.dispatch_depth = max(1, int(dispatch_depth))
        self.slo_ms = None if slo_ms is None else float(slo_ms)


class _Request:
    __slots__ = ("feed", "rows", "future", "t_submit", "t_picked",
                 "tctx", "tparent")

    def __init__(self, feed, rows):
        self.feed = feed
        self.rows = rows
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.t_picked = None
        # trace identity, pre-allocated at submit() when tracing is on:
        # the batch span links to tctx long before the request span
        # itself is recorded (fan-in attribution survives coalescing)
        self.tctx = None
        self.tparent = None


class _RequestQueue:
    """Row-accounted FIFO with non-blocking admission control."""

    def __init__(self, max_rows):
        self._max_rows = max_rows
        self._dq = deque()
        self._rows = 0
        self._closed = False
        self._sealed = False
        self._cond = threading.Condition()

    @property
    def rows(self):
        with self._cond:
            return self._rows

    @property
    def drained(self):
        """True once sealed AND empty — the batcher's drain-exit signal."""
        with self._cond:
            return self._sealed and not self._dq

    def put(self, req):
        with self._cond:
            if self._closed:
                raise ServerClosed("server is stopped")
            if self._sealed:
                raise ServerDraining("server is draining")
            if self._rows + req.rows > self._max_rows:
                raise ServerOverloaded(
                    f"queue at {self._rows}/{self._max_rows} rows; "
                    f"request of {req.rows} rows rejected")
            self._dq.append(req)
            self._rows += req.rows
            self._cond.notify()

    def get(self, timeout):
        """Next request, or None on timeout (and on close/seal with an
        empty queue — the caller checks the stop/drain flags)."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while not self._dq:
                remaining = deadline - time.perf_counter()
                if self._closed or self._sealed or remaining <= 0:
                    return None
                self._cond.wait(remaining)
            req = self._dq.popleft()
            self._rows -= req.rows
            return req

    def seal(self):
        """Lame-duck admission stop: put() raises ServerDraining, but —
        unlike close() — everything already queued is still handed out,
        so a draining server SERVES its backlog instead of failing it."""
        with self._cond:
            self._sealed = True
            self._cond.notify_all()

    def close(self):
        """Stop admitting; hand back whatever is still queued."""
        with self._cond:
            self._closed = True
            drained = list(self._dq)
            self._dq.clear()
            self._rows = 0
            self._cond.notify_all()
        return drained


class _BoundedQueue:
    """Blocking bounded FIFO for formed batches (stdlib queue.Queue minus
    the task_done bookkeeping; kept tiny so dispatch depth stays visible)."""

    def __init__(self, depth):
        self._dq = deque()
        self._depth = depth
        self._closed = False
        self._cond = threading.Condition()

    def put(self, item):
        with self._cond:
            while len(self._dq) >= self._depth and not self._closed:
                self._cond.wait()
            if self._closed:
                raise ServerClosed("dispatch queue closed")
            self._dq.append(item)
            self._cond.notify_all()

    def get(self):
        """Next item; None once the queue is closed AND drained (in-flight
        batches enqueued before close() are still handed out)."""
        with self._cond:
            while not self._dq and not self._closed:
                self._cond.wait()
            if not self._dq:
                return None
            item = self._dq.popleft()
            self._cond.notify_all()
            return item

    def close(self):
        """Stop accepting items: wakes blocked put() (which then raises
        ServerClosed) and lets get() return None once empty."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self):
        """Pop and return everything still queued (post-join leftovers)."""
        with self._cond:
            items = list(self._dq)
            self._dq.clear()
            self._cond.notify_all()
            return items


class Server:
    """Batched low-latency inference over a (transpiled) inference Program.

        server = serve.Server(program, feed_names, fetch_list,
                              place=fluid.CUDAPlace(0),
                              config=serve.ServeConfig(max_batch=16))
        server.start()                      # captures every bucket
        fut = server.submit({"x": one_example})
        y, = fut.result()
        server.stop()

    submit() accepts one example (arrays shaped like the feed var minus
    the batch axis) or a pre-batched group of rows (leading batch axis,
    up to max_batch); the Future resolves to the fetch list sliced back
    to exactly the submitted rows.
    """

    def __init__(self, program, feed_names, fetch_list, place=None,
                 scope=None, config=None, model=None):
        if not isinstance(program, Program):
            raise TypeError("program must be a Program")
        self.program = program
        # optional model name: when set, queue/latency/SLO series are
        # ALSO emitted with a {model=} label (the unlabeled aggregates
        # stay, so existing dashboards keep working) and stats() carries
        # a per-model block the fleet's SLO-weighted routing reads
        self.model = None if model is None else str(model)
        self.config = config or ServeConfig()
        self.place = check_and_get_place(place)
        self.scope = scope if scope is not None else Scope()
        self.feed_names = list(feed_names)
        self.fetch_list = [v if isinstance(v, Variable) else
                           program.global_block().var(str(v))
                           for v in fetch_list]
        gb = program.global_block()
        self._feed_vars = {}
        for n in self.feed_names:
            self._feed_vars[n] = gb.var(n)
        self._queue = _RequestQueue(self.config.max_queue_rows)
        self._dispatch_queues = []
        self._replicas = []       # [(executor, scope)]
        self._threads = []
        self._rr = 0
        self._stop = False
        self._ready = False
        self._draining = False
        self._batcher_thread = None
        self._warm_entries = 0
        self._step_modes = {}  # bucket -> [step mode of each replica]
        self._lock = threading.Lock()
        # per-server tallies mirrored next to the process-global registry:
        # the registry series are unlabeled and shared, so stats() and
        # latency_percentiles() read these to stay correct when several
        # Servers live in one process
        self._own = {name: monitor.Counter(name) for name in
                     ("requests", "rejected", "rows", "padded_rows",
                      "slo_violations")}
        self._own_request_ms = monitor.Histogram(
            "serve_request_ms", buckets=SERVE_MS_BUCKETS)

    # -- construction helpers -------------------------------------------
    @classmethod
    def from_inference_model(cls, dirname, place=None, config=None):
        """Serve a `save_inference_model` directory."""
        from .. import io as io_mod

        place = check_and_get_place(place)
        scope = Scope()
        exe = Executor(place)
        with scope_guard(scope):
            program, feed_names, fetch_targets = io_mod.load_inference_model(
                dirname, exe)
        return cls(program, feed_names, fetch_targets, place=place,
                   scope=scope, config=config)

    @classmethod
    def from_infer_func(cls, infer_func, param_path, place=None,
                        config=None, transpile=True):
        """Build the inference program like Inferencer does (in test mode:
        batch_norm on its running statistics, dropout off), load params,
        and (by default) run the InferenceTranspiler's numeric folding
        before serving."""
        from .. import io as io_mod
        from .. import unique_name
        from ..core.framework import program_guard
        from ..transpiler import InferenceTranspiler

        place = check_and_get_place(place)
        program = Program()
        with program_guard(program):
            with unique_name.guard():
                targets = infer_func()
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        # the reference Inferencer's clone(for_test=True); the JAX
        # package's serves the layers' training mode
        program = program.clone(for_test=True)
        targets = [program.global_block().var(t.name) for t in targets]
        scope = Scope()
        exe = Executor(place)
        with scope_guard(scope):
            io_mod.load_params(exe, param_path, program)
        if transpile:
            InferenceTranspiler().transpile(program, place, scope=scope)
        gb = program.global_block()
        feed_names = [n for n, v in gb.vars.items()
                      if getattr(v, "is_data", False)]
        return cls(program, feed_names, targets, place=place, scope=scope,
                   config=config)

    # -- lifecycle ------------------------------------------------------
    def start(self, warm=True):
        """Build the replicas, capture every bucket on each, and start the
        batcher/worker threads. The server reports ready only after
        warmup, so the first real request never eats a capture."""
        with self._lock:
            if self._threads:
                raise ServeError("server already started")
            if self._stop:
                raise ServerClosed("server was stopped")
            self._build_replicas()
            if warm:
                self._warmup()
            self._warm_entries = self._cache_entries()
            for i in range(self.config.replicas):
                q = _BoundedQueue(self.config.dispatch_depth)
                self._dispatch_queues.append(q)
                t = threading.Thread(target=self._worker, args=(i, q),
                                     name=f"serve-worker-{i}", daemon=True)
                self._threads.append(t)
            bt = threading.Thread(target=self._batcher, name="serve-batcher",
                                  daemon=True)
            self._batcher_thread = bt
            self._threads.append(bt)
            for t in self._threads:
                t.start()
            self._ready = True
            self._gauge("serve_ready").set(1)
        return self

    def __enter__(self):
        if not self._threads:
            self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        return False

    def ready(self):
        return self._ready and not self._stop and not self._draining

    def state(self):
        """Lifecycle state: created -> serving -> (draining ->) stopped.
        The HTTP /healthz endpoint maps this straight onto health-probe
        answers, so the fleet router can tell lame-duck from dead."""
        if self._stop:
            return "stopped"
        if self._draining:
            return "draining"
        if self._ready:
            return "serving"
        return "created"

    def draining(self):
        return self._draining and not self._stop

    def drain(self, timeout=30.0):
        """Lame-duck shutdown: stop admitting (submit() raises
        ServerDraining), SERVE everything already queued, let workers
        finish every in-flight batch (the _BoundedQueue close/drain
        contract), then stop clean — the zero-dropped-request half of a
        rolling restart. Returns True when fully drained within
        `timeout`, False if threads are still busy (call again, or
        stop() to abort the stragglers)."""
        with self._lock:
            if self._stop:
                return True
            if not self._threads:
                raise ServeError("server not started")
            self._draining = True
        t0 = time.perf_counter()
        deadline = t0 + float(timeout)
        self._gauge("serve_draining",
                    help="1 while the server is lame-duck").set(1)
        # seal, don't close: queued requests are served, not failed
        self._queue.seal()
        bt = self._batcher_thread
        if bt is not None:
            bt.join(max(0.0, deadline - time.perf_counter()))
            if bt.is_alive():
                return False
        # batcher has flushed the backlog; closing lets each worker hand
        # out its remaining in-flight batches and exit on drained+closed
        for q in self._dispatch_queues:
            q.close()
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
            if t.is_alive():
                return False
        # defensive: a worker that died mid-drain may strand a batch
        for q in self._dispatch_queues:
            for item in q.drain():
                self._fail_batch(item[0], ServerDraining("server drained"))
        with self._lock:
            self._stop = True
            self._ready = False
        reg = monitor.registry()
        reg.counter("serve_drains_total",
                    help="lame-duck drains completed").inc()
        self._gauge("serve_drain_duration_ms",
                    help="wall time of the last lame-duck drain").set(
            (time.perf_counter() - t0) * 1000.0)
        self._gauge("serve_draining").set(0)
        self._gauge("serve_ready").set(0)
        return True

    def stop(self):
        """Stop admitting, fail queued requests with ServerClosed, let
        already-dispatched batches finish, and join the threads. Any batch
        a dead or timed-out worker left behind is failed too — no Future
        handed out by submit() is ever stranded unresolved."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
            self._ready = False
        for req in self._queue.close():
            _resolve(req.future, exc=ServerClosed("server stopped"))
        # closing wakes a batcher blocked in put() (it fails that batch)
        # and lets each worker drain its in-flight batches, then exit
        for q in self._dispatch_queues:
            q.close()
        for t in self._threads:
            t.join(timeout=30.0)
        for q in self._dispatch_queues:
            for item in q.drain():
                self._fail_batch(item[0], ServerClosed("server stopped"))
        self._gauge("serve_ready").set(0)

    def _replica_place(self, i):
        """Replica i's device: CUDAPlace(i) walks the cards from the
        server's own (with one card, replicas > 1 raises at the replica's
        Executor: there is no fallback); a CPU server keeps every replica
        on the host place."""
        if isinstance(self.place, CUDAPlace):
            return CUDAPlace(self.place.device_id + i)
        return CPUPlace()

    def _build_replicas(self):
        """Replica 0 serves from the caller's scope; further replicas get
        a scope holding device-local copies of every persistable var (the
        round-robin fan-out — each replica owns one card end to end)."""
        persistables = [
            n for n, v in self.program.global_block().vars.items()
            if v.persistable and self.scope.find_var(n) is not None]
        for i in range(self.config.replicas):
            place = self._replica_place(i)
            exe = Executor(place)
            if i == 0:
                scope = self.scope
            else:
                scope = Scope()
                for n in persistables:
                    scope.set_var(n, self.scope.find_var(n).to(
                        device_for(place), copy=True))
            self._replicas.append((exe, scope))

    def _warmup(self):
        """Run each (replica, bucket) until its step is what every later
        dispatch of that shape replays: once, and on a card a second time,
        which captures the bucket's CUDA graph (the first runs eagerly).
        Raises ServeError when a graph-mode bucket has no graph after."""
        t0 = time.perf_counter()
        for b in self.config.buckets:
            feed = {n: np.zeros((b,) + self._example_shape(n),
                                dtype=self._feed_dtype(n))
                    for n in self.feed_names}
            modes = []
            for i, (exe, scope) in enumerate(self._replicas):
                graphs = len(exe.captured_steps(self.program, scope))
                self._warm_run(exe, scope, feed)
                mode = exe.step_mode(self.program)
                if mode == "graph":
                    self._warm_run(exe, scope, feed)
                    if len(exe.captured_steps(self.program,
                                              scope)) != graphs + 1:
                        raise ServeError(
                            f"replica {i}: bucket {b} ran in graph mode "
                            f"but no CUDA graph was captured")
                modes.append(mode)
            self._step_modes[b] = modes
        self._gauge(
            "serve_warmup_ms",
            help="bucket warm-up (run and capture) wall time at server "
                 "start").set((time.perf_counter() - t0) * 1000.0)

    def _warm_run(self, exe, scope, feed):
        outs = exe.run(self.program, feed=feed, fetch_list=self.fetch_list,
                       scope=scope, return_numpy=False)
        for o in outs:  # fence: the step must have run NOW
            as_numpy(o)

    def step_modes(self):
        """{bucket: [step mode of each replica]} after warm-up: "graph"
        (a captured CUDA graph replays every dispatch of the bucket) or
        "interpreter"."""
        return {b: list(m) for b, m in self._step_modes.items()}

    # -- request path ---------------------------------------------------
    def _example_shape(self, name):
        var = self._feed_vars[name]
        shape = list(var.shape or [])[1:]
        return tuple(1 if (d is None or d < 0) else int(d) for d in shape)

    def _feed_dtype(self, name):
        return self._feed_vars[name].dtype or "float32"

    def _normalize(self, feed):
        """-> ({name: [rows, ...] array}, rows). A value shaped like the
        feed var minus its batch axis counts as one row."""
        if not isinstance(feed, dict):
            raise ValueError("feed must be a dict of {feed_name: array}")
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError(f"feed missing {missing}")
        extra = [n for n in feed if n not in self._feed_vars]
        if extra:
            raise ValueError(f"unknown feed names {extra}")
        rows = None
        out = {}
        for n in self.feed_names:
            var = self._feed_vars[n]
            v = np.asarray(feed[n])
            rank = len(var.shape or [])
            if v.ndim == rank - 1:
                v = v[None, ...]
            elif v.ndim != rank:
                raise ValueError(
                    f"feed {n!r} rank {v.ndim} matches neither one example "
                    f"(rank {rank - 1}) nor a row batch (rank {rank})")
            if var.dtype is not None and str(v.dtype) != var.dtype:
                v = v.astype(var.dtype)
            if rows is None:
                rows = v.shape[0]
            elif v.shape[0] != rows:
                raise ValueError(
                    f"feed {n!r} has {v.shape[0]} rows, others have {rows}")
            out[n] = v
        if rows is None or rows < 1:
            raise ValueError("empty request")
        if rows > self.config.max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch "
                f"{self.config.max_batch}; split it client-side")
        return out, rows

    def resolve_model(self, name=None):
        """-> self when `name` is this server's model (or None);
        UnknownModel otherwise — the single-model end of the multi-model
        HTTP contract."""
        if name is None or name == self.model:
            return self
        raise UnknownModel(
            f"unknown model {name!r}; this server hosts "
            f"{self.model!r}" if self.model else
            f"unknown model {name!r}; this server is unnamed")

    def submit(self, feed, model=None):
        """Enqueue one request; returns a concurrent.futures.Future that
        resolves to the fetch-list arrays sliced to the request's rows.
        Raises ServerOverloaded beyond max_queue_rows (bounded
        backpressure), ServerClosed after stop(), and UnknownModel when
        `model` names something this server does not host."""
        self.resolve_model(model)
        if self._stop:
            raise ServerClosed("server is stopped")
        if self._draining:
            raise ServerDraining("server is draining")
        if not self._ready:
            raise ServeError("server not started (call start() first)")
        vals, rows = self._normalize(feed)
        req = _Request(vals, rows)
        if _trace.enabled():
            # inherit the submitter's context (the HTTP handler's
            # serve.http span) so the whole lifecycle is ONE trace
            req.tparent = _trace.current()
            req.tctx = _trace.new_context(parent=req.tparent)
        reg = monitor.registry()
        try:
            self._queue.put(req)
        except ServerOverloaded:
            self._own["rejected"].inc()
            reg.counter("serve_rejected_total",
                        help="requests rejected by admission control").inc()
            if self.model is not None:
                reg.counter("serve_rejected_total", model=self.model).inc()
            _trace.maybe_dump("server_overloaded")
            raise
        self._own["requests"].inc()
        reg.counter("serve_requests_total",
                    help="requests admitted to the serve queue").inc()
        if self.model is not None:
            reg.counter("serve_requests_total", model=self.model).inc()
        self._set_queue_gauge()
        return req.future

    def infer(self, feed, timeout=None):
        """Blocking convenience: submit + result."""
        return self.submit(feed).result(timeout=timeout)

    # -- batcher / workers ----------------------------------------------
    def _batcher(self):
        held = None
        while True:
            req = held if held is not None else self._queue.get(timeout=0.05)
            held = None
            if req is None:
                # drain exit: the sealed queue is empty and nothing is
                # held — the backlog has been flushed, drain() can close
                # the dispatch queues
                if self._stop or (self._draining and self._queue.drained):
                    return
                continue
            if req.t_picked is None:
                req.t_picked = time.perf_counter()
            batch, rows = [req], req.rows
            # fairness: the batching window is anchored at the OLDEST
            # member's submit time, never re-opened. A request carried
            # over from a previous batch (held) or aged in the queue has
            # already spent its window — it ages AHEAD of fresh arrivals
            # and flushes at once (after a non-blocking greedy fill from
            # the backlog) instead of waiting out a fresh max_wait_ms,
            # which a steady trickle of full buckets could previously
            # impose on a held underfull remainder over and over.
            deadline = req.t_submit + self.config.max_wait_ms / 1000.0
            while rows < self.config.max_batch and not self._stop:
                remaining = deadline - time.perf_counter()
                nxt = self._queue.get(timeout=max(0.0, remaining))
                if nxt is None:
                    break
                if nxt.t_picked is None:
                    nxt.t_picked = time.perf_counter()
                if rows + nxt.rows > self.config.max_batch:
                    held = nxt  # opens the NEXT batch
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._flush(batch, rows)
        # unreachable; stop() drains the queue

    def _flush(self, batch, rows):
        t0 = time.perf_counter()
        bucket = bucket_for(rows, self.config.buckets)
        feed = {}
        for n in self.feed_names:
            parts = [r.feed[n] for r in batch]
            feed[n] = parts[0] if len(parts) == 1 else \
                np.concatenate(parts, axis=0)
        feed = pad_rows(feed, rows, bucket)
        pad_s = time.perf_counter() - t0
        reg = monitor.registry()
        reg.counter("serve_batches_total", help="batches dispatched",
                    bucket=str(bucket)).inc()
        self._own["rows"].inc(rows)
        reg.counter("serve_rows_total", help="request rows served").inc(rows)
        self._own["padded_rows"].inc(bucket - rows)
        reg.counter("serve_padded_rows_total",
                    help="ladder padding rows dispatched").inc(bucket - rows)
        reg.histogram("serve_batch_rows", help="rows per dispatched batch",
                      buckets=self.config.buckets).observe(rows)
        # the batch left the request queue: keep the depth gauge live for
        # /metrics scrapes, not just high-water marks from submit()
        self._set_queue_gauge()
        if self._stop:
            self._fail_batch(batch, ServerClosed("server stopped"))
            return
        q = self._dispatch_queues[self._rr]
        self._rr = (self._rr + 1) % len(self._dispatch_queues)
        try:
            # t0 anchors the serve.pad span; workers tolerate bare
            # 5-tuples (tests construct them directly)
            q.put((batch, feed, bucket, rows, pad_s, t0))
        except ServerClosed as e:
            self._fail_batch(batch, e)

    @staticmethod
    def _fail_batch(batch, exc):
        for r in batch:
            _resolve(r.future, exc=exc)

    def _worker(self, idx, q):
        exe, scope = self._replicas[idx]
        while True:
            item = q.get()
            if item is None:
                return
            batch, feed, bucket, rows, pad_s = item[:5]
            t_pad = item[5] if len(item) > 5 else None
            # fan-in span: ONE dispatch serves N coalesced requests, so
            # the batch span LINKS to every request's context instead of
            # parenting under any one of them; the executor's step span
            # parents under it via the attached thread-local context
            links = [r.tctx for r in batch if r.tctx is not None] \
                if _trace.enabled() else None
            bspan = _trace.span("serve.batch", kind="serve", links=links,
                                bucket=bucket, rows=rows, replica=idx)
            try:
                with bspan:
                    t0 = time.perf_counter()
                    outs = exe.run(self.program, feed=feed,
                                   fetch_list=self.fetch_list, scope=scope,
                                   return_numpy=False)
                    dispatch_s = time.perf_counter() - t0
                    t1 = time.perf_counter()
                    host = [np.asarray(as_numpy(o)) for o in outs]
                    readback_s = time.perf_counter() - t1
            except BaseException as e:  # noqa: BLE001 — fail the futures
                self._fail_batch(batch, e)
                continue
            offset = 0
            done = time.perf_counter()
            try:
                for r in batch:
                    res = [h[offset:offset + r.rows] for h in host]
                    offset += r.rows
                    # _resolve: a client-cancelled Future (result(timeout)
                    # expired) must not kill this worker thread
                    if _resolve(r.future, result=res):
                        self._record_request(r, pad_s, dispatch_s,
                                             readback_s, done, replica=idx,
                                             batch_ctx=bspan.ctx,
                                             t_pad=t_pad, t_dispatch=t0,
                                             t_readback=t1)
            except BaseException as e:  # noqa: BLE001 — fail the futures
                self._fail_batch(batch, e)

    def _gauge(self, name, help=""):
        return monitor.registry().gauge(name, help=help)

    def _set_queue_gauge(self):
        rows = self._queue.rows
        self._gauge("serve_queue_rows",
                    help="rows currently queued").set(rows)
        if self.model is not None:
            monitor.registry().gauge("serve_queue_rows",
                                     model=self.model).set(rows)

    def _record_request(self, req, pad_s, dispatch_s, readback_s, done,
                        replica, batch_ctx=None, t_pad=None,
                        t_dispatch=None, t_readback=None):
        reg = monitor.registry()
        total_ms = (done - req.t_submit) * 1000.0
        queue_ms = ((req.t_picked or req.t_submit) - req.t_submit) * 1000.0
        self._own_request_ms.observe(total_ms)
        reg.histogram("serve_request_ms",
                      help="submit-to-result request latency",
                      buckets=SERVE_MS_BUCKETS).observe(total_ms)
        if self.model is not None:
            reg.histogram("serve_request_ms", buckets=SERVE_MS_BUCKETS,
                          model=self.model).observe(total_ms)
        for phase, ms in (("queue", queue_ms), ("pad", pad_s * 1000.0),
                          ("dispatch", dispatch_s * 1000.0),
                          ("readback", readback_s * 1000.0)):
            reg.histogram("serve_request_phase_ms",
                          help="per-phase request latency",
                          buckets=SERVE_MS_BUCKETS,
                          phase=phase).observe(ms)
        reg.counter("serve_replica_requests_total",
                    help="requests served per replica",
                    replica=str(replica)).inc()
        slo = self.config.slo_ms
        violated = slo is not None and total_ms > slo
        if violated:
            self._own["slo_violations"].inc()
            reg.counter("serve_slo_violations_total",
                        help="requests exceeding ServeConfig.slo_ms").inc()
            if self.model is not None:
                reg.counter("serve_slo_violations_total",
                            model=self.model).inc()
        if req.tctx is not None and _trace.enabled():
            # retroactive lifecycle spans under the identity allocated at
            # submit(): root request span (linked to the batch that
            # carried it) + queue/pad/dispatch/readback children
            picked = req.t_picked or req.t_submit
            ctx = _trace.record(
                "serve.request", req.t_submit, done, kind="serve",
                ctx=req.tctx, parent=req.tparent,
                links=[batch_ctx] if batch_ctx is not None else None,
                attrs={"rows": req.rows, "replica": replica,
                       "total_ms": round(total_ms, 3),
                       "slo_violated": violated})
            _trace.record("serve.queue", req.t_submit, picked,
                          kind="serve", parent=ctx)
            if t_pad is not None:
                _trace.record("serve.pad", t_pad, t_pad + pad_s,
                              kind="serve", parent=ctx)
            if t_dispatch is not None:
                _trace.record("serve.dispatch", t_dispatch,
                              t_dispatch + dispatch_s, kind="serve",
                              parent=ctx)
            if t_readback is not None:
                _trace.record("serve.readback", t_readback,
                              t_readback + readback_s, kind="serve",
                              parent=ctx)
        if violated:
            _trace.maybe_dump("serve_slo")

    # -- visibility -----------------------------------------------------
    def _cache_entries(self):
        return sum(exe.compile_cache_info()["entries"]
                   for exe, _ in self._replicas)

    def _cache_aggregate(self):
        """Summed compile-cache counters across this server's executors
        (Executor.compile_cache_info: misses are prepares plus captures;
        the l2 counters move under FLAGS_compile_cache_dir, the remote ones
        stay 0: the compile service is not ported)."""
        agg = {"l1_misses": 0, "l2_hits": 0, "l2_remote_hits": 0,
               "l2_remote_misses": 0, "l2_puts": 0, "l2_fallbacks": 0}
        for exe, _ in self._replicas:
            info = exe.compile_cache_info()
            l2 = info.get("l2") or {}
            agg["l1_misses"] += info.get("misses", 0)
            agg["l2_hits"] += l2.get("hits", 0)
            agg["l2_remote_hits"] += l2.get("remote_hits", 0)
            agg["l2_remote_misses"] += l2.get("remote_misses", 0)
            agg["l2_puts"] += l2.get("puts", 0)
            agg["l2_fallbacks"] += l2.get("fallbacks", 0)
        agg["misses"] = max(0, agg["l1_misses"] - agg["l2_hits"])
        return agg

    def reset_stats(self):
        """Zero this server's own request tallies and latency histogram,
        which stats() reads, to measure one load at a time; the
        steady-state compile baseline and the process registry stay."""
        self._own = {name: monitor.Counter(name) for name in self._own}
        self._own_request_ms = monitor.Histogram(
            "serve_request_ms", buckets=SERVE_MS_BUCKETS)

    def latency_percentiles(self, *ps):
        """{p: ms} over requests served by THIS server (the registry's
        serve_request_ms series is shared process-wide)."""
        ps = ps or (50, 95, 99)
        return self._own_request_ms.percentiles(*ps)

    def stats(self):
        """One scrape of the serving metrics: counts, latency percentiles,
        SLO violations, and the zero-steady-state-compile check. All values
        are scoped to this server instance, matching compile_entries, even
        when several Servers share the process-global registry."""
        pct = self.latency_percentiles(50, 95, 99)
        rows = self._own["rows"].value
        padded = self._own["padded_rows"].value
        cache = self._cache_aggregate()
        models = {}
        if self.model is not None:
            models[self.model] = {
                "slo_ms": self.config.slo_ms,
                "queue_rows": self._queue.rows,
                "requests": self._own["requests"].value,
                "p99_ms": pct[99],
                "slo_violations": self._own["slo_violations"].value,
            }
        return {
            "model": self.model,
            "models": models,
            "ready": self.ready(),
            "state": self.state(),
            "draining": self.draining(),
            "replicas": self.config.replicas,
            "buckets": list(self.config.buckets),
            "max_wait_ms": self.config.max_wait_ms,
            "requests": self._own["requests"].value,
            "rejected": self._own["rejected"].value,
            "rows": rows,
            "padded_rows": padded,
            "pad_fraction": (padded / (rows + padded)) if rows else 0.0,
            "queue_rows": self._queue.rows,
            "p50_ms": pct[50], "p95_ms": pct[95], "p99_ms": pct[99],
            "slo_ms": self.config.slo_ms,
            "slo_violations": self._own["slo_violations"].value,
            "step_modes": {str(b): m for b, m in self.step_modes().items()},
            "compile_entries": self._cache_entries(),
            "steady_state_compiles":
                self._cache_entries() - self._warm_entries,
            "compile_cache_misses": cache["misses"],
            "compile_cache": cache,
        }


class ModelSet:
    """N named one-shot Servers behind one frontend surface.

    The multi-model contract for the classic batcher: each model keeps
    its own Server (own queue, buckets, executors and graphs, SLO), and
    the set dispatches `submit(feed, model=...)` by name — the same
    surface the HTTP frontend speaks, so a ModelSet drops in anywhere a
    Server does. Each member captures its graphs in its own start(), in
    the caller's thread, while the members started before it replay
    theirs in their workers (captures are thread-local:
    executor_core.CapturedStep).
    """

    def __init__(self, servers, default=None):
        if not servers:
            raise ValueError("ModelSet needs at least one server")
        self.servers = dict(servers)
        for name, srv in self.servers.items():
            if srv.model is None:
                srv.model = str(name)
        self.default = str(default) if default is not None \
            else next(iter(self.servers))
        if self.default not in self.servers:
            raise ValueError(f"default {self.default!r} not in servers")

    @property
    def models(self):
        return self.servers

    def resolve_model(self, name=None):
        if name is None:
            return self.servers[self.default]
        srv = self.servers.get(str(name))
        if srv is None:
            raise UnknownModel(
                f"unknown model {name!r}; hosting "
                f"{sorted(self.servers)}")
        return srv

    def submit(self, feed, model=None):
        return self.resolve_model(model).submit(feed)

    def infer(self, feed, model=None, timeout=None):
        return self.submit(feed, model=model).result(timeout=timeout)

    # -- lifecycle (fan-out) --------------------------------------------
    def start(self, warm=True):
        for srv in self.servers.values():
            srv.start(warm=warm)
        return self

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        return False

    def stop(self):
        for srv in self.servers.values():
            srv.stop()

    def drain(self, timeout=30.0):
        ok = True
        for srv in self.servers.values():
            ok = srv.drain(timeout=timeout) and ok
        return ok

    def ready(self):
        return all(srv.ready() for srv in self.servers.values())

    def draining(self):
        return any(srv.draining() for srv in self.servers.values())

    def state(self):
        """Worst-of for /healthz: serving only when EVERY model serves;
        draining while any drains; otherwise the first non-serving
        member's state."""
        states = [srv.state() for srv in self.servers.values()]
        if all(s == "serving" for s in states):
            return "serving"
        if any(s == "draining" for s in states):
            return "draining"
        for s in states:
            if s != "serving":
                return s
        return "serving"

    def stats(self):
        per_model = {n: srv.stats() for n, srv in self.servers.items()}
        models = {}
        for n, st in per_model.items():
            models.update(st.get("models") or
                          {n: {"slo_ms": st.get("slo_ms"),
                               "queue_rows": st.get("queue_rows"),
                               "requests": st.get("requests"),
                               "p99_ms": st.get("p99_ms"),
                               "slo_violations":
                                   st.get("slo_violations")}})
        return {
            "ready": self.ready(),
            "state": self.state(),
            "draining": self.draining(),
            "default_model": self.default,
            "queue_rows": sum(st["queue_rows"]
                              for st in per_model.values()),
            "requests": sum(st["requests"] for st in per_model.values()),
            "rejected": sum(st["rejected"] for st in per_model.values()),
            "slo_violations": sum(st["slo_violations"]
                                  for st in per_model.values()),
            "steady_state_compiles": sum(st["steady_state_compiles"]
                                         for st in per_model.values()),
            "compile_entries": sum(st["compile_entries"]
                                   for st in per_model.values()),
            "models": models,
        }
