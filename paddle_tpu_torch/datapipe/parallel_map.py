"""ParallelMap: N worker threads over a bounded, order-preserving queue.

Reference contrast: reader/decorator.py xmap_readers parallelizes the map
but its ordered mode spin-waits (time.sleep polling) and its in-flight set
is unbounded when one item is slow. This stage bounds total in-flight items
with a ticket semaphore (backpressure all the way to the source) and
re-emits results in input order through a condition-guarded reorder buffer.

Threads, not processes: the heavy decode kernels this stage runs (numpy
frombuffer/reshape/astype, zlib, PIL) release the GIL, which is the same
reasoning the reference's threaded double-buffer reader relies on.
"""

import threading

from .. import trace as _trace

__all__ = ["ParallelMap"]


class _End:
    pass


class ParallelMap:
    """Iterate `fn(item)` over `source` with num_workers threads.

    buffer_size bounds TOTAL in-flight items (being mapped + mapped but not
    yet consumed): a slow consumer therefore stops the upstream source after
    at most buffer_size items — bounded memory by construction.
    order=True re-emits in input order (deterministic pipelines);
    order=False emits as completed (lower latency under skewed item cost).
    """

    def __init__(self, source, fn, num_workers=2, buffer_size=None,
                 order=True, stats=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._source = source
        self._fn = fn
        self._workers = int(num_workers)
        self._buf = int(buffer_size if buffer_size is not None
                        else 2 * num_workers)
        if self._buf < num_workers:
            raise ValueError(
                f"buffer_size {self._buf} < num_workers {num_workers} "
                f"would idle workers permanently")
        self._order = order
        self._stats = stats
        self._active = None  # live iteration's state (for close/join)

    def close(self):
        """Stop the live iteration's workers (idempotent). Safe from any
        thread — unlike closing the generator, which raises ValueError
        when a downstream stage's worker is currently executing it."""
        state = self._active
        if state is not None:
            state["stop"] = True
            with state["cond"]:
                state["cond"].notify_all()

    def join_workers(self, timeout=2.0):
        """Join the live iteration's worker threads (after close())."""
        state = self._active
        if state is None:
            return True
        import time

        ok = True
        deadline = time.monotonic() + timeout
        for t in state.get("threads", ()):
            t.join(max(0.0, deadline - time.monotonic()))
            ok = ok and not t.is_alive()
        return ok

    def __iter__(self):
        import time

        src = iter(self._source)
        src_lock = threading.Lock()
        tickets = threading.Semaphore(self._buf)
        cond = threading.Condition()
        done = {}          # idx -> result (order mode)
        ready = []         # results (unordered mode)
        state = {"next_in": 0, "next_out": 0, "eof_at": None,
                 "error": None, "stop": False, "ended": 0, "cond": cond,
                 "threads": ()}
        self._active = state
        st = self._stats
        # trace context is captured HERE, on the consumer thread that
        # starts the iteration, and attached inside each worker — worker
        # threads are fresh and carry no context of their own. `tracing`
        # is a per-iteration snapshot so workers don't re-read the flag
        # per item.
        tracing = _trace.enabled()
        tctx = _trace.current() if tracing else None

        def pull():
            """One (idx, item) under the source lock; None at EOF."""
            with src_lock:
                if state["eof_at"] is not None or state["error"] is not None:
                    return None
                try:
                    t0 = time.perf_counter()
                    item = next(src, _End)
                    if st:
                        st.add_wait_in(time.perf_counter() - t0)
                except BaseException as e:
                    with cond:
                        state["error"] = e
                        cond.notify_all()
                    return None
                if item is _End:
                    state["eof_at"] = state["next_in"]
                    with cond:
                        cond.notify_all()
                    return None
                idx = state["next_in"]
                state["next_in"] += 1
                return idx, item

        def work():
            if tracing:
                with _trace.attach(tctx):
                    work_loop()
            else:
                work_loop()

        def work_loop():
            try:
                while not state["stop"]:
                    # ticket BEFORE pulling: bounds in-flight including the
                    # item this worker is about to hold
                    while not tickets.acquire(timeout=0.2):
                        if state["stop"]:
                            return
                    nxt = pull()
                    if nxt is None:
                        tickets.release()
                        return
                    idx, item = nxt
                    try:
                        t0 = time.perf_counter()
                        res = self._fn(item)
                        t1 = time.perf_counter()
                        if st:
                            st.add_item(busy_s=t1 - t0)
                        if tracing:
                            _trace.record("datapipe.map", t0, t1,
                                          kind="datapipe",
                                          attrs={"idx": idx})
                    except BaseException as e:
                        with cond:
                            if state["error"] is None:
                                state["error"] = e
                            cond.notify_all()
                        return
                    with cond:
                        if self._order:
                            done[idx] = res
                        else:
                            ready.append(res)
                        cond.notify_all()
            finally:
                with cond:
                    state["ended"] += 1
                    cond.notify_all()

        threads = [threading.Thread(target=work, daemon=True,
                                    name=f"datapipe-map-{i}")
                   for i in range(self._workers)]
        state["threads"] = tuple(threads)
        for t in threads:
            t.start()

        def next_ready():
            """Block until the next emittable result / EOF / error."""
            with cond:
                while True:
                    if state["error"] is not None:
                        raise state["error"]
                    if self._order and state["next_out"] in done:
                        res = done.pop(state["next_out"])
                        state["next_out"] += 1
                        return res
                    if not self._order and ready:
                        state["next_out"] += 1
                        return ready.pop(0)
                    if state["eof_at"] is not None and \
                            state["next_out"] >= state["eof_at"]:
                        return _End
                    if state["ended"] == self._workers:
                        # workers gone and nothing emittable was found
                        # above: EOF, error, or a stop that left a gap in
                        # the reorder buffer — no result can arrive now
                        if state["error"] is not None:
                            raise state["error"]
                        return _End
                    cond.wait(0.2)

        try:
            while True:
                res = next_ready()
                if res is _End:
                    return
                tickets.release()  # consumed: let a worker pull one more
                yield res
        finally:
            state["stop"] = True
            with cond:
                cond.notify_all()
            if self._active is state:
                self._active = None
