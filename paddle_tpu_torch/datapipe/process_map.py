"""ProcessPoolMap: decode/augment in N worker PROCESSES.

Sibling to ParallelMap with the same public contract (bounded in-flight
tickets, ordered emission, object-level close()/join_workers() for the
DataPipe 3-phase shutdown) but the workers are OS processes, so pure-
Python decode that never releases the GIL still scales. BENCH_r05 showed
the thread path capped at 0.72 of device rate by exactly that.

Two modes:

  plain (chunk=None): results travel back to the parent pickled over a
    per-worker pipe — drop-in for `.map(fn, processes=True)` anywhere in
    a pipe.

  fused (chunk=K): the pipeline wires this stage directly in front of
    `prefetch_to_device(chunk=K)`. Workers write each decoded sample
    straight into row g of a shared-memory ring slot (shm.ShmRing), in
    the WIRE dtype, and only a ~100-byte ack crosses the pipe. The
    consumer emits one complete [K, ...] chunk per ring slot — views over
    shared memory plus a SlotLease the feeder releases after device_put.
    Decode -> link with zero host-side copies in between.

Transport is deliberately lock-free across processes: each worker owns a
task mp.Queue (parent writes; its feeder thread absorbs puts to a dead
reader) and one result Pipe it alone writes (acks are far below PIPE_BUF,
so a SIGKILL mid-write cannot wedge the other workers on a shared queue
lock, and `multiprocessing.connection.wait` gives the parent a real
select over all workers).

Worker death (SIGKILL mid-batch, OOM) is detected by the dispatcher's
exitcode scan within one 0.2 s poll interval: by default the consumer
gets a DataPipeError naming the pid/exitcode; under
FLAGS_datapipe_restart_workers=1 a replacement is forked and the dead
worker's in-flight items are re-dispatched (the parent keeps every
in-flight item precisely so this replay is possible). resilience.chaos
fires `worker_kill` faults through its `on_map_dispatch` hook, called as
each item goes to a worker. A forked worker inherits the parent's signal
handlers, and the trainer's PreemptionHandler only records a signal, to
act on it at the next step boundary: so a worker first puts SIGTERM back
to its default (the parent's terminate() must end it) and ignores SIGINT
(a Ctrl-C reaches the whole process group; the parent grace-saves, then
closes its pipe and its workers).

Start method: fork by default (fn needn't pickle; decode closures work),
FLAGS_datapipe_start_method=spawn for libraries that dislike fork.
"""

import os
import threading
import time

import numpy as np

from .. import trace as _trace
from ..flags import define, get as get_flag
from ..resilience import chaos as _chaos
from .shm import SHM_SLOT_KEY, ShmRing, ShmRingClient
from .transfer import WIRE_KEY

__all__ = ["ProcessPoolMap", "DataPipeError"]

define("datapipe_start_method", str, "",
       "multiprocessing start method for ProcessPoolMap workers "
       "('' = fork when available, else spawn).")
define("datapipe_restart_workers", bool, False,
       "Restart a died datapipe decode worker (re-dispatching its "
       "in-flight items) instead of raising DataPipeError.")
define("datapipe_pin_workers", bool, False,
       "Pin each datapipe decode worker process to one CPU core "
       "(round-robin over the parent's affinity mask, parent's own core "
       "last) so decode never migrates across cores mid-chunk. No-op on "
       "single-core hosts and platforms without sched_setaffinity.")
define("datapipe_readahead", int, 0,
       "In-flight decode items for the fused process map (0 = auto: "
       "deep enough to keep every ring slot's chunk assembling, "
       "ring_slots * chunk, floored at 2 * num_workers). Plain-mode "
       "maps keep buffer_size semantics.")
define("datapipe_dispatch_batch", int, 0,
       "Items per dispatch message on the fused shm path (0 = auto: "
       "chunk // num_workers, min 1). Batching cuts the per-item "
       "queue/pipe round-trips that bound single-core decode rate; 1 "
       "restores item-granular dispatch.")


class DataPipeError(RuntimeError):
    """A datapipe stage failed in a way the pipeline cannot hide —
    e.g. a decode worker process died mid-batch."""


class _End:
    pass


def _rebuild_exc(etype, msg, tb):
    """Parent-side reconstruction of a worker exception. Builtin types
    re-raise as themselves (so `ValueError` from a decode fn propagates
    like the thread path); anything else becomes a DataPipeError carrying
    the worker traceback."""
    import builtins

    cls = getattr(builtins, etype, None)
    if isinstance(cls, type) and issubclass(cls, Exception):
        try:
            return cls(msg)
        except Exception:
            pass
    return DataPipeError(f"decode worker raised {etype}: {msg}\n{tb}")


def _worker_main(wid, fn, task_q, conn):
    """Worker process body: decode tasks until the stop pill.

    Messages in (task_q): ("task", idx, slot, off, item) /
    ("taskb", idx0, slot, off0, [items]) — a coalesced run of shm rows —
    / ("probe", idx, item) / ("ring", meta, wire) / ("stop",).
    Messages out (conn): ("ok", idx, res, dur) / ("okshm", idx, dur) /
    ("okshmb", idx0, n, dur) / ("probe_ok", idx, res, dur) /
    ("err", idx, etype, msg, tb).
    """
    import signal
    import traceback

    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    client = None
    wire = None
    try:
        while True:
            task = task_q.get()
            kind = task[0]
            if kind == "stop":
                break
            if kind == "ring":
                client = ShmRingClient(task[1])
                wire = task[2]
                continue
            idx = task[1]
            try:
                if kind == "probe":
                    item = task[2]
                    t0 = time.perf_counter()
                    res = fn(item)
                    dur = time.perf_counter() - t0
                    conn.send(("probe_ok", idx, res, dur))
                elif kind == "taskb":
                    # coalesced dispatch: decode a run of rows into one
                    # slot, one ~100-byte ack for the whole run
                    _, idx, slot, off, items = task
                    t0 = time.perf_counter()
                    client.write_batch(slot, off, [fn(it) for it in items],
                                       wire)
                    dur = time.perf_counter() - t0
                    conn.send(("okshmb", idx, len(items), dur))
                else:  # "task"
                    _, idx, slot, off, item = task
                    t0 = time.perf_counter()
                    res = fn(item)
                    if slot is None:
                        dur = time.perf_counter() - t0
                        conn.send(("ok", idx, res, dur))
                    else:
                        client.write(slot, off, res, wire)
                        dur = time.perf_counter() - t0
                        conn.send(("okshm", idx, dur))
            except Exception as e:
                conn.send(("err", idx, type(e).__name__, str(e),
                           traceback.format_exc()))
    except (EOFError, OSError, KeyboardInterrupt):
        pass  # parent went away mid-shutdown: just exit
    finally:
        if client is not None:
            client.close()
        try:
            conn.close()
        except Exception:
            pass


class _Worker:
    __slots__ = ("wid", "proc", "task_q", "conn", "outstanding", "dead",
                 "conn_dead")

    def __init__(self, wid, proc, task_q, conn):
        self.wid = wid
        self.proc = proc
        self.task_q = task_q
        self.conn = conn
        self.outstanding = set()  # item idxs dispatched, not yet acked
        self.dead = False       # process exited (dispatcher's verdict)
        self.conn_dead = False  # result pipe broken (consumer's verdict)


class _InFlight:
    __slots__ = ("wid", "chunk", "off", "slot", "item", "probe", "batch")

    def __init__(self, wid, chunk, off, slot, item, probe=False,
                 batch=False):
        self.wid = wid
        self.chunk = chunk
        self.off = off
        self.slot = slot
        self.item = item  # one item, or the item list when batch=True
        self.probe = probe
        self.batch = batch


class ProcessPoolMap:
    """Iterate `fn(item)` over `source` with num_workers processes.

    chunk=K switches to fused shared-memory mode: emits [K, ...] chunk
    dicts (shm views) carrying SHM_SLOT_KEY (a SlotLease the consumer
    releases) and, with `wire`, WIRE_KEY — sized for AsyncDeviceFeeder
    with chunk=None. Emission is always input-ordered in fused mode;
    plain mode honors order=False.

    wire may be a WireSpec, None, or "auto" (resolve from the first
    decoded sample via transfer.auto_wire — covers uint8 feeds).
    ring_slots bounds chunk-sized shm slots (assembling + emitted but not
    yet released downstream).
    """

    def __init__(self, source, fn, num_workers=2, buffer_size=None,
                 order=True, stats=None, chunk=None, wire=None,
                 ring_slots=4, restart_workers=None, start_method=None,
                 wire_cb=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if chunk is not None and int(chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._source = source
        self._fn = fn
        self._workers_n = int(num_workers)
        if buffer_size is not None:
            self._buf = int(buffer_size)
        elif chunk is not None:
            # fused shm mode: memory is bounded by the ring, not the
            # ticket count, so read ahead deep enough that every ring
            # slot's chunk can be assembling at once (depth-aware)
            self._buf = int(get_flag("datapipe_readahead")
                            or max(2 * num_workers,
                                   int(ring_slots) * int(chunk)))
        else:
            self._buf = 2 * int(num_workers)
        if self._buf < num_workers:
            raise ValueError(
                f"buffer_size {self._buf} < num_workers {num_workers} "
                f"would idle workers permanently")
        self._order = bool(order)
        self._stats = stats
        self._chunk = None if chunk is None else int(chunk)
        self._wire = wire
        self._ring_slots = int(ring_slots)
        self._restart = restart_workers
        self._start_method = start_method
        self._wire_cb = wire_cb  # called once with the resolved WireSpec
        self._active = None

    # -- lifecycle (DataPipe 3-phase close contract) ---------------------
    def close(self):
        state = self._active
        if state is not None:
            state["stop"] = True
            with state["cond"]:
                state["cond"].notify_all()

    def join_workers(self, timeout=4.0):
        state = self._active
        if state is None:
            return True
        return self._shutdown(state, timeout)

    def _shutdown(self, state, timeout=4.0):
        with state["shutdown_lock"]:
            if state["shutdown_done"]:
                return True
            state["shutdown_done"] = True
        state["stop"] = True
        with state["cond"]:
            state["cond"].notify_all()
        deadline = time.monotonic() + timeout
        disp = state.get("dispatcher")
        if disp is not None and disp is not threading.current_thread():
            disp.join(max(0.1, deadline - time.monotonic()))
        workers = list(state["workers"].values())
        for w in workers:
            try:
                w.task_q.put(("stop",))
            except Exception:
                pass
        ok = True
        for w in workers:
            w.proc.join(max(0.05, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(0.5)
            if w.proc.is_alive():
                try:
                    w.proc.kill()
                except Exception:
                    pass
                w.proc.join(0.5)
            ok = ok and not w.proc.is_alive()
            try:
                w.conn.close()
            except Exception:
                pass
            try:
                w.task_q.close()
                w.task_q.cancel_join_thread()
            except Exception:
                pass
        ring = state.get("ring")
        if ring is not None:
            ring.close()  # workers joined: safe to unlink
        if self._active is state:
            self._active = None
        return ok

    # -- iteration -------------------------------------------------------
    def _mp_context(self):
        import multiprocessing as mp

        method = self._start_method
        if method is None:
            method = get_flag("datapipe_start_method") or ""
        if not method:
            method = "fork" if "fork" in mp.get_all_start_methods() \
                else "spawn"
        return mp.get_context(method)

    def __iter__(self):
        ctx = self._mp_context()
        K = self._chunk
        fused = K is not None
        restart = self._restart
        if restart is None:
            restart = bool(get_flag("datapipe_restart_workers"))
        st = self._stats
        tracing = _trace.enabled()
        cond = threading.Condition()
        tickets = threading.Semaphore(self._buf)
        done = {}    # plain ordered: idx -> result
        ready = []   # plain unordered
        state = {
            "stop": False, "error": None, "eof_at": None,
            "next_in": 0, "next_out": 0, "acked": 0,
            "cond": cond, "workers": {}, "inflight": {},
            "ring": None, "wire": self._wire, "probe_res": None,
            "probe_sent": False,
            "chunk_acks": {}, "chunk_lease": {}, "next_chunk_out": 0,
            "deaths": 0, "restarts": 0,
            "dispatcher": None, "disp_ended": False,
            "shutdown_lock": threading.Lock(), "shutdown_done": False,
        }
        self._active = state
        wid_seq = [0]

        def pin_worker(proc, wid):
            """FLAGS_datapipe_pin_workers: bind the worker to one core of
            the parent's affinity mask, round-robin, keeping the parent's
            current core for last so decode doesn't contend with dispatch
            when there are cores to spare."""
            if not get_flag("datapipe_pin_workers"):
                return
            if not hasattr(os, "sched_setaffinity"):
                return
            try:
                cpus = sorted(os.sched_getaffinity(0))
                if len(cpus) < 2:
                    return  # single core: pinning only hurts
                try:
                    own = os.sched_getcpu()
                except (AttributeError, OSError):
                    own = None
                if own in cpus and len(cpus) > self._workers_n:
                    cpus = [c for c in cpus if c != own] + [own]
                os.sched_setaffinity(proc.pid, {cpus[wid % len(cpus)]})
            except OSError:
                pass  # containers may forbid affinity changes

        def spawn_worker():
            wid = wid_seq[0]
            wid_seq[0] += 1
            task_q = ctx.Queue()
            r_conn, w_conn = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_worker_main, args=(wid, self._fn, task_q, w_conn),
                daemon=True, name=f"datapipe-proc-{wid}")
            proc.start()
            w_conn.close()  # parent keeps only the read end
            pin_worker(proc, wid)
            w = _Worker(wid, proc, task_q, r_conn)
            if state["ring"] is not None:
                w.task_q.put(("ring", state["ring"].meta(), state["wire"]))
            with cond:  # consumer snapshots this dict under cond
                state["workers"][wid] = w
            return w

        def fail(e):
            with cond:
                if state["error"] is None:
                    state["error"] = e
                cond.notify_all()

        def pick_worker():
            alive = [w for w in state["workers"].values() if not w.dead]
            if not alive:
                return None
            return min(alive, key=lambda w: len(w.outstanding))

        def scan_deaths():
            """Dispatcher-side: detect dead workers; restart + re-dispatch
            their in-flight items, or surface a DataPipeError."""
            for w in list(state["workers"].values()):
                if w.dead or w.proc.exitcode is None:
                    continue
                w.dead = True
                with cond:
                    lost = sorted(w.outstanding)
                    w.outstanding.clear()
                    state["deaths"] += 1
                _count("datapipe_worker_deaths_total")
                if not restart:
                    fail(DataPipeError(
                        f"datapipe decode worker pid {w.proc.pid} died "
                        f"with exitcode {w.proc.exitcode} "
                        f"({len(lost)} items in flight); set "
                        f"FLAGS_datapipe_restart_workers=1 to restart "
                        f"workers automatically"))
                    return
                if state["stop"]:
                    return
                nw = spawn_worker()
                with cond:
                    state["restarts"] += 1
                _count("datapipe_worker_restarts_total")
                for idx in lost:
                    rec = state["inflight"].get(idx)
                    if rec is None:  # acked just before the death scan
                        continue
                    tgt = pick_worker() or nw
                    rec.wid = tgt.wid
                    tgt.outstanding.add(idx)
                    if rec.probe:
                        tgt.task_q.put(("probe", idx, rec.item))
                    elif rec.batch:
                        tgt.task_q.put(("taskb", idx, rec.slot, rec.off,
                                        rec.item))
                    else:
                        tgt.task_q.put(("task", idx, rec.slot, rec.off,
                                        rec.item))

        def _count(name):
            from .. import monitor

            if monitor.enabled():
                monitor.registry().counter(
                    name, help="datapipe process-pool worker events").inc()

        def broadcast_ring():
            meta = state["ring"].meta()
            for w in state["workers"].values():
                if not w.dead:
                    w.task_q.put(("ring", meta, state["wire"]))

        def settle_probe():
            """Dispatcher: turn the probe result into the ring + chunk 0
            row 0 (the one parent-side copy of the whole fused path)."""
            idx, res = state["probe_res"]
            wire = _resolve_wire(state["wire"], res)
            state["wire"] = wire
            if self._wire_cb is not None:
                try:
                    self._wire_cb(wire)
                except Exception:
                    pass
            schema = {}
            for n, v in res.items():
                if n.startswith("__"):
                    continue
                a = np.asarray(v)
                dt = wire.wire_dtype(n, a) if wire is not None else a.dtype
                schema[n] = ((K,) + a.shape, dt)
            if not schema:
                fail(DataPipeError(
                    "fused process map needs dict samples with at least "
                    f"one array feed, got keys {sorted(res.keys())}"))
                return
            ring = ShmRing(self._ring_slots, schema, name_hint="pmap")
            state["ring"] = ring
            broadcast_ring()
            slot = None
            while slot is None and not state["stop"]:
                slot = ring.acquire(0.2)
            if slot is None:
                return
            rec = state["inflight"].get(idx)
            with cond:
                state["chunk_lease"][0] = ring.lease(slot)
                views = ring.views(slot)
            for n in views:
                v = res[n]
                if wire is not None and n in wire:
                    v = wire[n].encode(v)
                views[n][0] = v
            with cond:
                state["probe_res"] = None
                if rec is not None:
                    state["inflight"].pop(idx, None)
                    w = state["workers"].get(rec.wid)
                    if w is not None:
                        w.outstanding.discard(idx)
                state["chunk_acks"][0] = state["chunk_acks"].get(0, 0) + 1
                state["acked"] += 1
                tickets.release()
                cond.notify_all()

        def dispatch_loop():
            src = iter(self._source)
            cur_chunk, cur_off, cur_slot = 0, 0, None
            disp_b = 1
            if fused:
                # coalesced dispatch: B items per queue/pipe round-trip.
                # Auto splits each chunk evenly over the pool so no worker
                # idles while another decodes a whole chunk.
                disp_b = int(get_flag("datapipe_dispatch_batch")) \
                    or max(1, K // max(1, self._workers_n))
            pending = []  # [(idx, item)] of the assembling coalesced run

            def flush_run():
                """Ship the pending run as one taskb message. False when
                no worker is alive to take it (error already set)."""
                nonlocal pending
                if not pending:
                    return True
                w = pick_worker()
                if w is None:
                    return False
                idx0 = pending[0][0]
                items = [it for _, it in pending]
                off0 = cur_off - len(pending)
                for i, _ in pending:
                    _chaos.on_map_dispatch(i, w.proc.pid)
                with cond:
                    state["inflight"][idx0] = _InFlight(
                        w.wid, cur_chunk, off0, cur_slot, items,
                        batch=True)
                    w.outstanding.add(idx0)
                w.task_q.put(("taskb", idx0, cur_slot, off0, items))
                pending = []
                return True

            try:
                while not (state["stop"] or state["error"] is not None):
                    scan_deaths()
                    if state["error"] is not None:
                        return
                    if fused and state["probe_res"] is not None:
                        settle_probe()
                        if state["error"] is not None or state["stop"]:
                            return
                        # the probe filled chunk 0 row 0; with K == 1 that
                        # chunk is already complete (and its lease may be
                        # emitted any moment), so don't touch it again
                        if K == 1:
                            cur_chunk, cur_off, cur_slot = 1, 0, None
                        else:
                            cur_chunk, cur_off = 0, 1
                            cur_slot = state["chunk_lease"][0].slot
                        continue
                    if state["eof_at"] is not None:
                        # source drained: stay alive as the death monitor
                        # until the consumer finishes (stop) — tail items
                        # are still decoding in the workers
                        with cond:
                            cond.wait(0.1)
                        continue
                    if fused and state["probe_sent"] \
                            and state["ring"] is None:
                        with cond:  # schema probe still in flight
                            cond.wait(0.05)
                        continue
                    if fused and state["ring"] is not None \
                            and cur_slot is None:
                        slot = state["ring"].acquire(0.2)
                        if slot is None:
                            continue
                        cur_slot = slot
                        with cond:
                            state["chunk_lease"][cur_chunk] = \
                                state["ring"].lease(slot)
                    tb = time.perf_counter()
                    if not tickets.acquire(timeout=0.2):
                        if st:
                            st.add_bp_wait(time.perf_counter() - tb)
                        continue
                    t0 = time.perf_counter()
                    try:
                        item = next(src, _End)
                    except BaseException as e:
                        tickets.release()
                        fail(e)
                        return
                    if st:
                        st.add_wait_in(time.perf_counter() - t0)
                    if item is _End:
                        tickets.release()
                        # flush the partial run first: its rows must be
                        # acked for the consumer's tail-drop accounting
                        if fused and not flush_run():
                            return
                        with cond:
                            state["eof_at"] = state["next_in"]
                            cond.notify_all()
                        continue
                    idx = state["next_in"]
                    state["next_in"] += 1
                    if fused and not state["probe_sent"]:
                        # first item doubles as the schema probe
                        w = pick_worker()
                        if w is None:
                            tickets.release()
                            return  # scan_deaths already set the error
                        _chaos.on_map_dispatch(idx, w.proc.pid)
                        with cond:
                            state["inflight"][idx] = _InFlight(
                                w.wid, 0, 0, None, item, probe=True)
                            w.outstanding.add(idx)
                            state["probe_sent"] = True
                        w.task_q.put(("probe", idx, item))
                        continue
                    if fused:
                        pending.append((idx, item))
                        cur_off += 1
                        if len(pending) >= disp_b or cur_off == K:
                            if not flush_run():
                                return
                        if cur_off == K:
                            cur_chunk += 1
                            cur_off = 0
                            cur_slot = None
                        continue
                    w = pick_worker()
                    if w is None:
                        tickets.release()
                        return
                    _chaos.on_map_dispatch(idx, w.proc.pid)
                    with cond:
                        state["inflight"][idx] = _InFlight(
                            w.wid, cur_chunk, 0, None, item)
                        w.outstanding.add(idx)
                    w.task_q.put(("task", idx, None, 0, item))
            except BaseException as e:  # pragma: no cover - defensive
                fail(e)
            finally:
                with cond:
                    state["disp_ended"] = True
                    cond.notify_all()

        for _ in range(self._workers_n):
            spawn_worker()
        disp = threading.Thread(target=dispatch_loop, daemon=True,
                                name="datapipe-pmap-dispatch")
        state["dispatcher"] = disp
        disp.start()
        row_bytes = [None]  # chunk mode: bytes of one decoded row

        def handle_msg(msg, recv_t):
            kind = msg[0]
            if kind == "err":
                _, idx, etype, emsg, tb = msg
                fail(_rebuild_exc(etype, emsg, tb))
                return
            idx = msg[1]
            with cond:
                rec = state["inflight"].pop(idx, None)
                if rec is None:
                    return  # duplicate ack after a restart re-dispatch
                w = state["workers"].get(rec.wid)
                if w is not None:
                    w.outstanding.discard(idx)
                if kind == "probe_ok":
                    _, _, res, dur = msg
                    # push back: settle_probe (dispatcher) does the ring
                    # build + slot write outside the lock
                    state["inflight"][idx] = rec
                    if w is not None:
                        w.outstanding.add(idx)
                    state["probe_res"] = (idx, res)
                    if st:
                        st.add_item(busy_s=dur)
                    cond.notify_all()
                    return
                n_items = msg[2] if kind == "okshmb" else 1
                state["acked"] += n_items
                dur = msg[2] if kind == "okshm" else msg[3]
                if kind == "ok":
                    res = msg[2]
                    if self._order:
                        done[idx] = res
                    else:
                        ready.append(res)
                else:  # okshm / okshmb
                    c = rec.chunk
                    state["chunk_acks"][c] = \
                        state["chunk_acks"].get(c, 0) + n_items
                    tickets.release(n_items)
                if st:
                    nb = 0
                    if kind in ("okshm", "okshmb"):
                        if row_bytes[0] is None and state["ring"]:
                            sch = state["ring"].schema
                            row_bytes[0] = sum(
                                int(np.prod(s[1:], dtype=np.int64))
                                * np.dtype(d).itemsize
                                for s, d in sch.values())
                        nb = (row_bytes[0] or 0) * n_items
                    st.add_item(busy_s=dur, nbytes=nb, count=n_items)
                if tracing:
                    _trace.record("datapipe.pmap", recv_t - dur, recv_t,
                                  kind="datapipe", attrs={"idx": idx})
                cond.notify_all()

        def emit_check():
            """Under cond: next emittable item, _End, or None (wait)."""
            if state["error"] is not None:
                raise state["error"]
            if fused:
                c = state["next_chunk_out"]
                if state["chunk_acks"].get(c, 0) == K:
                    lease = state["chunk_lease"].pop(c)
                    state["chunk_acks"].pop(c, None)
                    state["next_chunk_out"] += 1
                    ring, wire = state["ring"], state["wire"]
                    if st:
                        st.sample_depth(len(state["inflight"]))
                    out = dict(ring.views(lease.slot))
                    out[SHM_SLOT_KEY] = lease
                    if wire is not None:
                        out[WIRE_KEY] = wire
                    return out
                if state["eof_at"] is not None \
                        and state["acked"] >= state["eof_at"]:
                    if state["next_chunk_out"] >= state["eof_at"] // K:
                        # partial tail chunk: drop (feeder semantics) and
                        # hand its slot back before tearing down
                        tail = state["chunk_lease"].pop(
                            state["eof_at"] // K, None)
                        if tail is not None:
                            tail.release()
                        return _End
                return None
            if self._order and state["next_out"] in done:
                res = done.pop(state["next_out"])
                state["next_out"] += 1
                return res
            if not self._order and ready:
                state["next_out"] += 1
                return ready.pop(0)
            if state["eof_at"] is not None \
                    and state["next_out"] >= state["eof_at"]:
                return _End
            return None

        def next_ready():
            from multiprocessing import connection as mpc2

            t0 = time.perf_counter()
            while True:
                with cond:
                    res = emit_check()
                if res is not None:
                    if st and res is not _End:
                        st.add_wait_out(time.perf_counter() - t0)
                    return res
                if state["stop"]:
                    return _End
                with cond:
                    conns = {w.conn: w for w in state["workers"].values()
                             if not w.dead and not w.conn_dead}
                if not conns:
                    with cond:  # no live pipes: dispatcher decides next
                        if state["error"] is not None:
                            raise state["error"]
                        cond.wait(0.2)
                    continue
                try:
                    ready_conns = mpc2.wait(list(conns), timeout=0.2)
                except OSError:
                    ready_conns = []
                recv_t = time.perf_counter()
                for conn in ready_conns:
                    try:
                        msg = conn.recv()
                    except Exception:
                        # worker died mid-message; the dispatcher's
                        # exitcode scan decides restart-vs-error — just
                        # stop polling this pipe
                        conns[conn].conn_dead = True
                        continue
                    handle_msg(msg, recv_t)

        try:
            while True:
                res = next_ready()
                if res is _End:
                    return
                if not fused:
                    tickets.release()
                yield res
        finally:
            self._shutdown(state)


def _resolve_wire(wire, sample):
    """Turn a wire arg (None | "auto" | WireSpec) into a concrete spec
    using the first decoded sample."""
    if wire == "auto":
        from .transfer import auto_wire

        return auto_wire(sample)
    return wire
