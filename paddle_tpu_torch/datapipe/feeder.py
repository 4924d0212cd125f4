"""AsyncDeviceFeeder: background host->device staging with double buffering.

The JAX package's feeder (paddle_tpu/datapipe/feeder.py), staging with
torch onto one card. K batches are stacked into one [K, ...] tensor per
feed name, sized for Executor.run(feed=chunk, iters=K): on the card every
step of the chunk is one replay of the captured step.

What a staged chunk goes through:
  * Stack. Each transfer thread stacks K batches into its own
    preallocated PINNED host buffer, in the wire dtype (transfer.py). A
    chunk from a fused process map arrives in a shared-memory slot
    (shm.py), which is not pinned: the thread stacks the slot into its
    pinned buffer (one host copy) and gives the slot back at once.
  * Copy. The thread copies the pinned buffer into a device chunk buffer
    (`copy_(non_blocking=True)`) on a CUDA stream of its own, records an
    event there and waits for it before it touches the pinned buffer
    again, so a pinned buffer is never refilled while its copy reads it.
  * Hand-over. The consumer's current stream waits for that event
    (`wait_event`) before the chunk is yielded; the executor, which is the
    usual consumer, makes its stream wait on it again (ChunkLease.wait).
  * Reuse. Device chunk buffers form a ring of `capacity` slots. A chunk
    marked DONATE_KEY carries a ChunkLease: the executor releases it after
    the run that read it (ChunkLease.release records an event on its
    stream, after the last fill that read the chunk), and a thread refills
    that slot only once the event has completed. A chunk whose lease is
    collected unreleased (a consumer that keeps the tensors and drops the
    rest) is never refilled: the ring forgets its slot and makes another.
    A ring whose every slot is held by the consumer grows by one, so a
    consumer that holds chunks cannot deadlock the pipe.
  * Backpressure. Capacity tickets bound staged-chunks-in-flight
    (transferring + queued), so a stalled consumer holds the pipe back to
    the source; per-stage stats (stack/transfer busy, starvation) and
    profiler counter tracks are the JAX package's.

A CPU place runs the same code without pinning, streams or events: the
"device" ring slots are host tensors, and a copy is a host copy. A CUDA
place where there is no card raises at iteration (core.places.device_for);
a copy that fails raises in the consumer, and nothing falls back to a
pageable copy.

Transfer engine (transfer.py): with `wire=WireSpec(...)` each batch is
encoded into the staging buffer in its WIRE dtype (uint8 pixels, bf16
floats) so the copy moves the compressed representation; staged chunks
carry the spec (WIRE_KEY) so the executor decodes inside the step. Each
transfer thread is one LINK LANE: pass `link_stats` (index -> StageStats)
to get per-lane bytes/busy in DataPipe.stats() and the profiler host lane.
On a card a lane's busy time is its copies' time on the card (CUDA timing
events), and the transfer stage's the lane threads' host time from the
copy's issue to its completion seen on the host, which also holds the
thread's waits for the interpreter lock.
"""

import threading
import time
import weakref

import numpy as np
import torch

from .. import trace as _trace
from ..core.places import CUDAPlace, device_for
from ..flags import define, get as get_flag
from .shm import SHM_SLOT_KEY
from .transfer import DONATE_KEY, WIRE_KEY, torch_dtype

__all__ = ["AsyncDeviceFeeder", "ChunkLease"]

define("datapipe_transfer_threads", int, 0,
       "Parallel host->device transfer threads for datapipe "
       "AsyncDeviceFeeder (0 = auto: min(capacity, 2)).")
define("datapipe_prefetch_depth", int, 0,
       "Default staged-chunks-in-flight capacity for AsyncDeviceFeeder "
       "when the pipe doesn't pass one explicitly (0 = 2: double "
       "buffer). Deeper prefetch rides out decode jitter at the cost of "
       "one chunk of device memory per extra level.")

_POLL_S = 0.2  # stop-flag poll of every wait


class _End:
    pass


def _wait_event(ev, stopped):
    """Wait for a CUDA event from a worker thread, polling `stopped()`:
    True once it completed, False when stopped first."""
    while not ev.query():
        if stopped():
            return False
        time.sleep(0.0005)
    return True


class _Slot:
    """One device chunk buffer of the ring: {name: tensor}; `state` is
    "staged" (being filled or queued for the consumer), "out" (held by the
    consumer), "released" (`event` pending on the consumer's stream) or
    "free"."""

    __slots__ = ("tensors", "state", "event")

    def __init__(self):
        self.tensors = {}
        self.state = "staged"
        self.event = None


class _Ring:
    """The device chunk buffers of one iteration of a feeder."""

    def __init__(self, device, capacity):
        self.device = device
        self.capacity = capacity
        self.slots = []
        self.cond = threading.Condition()

    def acquire(self, stopped):
        """A slot for a worker to fill with its next chunk, or None when
        stopped. The worker reserves it before it pulls the chunk, so no
        worker waits here holding a chunk the consumer waits for. A free
        slot is reused; a released one once its event has completed (the
        consumer's last read of it is done); otherwise a new one is made
        while the ring is under capacity, or when the consumer holds every
        slot. Else the worker waits."""
        while True:
            with self.cond:
                pending = None
                for s in self.slots:
                    if s.state == "released":
                        if s.event is None or s.event.query():
                            s.state, s.event = "free", None
                        else:
                            pending = s
                free = next((s for s in self.slots if s.state == "free"),
                            None)
                if free is not None:
                    free.state = "staged"
                    return free
                if len(self.slots) < self.capacity or all(
                        s.state == "out" for s in self.slots):
                    slot = _Slot()
                    self.slots.append(slot)
                    return slot
                if pending is None:
                    self.cond.wait(_POLL_S)
                    if stopped():
                        return None
                    continue
            if not _wait_event(pending.event, stopped):
                return None

    def tensors(self, slot, spec):
        """`slot`'s tensors, (re)made to `spec` ({name: (shape, torch
        dtype)}) when their shapes or dtypes differ."""
        if not _fits(slot.tensors, spec):
            slot.tensors = {n: torch.empty(shape, dtype=dt,
                                           device=self.device)
                            for n, (shape, dt) in spec.items()}
        return slot.tensors

    def unreserve(self, slot):
        with self.cond:
            slot.state = "free"
            self.cond.notify_all()

    def hand_out(self, slot):
        with self.cond:
            slot.state = "out"
            self.cond.notify_all()

    def give_back(self, slot, stream):
        """Give `slot` back once the work enqueued so far on `stream` (a
        CUDA stream; None: the device's current stream; nothing on the
        CPU) is done."""
        event = None
        if self.device.type == "cuda":
            if stream is None:
                stream = torch.cuda.current_stream(self.device)
            event = torch.cuda.Event()
            event.record(stream)
        with self.cond:
            slot.state, slot.event = "released", event
            self.cond.notify_all()

    def forget(self, slot):
        """Drop `slot` from the ring: its tensors belong to whoever still
        holds them."""
        with self.cond:
            if slot in self.slots:
                self.slots.remove(slot)
            self.cond.notify_all()


def _fits(tensors, spec):
    return tensors.keys() == spec.keys() and all(
        tuple(tensors[n].shape) == tuple(shape) and tensors[n].dtype == dt
        for n, (shape, dt) in spec.items())


class ChunkLease:
    """A staged chunk's hold on its device ring slot (the value of the
    chunk's DONATE_KEY). `wait(stream)` makes `stream` wait for the copy
    that filled the chunk; `release(stream)` gives the slot back to the
    feeder once the work enqueued on `stream` so far is done — call it
    after enqueueing the last read of the chunk; after the release the
    chunk's tensors may be overwritten. A lease that is collected
    unreleased leaves the tensors to their holders (_Ring.forget)."""

    def __init__(self, ring, slot, copy_event):
        self._ring, self._slot = ring, slot
        self._copy_event = copy_event
        self._fin = weakref.finalize(self, ring.forget, slot)

    def wait(self, stream=None):
        if self._copy_event is not None:
            if stream is None:
                stream = torch.cuda.current_stream(self._ring.device)
            stream.wait_event(self._copy_event)

    def release(self, stream=None):
        if self._fin.detach() is not None:
            self._ring.give_back(self._slot, stream)

    @property
    def released(self):
        return not self._fin.alive


class AsyncDeviceFeeder:
    """Iterate device-resident feed dicts off background transfer thread(s).

    source:           iterable of per-step feed dicts {name: ndarray}, or a
                      reader creator (callable returning an iterator)
    chunk:            K steps stacked per staged item ([K, ...] tensors for
                      Executor.run(iters=K)); None = stage items as-is
    place:            Place to stage to (default CUDAPlace(0); CPUPlace()
                      stages host tensors)
    capacity:         staged chunks buffered ahead (>= 2: double buffer),
                      and the device chunk ring's size
    transfer_threads: parallel copy workers, each with its own pinned
                      buffer and CUDA stream (None = FLAGS
                      datapipe_transfer_threads, 0 = auto)
    stage_fn:         override for the staging step, stage_fn(idx, stacked)
                      -> {name: device tensor}, given numpy arrays the
                      callee may keep (no buffer reuse)
    wire:             optional transfer.WireSpec — covered feeds are staged
                      and shipped in their wire dtype; emitted chunks carry
                      the spec under WIRE_KEY so the executor decodes them
                      inside the step
    donate:           stage into the reusable device ring and hand each
                      chunk out with a ChunkLease under DONATE_KEY; None =
                      auto (on unless stage_fn). Off: every chunk gets
                      device tensors of its own, which the consumer keeps
    stack_stats /     optional StageStats receiving the stack-copy and
    transfer_stats:   transfer/starvation counters
    link_stats:       per-transfer-thread lane stats — a callable
                      (thread index -> StageStats) or a list; each lane
                      records its own bytes and busy time (on a card:
                      its copies' device time)

    A partial tail chunk is dropped (an odd [K', ...] shape would prepare
    and capture another step), matching DeviceChunkFeeder.
    """

    def __init__(self, source, chunk=None, place=None, capacity=None,
                 transfer_threads=None, stage_fn=None, wire=None,
                 donate=None, stack_stats=None, transfer_stats=None,
                 link_stats=None, wire_cb=None):
        if chunk is not None and int(chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if capacity is None:
            capacity = get_flag("datapipe_prefetch_depth") or 2
        if int(capacity) < 2:
            raise ValueError(
                f"capacity must be >= 2 (double buffer), got {capacity}")
        self._source = source
        self._chunk = None if chunk is None else int(chunk)
        self._place = place if place is not None else CUDAPlace(0)
        self._cap = int(capacity)
        if transfer_threads is None:
            transfer_threads = get_flag("datapipe_transfer_threads")
        if int(transfer_threads) == 0:  # auto
            transfer_threads = min(self._cap, 2)
        if int(transfer_threads) < 1:
            raise ValueError(
                f"transfer_threads must be >= 1, got {transfer_threads}")
        self._threads = min(int(transfer_threads), self._cap)
        self._stage_fn = stage_fn
        self._wire = wire
        self._donate = bool(stage_fn is None) if donate is None \
            else bool(donate) and stage_fn is None
        self._stack_stats = stack_stats
        self._transfer_stats = transfer_stats
        self._link_stats = link_stats
        self._wire_cb = wire_cb  # called once with a resolved "auto" spec
        self._active = None  # stop flag of the live iteration (for close())

    def close(self):
        """Stop the live iteration's workers (idempotent)."""
        state = self._active
        if state is not None:
            state["stop"] = True
            with state["cond"]:
                state["cond"].notify_all()

    def join_workers(self, timeout=2.0):
        """Join the live iteration's transfer threads (after close());
        True when none is left running. Workers poll their stop flag at
        0.2s granularity, so a closed pipeline drains within ~2 polls."""
        state = self._active
        if state is None:
            return True
        ok = True
        deadline = time.monotonic() + timeout
        for t in state.get("threads", ()):
            t.join(max(0.0, deadline - time.monotonic()))
            ok = ok and not t.is_alive()
        return ok

    def __iter__(self):
        dev = device_for(self._place)  # raises for a CUDA place without one
        cuda = dev.type == "cuda"
        src = self._source() if callable(self._source) \
            else iter(self._source)
        K = self._chunk
        src_lock = threading.Lock()
        tickets = threading.Semaphore(self._cap)
        cond = threading.Condition()
        done = {}  # chunk idx -> staged dict
        state = {"next_in": 0, "next_out": 0, "eof_at": None,
                 "error": None, "stop": False, "ended": 0, "cond": cond,
                 "threads": ()}
        ring = _Ring(dev, self._cap) if self._donate else None
        state["ring"] = ring
        self._active = state
        sst, tst = self._stack_stats, self._transfer_stats
        # wire may be "auto": resolved from the first pulled item (under
        # the source lock, so exactly once) via transfer.auto_wire
        wire_state = {"wire": self._wire,
                      "pending": self._wire == "auto"}

        def stopped():
            return state["stop"] or state["error"] is not None

        def eff_wire(item):
            if wire_state["pending"]:
                from .transfer import auto_wire

                wire_state["wire"] = auto_wire(item)
                wire_state["pending"] = False
                if self._wire_cb is not None:
                    try:
                        self._wire_cb(wire_state["wire"])
                    except Exception:
                        pass
            return wire_state["wire"]
        # consumer-thread trace context, attached inside each transfer
        # worker (explicit cross-thread propagation); snapshot of the
        # flag so workers don't re-read it per chunk
        tracing = _trace.enabled()
        tctx = _trace.current() if tracing else None

        def link_stat(i):
            ls = self._link_stats
            if ls is None:
                return None
            if callable(ls):
                return ls(i)
            return ls[i] if i < len(ls) else None

        def fail(e):
            with cond:
                if state["error"] is None:
                    state["error"] = e
                cond.notify_all()

        def host_buffer(holder, name, shape, np_dtype, wire_name):
            """This worker's staging buffer for `name`: a pinned torch
            tensor on a card (a plain one on the CPU, or numpy for
            stage_fn) and its numpy view, remade when the shape or dtype
            changes."""
            key = (tuple(shape), np.dtype(np_dtype).str, wire_name)
            got = holder.get(name)
            if got is not None and got[0] == key:
                return got[1], got[2]
            if self._stage_fn is not None:
                arr = np.empty(shape, np_dtype)
                holder[name] = (key, None, arr)
                return None, arr
            tdt = torch_dtype("bfloat16" if wire_name == "bfloat16"
                              else np_dtype)
            t = torch.empty(tuple(shape), dtype=tdt, pin_memory=cuda)
            view = t.view(torch.int16).numpy().view(np.uint16) \
                if tdt == torch.bfloat16 else t.numpy()
            holder[name] = (key, t, view)
            return t, view

        def pull_chunk(holder):
            """Under the source lock: pull K batches (or one item) and copy
            them into this worker's staging buffers. Returns (idx, {name:
            (tensor, numpy view)}, w) or None at EOF/stop, `w` the
            effective WireSpec for the emitted chunk's markers. A fused
            process map's shm slot is released once copied."""
            with src_lock:
                if state["eof_at"] is not None or state["error"] is not None \
                        or state["stop"]:
                    return None
                lease = None
                try:
                    bufs = {}
                    if K is None:
                        t0 = time.perf_counter()
                        item = next(src, _End)
                        if sst:
                            sst.add_wait_in(time.perf_counter() - t0)
                        if item is _End:
                            state["eof_at"] = state["next_in"]
                            with cond:
                                cond.notify_all()
                            return None
                        w = eff_wire(item)
                        tb = time.perf_counter()
                        if isinstance(item, dict) and SHM_SLOT_KEY in item:
                            # fused upstream: arrays are shm views already
                            # in wire dtype; the slot is free once copied
                            item = dict(item)
                            lease = item.pop(SHM_SLOT_KEY)
                            w = item.pop(WIRE_KEY, None) or w
                        elif w is not None:
                            item = w.encode_feed(item)
                        for n, a in item.items():
                            if n.startswith("__") and n != "__valid__":
                                continue
                            a = np.asarray(a)
                            wn = w[n].wire_dtype if w is not None \
                                and n in w else None
                            t, view = host_buffer(holder, n, a.shape,
                                                  a.dtype, wn)
                            np.copyto(view, a)
                            bufs[n] = (t, view)
                        if lease is not None:
                            lease.release()
                            lease = None
                        if sst:
                            sst.add_item(
                                busy_s=time.perf_counter() - tb,
                                nbytes=sum(v.nbytes
                                           for _, v in bufs.values()))
                    else:
                        got = 0
                        w = wire_state["wire"]
                        while got < K:
                            t0 = time.perf_counter()
                            item = next(src, _End)
                            if sst:
                                sst.add_wait_in(time.perf_counter() - t0)
                            if item is _End:
                                # partial tail: drop (DeviceChunkFeeder
                                # semantics — no odd-shape recapture)
                                state["eof_at"] = state["next_in"]
                                with cond:
                                    cond.notify_all()
                                return None
                            w = eff_wire(item)
                            tb = time.perf_counter()
                            if not bufs:
                                # __valid__ (the Batcher's pad mask) is a
                                # real [bs] bool array and rides the chunk;
                                # other __ metadata stays host-side
                                for n, a in item.items():
                                    if n.startswith("__") \
                                            and n != "__valid__":
                                        continue
                                    a = np.asarray(a)
                                    dt = w.wire_dtype(n, a) \
                                        if w is not None else a.dtype
                                    wn = w[n].wire_dtype if w is not None \
                                        and n in w else None
                                    bufs[n] = host_buffer(
                                        holder, n, (K,) + a.shape, dt, wn)
                            for n, (_, b) in bufs.items():
                                v = item[n]
                                if w is not None and n in w:
                                    v = w[n].encode(v)
                                b[got] = v
                            got += 1
                            if sst:
                                # wire bytes: what the link will move
                                sst.add_item(
                                    busy_s=time.perf_counter() - tb,
                                    nbytes=sum(b[0].nbytes
                                               for _, b in bufs.values()))
                except BaseException as e:
                    if lease is not None:
                        lease.release()
                    fail(e)
                    return None
                idx = state["next_in"]
                state["next_in"] += 1
                return idx, bufs, w

        def acquire_slot():
            """A ring slot for the next chunk (None without a ring; _End
            when stopped while waiting). The wait for the consumer to give
            one back is backpressure, not transfer time."""
            if ring is None:
                return None
            tw = time.perf_counter()
            slot = ring.acquire(stopped)
            if tst:
                tst.add_bp_wait(time.perf_counter() - tw)
            return _End if slot is None else slot

        def copy_to_device(bufs, slot, stream):
            """Copy this worker's staging buffers into `slot`'s tensors (or
            new ones): ({name: device tensor}, copy event or None, the
            copy's seconds on the card, or None on the CPU)."""
            if slot is not None:
                out = ring.tensors(slot, {
                    n: (tuple(t.shape), t.dtype)
                    for n, (t, _) in bufs.items()})
            else:
                out = {n: torch.empty(tuple(t.shape), dtype=t.dtype,
                                      device=dev)
                       for n, (t, _) in bufs.items()}
            if not cuda:
                for n, (t, _) in bufs.items():
                    out[n].copy_(t)
                return out, None, None
            start = torch.cuda.Event(enable_timing=True)
            ev = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record(stream)
                for n, (t, _) in bufs.items():
                    out[n].copy_(t, non_blocking=True)
                ev.record(stream)
            # the pinned buffer is refilled only after its copy is done
            ev.synchronize()
            return out, ev, start.elapsed_time(ev) / 1e3

        def work(lst):
            if tracing:
                with _trace.attach(tctx):
                    work_loop(lst)
            else:
                work_loop(lst)

        def work_loop(lst):
            # this worker's private staging buffers and copy stream
            holder = {}
            try:
                if cuda:
                    torch.cuda.set_device(dev)
                stream = torch.cuda.Stream(dev) if cuda else None
                while not state["stop"]:
                    tw = time.perf_counter()
                    waited = False
                    while not tickets.acquire(timeout=_POLL_S):
                        if state["stop"]:
                            return
                        waited = True
                    if waited and tst:
                        # prefetch budget full: downstream backpressure
                        tst.add_bp_wait(time.perf_counter() - tw)
                    slot = None
                    if self._stage_fn is None:
                        slot = acquire_slot()
                        if slot is _End:  # stopped
                            tickets.release()
                            return
                    tp = time.perf_counter()
                    nxt = pull_chunk(holder)
                    if nxt is None:
                        if slot is not None:
                            ring.unreserve(slot)
                        tickets.release()
                        return
                    idx, bufs, w = nxt
                    if tracing:
                        _trace.record("datapipe.stack", tp,
                                      time.perf_counter(), kind="datapipe",
                                      attrs={"chunk": idx})
                    try:
                        ev = card_s = None
                        t0 = time.perf_counter()
                        if self._stage_fn is not None:
                            # copies: the callee may keep what it is given
                            staged = self._stage_fn(
                                idx, {n: v.copy() for n, (_, v) in
                                      bufs.items()})
                        elif lst is not None:
                            with lst.span():
                                staged, ev, card_s = copy_to_device(
                                    bufs, slot, stream)
                        else:
                            staged, ev, card_s = copy_to_device(
                                bufs, slot, stream)
                        if self._stage_fn is None:
                            staged = dict(staged)
                        dt = time.perf_counter() - t0
                        nb = sum(v.nbytes for _, v in bufs.values())
                        if tracing:
                            _trace.record(
                                "datapipe.transfer", t0, t0 + dt,
                                kind="datapipe",
                                attrs={"chunk": idx, "bytes": nb})
                        if tst:
                            tst.add_item(busy_s=dt, nbytes=nb)
                        if lst is not None:
                            # the lane's link time: the copy as the card
                            # timed it (the host's time, `dt`, also holds
                            # the thread's waits for the interpreter)
                            lst.add_item(busy_s=dt if card_s is None
                                         else card_s, nbytes=nb)
                            from .. import profiler

                            profiler.record_bytes(
                                f"datapipe/{lst.name}", nb)
                        # transfer-engine metadata: the executor pops both
                        # (pop_markers); stage_fn chunks are callee-owned,
                        # so copy before annotating and never lease them
                        if w is not None:
                            if self._stage_fn is not None:
                                staged = dict(staged)
                            staged[WIRE_KEY] = w
                        if slot is not None:
                            staged[_SLOT] = (slot, ev)
                        elif ev is not None:
                            staged[_EVENT] = ev
                    except BaseException as e:
                        fail(e)
                        return
                    with cond:
                        done[idx] = staged
                        cond.notify_all()
            except BaseException as e:
                fail(e)
            finally:
                with cond:
                    state["ended"] += 1
                    cond.notify_all()

        threads = [threading.Thread(target=work, args=(link_stat(i),),
                                    daemon=True,
                                    name=f"datapipe-feed-{i}")
                   for i in range(self._threads)]
        state["threads"] = tuple(threads)
        for t in threads:
            t.start()

        def next_staged():
            t0 = time.perf_counter()
            with cond:
                while True:
                    if state["error"] is not None:
                        raise state["error"]
                    if state["next_out"] in done:
                        res = done.pop(state["next_out"])
                        state["next_out"] += 1
                        if tst:
                            tst.add_wait_out(time.perf_counter() - t0)
                            tst.sample_depth(len(done) + 1)
                        return res
                    if state["eof_at"] is not None and \
                            state["next_out"] >= state["eof_at"]:
                        return _End
                    if state["ended"] == self._threads:
                        # workers gone and next_out wasn't in `done` above:
                        # EOF, error, or a stop that left a gap in the
                        # reorder buffer — nothing more can arrive
                        if state["error"] is not None:
                            raise state["error"]
                        return _End
                    cond.wait(_POLL_S)

        def hand_over(res):
            """The staged dict as the consumer gets it: the consumer's
            current stream waits for the chunk's copy, and a ring chunk
            carries its ChunkLease under DONATE_KEY."""
            slot, ev = res.pop(_SLOT, (None, None))
            ev = res.pop(_EVENT, ev)
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)
            if slot is not None:
                ring.hand_out(slot)
                res[DONATE_KEY] = ChunkLease(ring, slot, ev)
            return res

        try:
            while True:
                res = next_staged()
                if res is _End:
                    return
                tickets.release()
                yield hand_over(res)
        finally:
            state["stop"] = True
            with cond:
                cond.notify_all()
            if self._active is state:
                self._active = None


# private keys of a staged dict between a worker and the consumer side
_SLOT = "__slot__"
_EVENT = "__copy_event__"
