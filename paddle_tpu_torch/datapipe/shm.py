"""Shared-memory staging rings for the process-parallel decode path.

A ShmRing is a pool of POSIX shared-memory slots. Each slot holds one
CHUNK of staged feeds — a set of named arrays laid out back-to-back at
64-byte-aligned offsets inside one `multiprocessing.shared_memory`
segment, already in their WIRE dtype. Decode workers attach to the
segments by name (ShmRingClient) and write their results directly into
`slot[g]` for their assigned (slot, offset); the parent never copies the
decoded bytes again until AsyncDeviceFeeder stacks the slot's views into
its pinned staging buffer, the one host copy before the card's link (an
unpinned shm page cannot be copied asynchronously).

Ownership protocol:

  * the PARENT allocates, acquires and releases slots (workers only ever
    write into a slot the parent assigned them, so no cross-process
    locking is needed);
  * a slot is busy from dispatch of its first item until the consumer of
    the staged chunk calls `SlotLease.release()` — for the fused
    map->device path that consumer is the feeder, which releases once it
    has copied the slot into its pinned staging buffer (or into a host
    chunk of its own for a CPU place);
  * `close()` closes and unlinks every segment (idempotent). Worker
    processes merely close their attachments.

Segment names carry the `pttpipe_` prefix so leaked segments are greppable
in /dev/shm; a module-level registry (`live_segments()`) backs the
no-leak pytest fixture and the green-gate smoke.

Super-slot coalescing: logical slots are packed `coalesce` per POSIX
segment (one mmap + one /dev/shm inode per SUPER-slot instead of per
chunk), at 64-byte-aligned strides. Fewer segments means fewer attach
mmaps in every worker, fewer page-table entries, and bigger contiguous
regions for the kernel to fault in — the "larger chunks" half of the
unthrottled staging path. The acquire/release protocol is unchanged:
slots stay the unit of ownership, only their backing storage is shared.
"""

import os
import threading

import numpy as np

__all__ = ["ShmRing", "ShmRingClient", "SlotLease", "SHM_SLOT_KEY",
           "live_segments", "SEGMENT_PREFIX"]

SHM_SLOT_KEY = "__shm_slot__"  # staged-chunk metadata: its SlotLease
SEGMENT_PREFIX = "pttpipe"

_ALIGN = 64  # device_put zero-copy wants 64-byte-aligned host buffers

_live_lock = threading.Lock()
_live = set()  # segment names created (and not yet unlinked) by this proc
_seq = [0]


def live_segments():
    """Names of shm segments this process created and has not unlinked —
    must be empty after every test (conftest fixture) and after bench
    runs (green gate)."""
    with _live_lock:
        return sorted(_live)


def _register(name):
    with _live_lock:
        _live.add(name)


def _unregister(name):
    with _live_lock:
        _live.discard(name)


def _layout(schema):
    """(offsets, total_size) for {name: (shape, dtype)} laid out
    back-to-back at _ALIGN boundaries."""
    offsets, off = {}, 0
    for name, (shape, dtype) in schema.items():
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
        offsets[name] = off
        off += int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return offsets, max(off, 1)


def _normalize_schema(schema):
    return {str(n): (tuple(int(d) for d in shape), str(np.dtype(dt)))
            for n, (shape, dt) in schema.items()}


class SlotLease:
    """Handle to one acquired ring slot, released exactly once by
    whichever stage consumes the staged chunk (idempotent)."""

    __slots__ = ("_ring", "slot", "_done")

    def __init__(self, ring, slot):
        self._ring = ring
        self.slot = slot
        self._done = False

    def release(self):
        if not self._done:
            self._done = True
            self._ring.release(self.slot)

    def __repr__(self):
        return f"SlotLease(slot={self.slot}, released={self._done})"


def _auto_coalesce(slots, stride):
    """Chunks packed per segment: as many as fit in ~8 MB (but never more
    than the ring has), so small-chunk rings collapse to one segment while
    image-scale chunks keep one segment each."""
    cap = max(1, (8 << 20) // max(stride, 1))
    return max(1, min(int(slots), cap))


class ShmRing:
    """Parent-side ring of `slots` logical shared-memory slots, each
    holding the arrays of `schema` ({name: (shape, dtype)}), packed
    `coalesce` slots per POSIX segment (super-slots)."""

    def __init__(self, slots, schema, name_hint="ring", coalesce=None):
        from multiprocessing import shared_memory

        if int(slots) < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.schema = _normalize_schema(schema)
        self._offsets, self._size = _layout(self.schema)
        # slot stride inside a super-slot segment, aligned so every
        # slot's first array stays 64-byte-aligned for zero-copy puts
        self._stride = (self._size + _ALIGN - 1) // _ALIGN * _ALIGN
        if coalesce is None:
            coalesce = _auto_coalesce(slots, self._stride)
        self._coalesce = max(1, min(int(coalesce), int(slots)))
        self._n_slots = int(slots)
        n_segs = (self._n_slots + self._coalesce - 1) // self._coalesce
        self._segs = []
        self._names = []
        for i in range(n_segs):
            _seq[0] += 1
            # slots in the tail segment: may be fewer than `coalesce`
            n_here = min(self._coalesce,
                         self._n_slots - i * self._coalesce)
            name = (f"{SEGMENT_PREFIX}_{os.getpid()}_{_seq[0]}_"
                    f"{name_hint}_{i}")
            seg = shared_memory.SharedMemory(
                name=name, create=True, size=self._stride * n_here)
            _register(seg.name)
            self._segs.append(seg)
            self._names.append(seg.name)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._free = list(range(int(slots)))
        self._closed = False

    @property
    def slots(self):
        return self._n_slots

    @property
    def coalesce(self):
        return self._coalesce

    @property
    def segments(self):
        return len(self._names)

    @property
    def nbytes(self):
        return self._stride * self._n_slots

    def meta(self):
        """Picklable attach info for ShmRingClient in worker processes."""
        return {"names": list(self._names), "schema": dict(self.schema),
                "offsets": dict(self._offsets),
                "coalesce": self._coalesce, "stride": self._stride}

    # -- slot pool (parent threads only) --------------------------------
    def acquire(self, timeout=0.2):
        """Next free slot index, or None after `timeout` (caller re-polls
        so stop flags stay responsive)."""
        with self._cond:
            if not self._free:
                self._cond.wait(timeout)
            if not self._free:
                return None
            return self._free.pop()

    def release(self, slot):
        with self._cond:
            if not self._closed and slot not in self._free:
                self._free.append(slot)
                self._cond.notify()

    def lease(self, slot):
        return SlotLease(self, slot)

    def views(self, slot):
        """{name: ndarray} views over one slot's buffer (no copies)."""
        seg_i, lane = divmod(slot, self._coalesce)
        buf = self._segs[seg_i].buf
        base = lane * self._stride
        out = {}
        for name, (shape, dtype) in self.schema.items():
            off = base + self._offsets[name]
            out[name] = np.ndarray(shape, dtype=dtype, buffer=buf,
                                   offset=off)
        return out

    def close(self):
        """Close + unlink every segment (idempotent). Call after worker
        processes are joined; POSIX keeps the memory alive for any
        straggler mapping until its last close."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        for seg in self._segs:
            try:
                seg.close()
            except Exception:
                pass
            try:
                seg.unlink()
            except Exception:
                pass
            _unregister(seg.name)
        self._segs = []


class _MMapSeg:
    """Direct mmap of /dev/shm/<name>: the attachment path that does NOT
    involve multiprocessing.resource_tracker. Attaching via SharedMemory
    in a worker either double-unregisters the parent's tracker entry
    (fork: shared tracker process) or unlinks live segments at worker
    exit (spawn: bpo-39959) — mapping the file directly sidesteps both."""

    __slots__ = ("_f", "_mm", "buf")

    def __init__(self, path):
        import mmap

        self._f = open(path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), 0)
        self.buf = memoryview(self._mm)

    def close(self):
        try:
            self.buf.release()
        except Exception:
            pass
        try:
            self._mm.close()
        except Exception:
            pass
        try:
            self._f.close()
        except Exception:
            pass


class ShmRingClient:
    """Worker-side attachment: lazily opens segments by name and exposes
    the same views() layout. Workers write, never acquire/release."""

    def __init__(self, meta):
        self._names = list(meta["names"])
        self._schema = {n: (tuple(s), d)
                        for n, (s, d) in meta["schema"].items()}
        self._offsets = dict(meta["offsets"])
        # pre-coalescing parents (older meta) map one slot per segment
        self._coalesce = int(meta.get("coalesce", 1))
        self._stride = int(meta.get("stride", 0))
        self._segs = {}

    def _seg(self, seg_i):
        seg = self._segs.get(seg_i)
        if seg is None:
            path = f"/dev/shm/{self._names[seg_i]}"
            if os.path.exists(path):
                seg = _MMapSeg(path)
            else:  # platforms without /dev/shm, tracker quirks and all
                from multiprocessing import shared_memory

                seg = shared_memory.SharedMemory(name=self._names[seg_i])
            self._segs[seg_i] = seg
        return seg

    def views(self, slot):
        seg_i, lane = divmod(slot, self._coalesce)
        buf = self._seg(seg_i).buf
        base = lane * self._stride
        out = {}
        for name, (shape, dtype) in self._schema.items():
            off = base + self._offsets[name]
            out[name] = np.ndarray(shape, dtype=dtype, buffer=buf,
                                   offset=off)
        return out

    def write(self, slot, index, values, wire=None):
        """Encode + copy one decoded sample dict into row `index` of slot
        `slot` — the single host-side copy of the fused decode path.
        Unknown and '__'-metadata keys are ignored (schema is authority)."""
        views = self.views(slot)
        for name, view in views.items():
            v = values[name]
            if wire is not None and name in wire:
                v = wire[name].encode(v)
            view[index] = v

    def write_batch(self, slot, index0, values_list, wire=None):
        """write() for a run of consecutive rows starting at `index0`,
        constructing each slot view ONCE instead of per item — the hot
        loop of coalesced (taskb) dispatch."""
        views = self.views(slot)
        for name, view in views.items():
            enc = wire[name].encode if wire is not None and name in wire \
                else None
            for j, values in enumerate(values_list):
                v = values[name]
                view[index0 + j] = enc(v) if enc is not None else v

    def close(self):
        for seg in self._segs.values():
            try:
                seg.close()
            except Exception:
                pass
        self._segs = {}
