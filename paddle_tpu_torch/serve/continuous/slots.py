"""Decode state slots: the persistent per-request memory of a
continuous batcher.

A one-shot batcher owns a request for exactly one dispatch; an
iteration-level scheduler owns it for K model steps, and between steps
the request's decode state (the recurrent feeds the next step consumes,
the token prefix produced so far, the per-slot step counter and RNG
seed) has to live SOMEWHERE the next step can reach without a host
round-trip per value. `SlotBank` is that somewhere: one tensor per feed
var on the model's device, shaped [capacity + 1, *example_shape], where
row i is slot i's current value and the extra row is a scratch lane that
padding reads from.

The bank is addressed by a fixed-capacity slot ladder: a step over k
active slots gathers the smallest ladder rung >= k lanes (pad lanes
point at the scratch row), so every step shape the scheduler can ever
issue is known at start() and each rung's step is prepared and captured
before the first request — the slot-count analog of serve/buckets.py's
row-count ladder, preserving the zero-steady-state-capture contract.
Gather (`index_select`) and scatter (`index_copy_`) move rows verbatim
on the device (no arithmetic, no host copy), so a value fed back through
the bank is bitwise the value the model fetched — the foundation of the
decode parity guarantee.

Every pad lane of a step indexes the one scratch row. Several writes to
one row leave an undefined winner (`index_copy_` with duplicate indices,
which torch.use_deterministic_algorithms refuses on a card), so
`scatter` writes the live lanes only: the scratch row is never written,
stays zero, and every pad lane reads the same zeros — nothing reads it
as a result.

A port of the JAX package's paddle_tpu/serve/continuous/slots.py.
"""

import numpy as np
import torch

from ...core import dtypes
from ...core.places import CUDAPlace, device_for
from ..buckets import ladder

__all__ = ["SlotBank"]


class SlotBank:
    """Fixed-capacity per-slot state tensors plus slot bookkeeping.

    var_specs maps feed name -> (example_shape, dtype). Every feed var
    of the model lives in the bank — recurrent state vars get scattered
    back each step, static per-request feeds (conditioning inputs) are
    written once at admission and only ever gathered. `place` is the
    model's place: the first card unless the caller passes another.
    """

    def __init__(self, capacity, var_specs, slot_buckets=None, place=None):
        self.device = device_for(place if place is not None
                                 else CUDAPlace(0))
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.scratch = self.capacity  # the pad lane's row index
        self.rungs = ladder(self.capacity, slot_buckets)
        self.names = list(var_specs)
        self._specs = {n: (tuple(int(d) for d in shape), str(dtype))
                       for n, (shape, dtype) in var_specs.items()}
        self._state = {}
        for n, (shape, dtype) in self._specs.items():
            self._state[n] = torch.zeros(
                (self.capacity + 1,) + shape, dtype=dtypes.to_torch(dtype),
                device=self.device)
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() -> 0
        self._active = []  # sorted slot ids in use
        self.steps = np.zeros(self.capacity, dtype=np.int64)
        self.seeds = np.zeros(self.capacity, dtype=np.uint32)
        self.requests = [None] * self.capacity
        # token prefix: per-slot list of per-step output row tuples,
        # stacked into [steps, ...] arrays when the request completes
        self._prefix = [None] * self.capacity

    # -- slot bookkeeping ------------------------------------------------
    @property
    def free_slots(self):
        return len(self._free)

    def active_slots(self):
        """Sorted tuple of in-use slot ids — the deterministic lane
        order every step gathers and scatters in."""
        return tuple(self._active)

    def alloc(self, request, seed=0):
        """Claim a slot for `request`; None when the bank is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._active.append(slot)
        self._active.sort()
        self.steps[slot] = 0
        self.seeds[slot] = np.uint32(seed)
        self.requests[slot] = request
        self._prefix[slot] = []
        return slot

    def release(self, slot):
        self._active.remove(slot)
        self._free.append(slot)
        self.requests[slot] = None
        self._prefix[slot] = None
        self.steps[slot] = 0

    # -- device-resident state ------------------------------------------
    def _index(self, idx):
        return torch.from_numpy(
            np.ascontiguousarray(idx, dtype=np.int64)).to(self.device)

    def write_row(self, slot, rows):
        """Stage one request's initial feed values into its slot (the
        admission write: one host-to-device copy a feed)."""
        for n, v in rows.items():
            shape, dtype = self._specs[n]
            row = np.ascontiguousarray(v, dtype=dtype).reshape(shape)
            self._state[n][slot].copy_(torch.from_numpy(row))

    def gather(self, idx):
        """{name: [len(idx), ...]} device tensors for the given lane
        indices (pad lanes pass self.scratch)."""
        it = self._index(idx)
        return {n: a.index_select(0, it) for n, a in self._state.items()}

    def scatter(self, idx, values):
        """Write fetched next-state rows back into the bank, on the
        device. `values` maps feed name -> [len(idx), ...]; the lanes
        that index the scratch row are not written (module docstring)."""
        idx = np.asarray(idx)
        live = np.nonzero(idx < self.capacity)[0]
        if not len(live):
            return
        it = self._index(idx[live])
        pick = None if len(live) == len(idx) else self._index(live)
        for n, v in values.items():
            dst = self._state[n]
            if pick is not None:
                v = v.index_select(0, pick)
            dst.index_copy_(0, it, v.to(dst.dtype))

    def lane_index(self, bucket):
        """[bucket] lane->slot index array: active slots first, scratch
        for the pad lanes."""
        idx = np.full(bucket, self.scratch, dtype=np.int32)
        active = self._active
        idx[:len(active)] = active
        return idx

    def rng_rows(self, idx):
        """Deterministic per-(slot, step) RNG key rows, uint32 [n, 2]:
        (seed, step). A request replayed solo sees the identical key
        sequence, so stochastic decodes stay parity-comparable."""
        idx = np.asarray(idx)
        rows = np.zeros((len(idx), 2), dtype=np.uint32)
        for lane, slot in enumerate(idx):
            if slot < self.capacity:
                rows[lane, 0] = self.seeds[slot]
                rows[lane, 1] = np.uint32(self.steps[slot])
        return rows

    # -- token prefix ----------------------------------------------------
    def append_outputs(self, slot, out_rows):
        """Append this step's fetched output rows to the slot's prefix."""
        self._prefix[slot].append(out_rows)

    def take_prefix(self, slot):
        """[steps, ...] stacked arrays, one per output fetch, in fetch
        order — the completed request's result."""
        steps = self._prefix[slot]
        n_out = len(steps[0]) if steps else 0
        return [np.stack([s[i] for s in steps], axis=0)
                for i in range(n_out)]

    # -- warmup ----------------------------------------------------------
    def warm(self):
        """Run every gather/scatter shape the scheduler can issue once:
        one lane count per ladder rung, plus the single-lane admission
        write (slot 0 is zeros anyway). Eager torch compiles nothing; the
        round trip allocates each rung's index and state buffers before
        serving."""
        for b in self.rungs:
            idx = np.full(b, self.scratch, dtype=np.int32)
            self.scatter(idx, self.gather(idx))
        zero = {n: np.zeros(shape, dtype=dtype)
                for n, (shape, dtype) in self._specs.items()}
        self.write_row(0, zero)
