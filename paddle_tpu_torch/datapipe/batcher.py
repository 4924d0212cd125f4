"""Batcher: pack samples into preallocated contiguous staging buffers.

Two tail modes (reference create_batch_reader_op.cc only drops):
  drop_remainder=True   — a partial final batch is dropped (static shapes,
                          no recompile; the DeviceChunkFeeder behavior)
  pad_to_batch=True     — the partial batch is padded by repeating its last
                          sample up to batch_size; the yielded dict carries
                          "__valid__": a [batch_size] bool_ mask (True for
                          real rows) so consumers can exclude the pad rows
                          from mean-reduced losses/metrics

Staging buffers are C-contiguous np arrays allocated ONCE per ring slot and
refilled in place — the allocation-per-batch the naive np.stack path pays is
what this removes from the hot loop (and contiguity is what keeps the
eventual device_put a single linear DMA). zero_copy=True hands out the ring
buffers themselves and is only safe when the next stage copies the data out
synchronously before consuming `ring - 1` further items (the Chunker and
AsyncDeviceFeeder both do; DataPipe wiring sets this automatically).
"""

import numpy as np

__all__ = ["Batcher"]


class Batcher:
    def __init__(self, source, batch_size, drop_remainder=True,
                 pad_to_batch=False, ring=2, zero_copy=False, stats=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if pad_to_batch and drop_remainder:
            # explicit pad wins; keeping both True is almost surely a
            # caller passing pad_to_batch to the drop-default signature
            drop_remainder = False
        self._source = source
        self._bs = int(batch_size)
        self._drop = drop_remainder
        self._pad = pad_to_batch
        self._ring = max(2, int(ring))
        self._zero_copy = zero_copy
        self._stats = stats

    def _alloc_ring(self, sample):
        rings = {}
        for name, arr in sample.items():
            if name.startswith("__"):
                # stage metadata (shm leases, wire markers) is per-item,
                # not batchable — consumed below, never staged
                continue
            arr = np.asarray(arr)
            rings[name] = [
                np.empty((self._bs,) + arr.shape, arr.dtype)
                for _ in range(self._ring)
            ]
        return rings

    def __iter__(self):
        import time

        rings = None
        slot = 0
        fill = 0
        st = self._stats

        def emit(n_valid):
            batch = {}
            for name, bufs in rings.items():
                buf = bufs[slot]
                if self._pad and n_valid < self._bs:
                    buf[n_valid:] = buf[n_valid - 1]
                out = buf if self._zero_copy else buf.copy()
                batch[name] = out
            if self._pad:
                # bool_ end to end: feeds straight into a masked-mean loss
                # (cast(mask) -> 0/1 weights) without a host-side compare,
                # and bool_ is what every consumer dtype-checks against
                batch["__valid__"] = np.arange(self._bs) < n_valid
            if st:
                st.add_item(nbytes=sum(
                    b.nbytes for k, b in batch.items() if k != "__valid__"))
            return batch

        t0 = time.perf_counter()
        for sample in self._source:
            if st:
                st.add_wait_in(time.perf_counter() - t0)
            if not isinstance(sample, dict):
                raise TypeError(
                    f"Batcher takes dict samples {{name: array}}, got "
                    f"{type(sample).__name__} (use DataPipe.from_reader's "
                    f"feed_names= to adapt tuple readers)")
            tb = time.perf_counter()
            if rings is None:
                rings = self._alloc_ring(sample)
            lease = sample.get("__shm_slot__")
            for name, arr in sample.items():
                if name.startswith("__"):
                    continue
                try:
                    rings[name][slot][fill] = arr
                except KeyError:
                    raise KeyError(
                        f"sample slot {name!r} not in the first sample's "
                        f"slots {sorted(rings)}") from None
            if lease is not None:
                lease.release()  # copied out: the shm slot may be refilled
            fill += 1
            if st:
                st.busy_s += time.perf_counter() - tb
            if fill == self._bs:
                yield emit(self._bs)
                slot = (slot + 1) % self._ring
                fill = 0
            t0 = time.perf_counter()
        if fill and not self._drop:
            yield emit(fill)
