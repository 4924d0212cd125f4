"""Device-staged input pipeline — DEPRECATED shim.

The JAX package's shim (paddle_tpu/pipeline.py): DeviceChunkFeeder is a
thin wrapper over datapipe.AsyncDeviceFeeder, kept so existing call sites
keep working. New code should build a datapipe.DataPipe
(.batch().prefetch_to_device(chunk=K)) or use AsyncDeviceFeeder directly.

This module is the *input*-pipeline shim, unrelated to pipeline
parallelism.
"""

import warnings

__all__ = ["DeviceChunkFeeder"]

# once per process, not per instantiation: Trainer loops rebuild their
# feeder every pass, and the default "default" warning filter dedupes by
# code location only per-module-registry, which user warning config
# (-W always, pytest filters) routinely defeats
_deprecation_warned = False


class DeviceChunkFeeder:
    """Deprecated: use datapipe.AsyncDeviceFeeder / DataPipe.

    Iterate device-resident [K, ...] feed dicts off a prefetch thread.

    reader():      yields per-step feed dicts {name: ndarray}
    chunk:         K, the number of steps per dispatch (Executor iters=K)
    place:         Place the chunks are staged to (default CUDAPlace(0);
                   CPUPlace() stages host tensors)
    capacity:      staged chunks buffered ahead (2 = classic double buffer)
    stage_fn:      optional override for the host->device staging step,
                   called as stage_fn(chunk_index, {name: stacked_ndarray})
                   -> {name: device tensor}

    The tail is dropped if fewer than `chunk` batches remain. A single
    transfer thread is kept (the historical behavior: stage_fn sees chunk
    indices strictly in order); pass transfer_threads to
    AsyncDeviceFeeder for parallel transfer streams.
    """

    def __init__(self, reader, chunk, place=None, capacity=2, stage_fn=None):
        global _deprecation_warned
        if not _deprecation_warned:
            _deprecation_warned = True
            warnings.warn(
                "pipeline.DeviceChunkFeeder is deprecated; use "
                "datapipe.AsyncDeviceFeeder (or DataPipe.prefetch_to_device)",
                DeprecationWarning, stacklevel=2)
        from .datapipe import AsyncDeviceFeeder

        if int(chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        # donate=False: the legacy contract yields plain {name: tensor}
        # chunk dicts with no transfer-engine metadata riding along, each
        # with tensors of its own
        self._feeder = AsyncDeviceFeeder(
            reader, chunk=chunk, place=place, capacity=max(2, int(capacity)),
            transfer_threads=1, stage_fn=stage_fn, donate=False)

    def __iter__(self):
        return iter(self._feeder)
