"""paddle_tpu_torch.datapipe — parallel prefetching input pipeline (the
JAX package's datapipe, with torch staging onto the card).

A tf.data/Grain-class subsystem that keeps the device fed: sharded
seekable sources, threaded OR process-parallel decode with bounded
order-preserving queues, preallocated staging-buffer batching, and
background host->device transfer from pinned staging buffers on a CUDA
side stream, with double buffering — each stage
instrumented (queue depths, busy/wait ratios) through the profiler.

    from paddle_tpu_torch import datapipe
    pipe = (datapipe.DataPipe.from_recordio(path, parse_fn=parse)
            .map(decode, num_workers=4, processes=True)
            .prefetch_to_device(chunk=10, capacity=4))
    exe.run(program, feed=pipe, fetch_list=[loss])

map(processes=True) runs decode in worker processes (no GIL ceiling);
wired directly before prefetch_to_device(chunk=K) the two stages fuse
through a shared-memory ring of wire-dtype chunk buffers; the feeder
stacks each slot into its pinned buffer (one host copy) before the link.

The JAX package's docs/datapipe.md sets out the design and the stage-level
semantics, which this copy keeps.
"""

from .batcher import Batcher
from .feeder import AsyncDeviceFeeder
from .parallel_map import ParallelMap
from .pipeline import DataPipe
from .process_map import DataPipeError, ProcessPoolMap
from .shm import (SEGMENT_PREFIX, SHM_SLOT_KEY, ShmRing, ShmRingClient,
                  SlotLease, live_segments)
from .source import (GeneratorSource, RecordIOSource, Source,
                     default_shard_assignment)
from .stats import PipeStats, StageStats
from .transfer import (DONATE_KEY, WIRE_KEY, WireFormat, WireSpec,
                       auto_wire, pop_markers)

__all__ = [
    "DataPipe",
    "DataPipeError",
    "Source",
    "GeneratorSource",
    "RecordIOSource",
    "default_shard_assignment",
    "ParallelMap",
    "ProcessPoolMap",
    "Batcher",
    "AsyncDeviceFeeder",
    "PipeStats",
    "StageStats",
    "WireFormat",
    "WireSpec",
    "WIRE_KEY",
    "DONATE_KEY",
    "SHM_SLOT_KEY",
    "SEGMENT_PREFIX",
    "ShmRing",
    "ShmRingClient",
    "SlotLease",
    "live_segments",
    "auto_wire",
    "pop_markers",
]
