"""DataPipe: composable, observable input pipeline.

Wiring model (tf.data / Grain style, SURVEY §1 "Data pipeline"):

    pipe = (datapipe.DataPipe.from_recordio("train-*.recordio",
                                            parse_fn=parse)
            .map(decode, num_workers=4)
            .batch(128)
            .prefetch_to_device(place=fluid.CUDAPlace(0), chunk=10,
                                capacity=4, transfer_threads=2))
    for staged in pipe:                      # device-resident [K,...] dicts
        exe.run(program, feed=staged, iters=10, ...)

or hand the pipe straight to the executor, which pulls chunks itself:

    exe.run(program, feed=pipe, fetch_list=[loss])   # iters=pipe.feed_iters

Each stage runs concurrently with the others (worker threads + bounded
queues with backpressure), and every stage records busy/wait/queue-depth
counters surfaced by .stats() and the profiler timeline.

On the card the last stage stacks into pinned host buffers and copies
them on CUDA side streams into a ring of device chunk buffers
(feeder.py); prefetch_to_device(fluid.CPUPlace()) runs the same stages
into host tensors.

Zero-copy handoff: when .batch() is immediately followed by
.prefetch_to_device(chunk=K), the Batcher hands its ring staging buffers
out directly (no per-batch copy) — safe because the feeder copies each
batch into its chunk buffer under the pull lock before the next batch is
pulled, which is the ring-reuse boundary batcher.py documents.
"""

from .. import trace as _trace
from ..flags import get as get_flag
from .batcher import Batcher
from .parallel_map import ParallelMap
from .process_map import ProcessPoolMap
from .source import GeneratorSource, RecordIOSource, SkipSource, Source
from .stats import PipeStats

__all__ = ["DataPipe"]


def _named_sample_adapter(reader, feed_names):
    """Legacy fluid readers yield positional tuples; wrap into the dict
    samples the datapipe stages speak."""

    def adapted():
        it = reader() if callable(reader) else iter(reader)
        for sample in it:
            if isinstance(sample, dict):
                yield sample
                continue
            if len(sample) != len(feed_names):
                raise ValueError(
                    f"reader sample has {len(sample)} slots, feed_names "
                    f"names {len(feed_names)}: {feed_names}")
            yield dict(zip(feed_names, sample))

    return adapted


class DataPipe:
    """Immutable-ish builder: every transform returns a new DataPipe; the
    stage chain (threads, queues, buffers) is only built on iteration."""

    def __init__(self, source, _ops=None, _stats=None):
        if not isinstance(source, Source):
            source = GeneratorSource(source)
        self._source = source
        self._ops = list(_ops or [])
        self._stats = _stats if _stats is not None else PipeStats()
        self._stage_memo = {}  # op index -> StageStats (stable across iters)
        self._it = None        # persistent iterator for next_feed()
        self._layers = []      # built generators, innermost first
        self._stage_objs = []  # built stage objects (close/join handles)
        # source-position accounting for checkpoint/restore (resilience):
        self._pass_emitted = 0      # items yielded to the consumer this pass
        self._resume_base = 0       # records skipped at this pass's build
        self._resume_records = None  # pending skip for the NEXT build
        self._resolved_wire = None   # wire="auto" resolution, once built

    # -- construction ----------------------------------------------------
    @classmethod
    def from_reader(cls, reader, feed_names=None):
        """Wrap a legacy reader creator (callable yielding samples). With
        feed_names, positional tuple samples become {name: value} dicts."""
        if feed_names is not None:
            reader = _named_sample_adapter(reader, list(feed_names))
        return cls(GeneratorSource(reader))

    @classmethod
    def from_recordio(cls, paths, parse_fn=None, pass_num=1,
                      num_shards=None, shard_index=None, batch_read=64):
        return cls(RecordIOSource(paths, parse_fn=parse_fn,
                                  pass_num=pass_num, num_shards=num_shards,
                                  shard_index=shard_index,
                                  batch_read=batch_read))

    def _derive(self, op):
        p = DataPipe(self._source, self._ops + [op], self._stats)
        p._stage_memo = self._stage_memo
        return p

    def shard(self, num_shards, index):
        """Restrict the SOURCE to one disjoint shard (record i belongs to
        shard i % num_shards). Defaults come from the process topology at
        source construction; call this to override explicitly."""
        p = DataPipe(self._source.shard(num_shards, index), self._ops,
                     self._stats)
        p._stage_memo = self._stage_memo
        return p

    def map(self, fn, num_workers=2, buffer_size=None, order=True,
            processes=False):
        """Apply fn to every sample on num_workers threads (bounded,
        order-preserving unless order=False).

        processes=True runs the map in worker PROCESSES instead
        (ProcessPoolMap) — pure-Python decode that holds the GIL scales
        past the thread ceiling; an int is shorthand for
        processes=True, num_workers=N. When a process map is wired
        DIRECTLY in front of prefetch_to_device(chunk=K) the two stages
        fuse: workers decode straight into a shared-memory ring of
        wire-dtype chunk buffers and the feeder stacks each slot into its
        pinned staging buffer, the one host copy between decode and
        link."""
        if processes and not isinstance(processes, bool):
            num_workers = int(processes)
            processes = True
        return self._derive(("map", dict(fn=fn, num_workers=num_workers,
                                         buffer_size=buffer_size,
                                         order=order,
                                         processes=bool(processes))))

    def batch(self, batch_size, drop_remainder=True, pad_to_batch=False,
              ring=2):
        """Pack samples into preallocated [batch_size, ...] staging
        buffers; see Batcher for the drop/pad tail modes."""
        return self._derive(("batch", dict(batch_size=batch_size,
                                           drop_remainder=drop_remainder,
                                           pad_to_batch=pad_to_batch,
                                           ring=ring)))

    def prefetch_to_device(self, place=None, chunk=None, capacity=None,
                           transfer_threads=None, stage_fn=None,
                           wire="auto", donate=None):
        """Terminal stage: background host->device staging (see
        AsyncDeviceFeeder) to `place` (default CUDAPlace(0); CPUPlace()
        stages host tensors). chunk=K stacks K batches per staged item for
        Executor.run(iters=K); Executor reads K off .feed_iters.
        capacity=None reads FLAGS_datapipe_prefetch_depth (0 = 2, the
        double buffer); deeper prefetch rides out decode jitter.

        wire=WireSpec(...) ships covered feeds in their compressed wire
        dtype (uint8 pixels cut link bytes 4x vs float32) and the executor
        decodes (cast, normalize) inside the step. The
        default "auto" covers every uint8 feed with a pass-through uint8
        wire (numerically identical to the host cast it replaces;
        FLAGS_wire_compress=0 disables); wire=None ships everything
        uncompressed. donate stages into the feeder's ring of device
        chunk buffers, each chunk handed out with a lease the executor
        releases after its run (None = auto, see AsyncDeviceFeeder).
        """
        return self._derive(("device", dict(place=place, chunk=chunk,
                                            capacity=capacity,
                                            transfer_threads=transfer_threads,
                                            stage_fn=stage_fn, wire=wire,
                                            donate=donate)))

    # -- execution -------------------------------------------------------
    @property
    def feed_iters(self):
        """K of the prefetch_to_device(chunk=K) stage, else None. The
        executor uses this as its default iters= when fed a DataPipe."""
        for kind, kw in self._ops:
            if kind == "device" and kw["chunk"] is not None:
                return kw["chunk"]
        return None

    @property
    def wire_spec(self):
        """The prefetch_to_device stage's WireSpec (None when the pipe
        ships feeds uncompressed). "auto" reports the spec resolved from
        the first sample once iteration has started, None before."""
        for kind, kw in self._ops:
            if kind == "device":
                w = kw.get("wire")
                if w == "auto":
                    return self._resolved_wire
                return w
        return None

    def _set_resolved_wire(self, spec):
        self._resolved_wire = spec

    def _stage(self, i, name):
        if (i, name) not in self._stage_memo:
            self._stage_memo[(i, name)] = self._stats.stage(name)
        return self._stage_memo[(i, name)]

    def _build(self):
        with _trace.span("datapipe.build", kind="datapipe",
                         stages=len(self._ops)):
            return self._build_stages()

    def _build_stages(self):
        from .feeder import AsyncDeviceFeeder

        src = self._source
        self._resume_base = 0
        if self._resume_records:  # restore_state: fast-forward the source
            src = SkipSource(src, self._resume_records)
            self._resume_base = self._resume_records
            self._resume_records = None
        layers, objs = [], []
        cur = src
        fused_map = None  # index of a map op fused into the next device op
        for i, (kind, kw) in enumerate(self._ops):
            if kind == "map":
                kw2 = dict(kw)
                procs = kw2.pop("processes", False)
                if procs:
                    nxt = (self._ops[i + 1]
                           if i + 1 < len(self._ops) else None)
                    # fusion: process map feeding prefetch_to_device(K)
                    # directly — workers decode into a shared-memory ring
                    # of [K, ...] wire-dtype chunk slots, which the feeder
                    # stacks into its pinned buffers
                    fuse = bool(nxt and nxt[0] == "device"
                                and nxt[1]["chunk"] is not None
                                and nxt[1].get("stage_fn") is None)
                    if fuse:
                        dkw = nxt[1]
                        cap = dkw.get("capacity")
                        if cap is None:
                            cap = get_flag("datapipe_prefetch_depth") or 2
                        obj = ProcessPoolMap(
                            cur, chunk=int(dkw["chunk"]),
                            wire=dkw.get("wire"),
                            # one assembling + the feeder's prefetch
                            # budget, +1 so release latency never stalls
                            ring_slots=int(cap) + 2,
                            wire_cb=self._set_resolved_wire,
                            stats=self._stage(i, "map"), **kw2)
                        fused_map = i
                    else:
                        obj = ProcessPoolMap(
                            cur, stats=self._stage(i, "map"), **kw2)
                else:
                    obj = ParallelMap(cur, stats=self._stage(i, "map"),
                                      **kw2)
            elif kind == "batch":
                nxt = self._ops[i + 1] if i + 1 < len(self._ops) else None
                zero_copy = bool(nxt and nxt[0] == "device"
                                 and nxt[1]["chunk"] is not None)
                obj = Batcher(cur, zero_copy=zero_copy,
                              stats=self._stage(i, "batch"), **kw)
            elif kind == "device":
                kw2 = dict(kw)
                if fused_map == i - 1:
                    # the fused map already emits complete wire-encoded
                    # [K, ...] chunks (with their WIRE_KEY): stage as-is
                    kw2["chunk"] = None
                    kw2["wire"] = None
                obj = AsyncDeviceFeeder(
                    cur, stack_stats=self._stage(i, "stack"),
                    transfer_stats=self._stage(i, "transfer"),
                    # one lane per transfer thread: link0..linkN-1 rows in
                    # stats() show whether the streams share the link's
                    # bandwidth or serialize on it
                    link_stats=lambda t, _i=i: self._stage(_i, f"link{t}"),
                    wire_cb=self._set_resolved_wire,
                    **kw2)
            else:  # pragma: no cover - builder invariant
                raise AssertionError(f"unknown op {kind!r}")
            cur = iter(obj)
            layers.append(cur)
            objs.append(obj)
        return cur, layers, objs

    def __iter__(self):
        cur, layers, objs = self._build()
        self._layers = layers
        self._stage_objs = objs
        self._pass_emitted = 0
        if not layers:  # bare source
            for item in cur:
                self._pass_emitted += 1
                yield item
            return
        try:
            for item in cur:
                self._pass_emitted += 1
                yield item
        finally:
            self.close(_keep_it=True)

    # -- executor-facing pull API ---------------------------------------
    def next_feed(self):
        """Next staged feed dict off the persistent iterator (started on
        first call); raises StopIteration when the pipe is exhausted."""
        if self._it is None:
            self._it = iter(self)
        return next(self._it)

    def reset(self):
        """Stop the persistent iterator so the next next_feed() restarts
        the pipeline from the source (fresh pass)."""
        self.close()
        self._it = None

    def close(self, _keep_it=False):
        """Shut down every stage's worker threads (idempotent), even when
        torn down mid-step. Generator .close() alone can't do this: an
        inner stage's generator is EXECUTED BY the outer stage's worker
        threads, so closing it from here raises "generator already
        executing" and the inner workers leak. Instead: (1) flip every
        stage's object-level stop flag (thread-safe), (2) join worker
        threads outermost-first (workers poll stop at 0.2s granularity),
        (3) only then close the generators — nothing is executing them
        anymore."""
        if not _keep_it and self._it is not None:
            it, self._it = self._it, None
            it.close()
        for obj in self._stage_objs:  # innermost first: EOF flows outward
            close_fn = getattr(obj, "close", None)
            if close_fn is not None:
                close_fn()
        for obj in reversed(self._stage_objs):
            join = getattr(obj, "join_workers", None)
            if join is not None:
                join()
        for gen in reversed(self._layers):
            try:
                gen.close()
            except Exception:
                pass
        self._layers = []
        self._stage_objs = []

    # -- checkpoint/restore (resilience, ROADMAP queue 1 item 5) ----------
    def _records_per_item(self):
        """Source records consumed per item the pipe emits (batch x chunk).
        map stages are 1:1; exact for full batches, which drop_remainder
        guarantees everywhere but the final partial tail."""
        n = 1
        for kind, kw in self._ops:
            if kind == "batch":
                n *= int(kw["batch_size"])
            elif kind == "device" and kw["chunk"]:
                n *= int(kw["chunk"])
        return n

    def checkpoint_state(self):
        """Source position for a checkpoint manifest: how many (post-shard)
        records the CONSUMER has seen this pass. Counted at emission — not
        at the source, where prefetched-but-unconsumed records would be
        wrongly marked consumed and dropped on restore."""
        if self._resume_records is not None:  # restored, not yet iterated
            return {"records": self._resume_records}
        return {"records": self._resume_base
                + self._pass_emitted * self._records_per_item(),
                "emitted": self._pass_emitted}

    def restore_state(self, state):
        """Arrange for the next pass to skip the records a checkpoint
        recorded as consumed (checkpoint_state). Takes effect at the next
        build — call close()/reset() first if an iteration is live."""
        records = int(state.get("records", 0))
        self._resume_records = records if records > 0 else None
        self._pass_emitted = 0
        self._resume_base = 0

    def stats(self):
        """{stage: {items, bytes, busy_s, wait_in_s, wait_out_s, ...},
        'fractions': {...}} — see datapipe.stats.PipeStats.snapshot."""
        return self._stats.snapshot()

    def stats_delta(self):
        """Per-stage counter deltas since the previous stats_delta() call
        (what ONE step consumed) — merged into the monitor's step journal
        when the executor pulls from this pipe."""
        return self._stats.delta()
