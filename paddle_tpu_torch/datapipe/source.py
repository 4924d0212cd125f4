"""Source layer: sharded, seekable dataset readers.

A Source is the head of a DataPipe: a restartable iterable of raw items.
RecordIOSource reads the native RecordIO container through the batch-read
C API (recordio.Scanner.read_batch — one ctypes round-trip per N records
instead of per record) and supports disjoint shard assignment: record i
belongs to shard (i % num_shards), implemented with the native skip call so
non-owned records are never copied across the C boundary.

Shard assignment defaults to the ambient data-parallel topology: the
torch.distributed group's world size and rank when one is initialised
(ParallelExecutor's one process per card), so data-parallel replicas read
disjoint shards without any per-replica configuration (SURVEY §1 "Data pipeline"; the reference
splits file lists per trainer in fluid_benchmark.py the same way).
"""

import os

__all__ = ["Source", "GeneratorSource", "RecordIOSource", "SkipSource",
           "default_shard_assignment"]


def default_shard_assignment():
    """(num_shards, shard_index) for this worker: the torch.distributed
    group's (world size, rank) when a group is initialised, else (1, 0).
    One shard per process: each data-parallel rank is one process, so
    per-process sharding is per-replica sharding."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size()), int(dist.get_rank())
    return 1, 0


class Source:
    """Restartable iterable; each __iter__ starts a fresh pass."""

    def __iter__(self):
        raise NotImplementedError

    def shard(self, num_shards, index):  # pragma: no cover - interface
        raise NotImplementedError(
            f"{type(self).__name__} does not support sharding")


class SkipSource(Source):
    """Resume wrapper: skip the first `skip` (post-shard) records of the
    inner source's stream — how a restored DataPipe fast-forwards to its
    checkpointed position without replaying consumed records. Generic
    (works over any Source's iterator); RecordIO-native seek would avoid
    the decode cost of the skipped prefix but not change what is
    emitted."""

    def __init__(self, inner, skip):
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        self._inner = inner
        self._skip = int(skip)

    def shard(self, num_shards, index):  # pragma: no cover - not composed
        raise NotImplementedError("shard before restore, not after")

    def __iter__(self):
        it = iter(self._inner)
        for _ in range(self._skip):
            try:
                next(it)
            except StopIteration:
                return
        yield from it


class GeneratorSource(Source):
    """Wrap a reader creator (a callable returning an iterator — the legacy
    fluid reader convention) or any re-iterable. Sharding is stride-based
    over the sample stream (sample i -> shard i % num_shards)."""

    def __init__(self, reader, num_shards=1, shard_index=0):
        if num_shards < 1 or not (0 <= shard_index < num_shards):
            raise ValueError(
                f"bad shard spec: index {shard_index} of {num_shards}")
        self._reader = reader
        self._num_shards = int(num_shards)
        self._index = int(shard_index)

    def shard(self, num_shards, index):
        return GeneratorSource(self._reader, num_shards, index)

    def __iter__(self):
        it = self._reader() if callable(self._reader) else iter(self._reader)
        if self._num_shards == 1:
            yield from it
            return
        for i, item in enumerate(it):
            if i % self._num_shards == self._index:
                yield item


class RecordIOSource(Source):
    """Sharded, seekable reader over native RecordIO file(s).

    paths:       one path or a list (files are concatenated in order)
    parse_fn:    optional record-bytes -> item decode applied inline (cheap
                 parses only — put heavy decodes in a .map() stage)
    pass_num:    epochs to replay
    num_shards/  disjoint stride sharding over the global record stream;
    shard_index: None = derive both from the process topology
                 (default_shard_assignment)
    batch_read:  records fetched per native call (amortizes the ctypes
                 crossing; recordio.Scanner.read_batch)
    """

    def __init__(self, paths, parse_fn=None, pass_num=1, num_shards=None,
                 shard_index=None, batch_read=64):
        self._paths = [paths] if isinstance(paths, (str, os.PathLike)) \
            else list(paths)
        if not self._paths:
            raise ValueError("RecordIOSource needs at least one path")
        self._parse = parse_fn
        self._pass_num = int(pass_num)
        if num_shards is None and shard_index is None:
            num_shards, shard_index = default_shard_assignment()
        elif num_shards is None or shard_index is None:
            raise ValueError("pass both num_shards and shard_index, or "
                             "neither (auto from the mesh topology)")
        if num_shards < 1 or not (0 <= shard_index < num_shards):
            raise ValueError(
                f"bad shard spec: index {shard_index} of {num_shards}")
        self._num_shards = int(num_shards)
        self._index = int(shard_index)
        self._batch_read = max(1, int(batch_read))

    def shard(self, num_shards, index):
        return RecordIOSource(self._paths, self._parse, self._pass_num,
                              num_shards, index, self._batch_read)

    def _scan_one(self, path, offset):
        """Yield this shard's records from one file; `offset` is the global
        record index of the file's first record (shard stride spans files).
        Returns the record count of the file."""
        from .. import recordio

        n_shards, idx = self._num_shards, self._index
        scanner = recordio.Scanner(path)
        try:
            pos = 0  # records consumed from this file
            # seek to the first record of our shard (native skip: no copy)
            first = (idx - offset) % n_shards
            if first:
                pos += scanner.skip(first)
                if pos < first:
                    return pos  # file ends before our first record
            while True:
                if n_shards == 1:
                    recs = scanner.read_batch(self._batch_read)
                    pos += len(recs)
                else:
                    recs = []
                    for _ in range(self._batch_read):
                        got = scanner.read_batch(1)
                        if not got:
                            break
                        recs.append(got[0])
                        pos += 1
                        skipped = scanner.skip(n_shards - 1)
                        pos += skipped
                        if skipped < n_shards - 1:
                            break
                if not recs:
                    return pos
                for r in recs:
                    yield self._parse(r) if self._parse is not None else r
        finally:
            scanner.close()

    def __iter__(self):
        for _ in range(self._pass_num):
            offset = 0
            for path in self._paths:
                n = yield from self._scan_one(path, offset)
                offset += n
