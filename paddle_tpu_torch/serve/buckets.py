"""Bucket ladder: the fixed set of batch shapes a server dispatches.

The executor prepares one step per feed shape, and on a card captures one
CUDA graph per shape; a serving path that padded every batch to exactly
its row count would prepare and capture max_batch distinct steps on
demand — each a stall in the latency tail. The ladder quantizes instead:
requests coalesce to the SMALLEST ladder rung that fits, so after warmup
(which captures every rung) no dispatch ever leaves the cache. The
default ladder is powers of two up to max_batch — log2(max_batch)+1
graphs buy zero steady-state captures at a worst-case 2x padding
overhead. A copy of the JAX package's paddle_tpu/serve/buckets.py.
"""

import numpy as np

__all__ = ["ladder", "bucket_for", "pad_rows"]


def ladder(max_batch, buckets=None):
    """The sorted tuple of batch buckets ending at max_batch.

    `buckets=None` gives the power-of-two ladder (1, 2, 4, ..., max_batch,
    with max_batch appended when it is not itself a power of two); an
    explicit iterable is validated, deduplicated and capped instead."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if buckets is None:
        rungs = []
        b = 1
        while b < max_batch:
            rungs.append(b)
            b *= 2
        rungs.append(max_batch)
        return tuple(rungs)
    rungs = sorted({int(b) for b in buckets})
    if not rungs or rungs[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    if rungs[-1] > max_batch:
        raise ValueError(
            f"bucket {rungs[-1]} exceeds max_batch {max_batch}")
    if rungs[-1] != max_batch:
        rungs.append(max_batch)
    return tuple(rungs)


def bucket_for(rows, rungs):
    """Smallest rung that fits `rows`, or None when rows exceed the top."""
    for b in rungs:
        if rows <= b:
            return b
    return None


def pad_rows(feed, rows, bucket):
    """Zero-pad every feed array's leading (batch) axis from rows to
    bucket. Returns the same dict when bucket == rows (no copy)."""
    if bucket == rows:
        return feed
    if bucket < rows:
        raise ValueError(f"bucket {bucket} < rows {rows}")
    out = {}
    for name, v in feed.items():
        v = np.asarray(v)
        if v.shape[0] != rows:
            raise ValueError(
                f"feed {name!r} leading axis {v.shape[0]} != rows {rows}")
        pad = np.zeros((bucket - rows,) + v.shape[1:], dtype=v.dtype)
        out[name] = np.concatenate([v, pad], axis=0)
    return out
