"""Per-replica step-time skew over the ParallelExecutor's ranks.

A multi-card run that reports one aggregate rate hides stragglers: one slow
rank gates every collective, so the group runs at the slowest rank's pace
(the observation motivating cross-replica weight-update sharding, arxiv
2004.13336 — skew is the signal for where sharding pays off).

measure_replica_ms waits for this rank's step to finish on its card (an
event recorded on the current stream), stamps its elapsed time, and
all-gathers the stamps of every rank of the group (gloo on the CPU, NCCL
on the card), outside any captured graph. Waiting synchronizes the
dispatch queue, so ParallelExecutor only measures under
FLAGS_monitor_replica_skew; every rank must set it alike, since each
takes part in the all-gather.

replica_skew is the pure math (max/median ratio + slowest id), a copy of
the JAX package's paddle_tpu/monitor/skew.py.
"""

import time

__all__ = ["replica_skew", "measure_replica_ms"]


def replica_skew(times_ms, ids=None):
    """Skew summary of one step's per-replica completion times.

    times_ms: per-replica milliseconds; ids: optional aligned replica ids
    (ranks). Returns {"replicas", "max_ms", "median_ms",
    "max_over_median", "slowest"} — slowest is the id (or index) of the
    worst replica; max_over_median is None when the median is zero."""
    times = [float(t) for t in times_ms]
    if not times:
        raise ValueError("times_ms is empty")
    n = len(times)
    srt = sorted(times)
    median = (srt[n // 2] if n % 2 == 1
              else 0.5 * (srt[n // 2 - 1] + srt[n // 2]))
    worst = max(range(n), key=lambda i: times[i])
    return {
        "replicas": n,
        "max_ms": round(times[worst], 6),
        "median_ms": round(median, 6),
        "max_over_median": (round(times[worst] / median, 6)
                            if median > 0 else None),
        "slowest": (ids[worst] if ids is not None else worst),
    }


def measure_replica_ms(value, t0):
    """Per-rank completion stamps for one step output.

    value: a step output of this rank (a tensor; a SeqTensor unwraps to its
    data) on the rank's device; t0: perf_counter at dispatch. Returns
    (times_ms, ranks) in rank order, or None outside a process group of two
    or more ranks. Every rank of the group must call it."""
    import torch
    import torch.distributed as dist

    from ..core.registry import seq_data

    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    device = seq_data(value).device
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    if dist.get_backend() != "nccl":
        device = torch.device("cpu")
    mine = torch.tensor([ms], dtype=torch.float64, device=device)
    world = dist.get_world_size()
    every = mine.new_empty((world,))
    dist.all_gather_into_tensor(every, mine)
    return [float(t) for t in every.tolist()], list(range(world))
