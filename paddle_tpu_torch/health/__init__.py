"""paddle_tpu_torch.health — model-health telemetry computed in the step.

The monitor observes the process and trace observes requests; this
package observes the MODEL: per-param grad/weight norms, update ratios
and non-finite counts computed inside the step, so on the card they ride
its CUDA graph (stats.py), a JSONL run ledger + gauges (ledger.py),
convergence detectors wired into trace dumps (detectors.py), and a
run-parity comparison engine behind `python -m paddle_tpu_torch health
summary|compare` (compare.py). The JAX package's paddle_tpu.health, with
the same flags, ledger schema and text output, and its resilience
branch: a chaos monkey's `loss_spike` / `grad_explode` faults scale the
recorded stats (`_chaos_scales`), and resilience's health policy drains
the detectors' events.

Executor integration (executor.py / parallel_executor.py):

    hplan = health.plan_if_enabled(program)     # None when FLAGS_health=0
    ... prepared key gains hplan.digest or None ...
    step  = executor_core.build_step_fn(
        program, fetch_names + hplan.fetch_names, ...)
    step  = hplan.wrap_step(step, len(fetch_names))   # before capture
    ... run; stats = fetches.pop() ...
    health.on_step(step0, iters, stats, fetch_names, fetches, mon=mon)
"""

import math
import time

import numpy as np

from .. import flags
from . import compare, detectors, ledger, stats
from .compare import compare_ledgers, format_compare, summarize_ledger
from .detectors import DetectorBank, drain_events, pending_events
from .ledger import read_ledger
from .stats import (HealthPlan, STAT_FIELDS, plan_for, plan_if_enabled)

__all__ = [
    "HealthPlan", "STAT_FIELDS", "plan_for", "plan_if_enabled",
    "on_step", "enabled", "last_record", "reset",
    "DetectorBank", "drain_events", "pending_events",
    "read_ledger", "summarize_ledger", "compare_ledgers",
    "format_compare",
    "compare", "detectors", "ledger", "stats",
]

_bank = DetectorBank()
_last = {"record": None}


def enabled():
    return bool(flags.get("health"))


def last_record():
    """The most recent sampled record (tests / notebooks)."""
    return _last["record"]


def _host(v):
    """A fetched value (tensor, SeqTensor, numpy) as float64 numpy."""
    import torch

    from ..core.registry import seq_data

    v = seq_data(v)
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, dtype=np.float64)


def _find_loss(fetch_names, fetches, k, multi):
    """First float fetch that is one scalar per step — the documented
    loss heuristic (fetch the loss first to feed the detectors). Reads
    that one fetch only."""
    import torch

    from ..core.registry import seq_data

    for v in fetches or ():
        t = seq_data(v)
        if isinstance(t, torch.Tensor):
            shape, is_float = tuple(t.shape), t.is_floating_point()
        else:
            t = np.asarray(t)
            shape, is_float = t.shape, t.dtype.kind == "f"
        if not is_float:
            continue
        size = int(np.prod(shape))
        if multi:
            if len(shape) >= 1 and shape[0] == k and size == k:
                return _host(t).reshape(k)
        elif size == 1:
            return _host(t).reshape(1)
    return None


def _chaos_scales(step):
    """(loss_scale, grad_scale) from the installed chaos monkey."""
    from ..resilience import chaos  # lazy: resilience imports health

    monkey = chaos.active()
    if monkey is None:
        return 1.0, 1.0
    return monkey.poison_health(step)


def on_step(step0, iters, stats_dev, fetch_names, fetches,
            mon=None, kind="executor", labels=None):
    """Host side of the health path: sample, journal, detect.

    Called by the executors after a health-wrapped run with the stats
    popped off the fetch list: `stats_dev` maps each parameter label to
    its [4] (or, under iters=K, [K, 4]) row, as in the JAX package, or,
    with `labels` (HealthPlan.labels), is the step's stacked [P, 4] (or
    [K, P, 4]) tensor, read back in one copy. `step0` is the program step
    index of the first iteration in the run; `iters` is None for a single
    step or the run's K. Steps where `step % FLAGS_health_interval != 0`
    cost nothing on the host — the device stats are simply dropped
    without a readback.
    """
    interval = max(1, int(flags.get("health_interval") or 1))
    multi = iters is not None
    k = int(iters) if multi else 1
    sampled = [i for i in range(k) if (step0 + i) % interval == 0]
    if not sampled:
        return
    if labels is not None:
        stacked = _host(stats_dev).reshape(k, len(labels), len(STAT_FIELDS))
        stats_dev = {label: stacked[:, j] for j, label in enumerate(labels)}
    host = {label: _host(v).reshape(k, len(STAT_FIELDS))
            for label, v in stats_dev.items()}
    loss_vec = _find_loss(fetch_names, fetches, k, multi)
    last_rec = None
    for i in sampled:
        step = step0 + i
        params, nonfinite, gsq_total = {}, 0, 0.0
        for label, a in sorted(host.items()):
            gsq, wsq, dsq, bad = (float(x) for x in a[i])
            gn = math.sqrt(gsq) if gsq >= 0 else float("nan")
            wn = math.sqrt(wsq) if wsq >= 0 else float("nan")
            dn = math.sqrt(dsq) if dsq >= 0 else float("nan")
            params[label] = {
                "grad_norm": gn,
                "weight_norm": wn,
                "update_ratio": (dn / wn) if wn > 0 else 0.0,
                "nonfinite": int(bad),
            }
            if bad:
                nonfinite += 1
            gsq_total += gsq
        loss = float(loss_vec[i]) if loss_vec is not None else None
        ggn = math.sqrt(gsq_total) if gsq_total >= 0 else float("nan")

        loss_scale, grad_scale = _chaos_scales(step)
        if loss is not None and loss_scale != 1.0:
            loss *= loss_scale
        if grad_scale != 1.0:
            for st in params.values():
                st["grad_norm"] *= grad_scale
            ggn *= grad_scale

        rec = {"ts": time.time(), "step": int(step), "kind": kind,
               "loss": loss, "global_grad_norm": ggn,
               "nonfinite_params": nonfinite, "params": params}
        rec["events"] = _bank.observe(rec)  # also sets rec["loss_ema"]
        ledger.write_record(rec)
        ledger.set_gauges(rec)
        last_rec = rec
    _last["record"] = last_rec
    if mon is not None and last_rec is not None:
        if mon.extra is None:
            mon.extra = {}
        mon.extra["health"] = {
            "step": last_rec["step"],
            "loss": last_rec["loss"],
            "loss_ema": last_rec["loss_ema"],
            "global_grad_norm": last_rec["global_grad_norm"],
            "nonfinite_params": last_rec["nonfinite_params"],
            "events": last_rec["events"],
        }


def reset():
    """Forget plans, detector state, queued events, and the ledger
    writer (tests; also lets one process run independent experiments)."""
    stats.reset()
    ledger.reset()
    detectors.reset()
    _bank.reset()
    _last["record"] = None
