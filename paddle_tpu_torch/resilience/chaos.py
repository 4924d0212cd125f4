"""Deterministic fault injection for the resilience test matrix.

A ChaosMonkey holds a list of Faults; `install()` makes it global so the
executor's `on_run()` hook (one dict lookup when nothing is installed)
and the runner's step hooks can consult it. Faults are keyed
deterministically — no RNG — so a test can say "the 3rd device dispatch
raises UNAVAILABLE, twice" and prove the retry path end to end:

    delay        sleep delay_ms before the dispatch        (keyed on run-call index)
    transient    raise errors.TransientError               (keyed on run-call index)
    nan          poison the step's fetched metrics to NaN  (keyed on global step)
    sigterm      os.kill(self, SIGTERM)                    (keyed on global step)
    replica_kill os.kill(self, SIGKILL)                    (keyed on run-call index)
    replica_hang sleep delay_ms, holding the dispatch      (keyed on run-call index)
    worker_kill  SIGKILL a datapipe decode worker process  (keyed on map-item index)
    loss_spike   scale the health-recorded loss by `scale` (keyed on global step)
    grad_explode scale the health-recorded grad norms      (keyed on global step)
    worker_preempt  os.kill(self, SIGTERM)                 (keyed on global step)
    worker_join  spawn a trainer subprocess from `argv`    (keyed on global step)
    load_spike   multiply open-loop offered QPS by `scale` (keyed on wall-clock seconds)

delay/transient count *executor run calls* because that is what retry
wraps (a retried step consumes several run-call indices — set `times` to
cover the attempts you want to fail). nan/sigterm count the runner's
*global step*, which survives restore.

worker_preempt/worker_join are the ELASTIC-fleet faults: worker_preempt
delivers the preemption SIGTERM at step N — with an ElasticController
installed the dying trainer grace-saves, drains its membership, and the
survivors resize within one step boundary instead of one TTL.
worker_join spawns a fresh trainer subprocess (`argv`, tracked in
monkey.spawned) at step N, so a grow-the-fleet drill is scriptable the
same way a kill is. The port's runner hears the SIGTERM at the same
boundary (it runs the chaos hook before the elastic poll), so every rank
of the group agrees there that this one leaves.

load_spike is the traffic fault: it is TIME-windowed, not index-keyed
— `at` is seconds since the load generator started, and the fault is
active for `duration_s` seconds. An open-loop driver (bench --fleet,
the green_gate autoscale drill) multiplies its offered QPS by the
product of every active spike's `scale` via `load_multiplier(elapsed)`,
so a deterministic surge lands mid-run and the autoscaler has to absorb
it.

replica_kill/replica_hang are the serving-fleet faults: installed inside
a replica process, they fire on the Nth executor dispatch — the replica
dies un-gracefully mid-batch (SIGKILL is uncatchable, exactly like an
OOM-killed or hardware-failed host) or wedges long enough for the
router's health probes and circuit breaker to eject it. Unlike `delay`,
a hang is NOT a short stall the retry layer should ride out: delay_ms
here defaults to effectively-forever so the fault models a dead-but-
connected device.
"""

import os
import signal
import time

import numpy as np

from .. import monitor
from .errors import TransientError

__all__ = ["Fault", "ChaosMonkey", "install", "uninstall", "active",
           "on_run", "on_map_dispatch", "load_multiplier"]

_KINDS = ("delay", "transient", "nan", "sigterm", "replica_kill",
          "replica_hang", "worker_kill", "loss_spike", "grad_explode",
          "worker_preempt", "worker_join", "load_spike")

# a "hung" replica is dead-but-connected: default far past any sane
# request deadline so the router's probes, not patience, end the wait
_HANG_DEFAULT_MS = 3_600_000.0


class Fault:
    def __init__(self, kind, at, times=1, delay_ms=None, label=None,
                 scale=None, argv=None, duration_s=None):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        if delay_ms is None:
            delay_ms = (_HANG_DEFAULT_MS if kind == "replica_hang"
                        else 100.0)
        if kind == "worker_join" and not argv:
            raise ValueError("worker_join needs argv (the trainer "
                             "subprocess command line)")
        if scale is None:
            # loss_spike/grad_explode want a detector-tripping multiplier;
            # a 1000x traffic surge would just be a DoS drill
            scale = 2.0 if kind == "load_spike" else 1e3
        if duration_s is None and kind == "load_spike":
            duration_s = 5.0
        self.kind = kind
        self.at = int(at)        # run-call index, global step, or seconds
        self.times = int(times)  # consecutive occurrences from `at`
        self.delay_ms = float(delay_ms)
        self.label = label       # None = any executor; else exact match
        self.scale = float(scale)  # loss/grad/offered-QPS multiplier
        self.argv = list(argv) if argv else None  # worker_join command
        self.duration_s = (float(duration_s)
                           if duration_s is not None else None)
        self.fired = 0

    def _covers(self, n):
        # the fired cap (not just the position window) matters for
        # step-keyed faults: nan_policy=restore REPLAYS the poisoned step,
        # and a fault that re-fired on every replay would roll back forever
        return self.fired < self.times \
            and self.at <= n < self.at + self.times

    def __repr__(self):
        return (f"Fault({self.kind!r}, at={self.at}, times={self.times}, "
                f"label={self.label!r})")


class ChaosMonkey:
    def __init__(self, faults=()):
        self.faults = list(faults)
        self.run_calls = 0   # executor dispatches observed
        self.injected = []   # (kind, key, label) log for assertions
        self.spawned = []    # worker_join subprocess.Popen handles

    def add(self, fault):
        self.faults.append(fault)
        return self

    def _fire(self, fault, key, label=None):
        fault.fired += 1
        self.injected.append((fault.kind, key, label))
        monitor.registry().counter(
            "chaos_injections_total",
            help="faults injected by the chaos harness",
            kind=fault.kind).inc()

    def on_run(self, label):
        """Executor hook, called once per device dispatch (before the
        dispatch, so donated buffers are still intact on raise)."""
        n = self.run_calls
        self.run_calls += 1
        for f in self.faults:
            if f.label is not None and f.label != label:
                continue
            if f.kind == "delay" and f._covers(n):
                self._fire(f, n, label)
                time.sleep(f.delay_ms / 1000.0)
            elif f.kind == "transient" and f._covers(n):
                self._fire(f, n, label)
                raise TransientError(
                    f"chaos: injected transient at run call {n}")
            elif f.kind == "replica_kill" and f._covers(n):
                self._fire(f, n, label)
                # SIGKILL, not SIGTERM: the grace-save path must NOT run —
                # the fleet gate proves the ROUTER recovers the requests,
                # not that the replica saved itself
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "replica_hang" and f._covers(n):
                self._fire(f, n, label)
                time.sleep(f.delay_ms / 1000.0)

    def on_map_dispatch(self, n, pid):
        """ProcessPoolMap hook, called as item `n` is handed to the
        decode worker `pid`. worker_kill SIGKILLs that worker — an
        uncatchable mid-batch death, exactly what an OOM-killed decode
        process looks like — to prove the parent's death detection
        (DataPipeError or FLAGS_datapipe_restart_workers replay)."""
        for f in self.faults:
            if f.kind == "worker_kill" and f._covers(n):
                self._fire(f, n, "datapipe")
                os.kill(pid, signal.SIGKILL)

    def on_step(self, step):
        """Runner hook, called at each global-step boundary (after the
        step's checkpoint cadence ran)."""
        for f in self.faults:
            if f.kind in ("sigterm", "worker_preempt") and f._covers(step):
                # worker_preempt is sigterm under its elastic-drill name:
                # the handler grace-saves, drains membership, and dies,
                # and the survivors resize at their next step boundary
                self._fire(f, step)
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == "worker_join" and f._covers(step):
                import subprocess

                self._fire(f, step, "elastic")
                self.spawned.append(subprocess.Popen(f.argv))

    def load_multiplier(self, elapsed_s):
        """Open-loop offered-QPS multiplier `elapsed_s` seconds into the
        run: the product of the scales of every load_spike active in its
        [at, at + duration_s) window. Time-windowed, unlike every other
        fault — the surge has a width, not an occurrence count; the
        injection log and counter tick once per fault."""
        mult = 1.0
        for f in self.faults:
            if f.kind != "load_spike":
                continue
            if f.at <= elapsed_s < f.at + f.duration_s:
                if not f.fired:
                    self._fire(f, round(float(elapsed_s), 3), "load")
                mult *= f.scale
        return mult

    def poison(self, step, metrics):
        """Runner hook: NaN-poison the fetched metrics for step `step`."""
        for f in self.faults:
            if f.kind == "nan" and f._covers(step):
                self._fire(f, step)
                return _poison_tree(metrics)
        return metrics

    def poison_health(self, step):
        """Health hook: (loss_scale, grad_scale) to apply to the stats
        RECORDED for global step `step` — the detector drill faults.
        loss_spike multiplies the journaled loss, grad_explode the
        journaled grad norms, by `scale`; the training math is untouched
        (the drill proves the detectors, not the optimizer)."""
        loss_scale = grad_scale = 1.0
        for f in self.faults:
            if f.kind == "loss_spike" and f._covers(step):
                self._fire(f, step, "health")
                loss_scale *= f.scale
            elif f.kind == "grad_explode" and f._covers(step):
                self._fire(f, step, "health")
                grad_scale *= f.scale
        return loss_scale, grad_scale


def _poison_tree(value):
    """Copy of `value` with the first float leaf set to NaN."""
    done = [False]

    def rec(v):
        if done[0]:
            return v
        if isinstance(v, dict):
            return {k: rec(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(rec(x) for x in v)
        try:
            arr = np.asarray(v)
        except Exception:
            return v
        if arr.dtype.kind == "f" and not done[0]:
            done[0] = True
            arr = np.array(arr, copy=True)
            arr.flat[0] = np.nan
            return arr
        return v

    out = rec(value)
    return out if done[0] else value


_active = [None]

def install(monkey):
    _active[0] = monkey
    return monkey


def uninstall():
    _active[0] = None


def active():
    return _active[0]


def on_run(label):
    """Module-level executor hook — one list lookup when chaos is off."""
    m = _active[0]
    if m is not None:
        m.on_run(label)


def on_map_dispatch(n, pid):
    """Module-level ProcessPoolMap hook — one list lookup when off."""
    m = _active[0]
    if m is not None:
        m.on_map_dispatch(n, pid)


def load_multiplier(elapsed_s):
    """Module-level load_spike hook for open-loop drivers: 1.0 when no
    monkey is installed or no spike covers `elapsed_s`."""
    m = _active[0]
    return m.load_multiplier(elapsed_s) if m is not None else 1.0
