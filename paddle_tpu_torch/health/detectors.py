"""Convergence detectors over the sampled health records.

Host-side rolling-window logic — it sees only the tiny per-sample
summaries (loss scalar, per-param norms), never tensors. Each fired
event:

  * bumps `health_events_total{kind=...}` in the monitor registry,
  * fires `trace.maybe_dump("health_<kind>")` so the flight recorder
    snapshots the run around the anomaly (cooldown-gated, never raises),
  * lands on a bounded queue (drain_events / pending_events), which
    resilience.ResilientRunner drains after each step and maps through
    FLAGS_resilience_health_policy (warn | skip | restore).

Kinds: loss_spike, loss_divergence, loss_plateau, loss_nonfinite,
grad_explode, grad_vanish, param_nonfinite.

A copy of the JAX package's paddle_tpu/health/detectors.py. The spike
z-score uses a
std floor of 5% of |window mean| so a flat-but-noisy curve needs a real
excursion (not timer-grade jitter) to fire, and a cleanly decaying loss
never fires (its new samples sit below the window mean).
"""

import math
import threading

from .. import flags

flags.define("health_window", int, 20,
             "Rolling-window length (in sampled steps) for the loss "
             "spike z-score and the grad-explosion median baseline.")
flags.define("health_spike_z", float, 6.0,
             "Fire loss_spike when the sampled loss sits more than this "
             "many (floored) standard deviations above the window mean.")
flags.define("health_grad_explode", float, 1e4,
             "Absolute global-grad-norm threshold for grad_explode.")
flags.define("health_grad_ratio", float, 100.0,
             "Relative grad_explode threshold: norm > ratio * rolling "
             "median (needs >= 5 samples of history).")
flags.define("health_grad_vanish", float, 1e-9,
             "Fire grad_vanish when the global grad norm drops below "
             "this (0 disables).")
flags.define("health_diverge_factor", float, 10.0,
             "Fire loss_divergence when the loss EMA exceeds this "
             "factor times the best EMA seen so far.")
flags.define("health_plateau_patience", int, 0,
             "Fire loss_plateau after this many sampled steps without "
             "the loss EMA improving by health_plateau_tol "
             "(relative). 0 = plateau detection off.")
flags.define("health_plateau_tol", float, 1e-3,
             "Relative EMA improvement that resets the plateau counter.")
flags.define("health_ema", float, 0.98,
             "Decay of the loss exponential moving average.")

_MIN_HISTORY = 5  # samples before spike/explode baselines are trusted

_events_lock = threading.Lock()
_pending = []  # [(kind, step)], drained by the caller (drain_events)
_PENDING_CAP = 256


def _trace():
    from .. import trace
    return trace


def _registry():
    from ..monitor.step import registry
    return registry()


class DetectorBank:
    """Rolling state for one run's detectors. observe() one sampled
    record at a time; returns the list of event kinds fired."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.losses = []
        self.grad_norms = []
        self.ema = None
        self.best_ema = None
        self.stale_samples = 0

    # -- individual detectors ------------------------------------------

    def _check_loss(self, loss, events):
        window = max(_MIN_HISTORY, int(flags.get("health_window")))
        if not math.isfinite(loss):
            events.append("loss_nonfinite")
            return
        if len(self.losses) >= _MIN_HISTORY:
            hist = self.losses[-window:]
            mean = sum(hist) / len(hist)
            var = sum((x - mean) ** 2 for x in hist) / len(hist)
            std = max(math.sqrt(var), 0.05 * abs(mean), 1e-12)
            if (loss - mean) / std > flags.get("health_spike_z"):
                events.append("loss_spike")
        self.losses.append(loss)
        del self.losses[:-window]

        decay = flags.get("health_ema")
        self.ema = (loss if self.ema is None
                    else decay * self.ema + (1.0 - decay) * loss)
        tol = flags.get("health_plateau_tol")
        if (self.best_ema is None
                or self.ema < self.best_ema - tol * abs(self.best_ema)):
            self.best_ema = self.ema
            self.stale_samples = 0
        else:
            self.stale_samples += 1
        if (self.best_ema is not None
                and self.ema > flags.get("health_diverge_factor")
                * self.best_ema
                and self.ema - self.best_ema > 1e-6):
            events.append("loss_divergence")
        patience = flags.get("health_plateau_patience")
        if patience and self.stale_samples >= patience:
            events.append("loss_plateau")
            self.stale_samples = 0  # re-arm instead of firing every step

    def _check_grad(self, norm, events):
        if not math.isfinite(norm):
            return  # counted via nonfinite_params
        window = max(_MIN_HISTORY, int(flags.get("health_window")))
        fired = False
        if norm > flags.get("health_grad_explode"):
            events.append("grad_explode")
            fired = True
        elif len(self.grad_norms) >= _MIN_HISTORY:
            hist = sorted(self.grad_norms[-window:])
            median = hist[len(hist) // 2]
            if median > 0 and norm > flags.get("health_grad_ratio") * median:
                events.append("grad_explode")
                fired = True
        vanish = flags.get("health_grad_vanish")
        if not fired and vanish and norm < vanish:
            events.append("grad_vanish")
        if not fired:  # keep exploded samples out of the baseline
            self.grad_norms.append(norm)
            del self.grad_norms[:-window]

    # -- entry point ---------------------------------------------------

    def observe(self, record):
        events = []
        loss = record.get("loss")
        if loss is not None:
            self._check_loss(float(loss), events)
        record["loss_ema"] = self.ema
        norm = record.get("global_grad_norm")
        if norm is not None:
            self._check_grad(float(norm), events)
        if record.get("nonfinite_params"):
            events.append("param_nonfinite")
        for kind in events:
            _fire(kind, record.get("step"))
        return events


def _fire(kind, step):
    _registry().counter(
        "health_events_total",
        help="Model-health detector events by kind.", kind=kind).inc()
    _trace().maybe_dump("health_" + kind)
    with _events_lock:
        if len(_pending) < _PENDING_CAP:
            _pending.append((kind, step))


def drain_events():
    """Hand the queued (kind, step) events to the caller (the resilience
    policy hook, ResilientRunner._apply_health_policy) and clear the
    queue."""
    with _events_lock:
        out = list(_pending)
        del _pending[:]
    return out


def pending_events():
    with _events_lock:
        return list(_pending)


def reset():
    with _events_lock:
        del _pending[:]
