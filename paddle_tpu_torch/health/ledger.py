"""Run ledger: the model-health JSONL journal and its monitor gauges.

One record per sampled step, written through the same JournalWriter the
monitor step journal uses (same torn-line tolerance on read, same
FLAGS_monitor_journal_max_mb size-gated rotation):

    {"ts": ..., "step": 12, "kind": "executor", "loss": 0.41,
     "loss_ema": 0.44, "global_grad_norm": 1.7, "nonfinite_params": 0,
     "params": {"fc_0.w_0": {"grad_norm": ..., "weight_norm": ...,
                             "update_ratio": ..., "nonfinite": 0}, ...},
     "events": ["loss_spike", ...]}

The writer is lazy and re-opens when FLAGS_health_ledger changes, so
tests and multi-run processes can retarget it with flag_guard. A copy of
the JAX package's paddle_tpu/health/ledger.py.
"""

import threading

from .. import flags
from ..monitor.journal import JournalWriter, read_journal
from ..monitor.step import registry as _monitor_registry

flags.define("health_ledger", str, "",
             "Path of the model-health JSONL run ledger (empty = no "
             "ledger file; gauges and detectors still run).")

_lock = threading.Lock()
_state = {"path": None, "writer": None}


def _writer():
    path = flags.get("health_ledger")
    if not path:
        return None
    with _lock:
        if _state["path"] != path:
            if _state["writer"] is not None:
                _state["writer"].close()
            _state["writer"] = JournalWriter(path)
            _state["path"] = path
        return _state["writer"]


def write_record(record):
    w = _writer()
    if w is not None:
        w.write(record)


def set_gauges(record):
    """Publish the sampled stats to the monitor registry."""
    reg = _monitor_registry()
    for label, st in record.get("params", {}).items():
        reg.gauge("health_grad_norm",
                  help="Per-parameter gradient L2 norm (sampled).",
                  param=label).set(st["grad_norm"])
    reg.gauge("health_nonfinite_params",
              help="Parameters whose grad held non-finite values at the "
                   "last sampled step.").set(
        float(record.get("nonfinite_params", 0)))
    g = record.get("global_grad_norm")
    if g is not None:
        reg.gauge("health_global_grad_norm",
                  help="Global gradient L2 norm (sampled).").set(g)
    ema = record.get("loss_ema")
    if ema is not None:
        reg.gauge("health_loss_ema",
                  help="Exponential moving average of the training "
                       "loss (sampled).").set(ema)


def read_ledger(path):
    """Parse a health ledger (JSONL, torn lines skipped, `<path>.1`
    rollover segment read first when present)."""
    return read_journal(path)


def reset():
    with _lock:
        if _state["writer"] is not None:
            _state["writer"].close()
        _state["path"] = None
        _state["writer"] = None
