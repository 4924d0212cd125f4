"""paddle_tpu_torch.monitor — the process metrics registry.

One process-global MetricsRegistry that hot paths report into (the serving
engine's queue, batch, latency and SLO series), rendered as a snapshot
dict or as Prometheus-style text exposition for scraping (the HTTP
frontend's /metrics). The JAX package's step journal, MFU accounting,
replica skew and the executor's per-step records with their
FLAGS_monitor gate (its monitor/journal.py, mfu.py, skew.py, step.py) are
not ported yet.
"""

from .registry import (DEFAULT_MS_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry)

__all__ = ["registry", "exposition", "reset",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_MS_BUCKETS"]

_registry = MetricsRegistry()


def registry():
    return _registry


def exposition():
    """Prometheus-style text exposition of the process registry."""
    return _registry.exposition()


def reset():
    """Fresh telemetry session: drop every metric (tests / long-lived
    processes)."""
    _registry.reset()
