"""paddle_tpu_torch.monitor — step-level training telemetry.

One process-global MetricsRegistry every hot path reports into (executor
step phases, prepared-step cache outcomes, per-rank skew, the serving
engine's queue, batch, latency and SLO series), a JSONL step journal for
post-hoc analysis (FLAGS_monitor_journal), Prometheus-style text
exposition for scraping, and MFU accounting from the FLOPs the compile
probe counts over a prepared program's first eager step. The JAX
package's paddle_tpu.monitor, with the same names, flags, record schema
and text output.

Disabled-mode contract: with FLAGS_monitor=0 each executor step costs
exactly one flag check (monitor.enabled()) — no records, no registry
mutation, no journal I/O.
"""

from .journal import (JournalWriter, format_summary, read_journal,
                      summarize_journal)
from .mfu import CHIP_PEAK_TFLOPS, chip_peak_flops, mfu
from .registry import (DEFAULT_MS_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry)
from .skew import measure_replica_ms, replica_skew
from .step import (StepRecord, cache_evicted, cache_l2, compile_info,
                   compile_probe, enabled,
                   exposition, fingerprint_of, last_step, record_compile,
                   registry, reset, restore_steps, step_begin, step_end,
                   steps_done)

__all__ = [
    # step orchestration
    "enabled", "registry", "exposition", "reset", "step_begin", "step_end",
    "last_step", "StepRecord", "fingerprint_of", "steps_done",
    "restore_steps",
    # compile-cache visibility
    "compile_info", "record_compile", "compile_probe", "cache_evicted",
    "cache_l2",
    # replica skew
    "measure_replica_ms", "replica_skew",
    # MFU accounting
    "chip_peak_flops", "mfu", "CHIP_PEAK_TFLOPS",
    # journal
    "JournalWriter", "read_journal", "summarize_journal", "format_summary",
    # registry primitives
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_MS_BUCKETS",
]
