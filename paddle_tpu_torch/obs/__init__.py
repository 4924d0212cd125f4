"""Fleet-wide observability control plane.

Single-process telemetry already exists in three layers — the metrics
registry (monitor/), the step journal + health ledger (monitor/journal,
health/ledger) and the flight recorder (trace/). This package is the
cross-PROCESS layer that joins them for a whole job:

    collector.py   HTTP sink: processes push registry snapshots,
                   journal/health tails and trace-dump manifests
                   (POST /v1/obs/push), or are scraped off their
                   existing /metrics pages; re-served aggregated as
                   GET /metrics (counter-sum / gauge-max /
                   histogram-merge, per-replica labels, HELP/TYPE,
                   TTL stale expiry) + /v1/obs/summary JSON
    timeline.py    clock-aligned merge of per-process journals and
                   chrome traces onto one epoch timeline: per-step
                   cross-replica skew, consecutive-straggler
                   attribution, overlap efficiency, merged trace with
                   one pid lane per process
    client.py      the in-process push loop (maybe_start(role) hook
                   wired into Trainer/resilience sessions, fleet
                   replicas, the router and the elastic master; armed
                   by FLAGS_obs_push)
    top.py         `paddle_tpu_torch obs top` — live redraw-in-place
                   fleet table over /v1/obs/summary

CLI: `python -m paddle_tpu_torch obs collect|top|timeline` (cli.py). The
JAX package's paddle_tpu/obs/, whose wire payloads and summaries it
keeps, so one collector serves processes of either package."""

from .client import JsonlTail, ObsClient, maybe_start
from .collector import (Collector, make_obs_http, merge_hists,
                        parse_exposition, serve_obs)
from .timeline import (clock_offset, epoch_of, format_timeline,
                       hist_quantile, merge_chrome_traces,
                       merge_step_timeline, overlap_efficiency)
from .top import fetch_summary, render_summary, run_top

__all__ = [
    # collector
    "Collector", "make_obs_http", "serve_obs", "parse_exposition",
    "merge_hists",
    # timeline
    "epoch_of", "clock_offset", "hist_quantile", "merge_step_timeline",
    "merge_chrome_traces", "overlap_efficiency", "format_timeline",
    # client
    "ObsClient", "JsonlTail", "maybe_start",
    # top
    "fetch_summary", "render_summary", "run_top",
]
