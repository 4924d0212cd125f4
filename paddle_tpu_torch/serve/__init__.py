"""paddle_tpu_torch.serve: batched low-latency inference serving.

Wraps an inference Program (ideally after InferenceTranspiler folding)
behind `Server.submit(feed) -> Future`. A batcher thread coalesces
concurrent requests, pads them to a fixed bucket ladder so every
dispatch replays a CUDA graph the warmup phase already captured, and
round-robins batches across per-card replica executors. Latency phases
and p50/p95/p99 land in the monitor registry.

    from paddle_tpu_torch import serve
    server = serve.Server.from_inference_model("model_dir")
    with server:                       # start() captures every bucket
        y, = server.submit({"x": example}).result()

`python -m paddle_tpu_torch serve --model-dir model_dir` runs the same
engine behind a stdlib HTTP frontend (or a synthetic-load selftest), and
`paddle_tpu_torch.serve.fleet` runs N such replicas behind a
fault-tolerant router (health-checked least-queue routing, retries,
graceful drain).

Multi-model: `ModelSet` hosts N named one-shot Servers behind one
submit/stats surface; `serve.continuous.ContinuousServer` hosts N named
models inside ONE iteration-level step loop (requests join and leave a
running batch every model step — autoregressive decode without
head-of-line blocking). Both speak the same HTTP "model" field and
per-model SLO metrics the fleet router and autoscaler consume.
"""

from . import continuous, fleet
from .buckets import bucket_for, ladder, pad_rows
from .continuous import ContinuousConfig, ContinuousServer
from .engine import (SERVE_MS_BUCKETS, ModelSet, ServeConfig, ServeError,
                     Server, ServerClosed, ServerDraining,
                     ServerOverloaded, UnknownModel)
from .http import make_http_server, serve_http

__all__ = [
    "Server", "ServeConfig", "ServeError", "ServerOverloaded",
    "ServerClosed", "ServerDraining", "UnknownModel", "ModelSet",
    "ContinuousServer", "ContinuousConfig", "SERVE_MS_BUCKETS",
    "ladder", "bucket_for", "pad_rows",
    "serve_http", "make_http_server",
    "fleet", "continuous",
]
