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

`serve_http(server)` runs the same engine behind a stdlib HTTP frontend;
`ModelSet` hosts N named one-shot Servers behind one submit/stats
surface. The JAX package's continuous batching (serve/continuous) and
fleet tier (serve/fleet) are not ported yet.
"""

from .buckets import bucket_for, ladder, pad_rows
from .engine import (SERVE_MS_BUCKETS, ModelSet, ServeConfig, ServeError,
                     Server, ServerClosed, ServerDraining,
                     ServerOverloaded, UnknownModel)
from .http import make_http_server, serve_http

__all__ = [
    "Server", "ServeConfig", "ServeError", "ServerOverloaded",
    "ServerClosed", "ServerDraining", "UnknownModel", "ModelSet",
    "SERVE_MS_BUCKETS", "ladder", "bucket_for", "pad_rows",
    "serve_http", "make_http_server",
]
