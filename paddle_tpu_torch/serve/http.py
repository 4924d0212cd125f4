"""Stdlib HTTP frontend for a Server — no framework dependency.

Endpoints:
    POST /v1/infer    {"inputs": {name: nested-list},
                       "model": "name"?, "steps": K?, "seed": s?}  ->
                      {"outputs": [nested-list, ...]}  (sliced to the
                      request's rows). "model" picks a hosted model on a
                      multi-model engine (ModelSet / ContinuousServer);
                      omitted = the engine's default model; an unknown
                      name is 404 (deterministic — the fleet router
                      never retries it). "steps"/"seed" drive a K-step
                      decode on a continuous engine (400 on a one-shot
                      engine). Failure mapping is load-balancer
                      shaped: 503 + Retry-After on backpressure
                      rejection (ServerOverloaded — the replica is
                      healthy but full, come back), 503 +
                      Connection: close when stopping/draining
                      (ServerClosed/ServerDraining — stop reusing this
                      replica), 400 on malformed requests, 500 on model
                      errors. The fleet router retries 503s on another
                      replica; 4xx/500 are deterministic and pass through.
    POST /admin/drain flip the engine to lame-duck (202 {"state":
                      "draining"}): in-flight and queued requests finish,
                      new submits 503, and — when the factory was told
                      shutdown_on_drain — the HTTP server itself exits
                      after the drain completes (clean rolling-restart
                      exit).
    GET  /healthz     200 "ok" while serving; 503 "draining" (with
                      Connection: close) while lame-duck; 503
                      "warming"/"stopped" otherwise
    GET  /stats       Server.stats() as JSON
    GET  /metrics     Prometheus text exposition of the monitor registry

"steps"/"seed" drive the JAX package's continuous engine, which is not
ported yet (nor is its fleet router): the port serves one-shot engines
(Server, ModelSet), where "steps" other than 1 is a 400. A copy of the JAX
package's paddle_tpu/serve/http.py.

ThreadingHTTPServer gives one thread per connection; each handler
thread parks on its request's Future, so concurrent connections batch
together inside the engine exactly like in-process submitters.

Cross-process tracing: a router in front of N replicas sends
X-PTrace-Trace/X-PTrace-Span headers; the handler attaches them as the
parent context, so the replica's serve.http -> serve.request -> batch
spans land in the ROUTER's trace id and one request reconstructs end to
end across processes from the two flight recorders.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import monitor
from .. import trace as _trace
from .engine import (ServeError, ServerClosed, ServerDraining,
                     ServerOverloaded, UnknownModel)

__all__ = ["serve_http", "make_http_server", "TRACE_HEADER",
           "SPAN_HEADER"]

TRACE_HEADER = "X-PTrace-Trace"
SPAN_HEADER = "X-PTrace-Span"

_HEX16 = frozenset("0123456789abcdef")


def _remote_ctx(headers):
    """SpanContext from propagation headers, or None (absent/garbage —
    a malformed header must never fail the request it rode in on)."""
    tid = (headers.get(TRACE_HEADER) or "").strip().lower()
    sid = (headers.get(SPAN_HEADER) or "").strip().lower()
    if len(tid) == 16 and len(sid) == 16 \
            and set(tid) <= _HEX16 and set(sid) <= _HEX16:
        return _trace.SpanContext(tid, sid)
    return None


def _json_feed(payload, server):
    if not isinstance(payload, dict):
        raise ValueError('body must be a JSON object {"inputs": {...}}')
    inputs = payload.get("inputs")
    if not isinstance(inputs, dict):
        raise ValueError('body must be {"inputs": {name: array}}')
    return {n: np.asarray(v, dtype=server._feed_dtype(n))
            if n in server._feed_vars else np.asarray(v)
            for n, v in inputs.items()}


class _Handler(BaseHTTPRequestHandler):
    # the Server instance is attached to the HTTPServer by the factory
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code, body, content_type="application/json",
               headers=None):
        data = body if isinstance(body, bytes) else body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
            if k.lower() == "connection" and v.lower() == "close":
                # the header alone is advisory; actually drop keep-alive
                self.close_connection = True
        self.end_headers()
        self.wfile.write(data)

    def _reply_json(self, code, obj, headers=None):
        self._reply(code, json.dumps(obj), headers=headers)

    def do_GET(self):
        engine = self.server.engine
        if self.path == "/healthz":
            state = engine.state()
            if state == "serving":
                self._reply(200, "ok\n", content_type="text/plain")
            elif state == "draining":
                self._reply(503, "draining\n", content_type="text/plain",
                            headers={"Connection": "close"})
            else:
                self._reply(503, f"{state if state == 'stopped' else 'warming'}\n",
                            content_type="text/plain")
        elif self.path == "/stats":
            self._reply_json(200, engine.stats())
        elif self.path == "/metrics":
            self._reply(200, monitor.registry().exposition(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._reply_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        engine = self.server.engine
        if self.path == "/admin/drain":
            self._drain()
            return
        if self.path != "/v1/infer":
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
        # root span of the request's trace: submit() runs inside it, so
        # the engine's serve.request span (and everything under it)
        # inherits this span's trace id — HTTP accept through readback
        # reconstructs as one trace from a flight-recorder dump. When a
        # fleet router sent propagation headers, parent under ITS span
        # instead: the whole fleet hop becomes one cross-process trace.
        remote = _remote_ctx(self.headers) if _trace.enabled() else None
        with _trace.attach(remote) if remote is not None else _noop_cm():
            self._infer(engine)

    def _infer(self, engine):
        with _trace.span("serve.http", kind="serve", path=self.path) as sp:
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                model = payload.get("model") \
                    if isinstance(payload, dict) else None
                if model is not None and not isinstance(model, str):
                    raise ValueError('"model" must be a string')
                # resolve first: feed dtypes/shapes come from the NAMED
                # model, and an unknown name must 404 before any feed
                # parsing can turn it into a 400
                target = engine.resolve_model(model)
                feed = _json_feed(payload, target)
                steps = payload.get("steps")
                if getattr(engine, "is_continuous", False):
                    fut = engine.submit(
                        feed, model=model,
                        steps=1 if steps is None else int(steps),
                        seed=int(payload.get("seed", 0)))
                elif steps is not None and int(steps) != 1:
                    raise ValueError(
                        '"steps" needs a continuous engine '
                        '(serve.continuous.ContinuousServer)')
                else:
                    fut = engine.submit(feed, model=model)
            except UnknownModel as e:
                sp.set(status=404)
                self._reply_json(404, {"error": str(e)})
                return
            except ServerOverloaded as e:
                # full, not broken: tell the client (or router) to retry
                # elsewhere / later — one batching window is the honest
                # earliest time this replica could admit again
                sp.set(status=503)
                cfg = getattr(engine, "config", None)
                wait_ms = getattr(cfg, "max_wait_ms", None)
                if wait_ms is None:
                    wait_ms = getattr(cfg, "idle_wait_ms", 1000.0)
                retry_s = max(1, int(-(-wait_ms // 1000.0)))
                self._reply_json(503, {"error": str(e)},
                                 headers={"Retry-After": str(retry_s)})
                return
            except ServerDraining as e:
                sp.set(status=503)
                self._reply_json(503, {"error": str(e)},
                                 headers={"Connection": "close"})
                return
            except ServerClosed as e:
                sp.set(status=503)
                self._reply_json(503, {"error": str(e)},
                                 headers={"Connection": "close"})
                return
            except (ValueError, ServeError) as e:
                sp.set(status=400)
                self._reply_json(400, {"error": str(e)})
                return
            try:
                outs = fut.result()
            except ServerClosed as e:
                sp.set(status=503)
                self._reply_json(503, {"error": str(e)},
                                 headers={"Connection": "close"})
                return
            except Exception as e:  # noqa: BLE001 — surface model errors
                sp.set(status=500)
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            sp.set(status=200)
            self._reply_json(200, {
                "outputs": [np.asarray(o).tolist() for o in outs]})

    def _drain(self):
        """Kick the lame-duck drain on a background thread and answer
        immediately: the caller polls /healthz ("draining" -> connection
        refused / "stopped") instead of holding a socket open for the
        whole backlog."""
        engine = self.server.engine
        httpd = self.server
        already = engine.state() in ("draining", "stopped")

        def _run():
            engine.drain()
            if getattr(httpd, "shutdown_on_drain", False):
                httpd.shutdown()

        if not already:
            threading.Thread(target=_run, name="serve-drain",
                             daemon=True).start()
        self._reply_json(202, {"state": "draining", "already": already},
                         headers={"Connection": "close"})


class _noop_cm:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def make_http_server(engine, host="127.0.0.1", port=8000,
                     shutdown_on_drain=False):
    """A ThreadingHTTPServer bound to (host, port), serving `engine`.
    Caller owns serve_forever()/shutdown() (tests run it in a thread).
    With shutdown_on_drain, a completed /admin/drain also shuts the HTTP
    loop down, so a CLI replica process exits clean after its drain."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.engine = engine
    httpd.shutdown_on_drain = shutdown_on_drain
    return httpd


def serve_http(engine, host="127.0.0.1", port=8000,
               shutdown_on_drain=False):
    """Blocking frontend: serve until KeyboardInterrupt (or a completed
    /admin/drain when shutdown_on_drain), then stop both."""
    httpd = make_http_server(engine, host, port,
                             shutdown_on_drain=shutdown_on_drain)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
