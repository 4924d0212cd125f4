"""Fleet router: failure ownership for N interchangeable replicas.

The replica-level independence argument cuts both ways: if replicas are
interchangeable, the CLIENT should never see one die — the router owns
the failure. One request through `route()` gets:

  dispatch   least-queue-depth pick over routable replicas, gated by
             each replica's circuit breaker (a half-open breaker admits
             exactly one probe request)
  retry      a 503 answer (overloaded / draining) or a transient
             transport fault (resilience.errors.is_transient — resets,
             refused connects, timeouts) moves the request to ANOTHER
             replica; deterministic answers (2xx/4xx/5xx-non-503) pass
             through untouched
  deadline   a wall-clock budget per request; retries never start work
             the deadline cannot pay for (504 once it expires)
  budget     a fleet-wide RetryBudget: each admitted request deposits
             `ratio` tokens, each retry spends one — a partial outage
             cannot multiply offered load into a total one
  hedge      optionally, if the first attempt hasn't answered within
             hedge_ms, a second replica races it and the first answer
             wins (p99 tail insurance, bounded by the same budget-free
             single extra request)

Tracing: route() opens a `fleet.request` span with one `fleet.attempt`
child per try; the attempt's context rides the X-PTrace-* headers into
the replica, whose serve.http -> serve.request -> batch spans land in
the SAME trace id — a router-level dump reconstructs one request across
processes.

A port of the JAX package's paddle_tpu/serve/fleet/router.py.
"""

import http.client
import json
import queue
import threading
import time

from ... import monitor
from ... import trace as _trace
from ...resilience.errors import is_transient
from ...resilience.retry import RetryBudget
from ..http import SPAN_HEADER, TRACE_HEADER
from .health import HealthProber, http_fetch
from .membership import DEAD, LAME_DUCK, Membership
from .policy import LeastQueueDepthPolicy

__all__ = ["FleetConfig", "Router", "make_fleet_http", "serve_fleet"]


class FleetConfig:
    """Tuning knobs for one Router.

    probe_interval_s     health-probe sweep cadence; also how fast a
                         dead replica leaves the routable set
    heartbeat_ttl_s      membership lease for heartbeat-registered
                         replicas (silence past this -> dead)
    breaker_failures     consecutive failures (request or probe) that
                         open a replica's circuit breaker
    breaker_cooldown_s   open-breaker cooldown before half-opening
    request_deadline_ms  wall-clock SLO per routed request; retries stop
                         when it cannot be met (504 past it)
    attempt_timeout_ms   per-attempt transport timeout; None = whatever
                         of the deadline remains (set it lower so one
                         wedged replica costs an attempt, not the SLO)
    max_attempts         tries per request including the first
    retry_budget_ratio / retry_budget_burst
                         fleet-wide retry token bucket (see RetryBudget)
    hedge_ms             fire a second replica if the first attempt is
                         silent this long; None = no hedging
    degraded_queue_rows / degraded_p99_ms
                         probe thresholds demoting healthy -> degraded
    """

    def __init__(self, probe_interval_s=0.5, heartbeat_ttl_s=10.0,
                 breaker_failures=3, breaker_cooldown_s=2.0,
                 request_deadline_ms=30000.0, attempt_timeout_ms=None,
                 max_attempts=3, retry_budget_ratio=0.2,
                 retry_budget_burst=16, hedge_ms=None,
                 degraded_queue_rows=None, degraded_p99_ms=None):
        self.probe_interval_s = float(probe_interval_s)
        self.heartbeat_ttl_s = float(heartbeat_ttl_s)
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.request_deadline_ms = float(request_deadline_ms)
        self.attempt_timeout_ms = (None if attempt_timeout_ms is None
                                   else float(attempt_timeout_ms))
        self.max_attempts = int(max_attempts)
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        self.retry_budget_ratio = float(retry_budget_ratio)
        self.retry_budget_burst = float(retry_budget_burst)
        self.hedge_ms = None if hedge_ms is None else float(hedge_ms)
        self.degraded_queue_rows = degraded_queue_rows
        self.degraded_p99_ms = degraded_p99_ms


def http_transport(endpoint, path, body, headers, timeout_s):
    """POST over a fresh connection -> (status, headers, body). Fresh on
    purpose: after a replica dies, a pooled keep-alive socket would turn
    the first post-death request into a confusing reset mid-reuse; a
    fresh connect turns it into an immediate, classifiable refusal.

    A reply cut short (http.client's IncompleteRead or BadStatusLine: the
    replica died, or dropped the connection, in the middle of its answer)
    is raised as ConnectionResetError, a transient fault the router
    retries on another replica. The JAX package's transport lets it
    through as a non-transient error, which the router answers with 502
    (ROADMAP §3 item 21)."""
    host, port = endpoint.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    except http.client.HTTPException as e:
        raise ConnectionResetError(
            f"reply from {endpoint} cut short: {type(e).__name__}: "
            f"{e}") from e
    finally:
        conn.close()


def _err_body(msg):
    return json.dumps({"error": msg}).encode("utf-8")


# connection-scoped headers that must not ride through the router: the
# router re-frames the body (Content-Length) and owns its own client
# connections (Connection/Keep-Alive); end-to-end ones (Content-Type,
# model metadata, Retry-After) pass through
_HOP_BY_HOP = frozenset({
    "connection", "content-length", "date", "keep-alive",
    "proxy-authenticate", "proxy-authorization", "server", "te",
    "trailer", "transfer-encoding", "upgrade"})


def _end_to_end(upstream_headers):
    return {k: v for k, v in (upstream_headers or {}).items()
            if k.lower() not in _HOP_BY_HOP}


class _attach_maybe:
    """attach(ctx) when tracing gave us one, no-op otherwise."""

    __slots__ = ("_cm",)

    def __init__(self, ctx):
        self._cm = _trace.attach(ctx) if ctx is not None else None

    def __enter__(self):
        if self._cm is not None:
            self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            return self._cm.__exit__(*exc)
        return False


class Router:
    """Load balancer + failure owner over registered Server replicas.

        router = Router({"r0": "127.0.0.1:8001", "r1": "127.0.0.1:8002"})
        router.start()                          # health probing begins
        status, headers, body = router.route(payload_bytes)
        report = router.drain("r0")             # lame-duck + wait
        router.stop()

    `replicas` maps name -> "host:port" of a serve.http frontend; more
    join later via heartbeat() (HTTP /admin/register) or a `discover`
    source (a callable returning {name: endpoint}).
    """

    def __init__(self, replicas=None, config=None, fetch=None,
                 transport=None, discover=None):
        self.config = config or FleetConfig()
        cfg = self.config
        self.membership = Membership(
            heartbeat_ttl_s=cfg.heartbeat_ttl_s,
            breaker_failures=cfg.breaker_failures,
            breaker_cooldown_s=cfg.breaker_cooldown_s)
        self.policy = LeastQueueDepthPolicy()
        self.budget = RetryBudget(ratio=cfg.retry_budget_ratio,
                                  burst=cfg.retry_budget_burst)
        self._fetch = fetch if fetch is not None else http_fetch
        self.transport = (transport if transport is not None
                          else http_transport)
        self.prober = HealthProber(
            self.membership, interval_s=cfg.probe_interval_s,
            fetch=self._fetch, discover=discover,
            degraded_queue_rows=cfg.degraded_queue_rows,
            degraded_p99_ms=cfg.degraded_p99_ms)
        for name, endpoint in (replicas or {}).items():
            self.membership.add(name, endpoint)
        # per-router tallies next to the registry series (same idiom as
        # Server._own: two routers in one process must not conflate)
        self._own = {n: monitor.Counter(n) for n in
                     ("requests", "retries", "hedges", "hedge_wins",
                      "failures", "budget_exhausted",
                      "deadline_exceeded")}
        from ..engine import SERVE_MS_BUCKETS

        self._own_request_ms = monitor.Histogram(
            "fleet_request_ms", buckets=SERVE_MS_BUCKETS)
        # per-model router-side latency, keyed lazily by the model names
        # actually seen on the wire; the autoscaler windows each series
        # independently so one hot model is visible through a cold one
        self._own_model_ms = {}
        self._model_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------
    def start(self):
        self.prober.tick()  # synchronous first sweep: routable at return
        self.prober.start()
        return self

    def stop(self):
        self.prober.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        return False

    def heartbeat(self, name, endpoint):
        return self.membership.heartbeat(name, endpoint)

    # -- request path ---------------------------------------------------
    def _counter(self, own_name, reg_name, help_):
        self._own[own_name].inc()
        monitor.registry().counter(reg_name, help=help_).inc()

    def _acquire(self, exclude, model=None):
        """Next replica per policy whose breaker admits a request."""
        skip = set(exclude)
        while True:
            rep = self.policy.pick(self.membership.candidates(skip),
                                   model=model)
            if rep is None:
                return None
            if rep.breaker.try_acquire():
                return rep
            skip.add(rep.name)

    def _attempt_timeout(self, remaining_s):
        cap = self.config.attempt_timeout_ms
        if cap is None:
            return remaining_s
        return min(remaining_s, cap / 1000.0)

    def _send(self, rep, body, headers, timeout_s, attempt, parent_ctx,
              hedge):
        hdrs = dict(headers or {})
        with _attach_maybe(parent_ctx):
            with _trace.span("fleet.attempt", kind="fleet",
                             replica=rep.name, attempt=attempt,
                             hedge=hedge) as sp:
                if sp.ctx is not None:
                    hdrs[TRACE_HEADER] = sp.ctx.trace_id
                    hdrs[SPAN_HEADER] = sp.ctx.span_id
                status, rh, rb = self.transport(
                    rep.endpoint, "/v1/infer", body, hdrs, timeout_s)
                sp.set(status=status)
                return status, rh, rb

    def _hedged(self, rep, body, headers, timeout_s, parent_ctx, tried,
                model=None):
        """Race a second replica against a silent first attempt; first
        answer (success OR failure) wins, the loser is reaped off-path so
        its breaker outcome still lands. The loser's name goes into
        `tried` — it still holds the request in flight, so a later retry
        must not resend to it. Total wait stays within timeout_s: the
        post-hedge wait is what remains of it after the hedge_ms spent
        listening for the first attempt."""
        results = queue.Queue()

        def fire(r, hedge):
            try:
                results.put((r, self._send(r, body, headers, timeout_s,
                                           0, parent_ctx, hedge), None))
            except Exception as e:  # noqa: BLE001 — classified by caller
                results.put((r, None, e))

        fired = 1
        second = None
        t0 = time.perf_counter()
        threading.Thread(target=fire, args=(rep, False),
                         name="fleet-send", daemon=True).start()
        try:
            winner = results.get(timeout=self.config.hedge_ms / 1000.0)
        except queue.Empty:
            second = self._acquire(set(tried) | {rep.name}, model=model)
            if second is not None:
                self._counter("hedges", "fleet_hedges_total",
                              "hedged (raced) requests fired")
                fired += 1
                threading.Thread(target=fire, args=(second, True),
                                 name="fleet-hedge", daemon=True).start()
            remaining = timeout_s - (time.perf_counter() - t0)
            try:
                winner = results.get(timeout=max(0.0, remaining))
            except queue.Empty:
                if second is not None:
                    tried.add(second.name)  # silent, but still in flight
                raise TimeoutError(
                    f"no answer from {rep.name} within {timeout_s:.3f}s "
                    f"(hedged={fired > 1})") from None
        if fired > 1:
            w_rep, w_out, w_err = winner
            loser = second if w_rep is rep else rep
            tried.add(loser.name)
            if w_rep is not rep and w_err is None:
                self._counter("hedge_wins", "fleet_hedge_wins_total",
                              "hedged requests answered by the hedge")

            def reap(expected):
                for _ in range(expected):
                    try:
                        r, out, err = results.get(timeout=timeout_s + 1.0)
                    except queue.Empty:
                        return
                    if err is None and out[0] != 503:
                        r.breaker.record_success()
                    else:
                        r.breaker.record_failure()

            threading.Thread(target=reap, args=(fired - 1,),
                             name="fleet-reap", daemon=True).start()
        return winner

    def route(self, body, headers=None, model=None):
        """Route one POST /v1/infer body -> (status, headers, body).
        `model` (the request's "model" field, extracted by the frontend)
        weights the replica pick by that model's SLO lag and labels the
        latency observation."""
        cfg = self.config
        t_start = time.perf_counter()
        deadline = t_start + cfg.request_deadline_ms / 1000.0
        self._counter("requests", "fleet_router_requests_total",
                      "requests accepted by the fleet router")
        self.budget.on_request()
        tried = set()
        attempts = 0
        last = (503, {}, _err_body("no routable replica"))
        with _trace.span("fleet.request", kind="fleet") as fsp:
            while True:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self._counter("deadline_exceeded",
                                  "fleet_deadline_exceeded_total",
                                  "requests past their routing deadline")
                    last = (504, {}, _err_body("request deadline "
                                               "exceeded"))
                    break
                rep = self._acquire(tried, model=model)
                if rep is None:
                    break
                attempts += 1
                timeout_s = self._attempt_timeout(remaining)
                out, err = None, None
                try:
                    if attempts == 1 and cfg.hedge_ms is not None:
                        rep, out, err = self._hedged(
                            rep, body, headers, timeout_s, fsp.ctx,
                            tried, model=model)
                    else:
                        out = self._send(rep, body, headers, timeout_s,
                                         attempts - 1, fsp.ctx, False)
                except Exception as e:  # noqa: BLE001 — classified below
                    err = e
                if err is None and out[0] != 503:
                    # deterministic answer (2xx/4xx/500): the replica is
                    # functioning — pass it through, close the breaker
                    rep.breaker.record_success()
                    status, rh, rb = out
                    fsp.set(status=status, attempts=attempts,
                            replica=rep.name)
                    self._observe(t_start, model)
                    out_headers = _end_to_end(rh)
                    out_headers["X-Fleet-Replica"] = rep.name
                    out_headers["X-Fleet-Attempts"] = str(attempts)
                    return status, out_headers, rb
                if err is not None and not is_transient(err):
                    # programmer/config error on OUR side of the wire —
                    # retrying elsewhere cannot change it
                    self._counter("failures", "fleet_router_failures_total",
                                  "requests the router could not place")
                    fsp.set(status=502, error=type(err).__name__)
                    self._observe(t_start, model)
                    return 502, {"X-Fleet-Attempts": str(attempts)}, \
                        _err_body(f"{type(err).__name__}: {err}")
                # retryable: 503 from the replica or a transient fault
                rep.breaker.record_failure()
                if isinstance(err, ConnectionRefusedError):
                    # nothing listening: don't wait for the prober
                    self.membership.set_state(rep, DEAD, error=err)
                tried.add(rep.name)
                last = out if out is not None else \
                    (503, {}, _err_body(f"transient: {err}"))
                if attempts >= cfg.max_attempts:
                    break
                if not self.budget.try_spend():
                    self._counter("budget_exhausted",
                                  "fleet_retry_budget_exhausted_total",
                                  "retries refused by the fleet-wide "
                                  "retry budget")
                    break
                self._counter("retries", "fleet_router_retries_total",
                              "requests retried on another replica")
            status, rh, rb = last
            self._counter("failures", "fleet_router_failures_total",
                          "requests the router could not place")
            fsp.set(status=status, attempts=attempts)
            self._observe(t_start, model)
            out_headers = {"X-Fleet-Attempts": str(attempts)}
            for k in ("Retry-After", "Connection"):
                if k in rh:
                    out_headers[k] = rh[k]
            return status, out_headers, rb

    def _observe(self, t_start, model=None):
        ms = (time.perf_counter() - t_start) * 1000.0
        self._own_request_ms.observe(ms)
        from ..engine import SERVE_MS_BUCKETS

        monitor.registry().histogram(
            "fleet_request_ms", help="router-side request latency",
            buckets=SERVE_MS_BUCKETS).observe(ms)
        if model is not None:
            self._model_hist(model).observe(ms)
            monitor.registry().histogram(
                "fleet_request_ms", buckets=SERVE_MS_BUCKETS,
                model=str(model)).observe(ms)

    def _model_hist(self, model):
        """Per-model router-side latency histogram (lazily created; the
        autoscaler windows these for per-model scale signals)."""
        from ..engine import SERVE_MS_BUCKETS

        with self._model_lock:
            h = self._own_model_ms.get(model)
            if h is None:
                h = monitor.Histogram(
                    f"fleet_request_ms[{model}]",
                    buckets=SERVE_MS_BUCKETS)
                self._own_model_ms[model] = h
            return h

    # -- draining -------------------------------------------------------
    def drain(self, name, timeout_s=30.0, poll_interval_s=0.1):
        """Lame-duck one replica: stop dispatching to it NOW, tell it to
        drain, and wait until it reports stopped (or its listener goes
        away — the clean rolling-restart exit). Returns a report dict."""
        rep = self.membership.get(name)  # KeyError on unknown name
        t0 = time.perf_counter()
        self.membership.set_state(rep, LAME_DUCK)
        monitor.registry().counter(
            "fleet_drains_total", help="replica drains initiated").inc()
        try:
            self.transport(rep.endpoint, "/admin/drain", b"{}",
                           {"Content-Type": "application/json"}, 5.0)
        except OSError as e:
            self.membership.set_state(rep, DEAD, error=e)
            raise
        exited, state, stats = False, None, None
        deadline = t0 + float(timeout_s)
        while time.perf_counter() < deadline:
            try:
                state, stats = self._fetch(rep.endpoint)
            except OSError:
                exited = True  # listener gone: drained AND exited clean
                break
            if state == "stopped":
                break
            time.sleep(poll_interval_s)
        duration_ms = (time.perf_counter() - t0) * 1000.0
        monitor.registry().gauge(
            "fleet_drain_duration_ms",
            help="wall time of the last replica drain").set(duration_ms)
        self.membership.set_state(rep, DEAD, error="drained")
        return {"replica": name, "drained": exited or state == "stopped",
                "exited": exited, "duration_ms": duration_ms,
                "final_state": state, "final_stats": stats}

    # -- visibility -----------------------------------------------------
    def latency_percentiles(self, *ps):
        ps = ps or (50, 95, 99)
        return self._own_request_ms.percentiles(*ps)

    def latency_window(self, model=None):
        """(bucket_edges, cumulative_counts) of the router-side request
        latency histogram — aggregate, or one model's series when
        `model` is given (empty counts for a model never seen). The
        autoscaler diffs successive snapshots for a WINDOWED p99 — the
        cumulative percentiles answer "since boot", which is useless as
        a control signal once history piles up."""
        if model is None:
            hist = self._own_request_ms
        else:
            with self._model_lock:
                hist = self._own_model_ms.get(model)
            if hist is None:
                return self._own_request_ms.buckets, {}
        snap = hist.snapshot()
        return hist.buckets, snap["buckets"]

    def models_seen(self):
        """Model names that have crossed this router (for per-model
        autoscaler windows and dashboards)."""
        with self._model_lock:
            return sorted(self._own_model_ms)

    def stats(self):
        pct = self.latency_percentiles(50, 95, 99)
        return {
            "replicas": self.membership.describe(),
            "membership_epoch": self.membership.epoch,
            "healthy_replicas": self.membership.healthy_count(),
            "requests": self._own["requests"].value,
            "retries": self._own["retries"].value,
            "hedges": self._own["hedges"].value,
            "hedge_wins": self._own["hedge_wins"].value,
            "failures": self._own["failures"].value,
            "budget_exhausted": self._own["budget_exhausted"].value,
            "deadline_exceeded": self._own["deadline_exceeded"].value,
            "retry_budget_tokens": self.budget.tokens,
            "p50_ms": pct[50], "p95_ms": pct[95], "p99_ms": pct[99],
            "models": {
                m: {"p99_ms": self._model_hist(m).percentiles(99)[99]}
                for m in self.models_seen()},
        }


# -- HTTP frontend ------------------------------------------------------
def make_fleet_http(router, host="127.0.0.1", port=8100):
    """Router HTTP frontend, mirroring the replica surface:
    POST /v1/infer (routed), POST /admin/register {"name","endpoint"},
    POST /admin/drain {"replica"}, GET /healthz /stats /metrics."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _RouterHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code, body, content_type="application/json",
                   headers=None):
            data = body if isinstance(body, bytes) \
                else body.encode("utf-8")
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

        def _json(self, code, obj, headers=None):
            self._reply(code, json.dumps(obj), headers=headers)

        def do_GET(self):
            if self.path == "/healthz":
                if self.server.router.membership.candidates():
                    self._reply(200, "ok\n", content_type="text/plain")
                else:
                    self._reply(503, "no routable replicas\n",
                                content_type="text/plain")
            elif self.path == "/stats":
                self._json(200, self.server.router.stats())
            elif self.path == "/metrics":
                self._reply(200, monitor.registry().exposition(),
                            content_type="text/plain; version=0.0.4")
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            rt = self.server.router
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            if self.path == "/v1/infer":
                # best-effort "model" extraction off the wire body: a
                # malformed body still routes (the replica owns the 400)
                model = None
                try:
                    payload = json.loads(body or b"{}")
                    if isinstance(payload, dict):
                        m = payload.get("model")
                        if isinstance(m, str) and m:
                            model = m
                except ValueError:
                    pass
                status, hdrs, rbody = rt.route(body, headers={
                    "Content-Type": "application/json"}, model=model)
                # route() forwards the replica's Content-Type; lift it
                # out so _reply doesn't emit the header twice
                ctype = hdrs.pop("Content-Type", "application/json")
                self._reply(status, rbody, content_type=ctype,
                            headers=hdrs)
            elif self.path == "/admin/register":
                try:
                    payload = json.loads(body or b"{}")
                    rep = rt.heartbeat(str(payload["name"]),
                                       str(payload["endpoint"]))
                except (ValueError, KeyError, TypeError) as e:
                    self._json(400, {"error": f"bad registration: {e}"})
                    return
                self._json(200, {"registered": rep.name,
                                 "state": rep.state})
            elif self.path == "/admin/drain":
                # validate first: a malformed request is a 400, and 404
                # stays reserved for "well-formed but unknown replica"
                try:
                    payload = json.loads(body or b"{}")
                except ValueError as e:
                    self._json(400, {"error": f"bad drain request: {e}"})
                    return
                name = payload.get("replica") \
                    if isinstance(payload, dict) else None
                if not isinstance(name, str) or not name:
                    self._json(400, {"error":
                                     'body must be {"replica": "<name>"}'})
                    return
                try:
                    report = rt.drain(name)
                except KeyError:
                    self._json(404, {"error": f"unknown replica: {name!r}"})
                    return
                except (ValueError, TypeError, OSError) as e:
                    self._json(500, {"error": str(e)})
                    return
                self._json(200, report)
            else:
                self._json(404, {"error": f"no route {self.path}"})

    httpd = ThreadingHTTPServer((host, port), _RouterHandler)
    httpd.daemon_threads = True
    httpd.router = router
    return httpd


def serve_fleet(router, host="127.0.0.1", port=8100):
    """Blocking router frontend: serve until KeyboardInterrupt."""
    httpd = make_fleet_http(router, host, port)
    router.start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.stop()
