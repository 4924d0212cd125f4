"""Autoscaler: hold a latency target by resizing the serving fleet.

The control loop watches two signals the router already produces —

  * a WINDOWED p99 of router-side request latency (successive diffs of
    the `fleet_request_ms` histogram, not the since-boot percentiles),
  * total queued rows across routable replicas (the same depth the
    dispatch policy spreads against);

and holds `target_p99_ms` with the standard guards against flapping:

  hysteresis   scale-out arms when p99 > target (or the queue passes
               `high_queue_rows`); scale-in only arms when p99 is
               BELOW target * hysteresis AND the queue is empty —
               the dead band between the two thresholds holds steady
  breach/calm  consecutive-round counters: one hot tick (a compile
  rounds       stall, a probe hiccup) never spawns a process, one calm
               tick never kills one
  cooldowns    independent scale-out / scale-in refractory periods, so
               capacity added for a surge gets a chance to absorb it
               before the loop reconsiders
  bounds       min_replicas <= fleet <= max_replicas, always

Scale-out spawns replica processes through a pluggable spawner and
registers them on the router's membership (the unified epoch-fenced
MembershipTable — the same join/TTL/reap contract elastic training
uses); the prober grants routability on the first passing probe. (The
JAX package's warm scale-out through the distributed compile service
comes with ROADMAP queue 1 item 8; a `--cache-dir` shared by the
replicas warm-starts their prepared plans, FLAGS_compile_cache_dir.)

Scale-in NEVER kills: it picks a victim (LIFO over surge capacity),
runs `Router.drain()` — LAME_DUCK, finish the backlog, exit — and only
then reaps the process, so no accepted request is lost.

A port of the JAX package's paddle_tpu/serve/fleet/autoscaler.py.
"""

import math
import os
import subprocess
import threading
import time

from ... import monitor
from .membership import DEGRADED, HEALTHY
from .policy import scale_in_victim

__all__ = ["AutoscalerConfig", "Autoscaler", "ProcessReplicaSpawner"]


class AutoscalerConfig:
    """`model_targets` maps model name -> per-model p99 target (ms).
    Each named model gets its OWN latency window over the router's
    fleet_request_ms{model=} series; a breach on ANY of them arms
    scale-out even while the aggregate window sits under target — a
    high-traffic cold model can no longer mask a hot one. Scale-in
    additionally requires every named model calm (below its target *
    hysteresis)."""

    def __init__(self, target_p99_ms=500.0, high_queue_rows=None,
                 min_replicas=1, max_replicas=4, scale_step=1,
                 breach_rounds=2, calm_rounds=6, hysteresis=0.5,
                 cooldown_out_s=5.0, cooldown_in_s=30.0,
                 interval_s=1.0, drain_timeout_s=60.0,
                 model_targets=None):
        self.model_targets = {str(k): float(v) for k, v in
                              (model_targets or {}).items()}
        if any(v <= 0 for v in self.model_targets.values()):
            raise ValueError("model_targets values must be > 0")
        self.target_p99_ms = float(target_p99_ms)
        self.high_queue_rows = (None if high_queue_rows is None
                                else float(high_queue_rows))
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_step = int(scale_step)
        self.breach_rounds = int(breach_rounds)
        self.calm_rounds = int(calm_rounds)
        self.hysteresis = float(hysteresis)
        self.cooldown_out_s = float(cooldown_out_s)
        self.cooldown_in_s = float(cooldown_in_s)
        self.interval_s = float(interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        if self.target_p99_ms <= 0:
            raise ValueError("target_p99_ms must be > 0")
        if not 0 < self.hysteresis <= 1.0:
            raise ValueError("hysteresis must be in (0, 1]")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.scale_step < 1 or self.breach_rounds < 1 \
                or self.calm_rounds < 1:
            raise ValueError("scale_step/breach_rounds/calm_rounds "
                             "must be >= 1")


def _window_p99(edges, prev, cur, p=0.99):
    """p99 over the requests BETWEEN two cumulative histogram snapshots
    (monitor.Histogram.snapshot()["buckets"]); None when the window is
    empty. Linear interpolation inside the winning bucket; the +Inf
    bucket conservatively reports its finite lower edge."""
    def key(edge):
        return "+Inf" if math.isinf(edge) else edge

    counts, total = [], 0
    for edge in edges:
        c = cur.get(key(edge), 0) - (prev or {}).get(key(edge), 0)
        counts.append((edge, c - total))
        total = c
    if total <= 0:
        return None
    rank = p * total
    seen = 0.0
    lo = 0.0
    for edge, n in counts:
        if n > 0:
            if seen + n >= rank:
                if math.isinf(edge):
                    return lo
                frac = (rank - seen) / n
                return lo + (edge - lo) * frac
            seen += n
        if not math.isinf(edge):
            lo = edge
    return lo


class Autoscaler:
    """The loop. `router` needs .membership, .prober, .latency_window()
    and .drain(); `spawner` needs .spawn_many(n) -> [(name, endpoint)]
    and .stop(name) -> exit code (ProcessReplicaSpawner, or a fake in
    tests). tick() is public and synchronous so tests drive the state
    machine with an injected clock instead of sleeping."""

    def __init__(self, router, spawner, config=None, clock=None):
        self.router = router
        self.spawner = spawner
        self.config = config if config is not None else AutoscalerConfig()
        self._clock = clock if clock is not None else time.monotonic
        self._prev_window = None
        self._prev_model_windows = {}  # model -> last cumulative counts
        self._breach = 0
        self._calm = 0
        self._last_out = None
        self._last_in = None
        self._spawned = []  # names we scaled out, oldest first
        self._stop = threading.Event()
        self._thread = None
        self.last_p99 = None
        self.last_queue = 0.0
        self.last_model_p99 = {}   # model -> windowed p99 (or None)
        self.last_hot_models = []  # models breaching their target now
        self.scale_outs = 0
        self.scale_ins = 0
        self.drain_reports = []

    # -- loop -----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=30.0)
        self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must not die
                pass
            self._stop.wait(self.config.interval_s)

    # -- one control round ----------------------------------------------
    def _signals(self):
        edges, cum = self.router.latency_window()
        p99 = _window_p99(edges, self._prev_window, cum)
        self._prev_window = dict(cum)
        routable = [r for r in self.router.membership.replicas()
                    if r.state in (HEALTHY, DEGRADED)]
        queue = sum(r.queue_rows for r in routable)
        return p99, queue, routable

    def _model_signals(self):
        """{model: windowed p99 or None} for every model in
        model_targets, each over its OWN fleet_request_ms{model=}
        series — one hot model stays visible through any amount of
        cold-model traffic in the aggregate window."""
        out = {}
        for model in self.config.model_targets:
            edges, cum = self.router.latency_window(model=model)
            out[model] = _window_p99(
                edges, self._prev_model_windows.get(model), cum)
            self._prev_model_windows[model] = dict(cum)
        return out

    def tick(self):
        cfg = self.config
        now = self._clock()
        p99, queue, routable = self._signals()
        model_p99 = self._model_signals()
        hot_models = [m for m, v in model_p99.items()
                      if v is not None and v > cfg.model_targets[m]]
        self.last_p99, self.last_queue = p99, queue
        self.last_model_p99 = model_p99
        self.last_hot_models = hot_models
        live = len(routable)
        hot = (p99 is not None and p99 > cfg.target_p99_ms) or \
            (cfg.high_queue_rows is not None
             and queue >= cfg.high_queue_rows) or bool(hot_models)
        models_calm = all(
            v is None or v <= cfg.model_targets[m] * cfg.hysteresis
            for m, v in model_p99.items())
        cold = queue == 0 and models_calm and \
            (p99 is None or p99 <= cfg.target_p99_ms * cfg.hysteresis)
        if hot:
            self._breach += 1
            self._calm = 0
        elif cold:
            self._calm += 1
            self._breach = 0
        else:
            # the hysteresis dead band: neither counter advances
            self._breach = self._calm = 0
        self._gauges(p99, live)
        if self._breach >= cfg.breach_rounds and live < cfg.max_replicas \
                and self._cooled(self._last_out, cfg.cooldown_out_s, now):
            self._scale_out(min(cfg.scale_step,
                                cfg.max_replicas - live), now)
        elif self._calm >= cfg.calm_rounds and live > cfg.min_replicas \
                and self._cooled(self._last_in, cfg.cooldown_in_s, now):
            self._scale_in(routable, now)

    @staticmethod
    def _cooled(last, cooldown_s, now):
        return last is None or now - last >= cooldown_s

    def _scale_out(self, n, now):
        for name, endpoint in self.spawner.spawn_many(n):
            # membership join = the unified table's epoch-fenced JOIN;
            # the prober grants routability on the first passing probe
            self.router.membership.heartbeat(name, endpoint)
            self._spawned.append(name)
            self.scale_outs += 1
            monitor.registry().counter(
                "fleet_autoscaler_scale_outs_total",
                help="replicas spawned by the autoscaler").inc()
        self._last_out = now
        self._breach = 0

    def _scale_in(self, routable, now):
        victim = scale_in_victim(routable, prefer=self._spawned)
        if victim is None:
            return
        report = self.router.drain(
            victim, timeout_s=self.config.drain_timeout_s)
        # a cleanly drained replica exits on its own (shutdown_on_drain);
        # give it that exit before reaping, or stop() SIGTERMs a process
        # that is mid-teardown and records a bogus -15
        rc = None
        waiter = getattr(self.spawner, "wait", None)
        if report.get("drained") and waiter is not None:
            rc = waiter(victim, timeout_s=30.0)
        if rc is None:
            rc = self.spawner.stop(victim)
        report["exit_code"] = rc
        self.drain_reports.append(report)
        if victim in self._spawned:
            self._spawned.remove(victim)
        self.router.membership.remove(victim)
        self.scale_ins += 1
        monitor.registry().counter(
            "fleet_autoscaler_scale_ins_total",
            help="replicas drained away by the autoscaler").inc()
        self._last_in = now
        self._calm = 0

    def _gauges(self, p99, live):
        reg = monitor.registry()
        reg.gauge("fleet_autoscaler_routable_replicas",
                  help="routable replicas the autoscaler sees").set(live)
        if p99 is not None:
            reg.gauge("fleet_autoscaler_window_p99_ms",
                      help="windowed router p99 driving scale "
                           "decisions").set(p99)
        for m, v in self.last_model_p99.items():
            if v is not None:
                reg.gauge("fleet_autoscaler_window_p99_ms",
                          model=m).set(v)

    def describe(self):
        return {"p99_ms": self.last_p99, "queue_rows": self.last_queue,
                "model_p99_ms": dict(self.last_model_p99),
                "hot_models": list(self.last_hot_models),
                "breach_rounds": self._breach, "calm_rounds": self._calm,
                "scale_outs": self.scale_outs,
                "scale_ins": self.scale_ins,
                "spawned": list(self._spawned)}


class ProcessReplicaSpawner:
    """Spawn `paddle_tpu_torch fleet replica` subprocesses for scale-out.

    `argv_base` is the full replica command line minus --name/--port-
    file (e.g. [sys.executable, "-m", "paddle_tpu_torch", "fleet",
    "replica", "--model-dir", ..., "--place", "cuda", "--port", "0"]).
    Each spawn appends a unique name and a port file, waits for the
    replica to bind, and returns (name, endpoint).

    per_replica_cache gives every replica its OWN --cache-dir under
    `workdir` (a fresh host's store starts empty).
    """

    def __init__(self, argv_base, workdir, name_prefix="as", env=None,
                 per_replica_cache=False, start_timeout_s=180.0):
        self.argv_base = list(argv_base)
        self.workdir = str(workdir)
        self.name_prefix = name_prefix
        self.env = dict(env) if env is not None else None
        self.per_replica_cache = bool(per_replica_cache)
        self.start_timeout_s = float(start_timeout_s)
        self.procs = {}      # name -> Popen
        self.endpoints = {}  # name -> host:port
        self.exit_codes = {}
        self._seq = 0
        self._lock = threading.Lock()

    def _next_name(self):
        with self._lock:
            name = f"{self.name_prefix}{self._seq}"
            self._seq += 1
            return name

    def _launch(self, name):
        os.makedirs(self.workdir, exist_ok=True)
        port_file = os.path.join(self.workdir, f"{name}.port")
        try:
            os.unlink(port_file)
        except OSError:
            pass
        argv = self.argv_base + ["--name", name, "--port-file", port_file]
        if self.per_replica_cache:
            argv += ["--cache-dir",
                     os.path.join(self.workdir, f"cache-{name}")]
        proc = subprocess.Popen(argv, env=self.env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.STDOUT)
        self.procs[name] = proc
        return name, port_file

    def _await_port(self, name, port_file):
        deadline = time.monotonic() + self.start_timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(port_file):
                try:
                    port = int(open(port_file).read().strip() or 0)
                except ValueError:
                    port = 0
                if port:
                    endpoint = f"127.0.0.1:{port}"
                    self.endpoints[name] = endpoint
                    return name, endpoint
            proc = self.procs.get(name)
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"replica {name} exited rc={proc.returncode} "
                    "before binding")
            time.sleep(0.1)
        raise RuntimeError(f"replica {name} did not bind within "
                           f"{self.start_timeout_s}s")

    def spawn_many(self, n):
        """Start n replicas CONCURRENTLY (their interpreter+torch imports
        overlap), then wait for every port file; -> [(name, endpoint)].
        A replica that fails to bind is reaped and skipped — scale-out
        returns what actually came up."""
        launched = [self._launch(self._next_name()) for _ in range(n)]
        out = []
        for name, port_file in launched:
            try:
                out.append(self._await_port(name, port_file))
            except RuntimeError:
                self.stop(name, timeout_s=5.0)
        return out

    def spawn(self):
        return self.spawn_many(1)[0]

    def wait(self, name, timeout_s=30.0):
        """Wait for a replica to exit on its own (the post-drain path);
        returns its exit code, or None if it is still running."""
        proc = self.procs.get(name)
        if proc is None:
            return self.exit_codes.get(name)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None
        self.exit_codes[name] = rc
        return rc

    def stop(self, name, timeout_s=30.0):
        """Reap one replica process (AFTER Router.drain() — SIGTERM here
        triggers the replica's graceful drain path as a backstop).
        Returns the exit code, or None if it had to be killed."""
        proc = self.procs.get(name)
        if proc is None:
            return self.exit_codes.get(name)
        if proc.poll() is None:
            try:
                proc.terminate()
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
            except OSError:
                pass
        self.exit_codes[name] = proc.returncode
        return proc.returncode

    def stop_all(self, timeout_s=30.0):
        for name in list(self.procs):
            self.stop(name, timeout_s=timeout_s)
        return dict(self.exit_codes)
