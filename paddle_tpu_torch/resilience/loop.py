"""ResilientRunner: the fault-tolerant step loop the Trainer wraps around
its epoch iteration (and tests drive directly).

Per-step protocol:

    runner = ResilientRunner(ResilienceConfig(checkpoint_dir=...),
                             scope=scope, program=prog, place=place)
    with runner.session():
        runner.restore(pipe)                      # latest ckpt, if any
        for staged in pipe:
            metrics = runner.run_step(lambda: exe.run(...))   # retried
            metrics = runner.after_step(metrics, pipe=pipe)   # guard/save
            ...

after_step is the step-boundary brain: NaN guard (with chaos poisoning
first, so tests exercise the guard), checkpoint cadence (async — the
device never waits on an fsync), chaos SIGTERM injection, and the
preemption check (grace-save + raise Preempted). On nan_policy=restore it
rolls the scope AND the datapipe back to the last checkpoint and raises
RolledBack — the caller re-enters its iteration loop, which resumes from
the restored source position.

The port's random numbers come from one torch.Generator per (Executor,
program) that every step advances (core/executor_core.RandomStream), not
from the step counter as in the JAX package. A runner bound to the
Executor (`bind`) saves that stream's state in every checkpoint and puts
it back on restore and rollback, before the next step or replay, so a
program with dropout resumes on the numbers it would have drawn.
"""

from .. import flags, monitor
from . import chaos as chaos_mod
from .checkpoint import RNG_KEY, CheckpointManager
from .errors import NanLossError
from .nan_guard import NanGuard
from .preempt import PreemptionHandler
from .retry import RetryPolicy

__all__ = ["ResilienceConfig", "ResilientRunner", "RolledBack"]

_HEALTH_POLICIES = ("warn", "skip", "restore")


class RolledBack(Exception):
    """after_step restored the last checkpoint (nan_policy=restore); the
    caller must restart its iteration loop — the pipe will resume from
    the restored position."""

    def __init__(self, manifest):
        super().__init__(
            f"rolled back to checkpoint serial {manifest.get('serial')} "
            f"(step {manifest.get('step')})")
        self.manifest = manifest


class ResilienceConfig:
    """checkpoint_dir:       where checkpoints live (None = no checkpoints:
                             retry/NaN/preempt handling still active)
    checkpoint_interval:     save every N completed steps (0 = only
                             grace-saves on preemption)
    max_num_checkpoints:     LRU retention
    async_checkpoints:       background writer (False: every save blocks)
    retry:                   RetryPolicy, None = default policy, False =
                             no retries
    nan_policy:              raise|skip|restore; None = the flag
    health_policy:           warn|skip|restore applied when paddle_tpu_torch
                             .health detectors fired during the step;
                             None = FLAGS_resilience_health_policy
    handle_signals:          install SIGTERM/SIGINT handlers in session()
    save_on_preempt:         blocking grace-save before raising Preempted
    restore_on_start:        restore() picks up the latest checkpoint
    elastic:                 a parallel.elastic.ElasticController; the
                             runner starts it in session(), polls it at
                             every step boundary (raising Resized on an
                             epoch change) and drains membership before
                             raising Preempted so the survivors resize
                             immediately instead of waiting out the TTL
    """

    def __init__(self, checkpoint_dir=None, checkpoint_interval=0,
                 max_num_checkpoints=3, async_checkpoints=True,
                 retry=None, nan_policy=None, health_policy=None,
                 handle_signals=True, save_on_preempt=True,
                 restore_on_start=True, elastic=None):
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = int(checkpoint_interval)
        self.max_num_checkpoints = int(max_num_checkpoints)
        self.async_checkpoints = bool(async_checkpoints)
        self.retry = retry
        self.nan_policy = nan_policy
        self.health_policy = health_policy
        self.handle_signals = bool(handle_signals)
        self.save_on_preempt = bool(save_on_preempt)
        self.restore_on_start = bool(restore_on_start)
        self.elastic = elastic


class ResilientRunner:
    def __init__(self, config=None, scope=None, program=None, place=None):
        self.config = config if config is not None else ResilienceConfig()
        self.scope = scope
        self.program = program
        self.place = place
        self.global_step = 0   # steps completed (survives restore)
        self.state = {}        # caller extras round-tripped via manifest
        cfg = self.config
        self.checkpoint = None
        if cfg.checkpoint_dir:
            self.checkpoint = CheckpointManager(
                cfg.checkpoint_dir,
                max_num_checkpoints=cfg.max_num_checkpoints,
                async_write=cfg.async_checkpoints)
        if cfg.retry is False:
            self.retry = None
        elif cfg.retry is None:
            self.retry = RetryPolicy()
        else:
            self.retry = cfg.retry
        self.guard = NanGuard(policy=cfg.nan_policy)
        self.preempt = PreemptionHandler() if cfg.handle_signals else None
        self.elastic = cfg.elastic
        self.executor = None  # bind(): whose random stream rides along
        self._in_session = False

    def bind(self, executor):
        """Checkpoint the random stream `executor` keeps for the runner's
        program (Executor.rng_state) and put it back on restore."""
        self.executor = executor
        return self

    def _rng_state(self):
        if self.executor is None or self.program is None:
            return None
        return self.executor.rng_state(self.program)

    def _reseat(self, manifest):
        """Global step, extras and the bound random stream from a restored
        manifest."""
        self.global_step = int(manifest.get("step", 0))
        self.state = dict(manifest.get("extra", {}))
        rng = manifest.get(RNG_KEY)
        if rng is not None and self.executor is not None \
                and self.program is not None:
            self.executor.set_rng_state(self.program, rng)

    # ----------------------------------------------------------- lifecycle
    def session(self):
        """Context manager for one training run: the checkpoint's pinned
        snapshot buffers reserved and signal handlers in, queued
        checkpoint writes drained on the way out (even on error — the last
        completed save must land before the process dies)."""
        import contextlib

        @contextlib.contextmanager
        def _session():
            self._in_session = True
            # fleet observability rides the session lifecycle: a no-op
            # unless FLAGS_obs_push names a collector
            from ..obs import maybe_start as _obs_start

            obs_client = _obs_start("trainer")
            if self.checkpoint is not None:
                # the snapshot's pinned buffers, before the first step
                self.checkpoint.reserve(self.scope, self.program)
            try:
                if self.elastic is not None \
                        and not getattr(self.elastic, "_started", False):
                    self.elastic.start(self)
                if self.preempt is not None:
                    with self.preempt:
                        yield self
                else:
                    yield self
            finally:
                self._in_session = False
                if self.elastic is not None:
                    self.elastic.stop()
                if self.checkpoint is not None:
                    self.checkpoint.wait()
                if obs_client is not None:
                    # final push after the drain: the collector sees the
                    # terminal journal tail and any shutdown trace dump
                    obs_client.stop()

        return _session()

    def close(self):
        if self.checkpoint is not None:
            self.checkpoint.close()

    # ------------------------------------------------------------- restore
    def restore(self, pipe=None):
        """Load the latest checkpoint (scope vars, global step, caller
        extras, datapipe position). Returns the manifest or None."""
        if self.checkpoint is None or not self.config.restore_on_start:
            return None
        manifest = self.checkpoint.restore(
            scope=self.scope, program=self.program, place=self.place)
        if manifest is None:
            return None
        self._reseat(manifest)
        if pipe is not None and "datapipe" in manifest \
                and hasattr(pipe, "restore_state"):
            pipe.restore_state(manifest["datapipe"])
        return manifest

    def adopt(self, pipe=None, expect_mesh=None):
        """Adopt the newest COMMITTED checkpoint regardless of
        restore_on_start — the elastic resize path: every survivor
        re-seats itself on the fleet's resume point after the commit
        barrier. expect_mesh ({axis: size}) makes the restore refuse a
        checkpoint whose mp/pp geometry conflicts with the re-formed mesh.
        Returns the manifest, or None when there is nothing to adopt."""
        if self.checkpoint is None:
            return None
        self.checkpoint.wait()  # a cadence save may still be in flight
        manifest = self.checkpoint.restore(
            scope=self.scope, program=self.program, place=self.place,
            expect_mesh=expect_mesh)
        if manifest is None:
            return None
        self._reseat(manifest)
        if pipe is not None:
            # tear down the live iteration before repositioning the source
            pipe.close()
            if "datapipe" in manifest and hasattr(pipe, "restore_state"):
                pipe.restore_state(manifest["datapipe"])
        return manifest

    def _rollback(self, pipe):
        """nan_policy=restore: last checkpoint back into the scope AND the
        pipe; rewind the step counter; hand RolledBack to the caller."""
        if self.checkpoint is not None:
            self.checkpoint.wait()  # a cadence save may still be in flight
        if self.checkpoint is None \
                or self.checkpoint.latest_serial() < 0:
            raise NanLossError(
                "nan_policy=restore with no checkpoint to restore "
                f"(step {self.global_step})")
        manifest = self.checkpoint.restore(
            scope=self.scope, program=self.program, place=self.place)
        self._reseat(manifest)
        if pipe is not None:
            # tear down the live iteration before repositioning the source
            pipe.close()
            if "datapipe" in manifest and hasattr(pipe, "restore_state"):
                pipe.restore_state(manifest["datapipe"])
        monitor.registry().counter(
            "resilience_rollbacks_total",
            help="nan_policy=restore rollbacks to the last checkpoint").inc()
        raise RolledBack(manifest)

    # ---------------------------------------------------------------- save
    def save(self, pipe=None, block=False, extra=None):
        """Checkpoint now (serial, or None without a checkpoint dir)."""
        if self.checkpoint is None:
            return None
        merged = dict(self.state)
        if extra:
            merged.update(extra)
        return self.checkpoint.save(
            self.global_step, scope=self.scope, program=self.program,
            pipe=pipe, extra=merged, block=block, rng=self._rng_state())

    # ---------------------------------------------------------------- step
    def _apply_health_policy(self, pipe):
        """Generalized model-health guard: drain the detector events the
        step's health sampling queued (paddle_tpu_torch.health.detectors) and
        apply warn|skip|restore. The NaN-only guard above stays its own
        special case — it reads the fetched metrics directly and can
        raise, while this path reacts to the fused-stats detectors."""
        from .. import health  # lazy: this package is imported early

        events = health.drain_events()
        if not events:
            return
        policy = self.config.health_policy \
            or flags.get("resilience_health_policy")
        if policy not in _HEALTH_POLICIES:
            raise ValueError(
                f"resilience_health_policy must be one of "
                f"{_HEALTH_POLICIES}, got {policy!r}")
        monitor.registry().counter(
            "health_policy_actions_total",
            help="health detector events handled by the resilience "
                 "policy", policy=policy).inc(len(events))
        if policy == "restore":
            self._rollback(pipe)  # raises RolledBack
        if policy == "skip":
            self.state["health_skipped_steps"] = int(
                self.state.get("health_skipped_steps", 0)) + 1

    def run_step(self, fn):
        """Run one step (the exe.run closure) under the retry policy."""
        if self.retry is None:
            return fn()
        return self.retry.call(fn)

    def after_step(self, metrics, pipe=None, extra=None):
        """Step-boundary bookkeeping; call after every successful
        run_step. Returns the (possibly chaos-poisoned) metrics. Raises
        RolledBack (nan/health restore) or Preempted (grace-saved
        signal)."""
        s = self.global_step  # 0-based index of the step that just ran
        monkey = chaos_mod.active()
        if monkey is not None:
            metrics = monkey.poison(s, metrics)
        if self.guard.check(metrics, step=s) == "restore":
            self._rollback(pipe)  # raises RolledBack
        self._apply_health_policy(pipe)  # may raise RolledBack
        self.global_step = s + 1
        if extra:
            self.state.update(extra)
        cfg = self.config
        if self.checkpoint is not None and cfg.checkpoint_interval > 0 \
                and self.global_step % cfg.checkpoint_interval == 0:
            self.save(pipe=pipe)
        if monkey is not None:
            monkey.on_step(s)  # may deliver an injected SIGTERM
        leaving = self.preempt is not None \
            and self.preempt.pending() is not None
        if self.elastic is not None:
            # after the chaos hook (the JAX package polls before it): in
            # a group every rank must learn at this boundary that one of
            # them leaves, so the poll's agreement carries `leaving`
            self.elastic.poll(self, pipe=pipe, leaving=leaving)
        if leaving:
            serial = None
            if cfg.save_on_preempt and self.checkpoint is not None:
                serial = self.save(pipe=pipe, block=True)
            if self.elastic is not None:
                # SIGTERM-drain: leave the membership before dying so the
                # survivors resize immediately instead of waiting the TTL
                self.elastic.drain()
            self.preempt.raise_preempted(checkpoint_serial=serial)
        return metrics
