"""Elastic data-parallel training: resize the dp group mid-job.

The Fluid lineage's Go/etcd fault-tolerant master exists so a training
job outlives its workers; the JAX package's paddle_tpu/parallel/elastic.py
closes that loop for its runtime, and this module for the port. Every
trainer runs an ElasticController around its step loop, the master
(parallel/master.py) tracks a TTL'd membership set with a monotonically
increasing *membership epoch*, and any join/leave — heartbeat lapse,
connection close, or the explicit SIGTERM-drain from resilience/ — bumps
the epoch. On an epoch change every surviving trainer hits the resize
barrier at its next step boundary:

    1. barrier("resize", epoch)   all survivors of the new epoch meet;
                                  the release assigns dense ranks
    2. rank 0 commits a blocking checkpoint at the resize point
    3. barrier("commit", epoch)   nobody proceeds past an uncommitted save
    4. re-form the group          the old default process group is
                                  destroyed and a new one made with the
                                  barrier's dense ranks and world, under
                                  a rendezvous keyed by the epoch; then
                                  MeshSpec.build(dp=world)
    5. adopt the newest committed checkpoint (layout-independent: zero1
       snapshots are canonical full layout, so a dp=4 state restores onto
       dp=2 bitwise), refusing on an mp/pp-geometry conflict
    6. rescale lr via the pluggable RescalePolicy (linear-lr default,
       warmup ramp after growth), resume from the exact datapipe position

and raises Resized so the caller re-enters its loop on the new group —
a ParallelExecutor made anew over it (the old one's mesh is stale and
refuses to run), its prepare a clean miss for the new world. A worker
whose membership lapsed (it was partitioned or restarted) is REFUSED by
the generation-fenced heartbeat and re-joins under a strictly newer
epoch: restarted stragglers rejoin at the next epoch instead of
restarting the job.

What the port adds to the JAX protocol, because a rank is a process:

  * the group re-form (step 4). The JAX package re-forms a device subset
    inside one process. Here rank 0 of the epoch hosts a
    torch.distributed TCPStore on a port the OS picks and registers its
    address in the master's discovery registry under the epoch
    ("elastic_rendezvous", "<epoch>"); the other ranks look up THAT
    epoch's entry, so a rendezvous of an older epoch is never joined.
    A group that cannot be re-formed raises ElasticError.
  * the boundary agreement. Inside a group every step's collectives
    need every rank, so all ranks must take a resize at the same step
    boundary: `poll` all-reduces (max) one flag over the group — this
    rank's pending resize, or that it is leaving (a SIGTERM it is about
    to act on) — before deciding. A rank that leaves contributes its
    flag, then drains and exits; the others resize at that boundary.
"""

import datetime
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import monitor
from .. import trace
from . import distributed as distributed_mod
from . import mesh as mesh_mod
from .master import MasterClient

__all__ = ["ElasticConfig", "ElasticController", "ElasticError", "Resized",
           "RescalePolicy", "LinearRescale", "ConstantRescale",
           "find_lr_var", "fetch_status", "RENDEZVOUS_KIND"]

# discovery-registry kind under which rank 0 of an epoch publishes its
# rendezvous store ("host:port"), named by the epoch
RENDEZVOUS_KIND = "elastic_rendezvous"


class ElasticError(RuntimeError):
    """The resize protocol failed (barrier timeout, world below
    min_world, a group that could not be re-formed); the job cannot
    safely continue on this worker."""


class Resized(Exception):
    """The controller re-formed the group: the caller must re-enter its
    step loop (the scope/pipe are already re-seated on the adopted
    checkpoint, exactly like resilience.RolledBack) with a
    ParallelExecutor made anew."""

    def __init__(self, epoch, world_size, rank, members, old_world,
                 manifest=None, mesh=None):
        super().__init__(
            f"elastic resize: epoch {epoch}, world {old_world} -> "
            f"{world_size} (rank {rank})")
        self.epoch = epoch
        self.world_size = world_size
        self.rank = rank
        self.members = list(members)
        self.old_world = old_world
        self.manifest = manifest
        self.mesh = mesh


# --------------------------------------------------------------- rescale
class RescalePolicy:
    """How global batch and lr react to a world-size change.

    The contract: `lr_scale(base_world, world)` is the steady-state lr
    multiplier vs the base configuration, `batch_scale` the global-batch
    multiplier (informational — per-worker batch is what the datapipe
    actually controls), and `warmup_steps` is how many steps the lr ramps
    from its pre-resize value to the new target after a GROWTH (big fresh
    batch + full lr at step one after a grow is the classic divergence
    recipe; shrink applies the new lr immediately).
    """

    warmup_steps = 0

    def lr_scale(self, base_world, world):
        return 1.0

    def batch_scale(self, base_world, world):
        return 1.0


class LinearRescale(RescalePolicy):
    """Linear scaling rule: per-worker batch stays fixed, so the global
    batch — and with it the lr — scales with the world size."""

    def __init__(self, warmup_steps=0):
        self.warmup_steps = int(warmup_steps)

    def lr_scale(self, base_world, world):
        return float(world) / float(base_world)

    def batch_scale(self, base_world, world):
        return float(world) / float(base_world)


class ConstantRescale(RescalePolicy):
    """Keep global batch and lr fixed across resizes (every world computes
    the full global batch, its ranks splitting the rows — the
    parity-drill configuration, and the right choice when
    reproducibility beats throughput)."""


def find_lr_var(program, scope=None):
    """Name of the optimizer's global learning-rate var in `program`
    (optimizer._create_global_learning_rate names it learning_rate_<n>),
    or None. With `scope`, only names actually materialized there."""
    if program is None:
        return None
    for var in program.list_vars():
        if var.name.startswith("learning_rate") and var.persistable:
            if scope is None or scope.find_var(var.name) is not None:
                return var.name
    return None


def _scalar(value):
    if isinstance(value, torch.Tensor):
        return float(value.detach().reshape(-1)[0].item())
    return float(np.asarray(value).reshape(-1)[0])


# ------------------------------------------------------------ controller
class ElasticConfig:
    """master:            endpoint "host:port", a MasterClient, or an
                          in-process MasterService (tests)
    name:                 this worker's membership name (unique per job;
                          the barrier's dense ranks follow the names'
                          sorted order)
    addr:                 advertised address (informational)
    ttl:                  membership lease; a worker silent for ttl is
                          reaped and the survivors resize
    heartbeat_interval:   beat cadence (default ttl/3)
    start_world:          block start() until this many workers joined
                          (None = start stepping immediately)
    min_world:            resize below this raises ElasticError
    policy:               RescalePolicy (default LinearRescale())
    lr_var:               learning-rate var name (None = auto-detect from
                          the runner's program)
    mesh_spec:            MeshSpec re-formed at each resize: the
                          controller then forms the process group itself
                          (start) and re-forms it at every resize, and
                          builds the mesh over it (None = the group and
                          the mesh, if any, are the caller's business via
                          mesh_factory/on_resize)
    local_device_ids:     this rank's card for the group ([card]; None =
                          a CPU rank), as distributed.initialize takes it
    backend:              the group's backend (None = NCCL on a card,
                          gloo on the host; "gloo" with a card: ranks
                          that share it)
    rendezvous_host:      the address rank 0's rendezvous store binds and
                          advertises
    checkpoint_on_resize: rank 0 commits a blocking save at the barrier
    restore_on_resize:    every survivor adopts the newest committed
                          checkpoint after the commit barrier
    barrier_timeout:      per-barrier wait; resize_timeout bounds the
                          whole protocol including restarts
    """

    def __init__(self, master, name, addr="", ttl=5.0,
                 heartbeat_interval=None, start_world=None, min_world=1,
                 policy=None, lr_var=None, mesh_spec=None,
                 local_device_ids=None, backend=None,
                 rendezvous_host="127.0.0.1",
                 checkpoint_on_resize=True, restore_on_resize=True,
                 barrier_timeout=30.0, resize_timeout=120.0):
        self.master = master
        self.name = str(name)
        self.addr = str(addr)
        self.ttl = float(ttl)
        self.heartbeat_interval = (self.ttl / 3.0 if heartbeat_interval
                                   is None else float(heartbeat_interval))
        self.start_world = start_world
        self.min_world = int(min_world)
        self.policy = policy if policy is not None else LinearRescale()
        self.lr_var = lr_var
        self.mesh_spec = mesh_spec
        self.local_device_ids = (list(local_device_ids)
                                 if local_device_ids else None)
        self.backend = backend
        self.rendezvous_host = str(rendezvous_host)
        self.checkpoint_on_resize = bool(checkpoint_on_resize)
        self.restore_on_resize = bool(restore_on_resize)
        self.barrier_timeout = float(barrier_timeout)
        self.resize_timeout = float(resize_timeout)


class ElasticController:
    """One per trainer, wrapped around the step loop.

        ctl = ElasticController(ElasticConfig(master, name="w0",
                                              mesh_spec=MeshSpec()))
        ctl.start(runner)            # join + initial barrier -> rank/world,
                                     # the group formed
        while training:
            step()
            ctl.poll(runner, pipe)   # raises Resized on an epoch change
        ctl.stop()

    With a ResilientRunner the wiring is automatic: pass the controller
    as ResilienceConfig(elastic=ctl) and the runner polls at every step
    boundary, drains membership on SIGTERM, and the Trainer re-enters its
    loop on Resized.

    mesh_factory(world, rank, members) -> Mesh overrides cfg.mesh_spec;
    on_resize(resized) observes every completed resize (rebuild a
    ParallelExecutor over the new group here). `last_resize` holds the
    host ms of the last resize by part (barriers, checkpoint, reform,
    adopt, total).
    """

    def __init__(self, config, mesh_factory=None, on_resize=None):
        self.config = config
        self.name = config.name
        self.on_resize = on_resize
        self._forms_group = mesh_factory is None \
            and config.mesh_spec is not None
        if mesh_factory is not None:
            self.mesh_factory = mesh_factory
        elif config.mesh_spec is not None:
            self.mesh_factory = self._reform_and_build
        else:
            self.mesh_factory = None
        m = config.master
        self._owns_master = isinstance(m, str)
        self._master = MasterClient(m) if self._owns_master else m
        self.epoch = -1
        self.world_size = 0
        self.rank = -1
        self.members = []
        self.mesh = None
        self.resizes = 0
        self.last_resize = None
        self.base_lr = None
        self.base_world = None
        self._lr_var = config.lr_var
        self._cur_lr = None
        self._ramp = []          # pending warmup lr values, one per poll
        self._resize_pending = threading.Event()
        self._needs_rejoin = False
        self._stop_evt = threading.Event()
        self._hb_thread = None
        self._started = False
        self._parts = None       # the resize in flight's ms by part
        self._forming_epoch = None  # the epoch whose group is forming

    # ------------------------------------------------------------ lifecycle
    def start(self, runner=None):
        """Join the membership, optionally wait for start_world peers,
        pass the initial barriers to learn rank/world, form the group
        (with a mesh_spec), start heartbeats."""
        cfg = self.config
        r = self._master.elastic_join(self.name, cfg.addr, cfg.ttl)
        self.epoch = int(r["epoch"])
        if cfg.start_world:
            deadline = time.monotonic() + cfg.resize_timeout
            while len(self._master.elastic_membership()["members"]) \
                    < int(cfg.start_world):
                if time.monotonic() > deadline:
                    raise ElasticError(
                        f"{self.name}: only "
                        f"{len(self._master.elastic_membership()['members'])}"
                        f" of start_world={cfg.start_world} workers joined "
                        f"within {cfg.resize_timeout}s")
                time.sleep(0.02)
        members, rank, epoch = self._join_barriers()
        self.epoch = epoch
        self.members = members
        self.rank = rank
        self.world_size = len(members)
        self.base_world = int(cfg.start_world or self.world_size)
        if self.mesh_factory is not None:
            self.mesh = self.mesh_factory(self.world_size, self.rank,
                                          self.members)
        self._capture_base_lr(runner)
        self._record_membership_gauges()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"elastic-hb-{self.name}",
            daemon=True)
        self._hb_thread.start()
        self._started = True
        return self

    def drain(self):
        """Explicit SIGTERM-drain: leave the membership NOW so the
        survivors resize immediately instead of waiting out the TTL. The
        heartbeat stops first — a post-leave beat would be refused as a
        zombie anyway."""
        self._stop_evt.set()
        try:
            self._master.elastic_leave(self.name)
        except Exception:  # noqa: BLE001 — best-effort on the way down
            pass
        monitor.registry().counter(
            "elastic_drains_total",
            help="explicit membership leaves (SIGTERM-drain)").inc()

    def stop(self):
        """Leave + tear down (normal end of training). The group this
        controller formed stays up for the caller's last fetches; the
        process's exit (or distributed.reform) takes it down."""
        if not self._stop_evt.is_set():
            self.drain()
        if self._hb_thread is not None and self._hb_thread.is_alive():
            self._hb_thread.join(timeout=10.0)
        if self._owns_master:
            try:
                self._master.close()
            except Exception:  # noqa: BLE001
                pass

    def status(self):
        return {"name": self.name, "epoch": self.epoch,
                "world_size": self.world_size, "rank": self.rank,
                "members": list(self.members), "resizes": self.resizes,
                "resize_pending": self._resize_pending.is_set(),
                "last_resize": self.last_resize}

    # ------------------------------------------------------------ heartbeat
    def _hb_loop(self):
        cfg = self.config
        while not self._stop_evt.is_set():
            try:
                r = self._master.elastic_heartbeat(self.name, self.epoch)
                if not r.get("known"):
                    # membership lapsed: the survivors already resized away
                    # from us — rejoin under a NEW epoch at the next step
                    # boundary (never resurrect the old one)
                    self._needs_rejoin = True
                    self._resize_pending.set()
                elif r.get("stale") or int(r["epoch"]) != self.epoch:
                    self._resize_pending.set()
            except Exception:  # noqa: BLE001 — a missed beat is not fatal
                pass
            self._stop_evt.wait(cfg.heartbeat_interval)

    def resize_pending(self):
        return self._resize_pending.is_set()

    def membership(self):
        """The master's membership now: {"epoch", "members": {name:
        addr}}."""
        return self._master.elastic_membership()

    # ----------------------------------------------------------------- poll
    def poll(self, runner=None, pipe=None, leaving=False):
        """Step-boundary hook. Applies any in-flight lr warmup ramp, then
        runs the resize protocol if an epoch change is pending — raising
        Resized so the caller re-enters its loop on the new group. Inside
        a group this controller formed, the ranks first agree on one flag
        (module docstring): `leaving` says this rank is about to drain,
        and then no resize runs here (the caller drains)."""
        if self._stop_evt.is_set():
            return  # draining: never resize (or rejoin) on the way down
        if self._ramp:
            self._apply_lr(self._ramp.pop(0), runner)
        pending = self._still_pending()
        if self._forms_group and self.world_size > 1:
            pending = self._agree(pending or leaving)
        if not pending or leaving:
            return
        self._resize(runner, pipe)

    def _still_pending(self):
        """Whether a resize is due: a pending flag the master's epoch
        confirms (a beat that raced the last resize's own epoch update
        leaves the flag set with nothing to do)."""
        if self._needs_rejoin:
            return True
        if not self._resize_pending.is_set():
            return False
        m = self._master.elastic_membership()
        if int(m["epoch"]) == self.epoch and self.name in m["members"]:
            self._resize_pending.clear()
            return False
        return True

    def _agree(self, flag):
        """Max of `flag` over the ranks of the live group: every rank
        takes (or skips) the resize at the same step boundary."""
        device = "cpu"
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(int(t.item()))

    # ---------------------------------------------------------- the group
    def _reform_and_build(self, world, rank, members):
        """mesh_factory of a controller with a mesh_spec: re-form the
        default process group for (world, rank) under this epoch's
        rendezvous, then build the spec's mesh over it."""
        cfg = self.config
        t0 = time.perf_counter()
        try:
            store = self._rendezvous(self._forming_epoch, world, rank)
            distributed_mod.reform(store, world, rank,
                                   local_device_ids=cfg.local_device_ids,
                                   backend=cfg.backend)
            mesh = cfg.mesh_spec.build(world)
        except ElasticError:
            raise
        except Exception as e:  # noqa: BLE001 — surfaced as the protocol's
            raise ElasticError(
                f"{self.name}: could not re-form the process group for "
                f"epoch {self._forming_epoch} (world {world}, rank "
                f"{rank}): {e}") from e
        if self._parts is not None:
            self._parts["reform"] = (time.perf_counter() - t0) * 1e3
        return mesh

    def _rendezvous(self, epoch, world, rank):
        """The Store this epoch's group rendezvouses through: rank 0 hosts
        it and publishes its address under the epoch; the others look up
        that epoch's entry (never an older one) and connect."""
        cfg = self.config
        key = str(int(epoch))
        timeout = datetime.timedelta(seconds=cfg.barrier_timeout)
        if rank == 0:
            store = dist.TCPStore(cfg.rendezvous_host, 0, world, True,
                                  timeout=timeout, wait_for_workers=False)
            self._master.register(RENDEZVOUS_KIND, key,
                                  f"{cfg.rendezvous_host}:{store.port}",
                                  cfg.resize_timeout)
            return store
        deadline = time.monotonic() + cfg.barrier_timeout
        while True:
            addr = self._master.lookup(RENDEZVOUS_KIND).get(key)
            if addr:
                break
            if time.monotonic() > deadline:
                raise ElasticError(
                    f"{self.name}: no rendezvous for epoch {key} within "
                    f"{cfg.barrier_timeout}s")
            time.sleep(0.01)
        host, port = addr.rsplit(":", 1)
        return dist.TCPStore(host, int(port), world, False, timeout=timeout)

    # --------------------------------------------------------------- resize
    def _join_barriers(self):
        """The joiner's half of the resize protocol. A fresh worker must
        answer BOTH fleet barriers: incumbents run resize -> (rank-0
        save) -> commit, and the commit releases only when every member
        of the epoch — joiners included — arrives. A join that only
        answered the first barrier would wedge the incumbents' commit."""
        cfg = self.config
        deadline = time.monotonic() + cfg.resize_timeout
        while True:
            members, rank, epoch = self._barrier_until_released(
                "resize", deadline=deadline)
            b2 = self._master.elastic_barrier(
                self.name, epoch, "commit", cfg.barrier_timeout)
            if b2.get("ok"):
                self._forming_epoch = epoch
                return members, rank, epoch
            if b2.get("unknown"):
                self._needs_rejoin = True
            if time.monotonic() > deadline:
                raise ElasticError(
                    f"{self.name}: join commit barrier did not release "
                    f"within {cfg.resize_timeout}s (last: {b2})")

    def _barrier_until_released(self, phase, epoch=None, deadline=None):
        """Drive one barrier phase to release, restarting on epoch moves
        (concurrent leave/join while the barrier forms) and re-joining if
        our own membership lapsed mid-protocol. Returns (members, rank,
        epoch)."""
        cfg = self.config
        if deadline is None:
            deadline = time.monotonic() + cfg.resize_timeout
        while True:
            if self._needs_rejoin:
                if self._stop_evt.is_set():
                    # a drained worker's in-flight barrier RPC comes back
                    # `unknown` after its own leave; rejoining here would
                    # resurrect the membership we just gave up
                    raise ElasticError(
                        f"{self.name}: draining — refusing to rejoin a "
                        f"membership we left")
                r = self._master.elastic_join(self.name, cfg.addr, cfg.ttl)
                self._needs_rejoin = False
                epoch = int(r["epoch"])
                monitor.registry().counter(
                    "elastic_rejoins_total",
                    help="lapsed workers re-admitted under a new epoch"
                ).inc()
            if epoch is None:
                epoch = int(self._master.elastic_membership()["epoch"])
            b = self._master.elastic_barrier(
                self.name, epoch, phase, cfg.barrier_timeout)
            if b.get("ok"):
                return list(b["members"]), int(b["rank"]), int(b["epoch"])
            if b.get("unknown"):
                self._needs_rejoin = True
            if time.monotonic() > deadline:
                raise ElasticError(
                    f"{self.name}: barrier {phase!r} did not release "
                    f"within {cfg.resize_timeout}s (last: {b})")
            # restart against the reported epoch; on a bare timeout retry
            # the same epoch (stragglers may still be finishing a step)
            epoch = int(b["epoch"]) if b.get("restart") else epoch

    def _resize(self, runner, pipe):
        t0 = time.perf_counter()
        old_world, old_epoch = self.world_size, self.epoch
        reg = monitor.registry()
        self._parts = {}
        try:
            with trace.span("elastic.resize", kind="elastic",
                            worker=self.name, old_epoch=old_epoch,
                            old_world=old_world):
                resized = self._resize_inner(runner, pipe, old_world)
        except ElasticError:
            reg.counter("elastic_resize_failures_total",
                        help="resize protocol failures").inc()
            trace.maybe_dump("elastic_resize_failed")
            raise
        ms = (time.perf_counter() - t0) * 1000.0
        self.resizes += 1
        self.last_resize = dict(self._parts, total=ms)
        self._parts = None
        reg.counter("elastic_resizes_total",
                    help="completed elastic mesh resizes").inc()
        reg.gauge("elastic_resize_duration_ms",
                  help="wall time of the last resize (barrier + "
                       "checkpoint + mesh re-form + restore)").set(ms)
        self._record_membership_gauges()
        if self.on_resize is not None:
            self.on_resize(resized)
        raise resized

    def _resize_inner(self, runner, pipe, old_world):
        cfg = self.config
        deadline = time.monotonic() + cfg.resize_timeout
        parts = self._parts
        parts.update(barriers=0.0, checkpoint=0.0)
        while True:
            t0 = time.perf_counter()
            members, rank, epoch = self._barrier_until_released(
                "resize", deadline=deadline)
            parts["barriers"] += (time.perf_counter() - t0) * 1e3
            if len(members) < cfg.min_world:
                raise ElasticError(
                    f"world shrank to {len(members)} < min_world="
                    f"{cfg.min_world} (members {members})")
            # rank 0 commits the fleet's resume point; the commit barrier
            # guarantees nobody adopts an uncommitted save. If membership
            # moves between the two barriers (a straggler rejoining while
            # we restore — the rejoin-during-restore race) the commit
            # barrier restarts and the whole protocol re-runs against the
            # newer epoch.
            t0 = time.perf_counter()
            if rank == 0 and cfg.checkpoint_on_resize \
                    and getattr(runner, "checkpoint", None) is not None:
                runner.save(pipe=pipe, block=True,
                            extra={"elastic": {"epoch": epoch,
                                               "world_size": len(members),
                                               "members": members}})
            parts["checkpoint"] += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            b2 = self._master.elastic_barrier(
                self.name, epoch, "commit", cfg.barrier_timeout)
            parts["barriers"] += (time.perf_counter() - t0) * 1e3
            if b2.get("ok"):
                break
            if b2.get("unknown"):
                self._needs_rejoin = True
            if time.monotonic() > deadline:
                raise ElasticError(
                    f"{self.name}: commit barrier did not release within "
                    f"{cfg.resize_timeout}s (last: {b2})")
        # re-form the group and its mesh BEFORE adopting state, so the
        # restore can refuse a checkpoint whose geometry conflicts with it
        new_mesh = None
        if self.mesh_factory is not None:
            self._forming_epoch = epoch
            new_mesh = self.mesh_factory(len(members), rank, members)
        manifest = None
        t0 = time.perf_counter()
        if cfg.restore_on_resize and runner is not None \
                and getattr(runner, "checkpoint", None) is not None:
            expect = mesh_mod.mesh_geometry(new_mesh)
            if expect is None and cfg.mesh_spec is not None:
                expect = cfg.mesh_spec.geometry(len(members))
            manifest = runner.adopt(pipe=pipe, expect_mesh=expect)
        parts["adopt"] = (time.perf_counter() - t0) * 1e3
        self.mesh = new_mesh
        self.epoch = epoch
        self.members = members
        self.rank = rank
        self.world_size = len(members)
        self._apply_rescale(old_world, len(members), runner)
        self._resize_pending.clear()
        return Resized(epoch, len(members), rank, members, old_world,
                       manifest=manifest, mesh=new_mesh)

    # -------------------------------------------------------------- rescale
    def _capture_base_lr(self, runner):
        if self._lr_var is None and runner is not None:
            self._lr_var = find_lr_var(getattr(runner, "program", None),
                                       getattr(runner, "scope", None))
        if self._lr_var is None or runner is None \
                or getattr(runner, "scope", None) is None:
            return
        v = runner.scope.find_var(self._lr_var)
        if v is not None:
            self.base_lr = _scalar(v)
            self._cur_lr = self.base_lr

    def _apply_lr(self, lr, runner):
        if self._lr_var is None or runner is None \
                or getattr(runner, "scope", None) is None:
            return
        old = runner.scope.find_var(self._lr_var)
        if isinstance(old, torch.Tensor):
            # the scope's own tensor, in place: a captured step reads it
            old.fill_(float(lr))
        else:
            runner.scope.set_var(self._lr_var,
                                 np.full([1], lr, dtype=np.float32))
        self._cur_lr = float(lr)
        monitor.registry().gauge(
            "elastic_lr", help="learning rate after elastic rescale "
                               "(includes the warmup ramp)").set(lr)

    def _apply_rescale(self, old_world, world, runner):
        policy = self.config.policy
        if self.base_lr is None:
            self._capture_base_lr(runner)
        base_world = self.base_world or old_world or world
        if self.base_lr is None or not base_world:
            return
        target = self.base_lr * policy.lr_scale(base_world, world)
        prev = self._cur_lr if self._cur_lr is not None else self.base_lr
        grew = old_world and world > old_world
        if grew and policy.warmup_steps > 0 and target != prev:
            # ramp from the pre-resize lr to the new target over
            # warmup_steps polls; the final value lands exactly on target
            n = policy.warmup_steps
            self._ramp = [prev + (target - prev) * (i + 1) / n
                          for i in range(n)]
            self._apply_lr(prev, runner)  # hold until the ramp starts
        else:
            self._ramp = []
            self._apply_lr(target, runner)

    # -------------------------------------------------------------- metrics
    def _record_membership_gauges(self):
        reg = monitor.registry()
        reg.gauge("elastic_epoch",
                  help="current membership epoch").set(self.epoch)
        reg.gauge("elastic_world_size",
                  help="live dp world size (membership count)"
                  ).set(self.world_size)


def fetch_status(endpoint, timeout=10.0):
    """Membership snapshot from a running master ("host:port") — the
    `python -m paddle_tpu_torch elastic status` CLI backend."""
    c = MasterClient(endpoint, connect_timeout=timeout)
    try:
        m = c.elastic_membership()
        return {"endpoint": endpoint, "epoch": int(m["epoch"]),
                "world_size": len(m["members"]),
                "members": dict(m["members"])}
    finally:
        c.close()
