"""Elastic-training coordination service: task-lease master + discovery.

Reference parity: go/master/service.go (task queues :89 Todo/Pending/Done/
Failed, lease timeout + failure cap :341 processFailedTask, GetTask :373,
TaskFinished :411 with pass rollover, snapshot :207) and the etcd
registration in go/pserver/etcd_client.go:67 (here: a TTL'd in-master
registry, since the zero-dependency equivalent of etcd for this runtime is
the master itself); the JAX package's paddle_tpu/parallel/master.py.

The master hands out *tasks* (groups of data chunks) under a lease: a
trainer that dies mid-task simply never reports, the lease times out, and
the task is re-dispatched to a live trainer — up to `failure_max` times,
after which the task is discarded to `failed`. When todo and pending drain,
the pass counter advances and done+failed recycle as the next pass's todo.
Every mutation snapshots state to disk so a restarted master resumes the
pass where it died (reference snapshots to etcd; here a file, CRC-guarded).

Transport: the length-prefixed pickle framing of the variable runtime
(parallel/rpc.py: `_send_msg` / `_recv_msg`), whose bytes are the JAX
package's, so a port client talks to a JAX master and the reverse. This
is control-plane traffic, orders of magnitude off the data path.

Elastic membership (parallel/elastic.py rides on this): trainers join a
TTL'd membership set; every join/leave — explicit, connection close, or
heartbeat lapse — bumps a monotonically increasing *membership epoch*.
Heartbeats are generation-fenced: a beat carrying a stale epoch tells the
worker a resize is pending, and a beat from a lapsed (already-reaped)
member is refused outright — the worker must re-JOIN, which lands it in a
strictly newer epoch, so a zombie can never resurrect the epoch the
survivors already resized away from. The resize barrier releases when
every member of the target epoch has arrived; if membership moves while
the barrier forms (concurrent leave+join), waiters are told to restart
against the new epoch instead of deadlocking on a set that no longer
exists. The serving fleet's membership (serve/fleet/membership.py) holds a
`MembershipTable` directly, and its replicas register in the discovery
registry through a `Heartbeater`.

The distributed compile service (cache/service.py rides on this) keeps
the port's L2 entries (prepared plans as JSON, framed by cache/store.py)
by content digest, with single-flight compile leases.
"""

import socket
import threading
import time

from . import rpc as _rpc

__all__ = ["Task", "MembershipTable", "MasterService", "MasterClient",
           "Heartbeater", "task_iterator", "PassAfter", "PassBefore",
           "NoMoreAvailable", "AllTasksFailed"]


class PassBefore(RuntimeError):
    """Client is on an earlier pass than the master (drop to next pass)."""


class PassAfter(RuntimeError):
    """Client ran ahead of the master; wait for the pass to roll over."""


class NoMoreAvailable(RuntimeError):
    """No todo tasks right now (others still pending); retry shortly."""


class AllTasksFailed(RuntimeError):
    """Every task of the pass hit the failure cap."""


_ERRS = {"pass_before": PassBefore, "pass_after": PassAfter,
         "no_more": NoMoreAvailable, "all_failed": AllTasksFailed}


class Task:
    """reference service.go:62 TaskMeta+Task: id, epoch (lease generation),
    payload chunks (opaque to the master)."""

    def __init__(self, task_id, chunks):
        self.id = task_id
        self.epoch = 0
        self.num_failure = 0
        self.chunks = list(chunks)

    def __repr__(self):
        return f"Task(id={self.id}, epoch={self.epoch}, chunks={len(self.chunks)})"


def _partition(chunks, chunks_per_task):
    """reference partition():105 — group chunks into tasks of
    chunks_per_task, ids dense from 0 (the reference's nanosecond+rand id
    dance is a workaround it itself FIXMEs; dense ids snapshot cleanly)."""
    chunks_per_task = max(1, int(chunks_per_task))
    tasks = []
    for i in range(0, len(chunks), chunks_per_task):
        tasks.append(Task(len(tasks), chunks[i:i + chunks_per_task]))
    return tasks


class MembershipTable:
    """THE TTL'd, epoch-fenced membership primitive.

    One implementation serves both control planes: the elastic trainer
    mesh (MasterService wraps it in RPC ops) and the serving fleet
    (serve/fleet/membership.py holds one directly). The contract:

    - every join/leave/TTL-lapse bumps a monotonically increasing
      *membership epoch* — a lapse IS a leave, not a soft mark;
    - heartbeats are generation-fenced: a beat from a lapsed (already
      reaped) member is refused (``known=False``) — the member must
      re-JOIN, which lands it in a strictly NEWER epoch, so a zombie can
      never resurrect the epoch the survivors already moved away from;
    - leaves are owner-guarded: a stale connection's teardown cannot
      evict a member that already re-joined under a different owner.

    Not synchronized — the embedding service holds its own lock around
    every call (MasterService its condition variable, fleet Membership
    its mutex). ``on_change`` fires under that lock on every epoch bump
    so the embedder can invalidate forming barriers / update gauges.
    """

    def __init__(self, clock=time.monotonic, on_change=None):
        self._clock = clock
        self.on_change = on_change
        self.members = {}  # name -> {"addr", "expire", "ttl", "owner"}
        self.epoch = 0

    def _bump(self):
        self.epoch += 1
        if self.on_change is not None:
            self.on_change()

    def reap(self, now=None):
        """TTL lapse IS a leave: reaping bumps the epoch so survivors
        resize. Returns the reaped names."""
        now = self._clock() if now is None else now
        dead = [n for n, m in self.members.items() if m["expire"] <= now]
        for n in dead:
            del self.members[n]
        if dead:
            self._bump()
        return dead

    def join(self, name, addr="", ttl=10.0, owner=None):
        """(Re-)join under a fresh lease; always lands in a new epoch."""
        self.reap()
        self.members[name] = {"addr": str(addr),
                              "expire": self._clock() + float(ttl),
                              "ttl": float(ttl), "owner": owner}
        self._bump()
        return self.epoch

    def leave(self, name, owner=None):
        """Explicit departure. With `owner` set, only evicts a membership
        the same owner created (stale-socket teardown guard). Returns
        whether anything was evicted."""
        m = self.members.get(name)
        if m is not None and (owner is None or m["owner"] is None
                              or m["owner"] == owner):
            del self.members[name]
            self._bump()
            return True
        return False

    def heartbeat(self, name, epoch):
        """Generation-fenced liveness. known=False means the member
        lapsed (or never joined): refreshing its TTL here would resurrect
        a stale epoch — it must re-join instead. ``stale`` tells a live
        member its view of the epoch is behind (a resize is pending)."""
        self.reap()
        m = self.members.get(name)
        if m is None:
            return {"known": False, "epoch": self.epoch}
        m["expire"] = self._clock() + m["ttl"]
        return {"known": True, "epoch": self.epoch,
                "stale": int(epoch) != self.epoch}

    def refresh(self, name):
        """Renew one member's lease without the epoch fence (used where
        presence was already established under the embedder's lock)."""
        m = self.members.get(name)
        if m is not None:
            m["expire"] = self._clock() + m["ttl"]

    def get(self, name):
        return self.members.get(name)

    def addrs(self):
        return {n: m["addr"] for n, m in self.members.items()}

    def __contains__(self, name):
        return name in self.members

    def __len__(self):
        return len(self.members)


class MasterService:
    """In-process task-lease service; serve() exposes it over TCP."""

    def __init__(self, chunks_per_task=1, lease_timeout=3.0, failure_max=3,
                 snapshot_path=None, snapshot_every=32):
        self.chunks_per_task = chunks_per_task
        self.lease_timeout = float(lease_timeout)
        self.failure_max = int(failure_max)
        self.snapshot_path = snapshot_path
        # batch snapshots: a full-state pickle per dispatch is O(dataset)
        # under the lock; recover() requeues pending leases anyway, so a
        # slightly stale snapshot only replays a few reports
        self.snapshot_every = max(1, int(snapshot_every))
        self._mutations = 0
        self._mu = threading.Condition()
        self.todo = []
        self.pending = {}   # task_id -> (task, deadline)
        self.done = []
        self.failed = []
        self.cur_pass = 0
        self._registry = {}  # (kind, name) -> (addr, expire_time)
        # elastic membership: the shared TTL'd epoch-fenced table (owner =
        # the serving connection that joined a member, so a stale
        # connection's teardown can't evict a member that already
        # re-joined over a fresh socket). Epoch bumps invalidate any
        # barrier forming against an older epoch, under self._mu.
        self._table = MembershipTable(on_change=self._membership_moved)
        self._barrier_arrived = {}  # (epoch, phase) -> set(names)
        self._barrier_release = {}  # (epoch, phase) -> sorted member list
        # distributed compile service: first-misser prepares, peers fetch
        # the PTAC1 entry (a prepared plan) by content digest
        # (single-flight leases dedup N simultaneous missers down to ONE
        # prepare)
        self._compiled = {}        # digest -> whole-file PTAC1 blob
        self._compile_leases = {}  # digest -> lease expire time
        self._compile_counts = {"puts": 0, "duplicate_puts": 0, "gets": 0,
                                "hits": 0, "waits": 0, "leases": 0,
                                "lease_rejects": 0, "expired_leases": 0}
        self._stop = False
        self._init_done = False
        self._conns = set()  # accepted sockets, closed on stop()
        self._checker = threading.Thread(target=self._timeout_loop,
                                         daemon=True)
        self._checker.start()

    # ---------------------------------------------------------------- state
    def set_dataset(self, chunks):
        """reference SetDataset:281 — idempotent after first success."""
        with self._mu:
            if self._init_done:
                return
            self.todo = _partition(chunks, self.chunks_per_task)
            self._init_done = True
            self._snapshot_locked(force=True)

    def _snapshot_locked(self, force=False):
        """reference snapshot():207 — persist queues + pass counter.
        Unforced calls batch by mutation count; pass boundaries, dataset
        init, and stop() force a write."""
        if not self.snapshot_path:
            return
        self._mutations += 1
        if not force and self._mutations % self.snapshot_every != 0:
            return
        state = {"todo": self.todo, "pending": self.pending,
                 "done": self.done, "failed": self.failed,
                 "cur_pass": self.cur_pass, "init_done": self._init_done}
        _rpc.dump_crc_blob(self.snapshot_path, state)

    @classmethod
    def recover(cls, snapshot_path, **kwargs):
        """Restart from a snapshot: pending leases are conservatively
        requeued (their holders may have died with the master; reference
        recover() reloads state and lets timeouts sort it out — with the
        AfterFunc timers lost, requeueing is the correct translation)."""
        state = _rpc.load_crc_blob(snapshot_path)
        svc = cls(snapshot_path=snapshot_path, **kwargs)
        with svc._mu:
            svc.todo = state["todo"] + [t for t, _ in
                                        state["pending"].values()]
            svc.done = state["done"]
            svc.failed = state["failed"]
            svc.cur_pass = state["cur_pass"]
            svc._init_done = state["init_done"]
        return svc

    # ---------------------------------------------------------------- tasks
    def get_task(self, pass_id):
        """reference GetTask:373."""
        with self._mu:
            if not self._init_done:
                raise NoMoreAvailable("dataset not set yet")
            if pass_id < self.cur_pass:
                raise PassBefore(f"client pass {pass_id} < {self.cur_pass}")
            if pass_id > self.cur_pass:
                raise PassAfter(f"client pass {pass_id} > {self.cur_pass}")
            if not self.todo:
                if not self.done and not self.pending:
                    raise AllTasksFailed("all tasks of this pass failed")
                raise NoMoreAvailable("no todo tasks (others pending)")
            t = self.todo.pop(0)
            t.epoch += 1
            self.pending[t.id] = (t, time.monotonic() + self.lease_timeout)
            self._snapshot_locked()
            return t

    def task_finished(self, task_id):
        """reference TaskFinished:411 (incl. pass rollover)."""
        with self._mu:
            entry = self.pending.pop(task_id, None)
            if entry is None:
                return  # late report after timeout requeue: ignore
            t, _ = entry
            t.num_failure = 0
            self.done.append(t)
            self._maybe_rollover_locked()
            self._snapshot_locked()

    def _maybe_rollover_locked(self):
        """Advance the pass when todo+pending drain. Must ALSO run on the
        failure paths: if the pass's last outstanding task hits the failure
        cap, waiting for a task_finished that can never come would livelock
        every trainer in NoMoreAvailable. (The reference only checks in
        TaskFinished — its own 'deal with failed tasks' TODO.) A pass with
        zero successes stays put so get_task raises AllTasksFailed."""
        if not self.todo and not self.pending and self.done:
            self.cur_pass += 1
            self.todo = self.done + self.failed
            for t2 in self.todo:
                t2.num_failure = 0
            self.done, self.failed = [], []
            self._mu.notify_all()
            self._snapshot_locked(force=True)

    def task_failed(self, task_id, epoch):
        """reference TaskFailed:454."""
        with self._mu:
            entry = self.pending.get(task_id)
            if entry is None:
                return
            self._process_failed_locked(task_id, epoch)
            self._maybe_rollover_locked()
            self._snapshot_locked()

    def _process_failed_locked(self, task_id, epoch):
        """reference processFailedTask:341."""
        t, _ = self.pending[task_id]
        if t.epoch != epoch:
            return  # stale report from a previous lease
        del self.pending[task_id]
        t.num_failure += 1
        if t.num_failure > self.failure_max:
            self.failed.append(t)
        else:
            self.todo.append(t)

    def _timeout_loop(self):
        """Lease reaper (reference time.AfterFunc per dispatch; a scan
        thread is equivalent and survives recover())."""
        while not self._stop:
            time.sleep(min(0.1, self.lease_timeout / 4))
            now = time.monotonic()
            with self._mu:
                expired = [(tid, t.epoch)
                           for tid, (t, dl) in self.pending.items()
                           if dl <= now]
                for tid, epoch in expired:
                    self._process_failed_locked(tid, epoch)
                if expired:
                    self._maybe_rollover_locked()
                    self._snapshot_locked()
                # registry TTL expiry
                dead = [k for k, (_, exp) in self._registry.items()
                        if exp <= now]
                for k in dead:
                    del self._registry[k]
                # elastic membership TTL expiry (heartbeat lapse -> the
                # survivors get a new epoch and resize)
                self._table.reap(now)
                # single-flight compile leases whose holder died: wake
                # blocked fetchers so one of them re-takes the lease and
                # compiles instead of waiting on a corpse
                lapsed = [d for d, exp in self._compile_leases.items()
                          if exp <= now]
                for d in lapsed:
                    del self._compile_leases[d]
                if lapsed:
                    self._compile_counts["expired_leases"] += len(lapsed)
                    self._mu.notify_all()

    def counts(self):
        with self._mu:
            return {"todo": len(self.todo), "pending": len(self.pending),
                    "done": len(self.done), "failed": len(self.failed),
                    "cur_pass": self.cur_pass}

    # ------------------------------------------------------------ discovery
    def register(self, kind, name, addr, ttl=10.0):
        """reference etcd_client.go:67 Register — TTL'd; heartbeat by
        re-registering."""
        with self._mu:
            self._registry[(kind, name)] = (addr, time.monotonic() + ttl)

    def lookup(self, kind):
        with self._mu:
            now = time.monotonic()
            return {name: addr for (k, name), (addr, exp)
                    in self._registry.items() if k == kind and exp > now}

    # ----------------------------------------------------------- membership
    def _membership_moved(self):
        """MembershipTable on_change hook (fires under self._mu): every
        epoch bump invalidates any barrier forming against an older epoch
        (its waiters restart) and wakes everyone parked on the lock."""
        epoch = self._table.epoch
        for key in [k for k in self._barrier_arrived if k[0] != epoch]:
            del self._barrier_arrived[key]
        for key in [k for k in self._barrier_release if k[0] < epoch - 1]:
            del self._barrier_release[key]
        self._mu.notify_all()

    def elastic_join(self, name, addr="", ttl=10.0, _owner=None):
        with self._mu:
            self._table.join(name, addr, ttl, owner=_owner)
            return {"epoch": self._table.epoch,
                    "members": self._table.addrs()}

    def elastic_leave(self, name, _owner=None):
        """Explicit departure (SIGTERM-drain). With _owner set, only
        evicts a membership this connection created — a dead socket's
        teardown must not take down the re-joined incarnation."""
        with self._mu:
            self._table.leave(name, owner=_owner)
            return {"epoch": self._table.epoch}

    def elastic_heartbeat(self, name, epoch):
        """Generation-fenced liveness. known=False means the member lapsed
        (or never joined): the TTL reaper already resized the survivors
        away from it, so refreshing the TTL here would resurrect a stale
        epoch — the worker must re-join instead."""
        with self._mu:
            return self._table.heartbeat(name, epoch)

    def elastic_membership(self):
        with self._mu:
            self._table.reap()
            return {"epoch": self._table.epoch,
                    "members": self._table.addrs()}

    def elastic_barrier(self, name, epoch, phase="resize", timeout=30.0):
        """Block until every member of `epoch` arrived at (epoch, phase).

        Returns {"ok": True, "members": [...], "rank": i} on release.
        If membership moves while the barrier forms (a waiter's TTL
        lapses, a worker joins, a socket dies) the epoch advances and
        every waiter gets {"restart": True, "epoch": new} — the
        controller re-syncs and re-arrives instead of deadlocking on a
        membership set that no longer exists. Waiting at the barrier IS
        liveness: each wakeup refreshes the waiter's TTL, so a slow
        straggler elsewhere can't expire the workers already parked here.
        """
        epoch = int(epoch)
        deadline = time.monotonic() + float(timeout)
        with self._mu:
            while True:
                now = time.monotonic()
                self._table.reap(now)
                if self._table.epoch != epoch:
                    return {"ok": False, "restart": True,
                            "epoch": self._table.epoch}
                if name not in self._table:
                    return {"ok": False, "restart": True, "unknown": True,
                            "epoch": self._table.epoch}
                self._table.refresh(name)
                key = (epoch, phase)
                self._barrier_arrived.setdefault(key, set()).add(name)
                members = self._barrier_release.get(key)
                if members is None and self._barrier_arrived[key] \
                        >= set(self._table.members):
                    members = sorted(self._table.members)
                    self._barrier_release[key] = members
                    self._mu.notify_all()
                if members is not None:
                    return {"ok": True, "epoch": epoch, "phase": phase,
                            "members": members,
                            "rank": members.index(name)}
                if now >= deadline:
                    return {"ok": False, "timeout": True,
                            "epoch": self._table.epoch,
                            "waiting_for": sorted(
                                set(self._table.members)
                                - self._barrier_arrived.get(key, set()))}
                self._mu.wait(min(0.05, max(0.001, deadline - now)))

    # ------------------------------------------------- distributed compile
    # fetch_compiled service: the first replica to miss a digest takes a
    # single-flight lease and prepares; everyone else blocks on
    # compiled_get until the winner publishes the PTAC1 entry.
    # Blobs are opaque whole-file bytes here — the fetching replica's
    # L2Store re-validates magic/digest/payload checksum before commit,
    # so a corrupt publish can never poison a peer's cache.

    @staticmethod
    def _check_digest(digest):
        from ..cache.keys import is_digest

        if not is_digest(digest):
            raise _rpc.RpcError(f"malformed compile digest {digest!r}")
        return digest

    def compiled_put(self, digest, blob):
        """Publish a compiled blob under its content digest and release
        the single-flight lease; wakes every fetcher parked on it."""
        digest, blob = self._check_digest(digest), bytes(blob)
        with self._mu:
            dup = digest in self._compiled
            self._compiled[digest] = blob
            self._compile_leases.pop(digest, None)
            self._compile_counts["puts"] += 1
            if dup:
                self._compile_counts["duplicate_puts"] += 1
            self._mu.notify_all()
            return {"stored": True, "bytes": len(blob), "duplicate": dup}

    def compiled_get(self, digest, wait_s=0.0):
        """Fetch a blob by digest; with wait_s > 0, park until the
        leaseholder publishes it (or the wait times out -> None)."""
        digest = self._check_digest(digest)
        deadline = time.monotonic() + float(wait_s)
        with self._mu:
            self._compile_counts["gets"] += 1
            waited = False
            while True:
                blob = self._compiled.get(digest)
                if blob is not None:
                    self._compile_counts["hits"] += 1
                    if waited:
                        self._compile_counts["waits"] += 1
                    return blob
                now = time.monotonic()
                if now >= deadline:
                    return None
                waited = True
                self._mu.wait(min(0.05, max(0.001, deadline - now)))

    def compiled_lease(self, digest, ttl=120.0):
        """Single-flight compile dedup: grant at most one live lease per
        digest. granted=True means the caller compiles (and must
        compiled_put, or the lease expires and a waiter re-leases);
        granted=False means someone else is on it (or it's cached)."""
        digest = self._check_digest(digest)
        with self._mu:
            if digest in self._compiled:
                return {"granted": False, "cached": True}
            now = time.monotonic()
            exp = self._compile_leases.get(digest)
            if exp is not None and exp > now:
                self._compile_counts["lease_rejects"] += 1
                return {"granted": False, "cached": False}
            self._compile_leases[digest] = now + float(ttl)
            self._compile_counts["leases"] += 1
            return {"granted": True, "cached": False}

    def compiled_stats(self):
        with self._mu:
            return dict(self._compile_counts,
                        entries=len(self._compiled),
                        bytes=sum(len(b)
                                  for b in self._compiled.values()),
                        active_leases=len(self._compile_leases))

    # -------------------------------------------------------------- serving
    def serve(self, bind="127.0.0.1:0"):
        host, port = bind.rsplit(":", 1)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(32)
        self.port = self._listener.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        # fleet observability: push the master's registry (lease/member
        # gauges) to a collector when FLAGS_obs_push is set; no-op else
        from ..obs import maybe_start as _obs_start

        self._obs_client = _obs_start("master")
        return self.port

    def stop(self):
        self._stop = True
        obs_client = getattr(self, "_obs_client", None)
        if obs_client is not None:
            self._obs_client = None
            obs_client.stop()
        with self._mu:
            self._snapshot_locked(force=True)
        try:
            self._listener.close()
        except (AttributeError, OSError):
            pass
        # also drop live connections: a stopped master must go silent, not
        # keep answering RPCs on old sockets (clients reconnect-with-retry
        # to the replacement; see MasterClient._call)
        with self._mu:
            conns, self._conns = set(self._conns), set()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stop:
            try:
                self._listener.settimeout(0.2)
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._mu:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        # leases granted over THIS connection and not yet reported back.
        # A trainer that dies mid-task takes its socket with it: requeue
        # its outstanding leases on disconnect instead of leaking them
        # until the lease timeout stalls the whole pass on one dead peer.
        held = {}  # task_id -> epoch as granted here
        joined = set()  # member names elastic_join'd over THIS connection
        owner = id(conn)
        try:
            while True:
                msg = _rpc._recv_msg(conn)
                op, args = msg[0], msg[1:]
                try:
                    if op == "set_dataset":
                        self.set_dataset(args[0])
                        reply = ("ok", None)
                    elif op == "get_task":
                        t = self.get_task(args[0])
                        held[t.id] = t.epoch
                        reply = ("ok", (t.id, t.epoch, t.chunks))
                    elif op == "task_finished":
                        self.task_finished(args[0])
                        held.pop(args[0], None)
                        reply = ("ok", None)
                    elif op == "task_failed":
                        self.task_failed(args[0], args[1])
                        held.pop(args[0], None)
                        reply = ("ok", None)
                    elif op == "register":
                        self.register(*args)
                        reply = ("ok", None)
                    elif op == "lookup":
                        reply = ("ok", self.lookup(args[0]))
                    elif op == "elastic_join":
                        joined.add(args[0])
                        reply = ("ok", self.elastic_join(*args,
                                                         _owner=owner))
                    elif op == "elastic_leave":
                        joined.discard(args[0])
                        reply = ("ok", self.elastic_leave(args[0],
                                                          _owner=owner))
                    elif op == "elastic_heartbeat":
                        reply = ("ok", self.elastic_heartbeat(*args))
                    elif op == "elastic_membership":
                        reply = ("ok", self.elastic_membership())
                    elif op == "elastic_barrier":
                        reply = ("ok", self.elastic_barrier(*args))
                    elif op == "compiled_put":
                        reply = ("ok", self.compiled_put(*args))
                    elif op == "compiled_get":
                        reply = ("ok", self.compiled_get(*args))
                    elif op == "compiled_lease":
                        reply = ("ok", self.compiled_lease(*args))
                    elif op == "compiled_stats":
                        reply = ("ok", self.compiled_stats())
                    elif op == "counts":
                        reply = ("ok", self.counts())
                    elif op == "exit":
                        self.stop()
                        return
                    else:
                        reply = ("err", f"unknown op {op!r}")
                except tuple(_ERRS.values()) as e:
                    key = next(k for k, cls in _ERRS.items()
                               if isinstance(e, cls))
                    reply = ("taskerr", key, str(e))
                except _rpc.RpcError as e:
                    # a bad argument (e.g. malformed compile digest)
                    # rejects the op, not the connection
                    reply = ("err", str(e))
                _rpc._send_msg(conn, reply)
        except (ConnectionError, EOFError, OSError):
            return
        finally:
            with self._mu:
                self._conns.discard(conn)
                # reclaim this connection's outstanding leases now; the
                # epoch guard in _process_failed_locked drops entries a
                # reconnected client already re-leased under a new epoch
                requeued = False
                for tid, epoch in held.items():
                    if tid in self.pending:
                        self._process_failed_locked(tid, epoch)
                        requeued = True
                if requeued:
                    self._maybe_rollover_locked()
                    self._snapshot_locked()
            # a trainer that dies takes its socket with it: its membership
            # leaves NOW (survivors resize immediately) instead of waiting
            # out the TTL. The owner guard keeps this teardown from
            # evicting a member that already re-joined over a new socket.
            for name in joined:
                self.elastic_leave(name, _owner=owner)
            try:
                conn.close()
            except OSError:
                pass


class MasterClient:
    """reference go/master/client.go + python v2 master client.

    Transport faults (connection reset, broken pipe, a master restart)
    are retried with exponential backoff: the socket is dropped and a
    fresh connection dialed per attempt, so a trainer rides out a master
    restart instead of dying on the first hiccup (the reference client
    re-dials through its etcd watch the same way). Retried get_task calls
    are at-least-once — a lease the master granted just before the
    connection died is simply reclaimed by the lease timeout.
    """

    def __init__(self, endpoint, connect_timeout=30.0, retry=None):
        self._endpoint = endpoint
        self._connect_timeout = float(connect_timeout)
        self._lock = threading.Lock()
        self._sock = None
        self._closed = False
        if retry is None:
            from ..resilience.retry import RetryPolicy

            retry = RetryPolicy(kind="master_client")
        self._retry = retry
        with self._lock:
            self._connect_locked()  # fail fast when the master is absent

    def _connect_locked(self):
        self._sock = _rpc.dial(self._endpoint, self._connect_timeout)

    def _drop_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, *msg):
        from ..resilience.errors import TransientError

        def attempt():
            with self._lock:
                # checked under the lock EVERY attempt: close() may land
                # while the retry policy sleeps between attempts (outside
                # the lock), and a post-close attempt must not re-dial —
                # that socket would leak with nobody left to close it.
                # RpcError is not transient, so the retry loop stops here.
                if self._closed:
                    raise _rpc.RpcError(
                        f"master client for {self._endpoint} is closed")
                try:
                    if self._sock is None:
                        self._connect_locked()
                    _rpc._send_msg(self._sock, msg)
                    resp = _rpc._recv_msg(self._sock)
                except (ConnectionError, EOFError, socket.timeout,
                        OSError) as e:
                    self._drop_locked()  # next attempt re-dials
                    raise TransientError(
                        f"master rpc {msg[0]!r} to {self._endpoint} "
                        f"failed: {e}") from e
            if resp[0] == "taskerr":
                raise _ERRS[resp[1]](resp[2])
            if resp[0] != "ok":
                raise _rpc.RpcError(str(resp[1:]))
            return resp[1]

        return self._retry.call(attempt)

    def set_dataset(self, chunks):
        return self._call("set_dataset", list(chunks))

    def get_task(self, pass_id):
        tid, epoch, chunks = self._call("get_task", pass_id)
        t = Task(tid, chunks)
        t.epoch = epoch
        return t

    def task_finished(self, task_id):
        return self._call("task_finished", task_id)

    def task_failed(self, task_id, epoch):
        return self._call("task_failed", task_id, epoch)

    def register(self, kind, name, addr, ttl=10.0):
        return self._call("register", kind, name, addr, ttl)

    def lookup(self, kind):
        return self._call("lookup", kind)

    # elastic membership (see parallel/elastic.py for the controller that
    # drives these around a training step loop)
    def elastic_join(self, name, addr="", ttl=10.0):
        return self._call("elastic_join", name, addr, ttl)

    def elastic_leave(self, name):
        return self._call("elastic_leave", name)

    def elastic_heartbeat(self, name, epoch):
        return self._call("elastic_heartbeat", name, epoch)

    def elastic_membership(self):
        return self._call("elastic_membership")

    def elastic_barrier(self, name, epoch, phase="resize", timeout=30.0):
        return self._call("elastic_barrier", name, epoch, phase, timeout)

    # distributed compile service (see cache/service.py for the client
    # that rides these from the executors' L2-miss path)
    def compiled_put(self, digest, blob):
        return self._call("compiled_put", digest, blob)

    def compiled_get(self, digest, wait_s=0.0):
        return self._call("compiled_get", digest, wait_s)

    def compiled_lease(self, digest, ttl=120.0):
        return self._call("compiled_lease", digest, ttl)

    def compiled_stats(self):
        return self._call("compiled_stats")

    def counts(self):
        return self._call("counts")

    def close(self):
        """Disconnect THIS client; the master keeps serving other trainers
        (a departing trainer must never take the coordination service — and
        every live lease reaper — down with it). Terminal: a concurrent
        _call riding a reconnect-retry loop stops at its next attempt
        instead of re-dialing a socket nobody would ever close."""
        with self._lock:
            self._closed = True
            self._drop_locked()

    def shutdown_service(self):
        """Stop the master service itself (job teardown)."""
        with self._lock:
            self._closed = True
            try:
                if self._sock is None:
                    self._connect_locked()
                _rpc._send_msg(self._sock, ("exit",))
            except OSError:
                pass
            self._drop_locked()


class Heartbeater:
    """Background TTL re-registration against the master's discovery
    registry (reference etcd_client.go keepalive lease): a serving-fleet
    replica registers (kind, name, addr) and re-registers every ttl/3 so
    the entry outlives hiccups but expires ~one ttl after the process
    dies — which is exactly how the fleet router's discovery loop learns
    about replica death without the replica saying goodbye. Registration
    faults are swallowed (the retry policy inside MasterClient already
    rode out what it could; a missed beat just shortens the lease)."""

    def __init__(self, client, kind, name, addr, ttl=10.0, interval=None):
        self.client = client
        self._kind = kind
        self._name = name
        self._addr = addr
        self._ttl = float(ttl)
        self._interval = (self._ttl / 3.0 if interval is None
                          else float(interval))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"heartbeat-{name}",
                                        daemon=True)
        self.beats = 0

    def start(self):
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.client.register(self._kind, self._name, self._addr,
                                     ttl=self._ttl)
                self.beats += 1
            except Exception:  # noqa: BLE001 — a missed beat is not fatal
                pass
            self._stop.wait(self._interval)

    def stop(self, join=True):
        self._stop.set()
        if join and self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def close(self):
        """One-call teardown: stop the beat loop, then disconnect the
        underlying MasterClient. client.close() is terminal, so a beat
        caught mid-reconnect stops at its next attempt instead of
        re-dialing; the master itself keeps serving other trainers."""
        self.stop()
        self.client.close()


def task_iterator(client, pass_id, poll_interval=0.1, max_wait=60.0):
    """Generator a trainer drives one pass with: lease tasks, yield their
    chunks, report finished; ends when the master rolls to the next pass
    (the python v2 master reader-creator equivalent). On an exception inside
    the consumer the task is reported failed, not finished."""
    deadline = time.monotonic() + max_wait
    while True:
        try:
            task = client.get_task(pass_id)
        except (PassBefore, AllTasksFailed):
            return
        except (NoMoreAvailable, PassAfter):
            if time.monotonic() > deadline:
                raise
            time.sleep(poll_interval)
            continue
        deadline = time.monotonic() + max_wait
        try:
            for chunk in task.chunks:
                yield chunk
        except BaseException:
            client.task_failed(task.id, task.epoch)
            raise
        client.task_finished(task.id)
