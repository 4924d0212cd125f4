"""Elastic-training coordination: the TTL'd, epoch-fenced membership
table.

The JAX package's parallel/master.py is the elastic master: a task-lease
service over TCP (MasterService, MasterClient, Heartbeater) around one
membership primitive, `MembershipTable`. The port holds only the table,
which the serving fleet's membership rides on
(serve/fleet/membership.py). The master service, its client and the
heartbeater come with the rest of the distributed stack (ROADMAP queue 1
item 8).

Elastic membership: members join a TTL'd membership set; every
join/leave — explicit or a heartbeat lapse — bumps a monotonically
increasing *membership epoch*. Heartbeats are generation-fenced: a beat
from a lapsed (already-reaped) member is refused outright — it must
re-JOIN, which lands it in a strictly newer epoch, so a zombie can never
resurrect the epoch the survivors already moved away from.

A copy of the JAX package's paddle_tpu/parallel/master.py::MembershipTable.
"""

import time

__all__ = ["MembershipTable"]


class MembershipTable:
    """THE TTL'd, epoch-fenced membership primitive.

    One implementation serves both control planes: the elastic trainer
    mesh (the JAX package's MasterService wraps it in RPC ops) and the
    serving fleet
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
    every call (the master its condition variable, fleet Membership its
    mutex). ``on_change`` fires under that lock on every epoch bump
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
