"""paddle_tpu_torch.cache — the compile cache behind the Executor.

The JAX package's cache (paddle_tpu/cache/__init__.py), with the port's
counterpart of a compiled executable: a prepared step.

  L1  in-process OrderedDict of prepared steps, keyed by the Executor's
      (id(program), mutation, ...) tuple. True LRU: a hit moves the entry
      to the tail, the FLAGS_compile_cache_cap eviction pops the head — so
      a hot entry is never evicted to make room. An evicted entry is
      handed to `on_evict`, which drops what hangs off it: the Executor
      frees the entry's captured CUDA graphs, their static buffers and
      their private memory pools with it.

  L2  optional persistent store (FLAGS_compile_cache_dir, store.L2Store)
      of prepared plans, keyed by a process-stable content digest
      (keys.stable_digest). A plan is what the prepare computed from the
      program before any step ran: the program the fusion pass rewrote
      (Program.to_dict) and its FusionPlan's fields, as JSON. A process
      that misses L1 but hits L2 takes the plan instead of running the
      fusion pass (and the verification of its rewrite, when the entry
      was verified at the level asked for), then builds and captures the
      step as a miss does. A CUDA graph, a closure or a tensor is never
      stored. Absent entry = l2_miss; corrupt / version-stale /
      undecodable entry = l2_fallback (counted, prepared afresh — NEVER
      an exception to run()).

The Executor owns one CompileCache (kind "executor"; the one under a
ParallelExecutor has kind "parallel_executor"). Instance counters
(hits/misses/evictions + the l2_* family) always track and surface
through compile_cache_info(); monitor-registry counters also tick when
FLAGS_monitor is on. Not ported: the distributed compile service
(cache/service.py, over parallel.master: ROADMAP queue 1 item 8).
FLAGS_compile_service is defined, runs refuse it while it is set, and the
remote_* counters stay 0.
"""

from collections import OrderedDict

from .. import flags
from .keys import environment, is_digest, program_digest, stable_digest
from .store import L2Store

__all__ = ["CompileCache", "L2Store", "default_store", "environment",
           "is_digest", "program_digest", "stable_digest"]

flags.define(
    "compile_cache_cap", int, 0,
    "Maximum prepared steps per executor compile cache; 0 = unbounded. "
    "Past the cap the least-recently-used entry is evicted, with the CUDA "
    "graphs captured for it (their static buffers and memory pools are "
    "freed), and counted in monitor compile_cache_evictions_total — for "
    "workloads that churn feed shapes.")
flags.define(
    "compile_cache_dir", str, "",
    "Persistent compile-cache directory (the L2 behind the executor's "
    "in-memory cache): the prepared plan of a step (the program the "
    "fusion pass rewrote and its plan) is stored once and read by later "
    "processes, which skip the fusion pass and build and capture the "
    "step from it. Entries are invalidated by content digest (program, "
    "feed specs, amp/fusion/health/wire config, torch and CUDA versions, "
    "card). Empty: disabled.")
flags.define(
    "compile_cache_dir_max_mb", int, 2048,
    "Size cap for FLAGS_compile_cache_dir in MiB. After every store "
    "write the directory is pruned oldest-used-first (mtime LRU) down "
    "to the cap; <= 0 leaves it unbounded.")
flags.define(
    "compile_service", str, "",
    "Not ported: host:port of the JAX package's distributed compile "
    "service (cache/service.py over parallel.master, ROADMAP queue 1 "
    "item 8). Executor.run and ParallelExecutor.run raise "
    "NotImplementedError while it is set.")


def refuse_compile_service(who):
    """The NotImplementedError a run raises while FLAGS_compile_service is
    set."""
    if flags.get("compile_service"):
        raise NotImplementedError(
            f"{who}: FLAGS_compile_service (the distributed compile "
            f"service, ROADMAP queue 1 item 8) is not ported to "
            f"paddle_tpu_torch yet")


def default_store():
    """L2Store at FLAGS_compile_cache_dir, or None when the flag is empty
    (re-read per call: tests flip the flag at runtime)."""
    root = flags.get("compile_cache_dir")
    return L2Store(root) if root else None


def _l2_count(which, kind, n=1):
    """Registry counter compile_cache_l2_<which>_total{cache=kind}, gated
    on monitor.enabled() (the FLAGS_monitor=0 no-registry contract)."""
    from .. import monitor

    if monitor.enabled():
        monitor.cache_l2(kind, which, n)


class CompileCache:
    """One executor's compile cache: Mapping-like L1 LRU + optional L2.

    Keeps the raw-dict surface tests and tools read (len/iter/in/
    values/items/[]). `on_evict(key, entry)` is called for every entry
    the cap evicts."""

    def __init__(self, kind="executor", on_evict=None):
        self.kind = kind
        self.on_evict = on_evict
        self._entries = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.l2_hits = 0
        self.l2_misses = 0
        self.l2_fallbacks = 0
        self.l2_puts = 0
        self.l2_put_bytes = 0

    # -- L1 ------------------------------------------------------------
    def get(self, key, count_miss=True):
        """Counted LRU lookup: a hit refreshes the entry's recency. With
        count_miss=False a miss is left for the caller to count (the
        Executor counts only the prepares it keeps)."""
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
        elif count_miss:
            self.misses += 1
        return entry

    def put(self, key, entry, mon=None):
        """Insert at the recency tail, evicting least-recently-USED heads
        while FLAGS_compile_cache_cap bounds the cache."""
        cap = flags.get("compile_cache_cap")
        if cap and cap > 0:
            while len(self._entries) >= cap \
                    and key not in self._entries:
                old_key, old = self._entries.popitem(last=False)
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(old_key, old)
                from .. import monitor

                if monitor.enabled():
                    monitor.cache_evicted(self.kind)
                if mon is not None:
                    if mon.extra is None:
                        mon.extra = {}
                    mon.extra["cache_evictions"] = \
                        mon.extra.get("cache_evictions", 0) + 1
        self._entries[key] = entry
        self._entries.move_to_end(key)

    # read-only dict surface (external observers; no counter side effects)
    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return iter(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def __getitem__(self, key):
        return self._entries[key]

    def keys(self):
        return self._entries.keys()

    def values(self):
        return self._entries.values()

    def items(self):
        return self._entries.items()

    def clear(self):
        self._entries.clear()

    def info(self):
        """compile_cache_info() payload; "entries" key preserved (the
        serving engine diffs it across warmup)."""
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "l2": {
                "enabled": self.l2_enabled(),
                "dir": flags.get("compile_cache_dir") or None,
                "hits": self.l2_hits,
                "misses": self.l2_misses,
                "fallbacks": self.l2_fallbacks,
                "puts": self.l2_puts,
                "put_bytes": self.l2_put_bytes,
                "remote_hits": 0,
                "remote_misses": 0,
                "service": flags.get("compile_service") or None,
            },
        }

    # -- L2 ------------------------------------------------------------
    def l2_enabled(self):
        return bool(flags.get("compile_cache_dir"))

    def store(self):
        return default_store()

    def l2_digest(self, program, key_tail, extra=()):
        """Stable store key for one L1 key: its content tail (everything
        after the (id, mutation) head) + the executor kind + the caller's
        device context."""
        return stable_digest(
            program, key_tail,
            extra=(("kind", self.kind),) + tuple(extra))

    def l2_load(self, digest, decode, mon=None):
        """(decode(payload), the entry's meta) for a stored entry, or None
        on a miss or a fallback (corrupt / version-stale / undecodable
        entry) — counted, never raised."""
        store = self.store()
        if store is None or digest is None:
            return None
        outcome, payload, header = store.get(digest)
        if outcome == "miss":
            self.l2_misses += 1
            _l2_count("misses", self.kind)
            return None
        if outcome != "hit":
            self.count_l2_fallback(mon, reason=outcome)
            return None
        try:
            value = decode(payload)
        except Exception:
            # an entry that passed the checksum but does not decode into a
            # plan (another layout, a program this build cannot read): the
            # reference's deserialize fallback — prepare afresh
            self.count_l2_fallback(mon, reason="decode")
            return None
        self.l2_hits += 1
        _l2_count("hits", self.kind)
        return value, header.get("meta") or {}

    def count_l2_fallback(self, mon=None, reason=None):
        self.l2_fallbacks += 1
        _l2_count("fallbacks", self.kind)
        if mon is not None:
            if mon.extra is None:
                mon.extra = {}
            mon.extra["cache_l2_fallback"] = reason or "fallback"

    def l2_put(self, digest, payload, meta=None):
        """Commit one entry (the counterpart of the JAX package's
        aot_sink, called once after a prepare that missed L2); returns the
        bytes written. A failed write raises."""
        store = self.store()
        max_mb = int(flags.get("compile_cache_dir_max_mb"))
        nbytes = store.put(
            digest, payload, kind=self.kind, meta=meta,
            max_bytes=max_mb * (1 << 20) if max_mb > 0 else None)
        self.l2_puts += 1
        self.l2_put_bytes += nbytes
        _l2_count("puts", self.kind)
        _l2_count("put_bytes", self.kind, nbytes)
        return nbytes
