"""Distributed compile service client (the fetch_compiled RPC).

The service itself lives on the elastic master (parallel/master.py
``compiled_put`` / ``compiled_get`` / ``compiled_lease``): an in-memory
blob table keyed by the L2 content digest, plus single-flight compile
leases. This module is the executor-side client, wired into
CompileCache.l2_load's miss path (cache/__init__.py):

    L2 miss -> fetch_blob(digest, wait=0)        peer already prepared?
            -> try_lease(digest)                 no: race for the lease
               granted      -> prepare HERE; l2_put publishes the entry
               not granted  -> fetch_blob(digest, wait=WAIT_S)
                               (park until the leaseholder publishes;
                                a dead leaseholder's lease expires and
                                the master wakes us to return None —
                                we then prepare ourselves)

The wire payload is the WHOLE PTAC1 file (store.py format: magic + JSON
header + the prepared plan's JSON), so the fetching side commits it
through L2Store.put_blob, which re-validates framing, digest binding and
the payload checksum before the atomic replace — a corrupt publish
cannot poison a peer's cache, it just falls back to a local prepare.
The JAX package's service client (paddle_tpu/cache/service.py), whose
blobs are serialized executables; the protocol is the same.

Every transport fault degrades to "prepare locally": the service is a
spin-up accelerator, never a correctness dependency (the JAX package's
contract, kept as it is). The client is a
module singleton (one TCP connection per process, re-dialed when
FLAGS_compile_service changes) and is intentionally fail-fast — two
quick attempts, not the trainer plane's patient reconnect loop, because
the fallback (preparing) is always available.
"""

import threading

from .. import flags
from .keys import is_digest

__all__ = ["enabled", "fetch_blob", "offer_blob", "try_lease", "reset",
           "service_stats", "WAIT_S", "LEASE_TTL_S"]

flags.define(
    "compile_service", str, "",
    "host:port of a parallel.master serving the distributed compile "
    "service. On an L2 miss the executor fetches the PTAC1 entry (the "
    "prepared plan) by content digest from this service instead of "
    "preparing it; the first misser of a digest takes a single-flight "
    "lease, so N simultaneous missers produce ONE prepare and a "
    "scale-out replica warm-starts from its peers' plans. Requires "
    "FLAGS_compile_cache_dir (fetched entries land in the local L2). "
    "Empty: disabled.")

# how long a non-leaseholder parks waiting for the winner's publish; the
# master expires a dead winner's lease well before this and wakes us
WAIT_S = 120.0
# single-flight lease TTL: a leaseholder that dies mid-compile blocks
# peers for at most this long
LEASE_TTL_S = 120.0

_lock = threading.Lock()
_client = [None, None]  # [endpoint, MasterClient] — re-dialed on change


def enabled():
    return bool(flags.get("compile_service"))


def _get_client():
    endpoint = flags.get("compile_service")
    if not endpoint:
        return None
    with _lock:
        if _client[0] != endpoint or _client[1] is None:
            _drop_locked()
            from ..parallel.master import MasterClient
            from ..resilience.retry import RetryPolicy

            try:
                _client[:] = [endpoint, MasterClient(
                    endpoint, connect_timeout=10.0,
                    retry=RetryPolicy(max_attempts=2, base_delay_ms=50,
                                      kind="compile_service"))]
            except OSError:
                return None
        return _client[1]


def _drop_locked():
    old = _client[1]
    _client[:] = [None, None]
    if old is not None:
        try:
            old.close()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass


def reset():
    """Drop the cached connection (tests; endpoint teardown)."""
    with _lock:
        _drop_locked()


def fetch_blob(digest, wait_s=0.0):
    """Whole-file PTAC1 blob for `digest`, or None (absent / timed out /
    service unreachable / disabled). With wait_s > 0 the call parks
    until the current leaseholder publishes."""
    if not is_digest(digest):
        return None
    client = _get_client()
    if client is None:
        return None
    try:
        return client.compiled_get(digest, wait_s=float(wait_s))
    except Exception:  # noqa: BLE001 — transport fault -> compile locally
        reset()
        return None


def try_lease(digest):
    """True when THIS process should compile `digest` (it won the
    single-flight lease — or the service is unreachable, in which case
    compiling locally is the only safe answer)."""
    if not is_digest(digest):
        return True
    client = _get_client()
    if client is None:
        return True
    try:
        return bool(client.compiled_lease(
            digest, ttl=LEASE_TTL_S).get("granted"))
    except Exception:  # noqa: BLE001 — fail open: compile locally
        reset()
        return True


def offer_blob(digest, blob):
    """Publish a freshly compiled blob (releases our lease and wakes
    every peer parked on the digest). Swallows faults — a publish that
    fails just costs the peers their lease-expiry wait."""
    if not is_digest(digest) or not blob:
        return False
    client = _get_client()
    if client is None:
        return False
    try:
        return bool(client.compiled_put(digest, blob).get("stored"))
    except Exception:  # noqa: BLE001
        reset()
        return False


def service_stats():
    """The master's compiled_stats() dict, or None when unreachable."""
    client = _get_client()
    if client is None:
        return None
    try:
        return client.compiled_stats()
    except Exception:  # noqa: BLE001
        reset()
        return None
