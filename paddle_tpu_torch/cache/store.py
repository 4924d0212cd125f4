"""Persistent store of prepared steps (the compile cache's L2).

Layout: one file per entry under FLAGS_compile_cache_dir,
`<digest>.aot`, where digest is the stable content key from keys.py.
The layout, framing, atomic commit and pruning are the JAX package's
(paddle_tpu/cache/store.py); the header stamps torch's versions and the
card instead of jax's and the platform, and the payload is the prepared
plan (the cache's __init__ says what it holds), never an executable.

File format (everything the loader needs to refuse an entry without
touching the payload):

    magic   b"PTAC1\\n"
    8 bytes big-endian header length
    header  JSON (utf-8): digest, kind, created, torch, cuda, device,
            capability, payload_bytes, payload_sha256, meta
    payload the prepared plan, JSON (utf-8)

Writes commit atomically — tmp file in the same directory, fsync, then
os.replace (the resilience-checkpoint idiom), so a reader never sees a
torn entry and concurrent writers of the same digest last-write-win. A
successful read touches the entry's mtime, making directory pruning
(size cap, oldest-mtime-first) true LRU rather than FIFO.

get() NEVER raises on a bad entry: corruption, a truncated header, a
torch/CUDA/card mismatch, or a payload checksum failure all come back
as a ("corrupt" | "stale") outcome for the caller to count as a fallback
and prepare over. The only exceptions that escape are programming
errors, not cache-content errors.
"""

import itertools
import json
import os
import struct
import time

from .keys import environment

__all__ = ["L2Store", "MAGIC"]

MAGIC = b"PTAC1\n"
_SUFFIX = ".aot"

# tmp names carry pid AND a process-local sequence: two THREADS putting
# the same digest concurrently must not share a tmp file, or one commits
# the other's half-written bytes (itertools.count is atomic in CPython)
_tmp_seq = itertools.count()


_ENV_KEYS = ("torch", "cuda", "device", "capability")


def _stamp():
    """keys.environment() under the header's names."""
    return dict(zip(_ENV_KEYS, environment()))


def _sha256(data):
    import hashlib

    return hashlib.sha256(data).hexdigest()


class L2Store:
    def __init__(self, root):
        self.root = str(root)

    def path_for(self, digest):
        return os.path.join(self.root, f"{digest}{_SUFFIX}")

    # -- read ----------------------------------------------------------
    def get(self, digest):
        """(outcome, payload, header): outcome is "hit" (payload + header
        set), "miss" (no entry), "stale" (version/geometry mismatch,
        header set) or "corrupt" (unreadable; header may be None)."""
        path = self.path_for(digest)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return "miss", None, None
        except OSError:
            return "corrupt", None, None
        header, payload = self._parse(raw)
        if header is None:
            return "corrupt", None, None
        if payload is None or _sha256(payload) != header.get("payload_sha256"):
            return "corrupt", None, header
        if _stamp() != {k: header.get(k) for k in _ENV_KEYS}:
            return "stale", None, header
        try:
            # LRU recency stamp: pruning deletes oldest-mtime first
            os.utime(path, None)
        except OSError:
            pass
        return "hit", payload, header

    @staticmethod
    def _parse(raw):
        if len(raw) < len(MAGIC) + 8 or not raw.startswith(MAGIC):
            return None, None
        try:
            (hlen,) = struct.unpack(
                ">Q", raw[len(MAGIC):len(MAGIC) + 8])
            hend = len(MAGIC) + 8 + hlen
            header = json.loads(raw[len(MAGIC) + 8:hend].decode("utf-8"))
            payload = raw[hend:]
        except (ValueError, UnicodeDecodeError, struct.error):
            return None, None
        if not isinstance(header, dict):
            return None, None
        if len(payload) != header.get("payload_bytes", -1):
            return header, None
        return header, payload

    # -- write ---------------------------------------------------------
    def put(self, digest, payload, kind="executor", meta=None,
            max_bytes=None):
        """Atomically commit one entry; returns bytes written (whole
        file). Prunes the directory to max_bytes (oldest mtime first)
        after the commit when a cap is given."""
        header = {
            "digest": digest,
            "kind": kind,
            "created": time.time(),
            **_stamp(),
            "payload_bytes": len(payload),
            "payload_sha256": _sha256(payload),
            "meta": meta or {},
        }
        hb = json.dumps(header, sort_keys=True).encode("utf-8")
        blob = MAGIC + struct.pack(">Q", len(hb)) + hb + payload
        self._commit(digest, blob)
        if max_bytes and max_bytes > 0:
            self.prune(max_bytes)
        return len(blob)

    def _commit(self, digest, blob):
        """Atomic write: tmp in the same directory, fsync, os.replace.
        Concurrent same-digest writers last-write-win — each writes its
        own tmp, and the replace is atomic, so a reader sees exactly one
        writer's whole file, never an interleaving. A commit over an
        existing entry is counted (two replicas that both missed both
        prepared: wasted work)."""
        os.makedirs(self.root, exist_ok=True)
        path = self.path_for(digest)
        duplicate = os.path.exists(path)
        tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_seq)}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        if duplicate:
            from .. import monitor

            if monitor.enabled():
                monitor.registry().counter(
                    "compile_cache_l2_duplicate_puts_total",
                    help="same-digest L2 entries overwritten by a "
                         "concurrent or repeated put (last writer "
                         "wins, atomically)").inc()

    # -- whole-file blobs (the compile service's wire payload) ---------
    def read_blob(self, digest):
        """Raw on-disk bytes of one entry — the WHOLE file (magic +
        header + payload), which is what the JAX package's compile
        service ships between peers — or None when absent/unreadable."""
        try:
            with open(self.path_for(digest), "rb") as f:
                return f.read()
        except OSError:
            return None

    def put_blob(self, digest, blob, max_bytes=None):
        """Commit a whole-file blob (a peer's, or read_blob's), re-validating
        magic, framing, digest binding, and the payload checksum BEFORE
        the commit — a corrupt or mislabeled publish must not poison
        this cache. The environment (torch/CUDA/card) is NOT checked
        here: get() refuses stale entries on read, same as local ones.
        Returns True on commit."""
        blob = bytes(blob)
        header, payload = self._parse(blob)
        if header is None or payload is None:
            return False
        if header.get("digest") != digest \
                or _sha256(payload) != header.get("payload_sha256"):
            return False
        self._commit(digest, blob)
        if max_bytes and max_bytes > 0:
            self.prune(max_bytes)
        return True

    # -- maintenance ---------------------------------------------------
    def entries(self):
        """[{digest, bytes, age_s, mtime, path, ok, kind, torch, ...}]
        sorted newest first; unparseable files appear with ok=False so
        `cache ls` surfaces debris instead of hiding it."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        now = time.time()
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            ent = {
                "digest": name[:-len(_SUFFIX)],
                "bytes": st.st_size,
                "mtime": st.st_mtime,
                "age_s": max(0.0, now - st.st_mtime),
                "path": path,
                "ok": False,
            }
            try:
                with open(path, "rb") as f:
                    head = f.read(1 << 16)
                header, _ = self._parse(head)
            except OSError:
                header = None
            if header is not None:
                ent["ok"] = True
                for k in ("kind",) + _ENV_KEYS + ("created",):
                    if k in header:
                        ent[k] = header[k]
            out.append(ent)
        out.sort(key=lambda e: e["mtime"], reverse=True)
        return out

    def total_bytes(self):
        return sum(e["bytes"] for e in self.entries())

    def prune(self, max_bytes):
        """Delete oldest-mtime entries until the directory fits
        max_bytes; returns the number of entries removed."""
        ents = self.entries()
        total = sum(e["bytes"] for e in ents)
        removed = 0
        for e in sorted(ents, key=lambda e: e["mtime"]):
            if total <= max_bytes:
                break
            try:
                os.unlink(e["path"])
            except OSError:
                continue
            total -= e["bytes"]
            removed += 1
        return removed

    def clear(self):
        """Delete every entry (and stranded tmp debris); returns count."""
        removed = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        for name in names:
            if name.endswith(_SUFFIX) or f"{_SUFFIX}.tmp." in name:
                try:
                    os.unlink(os.path.join(self.root, name))
                    removed += 1
                except OSError:
                    pass
        return removed
