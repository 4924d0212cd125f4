"""Stable content digests for the persistent compile cache (L2).

The in-memory prepared-step key pins a program by (id(program),
program._mutation) — exact within a process, meaningless across
processes. The L2 key replaces that pair with a sha256 of the program's
canonical JSON serialization (Program.desc_str: sort_keys, ops in program
order) and appends everything else that changes the prepared step:

  * the in-memory key's content tail (fusion flags, the amp fingerprint,
    the feeds' names, shapes and dtypes, the fetches, the health digest
    and the wire fingerprint), which is process-stable by construction
    (tuples of primitives; no id()s, no hash()es);
  * the runtime environment: the torch version, torch.version.cuda, and
    the card's name and compute capability (the store also stamps these
    in the entry's header and checks them at load);
  * the executor kind and device the caller passes as `extra`.

The JAX package's keys (paddle_tpu/cache/keys.py), with torch's versions
and the card in place of jax's and the platform's. Never hash() anything
here: PYTHONHASHSEED makes it process-local. The cross-process stability
is asserted by a subprocess test in tests/test_torch_compile_cache.py.
"""

import hashlib

import torch

__all__ = ["program_digest", "stable_digest", "environment", "is_digest"]

_HEX = set("0123456789abcdef")


def is_digest(value):
    """True for a well-formed sha256 hex key. A digest is also a filename
    under FLAGS_compile_cache_dir, so one from outside must pass this
    before it names a file."""
    return (isinstance(value, str) and len(value) == 64
            and set(value) <= _HEX)


# program content digests, keyed (id(program), mutation) — sha256 of a big
# JSON string is the expensive part, and it is only ever needed on the
# prepare-miss path, so a small FIFO memo keeps repeat misses (new feed
# shapes against one program) from re-serializing the ProgramDesc
_digest_memo = {}
_DIGEST_MEMO_CAP = 128


def program_digest(program):
    """sha256 hex of the program's canonical serialization."""
    key = (id(program), program._mutation)
    hit = _digest_memo.get(key)
    if hit is not None:
        return hit
    d = hashlib.sha256(program.desc_str().encode("utf-8")).hexdigest()
    while len(_digest_memo) >= _DIGEST_MEMO_CAP:
        _digest_memo.pop(next(iter(_digest_memo)))
    _digest_memo[key] = d
    return d


def environment():
    """(torch version, CUDA version, card name, compute capability), the
    last three None without a card: stamped into every entry and folded
    into every digest — a version bump or another card is a cold start."""
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        cc = "sm_%d%d" % torch.cuda.get_device_capability(0)
    else:
        name = cc = None
    return (torch.__version__, torch.version.cuda, name, cc)


def stable_digest(program, key_tail, extra=()):
    """Hex digest naming one L2 entry.

    key_tail: the in-memory key MINUS its (id, mutation) head — tuples of
    primitives whose repr is process-stable. extra: caller context
    (executor kind, device).
    """
    h = hashlib.sha256()
    h.update(b"paddle_tpu_torch-prepared-v1\0")
    h.update(repr(environment()).encode("utf-8"))
    h.update(b"\0")
    h.update(program_digest(program).encode("utf-8"))
    h.update(b"\0")
    h.update(repr(tuple(key_tail)).encode("utf-8"))
    h.update(b"\0")
    h.update(repr(tuple(extra)).encode("utf-8"))
    return h.hexdigest()
