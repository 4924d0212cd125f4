"""Placement policies mapping split variable blocks onto pserver endpoints.

Role parity with reference python/paddle/fluid/transpiler/ps_dispatcher.py
(RoundRobin / HashName surface); the JAX package's dispatchers. One deliberate
upgrade over the reference: HashName uses a stable digest (crc32) rather than Python's
process-seeded hash() — trainers and pservers compute placement
independently, and with PYTHONHASHSEED randomization a builtin-hash scheme
can assign the same parameter block to different endpoints in different
processes.
"""

import zlib

__all__ = ["PSDispatcher", "RoundRobin", "HashName"]


class PSDispatcher:
    """Base policy: subclasses decide which endpoint serves each block."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        """varlist: split Variables -> endpoint per variable (parallel list)."""
        raise NotImplementedError(
            f"{type(self).__name__} must implement dispatch()")


class RoundRobin(PSDispatcher):
    """Deal blocks out like cards: step through the endpoint ring, keeping
    the cursor across calls so successive dispatch() calls stay balanced."""

    def dispatch(self, varlist):
        n = len(self._eps)
        chosen = [self._eps[(self._step + i) % n]
                  for i in range(len(varlist))]
        self._step = (self._step + len(varlist)) % n
        return chosen


class HashName(PSDispatcher):
    """Stable name-keyed placement: the same variable name always lands on
    the same endpoint, in every process, regardless of dispatch order."""

    @staticmethod
    def _bucket(name, buckets):
        return zlib.crc32(name.encode("utf-8")) % buckets

    def dispatch(self, varlist):
        return [self._eps[self._bucket(v.name, len(self._eps))]
                for v in varlist]
