"""RetryPolicy: bounded exponential backoff + jitter around a step fn.

Wraps `exe.run()` (or any callable touching flaky infrastructure — the
MasterClient transport reuses it) so transient device/transfer errors are
retried with exponential backoff while programmer errors surface
immediately (see errors.is_transient). Every retry lands in the monitor
registry as `resilience_retries_total` so a fleet dashboard can see a
link going bad before it goes dark.
"""

import random
import threading
import time

from .. import flags
from .. import monitor
from .errors import is_transient

__all__ = ["RetryPolicy", "RetryBudget"]


class RetryPolicy:
    """call(fn) runs fn, retrying transient failures.

    max_attempts:  total tries including the first (flag default)
    base_delay_ms: backoff before retry i is base * 2**i, capped at
    max_delay_ms:  this ceiling
    jitter:        each delay is scaled by uniform[1-jitter, 1+jitter]
                   (decorrelates a fleet retrying in lockstep); the rng is
                   seeded per-policy so tests are deterministic
    classify:      exc -> bool (True = transient, retry); default
                   errors.is_transient
    sleep:         injectable for tests
    deadline_ms:   optional wall-clock bound on ONE call(): once the
                   elapsed time plus the next backoff would exceed it the
                   last error re-raises instead of sleeping — total
                   attempts respect a request SLO, not just max_attempts.
                   None = attempts-bounded only.
    clock:         injectable monotonic-seconds source for deadline tests
    """

    def __init__(self, max_attempts=None, base_delay_ms=None,
                 max_delay_ms=None, jitter=0.25, classify=None, sleep=None,
                 seed=0, kind="executor", deadline_ms=None, clock=None):
        self.max_attempts = int(max_attempts
                                if max_attempts is not None
                                else flags.get("resilience_max_attempts"))
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        self.base_delay_ms = float(
            base_delay_ms if base_delay_ms is not None
            else flags.get("resilience_backoff_base_ms"))
        self.max_delay_ms = float(
            max_delay_ms if max_delay_ms is not None
            else flags.get("resilience_backoff_max_ms"))
        self.jitter = float(jitter)
        self.classify = classify if classify is not None else is_transient
        self.sleep = sleep if sleep is not None else time.sleep
        self._rng = random.Random(seed)
        self.kind = kind
        self.deadline_ms = (None if deadline_ms is None
                            else float(deadline_ms))
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be positive, got {deadline_ms}")
        self.clock = clock if clock is not None else time.monotonic
        self.last_attempts = 0  # attempts the most recent call() used

    def delay_ms(self, attempt):
        """Backoff before retry `attempt` (0-based), jittered."""
        d = min(self.base_delay_ms * (2.0 ** attempt), self.max_delay_ms)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn, *args, **kwargs):
        last = None
        t0 = self.clock() if self.deadline_ms is not None else None
        for attempt in range(self.max_attempts):
            self.last_attempts = attempt + 1
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if not self.classify(e):
                    raise
                last = e
                if attempt + 1 >= self.max_attempts:
                    raise
                delay = self.delay_ms(attempt)
                if t0 is not None:
                    elapsed_ms = (self.clock() - t0) * 1000.0
                    # the deadline bounds the whole call(): never start a
                    # backoff sleep the SLO cannot pay for — re-raising
                    # now beats waking up past the deadline to retry work
                    # nobody is waiting for anymore
                    if elapsed_ms + delay >= self.deadline_ms:
                        raise
                monitor.registry().counter(
                    "resilience_retries_total",
                    help="transient step failures retried with backoff",
                    kind=self.kind).inc()
                self.sleep(delay / 1000.0)
        raise last  # pragma: no cover - loop always returns or raises


class RetryBudget:
    """Fleet-wide bound on retry amplification (token bucket).

    Under a partial outage every request wants to retry; unbounded
    retries multiply offered load exactly when capacity is lowest and
    turn a brownout into a blackout. The budget couples retry capacity
    to successful admission: each first attempt deposits `ratio` tokens
    (capped at `burst`), each retry spends one — so sustained retry
    traffic cannot exceed `ratio` of request traffic, while short bursts
    (one replica dying) draw down the reserve.

        budget = RetryBudget(ratio=0.2, burst=16)
        budget.on_request()            # per admitted request
        if budget.try_spend(): retry() # else fail fast
    """

    def __init__(self, ratio=0.2, burst=16):
        self.ratio = float(ratio)
        self.burst = float(burst)
        if not 0.0 <= self.ratio <= 1.0:
            raise ValueError(f"ratio must be in [0, 1], got {ratio}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self._tokens = self.burst  # start full: cold fleets may retry
        self._lock = threading.Lock()

    @property
    def tokens(self):
        with self._lock:
            return self._tokens

    def on_request(self):
        """Deposit for one admitted (first-attempt) request."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def try_spend(self):
        """Take one retry token; False = budget exhausted, fail fast."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False
