"""NaN/Inf loss guard for the training loop.

After each step the runner hands the fetched metrics to the guard; on a
non-finite value the configured policy decides the outcome:

    raise    NanLossError — fail fast (default; right for CI and debug)
    skip     count it (`nan_steps_total`) and keep training — the
             classic "one bad batch" mitigation. Note the poisoned
             update has already been applied by the time the loss is
             fetched (the step writes the scope's tensors, in place on
             the captured graph), so `skip` accepts the contaminated
             step and relies on clipping/decay to wash it out.
    restore  tell the runner to roll back to the last checkpoint and
             resume from there — the only policy that truly discards
             the poisoned update.
"""

import math

import numpy as np

from .. import flags
from .. import monitor
from .errors import NanLossError

__all__ = ["NanGuard", "scan_non_finite"]

_POLICIES = ("raise", "skip", "restore")


def _leaves(value, path):
    if isinstance(value, dict):
        for k, v in value.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _leaves(v, f"{path}[{i}]" if path else f"[{i}]")
    else:
        yield path, value


def scan_non_finite(values):
    """Paths of non-finite numeric leaves in a fetched-metrics pytree."""
    bad = []
    for path, v in _leaves(values, ""):
        try:
            arr = np.asarray(v)
        except Exception:
            continue
        if arr.dtype.kind not in "fc":
            continue
        if not np.all(np.isfinite(arr)):
            bad.append(path or "<value>")
    return bad


class NanGuard:
    def __init__(self, policy=None):
        self._policy = policy

    @property
    def policy(self):
        p = self._policy or flags.get("resilience_nan_policy")
        if p not in _POLICIES:
            raise ValueError(
                f"FLAGS_resilience_nan_policy must be one of {_POLICIES}, "
                f"got {p!r}")
        return p

    def check(self, metrics, step=None):
        """'ok' when finite; else apply the policy: raise NanLossError,
        or return 'skip' / 'restore' for the runner to act on."""
        bad = scan_non_finite(metrics)
        if not bad:
            return "ok"
        policy = self.policy
        monitor.registry().counter(
            "nan_steps_total",
            help="steps whose fetched metrics contained NaN/Inf",
            policy=policy).inc()
        try:  # flight recorder: the steps leading up to the bad batch
            from .. import trace as _trace_mod

            _trace_mod.maybe_dump("nan_guard")
        except Exception:
            pass
        if policy == "raise":
            at = f" at step {step}" if step is not None else ""
            raise NanLossError(
                f"non-finite metrics{at}: {', '.join(bad)}")
        return policy

    def __call__(self, metrics, step=None):
        return self.check(metrics, step=step)
