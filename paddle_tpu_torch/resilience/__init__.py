"""paddle_tpu_torch.resilience — fault-tolerant training loop (the JAX
package's paddle_tpu.resilience, ported).

Async atomic checkpoints (checkpoint.py), retry with backoff around the
step dispatch (retry.py/errors.py), NaN/Inf loss guard (nan_guard.py),
SIGTERM/SIGINT grace-save (preempt.py), hang watchdog (watchdog.py), and
a deterministic fault-injection harness (chaos.py), composed into one
step-loop protocol by loop.ResilientRunner — which Trainer wires in via
its resilience_config argument.

The checkpoint layout is the JAX package's byte for byte (docs/
resilience.md): a checkpoint written by either package restores in the
other. The port adds one manifest key, `torch_rng`: the state of the
program's random stream (a torch.Generator: on a card its seed and Philox
offset), which the JAX package draws per step from its step counter
instead, and which its restore ignores.
"""

from .. import flags

# Flags first: the submodules read them at call time, and importing any
# `paddle_tpu_torch.resilience.<sub>` runs this package __init__ beforehand.
flags.define("resilience_max_attempts", int, 5,
             "Total tries (first + retries) the resilience RetryPolicy "
             "gives a transient step failure before re-raising.")
flags.define("resilience_backoff_base_ms", int, 100,
             "Backoff before retry i is base * 2**i milliseconds "
             "(jittered), capped by resilience_backoff_max_ms.")
flags.define("resilience_backoff_max_ms", int, 5000,
             "Ceiling on the resilience retry backoff, milliseconds.")
flags.define("resilience_nan_policy", str, "raise",
             "What the NaN/Inf loss guard does on a non-finite metric: "
             "raise (NanLossError), skip (count and continue), or "
             "restore (roll back to the last checkpoint).")
flags.define("resilience_health_policy", str, "warn",
             "What ResilientRunner does when a paddle_tpu_torch.health "
             "detector fired during the step (loss spike, grad "
             "explosion, divergence, ...): warn (count and continue), "
             "skip (count the step as suspect and continue), or restore "
             "(roll back to the last checkpoint). The NaN-only guard "
             "(resilience_nan_policy) stays its own special case.")
flags.define("step_deadline_ms", int, 0,
             "Hang watchdog: if one executor dispatch exceeds this many "
             "milliseconds, dump every thread's stack (and the chrome "
             "trace when profiling) to FLAGS_hang_dump_dir. 0 = off.")
flags.define("hang_dump_dir", str, "",
             "Directory for watchdog hang dumps (empty = cwd).")

from . import chaos, checkpoint, errors, nan_guard, preempt, retry, watchdog
from .checkpoint import CheckpointManager, inspect_dir
from .errors import (NanLossError, Preempted, StepHang, TransientError,
                     is_transient, register_transient)
from .loop import ResilienceConfig, ResilientRunner, RolledBack
from .nan_guard import NanGuard
from .preempt import PreemptionHandler
from .retry import RetryBudget, RetryPolicy

__all__ = [
    "CheckpointManager", "inspect_dir",
    "ResilienceConfig", "ResilientRunner", "RolledBack",
    "RetryPolicy", "RetryBudget", "NanGuard", "PreemptionHandler",
    "TransientError", "NanLossError", "Preempted", "StepHang",
    "is_transient", "register_transient",
    "chaos", "checkpoint", "errors", "nan_guard", "preempt", "retry",
    "watchdog",
]
