"""Failure taxonomy for the fault-tolerant training loop.

The retry layer must answer ONE question per exception: is this a
transient infrastructure fault (device/transfer hiccup, connection reset,
lease race — retry with backoff) or a programmer error (shape mismatch,
unknown var, assertion — re-raising immediately is the only honest
answer)? The reference Fluid makes the same split implicitly: its gRPC
client retries UNAVAILABLE/DEADLINE_EXCEEDED statuses while
PADDLE_ENFORCE failures abort the run.

Classification is pattern-based for backend exceptions (a RuntimeError
or OSError whose message carries a transport status, as the JAX package's
XlaRuntimeError does) plus an extensible registry for runtime-specific
types. CUDA has no counterpart of those statuses: an error that the CUDA
runtime, cuBLAS, cuDNN or NCCL reports (an illegal address, a launch
failure) leaves the context or the communicator unusable, and is never
retried, whatever else its message says; an out-of-memory error is the
counterpart of RESOURCE_EXHAUSTED and is not retried either.
"""

import socket as _socket

import torch

__all__ = ["TransientError", "NanLossError", "Preempted", "StepHang",
           "is_transient", "register_transient"]


class TransientError(RuntimeError):
    """A retryable infrastructure fault (also what chaos injection
    raises to exercise the retry path end to end)."""


class NanLossError(FloatingPointError):
    """A step produced a non-finite loss under
    FLAGS_resilience_nan_policy=raise."""


class Preempted(BaseException):
    """The run was preempted (SIGTERM/SIGINT) and has grace-saved.

    BaseException, like KeyboardInterrupt: no `except Exception` recovery
    layer (retry, event handlers) may swallow a preemption on its way out
    of the training loop.
    """

    def __init__(self, signum, checkpoint_serial=None):
        super().__init__(f"preempted by signal {signum}"
                         + (f" (checkpoint {checkpoint_serial} saved)"
                            if checkpoint_serial is not None else ""))
        self.signum = signum
        self.checkpoint_serial = checkpoint_serial


class StepHang(RuntimeError):
    """Reserved: a step exceeded FLAGS_step_deadline_ms and the watchdog
    was configured to abort rather than only dump."""


# always-transient exception types; extensible at runtime. The concrete
# ConnectionError subclasses and socket.timeout are listed explicitly —
# they are what the rpc/router transport path actually raises (a replica
# SIGKILLed mid-request surfaces as ConnectionResetError on the router,
# a dead listener as ConnectionRefusedError, a wedged replica as
# socket.timeout) and the fleet's retry-on-other-replica decision rides
# on this classification, so it must not depend on the stdlib hierarchy
# keeping them under ConnectionError/TimeoutError.
_TRANSIENT_TYPES = [TransientError, ConnectionError, TimeoutError,
                    ConnectionResetError, BrokenPipeError,
                    ConnectionRefusedError, _socket.timeout]

# XLA/transport status markers that mean "the infrastructure hiccuped".
# RESOURCE_EXHAUSTED (OOM) is deliberately absent: retrying the same
# dispatch against the same HBM budget cannot succeed.
_TRANSIENT_MARKERS = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED",
    "connection reset", "connection refused", "broken pipe",
    "socket closed", "transfer to device failed",
    "failed to transfer", "premature end of",
)

# unambiguous programmer errors — never retried, whatever they wrap;
# torch's OutOfMemoryError is the card's RESOURCE_EXHAUSTED
_FATAL_TYPES = (ValueError, TypeError, KeyError, IndexError,
                AttributeError, AssertionError, NotImplementedError,
                torch.cuda.OutOfMemoryError)

# what a failure of the CUDA runtime or its libraries says: the context
# (or the NCCL communicator) is left unusable, so a retry cannot succeed
_FATAL_MARKERS = ("CUDA error", "CUDA driver error", "CUBLAS_STATUS_",
                  "CUDNN_STATUS_", "cuDNN error", "NCCL error",
                  "device-side assert")


def register_transient(exc_type):
    """Mark an exception type as always-transient (plugin backends)."""
    if exc_type not in _TRANSIENT_TYPES:
        _TRANSIENT_TYPES.append(exc_type)


def is_transient(exc):
    """True when `exc` looks like a retryable infrastructure fault."""
    if isinstance(exc, tuple(_TRANSIENT_TYPES)):
        return True
    if isinstance(exc, _FATAL_TYPES) or isinstance(exc, BaseException) \
            and not isinstance(exc, Exception):
        return False
    # backend runtime errors (a RuntimeError carrying the status in its
    # message); a CUDA failure first, which no marker may rescue
    if isinstance(exc, (RuntimeError, OSError)):
        msg = str(exc)
        if any(m in msg for m in _FATAL_MARKERS):
            return False
        return any(m.lower() in msg.lower() for m in _TRANSIENT_MARKERS)
    return False
