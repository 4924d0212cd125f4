"""Preemption handling: catch SIGTERM/SIGINT, finish the in-flight step,
grace-save, then surface errors.Preempted.

Signal handlers must not touch the device (the dispatch they interrupt
holds donated buffers), so the handler only records the signal; the
training loop polls `pending()` at the next step boundary — the one
point where scope state is consistent — saves a blocking checkpoint and
raises Preempted. A second signal while the grace-save runs restores the
default disposition, so an operator's double-Ctrl-C still kills a stuck
save.
"""

import signal
import threading

from .. import monitor
from .errors import Preempted

__all__ = ["PreemptionHandler"]

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Context manager; install only around the training loop.

    with PreemptionHandler() as pre:
        for step in ...:
            run_step()
            if pre.pending():
                save_blocking()
                pre.raise_preempted(checkpoint_serial=serial)
    """

    def __init__(self, signals=_SIGNALS):
        self.signals = tuple(signals)
        self._signum = [None]
        self._prev = {}
        self._installed = False

    def _handler(self, signum, frame):
        first = self._signum[0] is None
        self._signum[0] = signum
        if first:
            monitor.registry().counter(
                "preemptions_total",
                help="SIGTERM/SIGINT preemptions observed",
                signum=str(signum)).inc()
        else:
            # second signal: give up gracefulness, restore defaults so the
            # next one (or this one's re-raise) actually terminates
            self._restore()
            signal.default_int_handler(signum, frame) \
                if signum == signal.SIGINT else signal.raise_signal(signum)

    def __enter__(self):
        if threading.current_thread() is not threading.main_thread():
            return self  # signals only deliverable to the main thread
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):
                pass
        self._installed = True
        return self

    def _restore(self):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def __exit__(self, exc_type, exc, tb):
        self._restore()
        return False

    def pending(self):
        """The signum of a received signal, else None."""
        return self._signum[0]

    def clear(self):
        self._signum[0] = None

    def raise_preempted(self, checkpoint_serial=None):
        signum = self._signum[0]
        if signum is None:
            raise RuntimeError("raise_preempted() without a pending signal")
        raise Preempted(signum, checkpoint_serial=checkpoint_serial)
