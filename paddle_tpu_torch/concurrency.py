"""CSP concurrency: channels, Go blocks, Select.

Reference parity: python/paddle/fluid/concurrency.py:27 (Go/Select/
make_channel/channel_send/channel_recv/channel_close) over
framework/channel.h:33 and operators/{go,channel_send,channel_recv,
channel_close,select}_op.cc.

The JAX package's CSP (paddle_tpu/concurrency.py), with the same layers
and programs. CSP is host-side control plane (the reference runs it on CPU
threads too — goroutine-style). Channels are runtime objects in the step's
env; `go` runs its sub-block on a daemon thread through the interpreter;
`select` polls its cases and fires one sub-block. The six op types are
host ops (core/executor_core.py HOST_OPS): a program that holds one runs
on the interpreter, uncached, never in a CUDA graph.

On a card, work is ordered per stream, and a goroutine runs its kernels on
a stream of its own: a CUDA tensor sent over a channel carries an event
recorded on the sender's current stream, and the receiver's current
stream waits for it before the value is read (`Channel.recv`,
`Channel.try_recv`).
"""

import queue
import threading
import time

import torch

from .layer_helper import LayerHelper
from .core.framework import Variable, VarType
from .layers.control_flow import BlockGuard
from . import unique_name

__all__ = ["Go", "make_channel", "channel_send", "channel_recv",
           "channel_close", "Select"]


def _cuda_tensors(value):
    """The CUDA tensors `value` holds: a tensor, a SeqTensor's data and
    lengths, or none."""
    if isinstance(value, torch.Tensor):
        return [value] if value.is_cuda else []
    if hasattr(value, "lengths") and hasattr(value, "data"):
        return _cuda_tensors(value.data) + _cuda_tensors(value.lengths)
    return []


def _ready_event(value):
    """An event recorded on the current stream of the card `value` lives
    on, after the work that writes it so far; None for a host value."""
    tensors = _cuda_tensors(value)
    if not tensors:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return event


def _wait_ready(value, event):
    """Make the receiver's current stream wait for the sender's work on
    `value`."""
    if event is not None:
        device = _cuda_tensors(value)[0].device
        torch.cuda.current_stream(device).wait_event(event)
    return value


class Channel:
    """Buffered/unbuffered channel (reference framework/channel.h:33).

    capacity 0 = rendezvous: send blocks until a receiver takes the value
    (approximated with a size-1 queue plus a handshake event)."""

    def __init__(self, capacity=0):
        self.capacity = capacity
        self._q = queue.Queue(maxsize=max(capacity, 1))
        self._rendezvous = capacity == 0
        self._closed = threading.Event()

    def send(self, value):
        if self._closed.is_set():
            raise RuntimeError("send on closed channel")
        event = _ready_event(value)
        if self._rendezvous:
            taken = threading.Event()
            self._put_checking_close((value, event, taken))
            # handshake, but wake if the channel closes underneath us (a
            # parked sender must not leak forever like a naive wait would)
            while not taken.wait(0.05):
                if self._closed.is_set() and not taken.is_set():
                    raise RuntimeError("channel closed while sending")
            return True
        self._put_checking_close((value, event, None))
        return True

    def _put_checking_close(self, item):
        while True:
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                if self._closed.is_set():
                    raise RuntimeError("channel closed while sending")

    def try_send(self, value):
        """Non-blocking send (select): False when full/closed. On a
        rendezvous channel this completes without awaiting the handshake —
        select's 'send became possible' approximation."""
        if self._closed.is_set():
            return False
        try:
            self._q.put((value, _ready_event(value), None), block=False)
            return True
        except queue.Full:
            return False

    def try_recv(self):
        """Non-blocking recv (select): (value, True) on success,
        (None, False) when closed+drained; raises queue.Empty otherwise."""
        try:
            value, event, taken = self._q.get(block=False)
            if taken is not None:
                taken.set()
            return _wait_ready(value, event), True
        except queue.Empty:
            if self._closed.is_set():
                return None, False
            raise

    def recv(self, block=True, timeout=None):
        """-> (value, ok). ok=False when the channel is closed and drained."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while True:
            try:
                value, event, taken = self._q.get(block=False)
                if taken is not None:
                    taken.set()
                return _wait_ready(value, event), True
            except queue.Empty:
                if self._closed.is_set():
                    return None, False
                if not block:
                    raise
                if deadline is not None and time.monotonic() >= deadline:
                    raise queue.Empty
                self._closed.wait(0.001)

    def can_recv(self):
        return not self._q.empty()

    def can_send(self):
        return not self._closed.is_set() and not self._q.full()

    def close(self):
        self._closed.set()


def make_channel(dtype, capacity=0):
    """reference concurrency.py make_channel — returns a CHANNEL variable;
    the channel object itself is created by the emitted channel_create op."""
    helper = LayerHelper("channel")
    var = helper.main_program.current_block().create_var(
        name=unique_name.generate("channel"), type=VarType.RAW,
        dtype=dtype if isinstance(dtype, str) else "float32", shape=None)
    helper.append_op("channel_create", {}, {"Out": [var]},
                     {"capacity": int(capacity)})
    return var


def channel_send(channel, value, is_copy=False):
    helper = LayerHelper("channel_send")
    status = helper.create_tmp_variable(dtype="bool", shape=[1])
    helper.append_op("channel_send", {"Channel": [channel], "X": [value]},
                     {"Status": [status]}, {})
    return status


def channel_recv(channel, return_value):
    helper = LayerHelper("channel_recv")
    status = helper.create_tmp_variable(dtype="bool", shape=[1])
    helper.append_op("channel_recv", {"Channel": [channel]},
                     {"Out": [return_value], "Status": [status]}, {})
    return return_value, status


def channel_close(channel):
    helper = LayerHelper("channel_close")
    helper.append_op("channel_close", {"Channel": [channel]}, {}, {})


class Go(BlockGuard):
    """reference concurrency.py Go:27 — run the enclosed block
    concurrently (goroutine)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("go", name=name)
        super().__init__(self.helper.main_program)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            # still roll back so the current-block pointer doesn't stay
            # stuck inside the abandoned sub-block
            return super().__exit__(exc_type, exc_val, exc_tb)
        sub_block = self.main_program.current_block()
        res = super().__exit__(exc_type, exc_val, exc_tb)
        parent_block = self.main_program.block(sub_block.parent_idx)
        x_names = sorted({
            n for op in sub_block.ops for n in op.input_arg_names()
            if n and parent_block.vars.get(n) is not None
        })
        parent_block.append_op(
            "go",
            {"X": [parent_block.var(n) for n in x_names]},
            {},
            {"sub_block": sub_block},
        )
        return res


class Select(BlockGuard):
    """reference concurrency.py Select:199 — wait on several channel
    operations, run the sub-block of whichever becomes ready first.

        with Select() as sel:
            with sel.case(channel_recv, ch, out_var):
                ...consume...
            with sel.default():
                ...nothing ready...
    """

    SEND, RECV, DEFAULT = 0, 1, 2

    def __init__(self, name=None):
        self.helper = LayerHelper("select", name=name)
        super().__init__(self.helper.main_program)
        self.cases = []  # (kind, channel name, value name, sub_block)

    class _CaseGuard(BlockGuard):
        def __init__(self, select, kind, channel, value):
            super().__init__(select.main_program)
            self.select = select
            self.kind = kind
            self.channel = channel
            self.value = value

        def __exit__(self, exc_type, exc_val, exc_tb):
            if exc_type is not None:
                return super().__exit__(exc_type, exc_val, exc_tb)
            sub_block = self.main_program.current_block()
            res = super().__exit__(exc_type, exc_val, exc_tb)
            self.select.cases.append(
                (self.kind,
                 self.channel.name if self.channel is not None else "",
                 self.value.name if isinstance(self.value, Variable) else "",
                 sub_block))
            return res

    def case(self, op, channel, value):
        kind = Select.SEND if op is channel_send else Select.RECV
        return Select._CaseGuard(self, kind, channel, value)

    def default(self):
        return Select._CaseGuard(self, Select.DEFAULT, None, None)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return super().__exit__(exc_type, exc_val, exc_tb)
        sub_block = self.main_program.current_block()
        res = super().__exit__(exc_type, exc_val, exc_tb)
        parent_block = self.main_program.block(sub_block.parent_idx)
        parent_block.append_op(
            "select", {}, {},
            {"sub_block": sub_block,
             "cases": [(k, ch, v) for k, ch, v, _ in self.cases],
             "case_blocks": [b for _, _, _, b in self.cases]},
        )
        return res
