"""CSP op kernels: channel_create/send/recv/close, go, select.

Reference parity: operators/{go,channel_send,channel_recv,channel_close,
select}_op.cc over framework/channel.h:33, as the JAX package runs them
(paddle_tpu/ops/concurrency_ops.py). All six are host ops
(core/executor_core.py HOST_OPS): CSP is control-plane threading, exactly
as the reference runs it, while any math inside a Go/Select sub-block
runs through the same kernels on the interpreter. A goroutine runs on a
daemon thread, on the card of the step and on a CUDA stream of its own,
after the work its parent enqueued so far; channels order a sent tensor's
reads after its writes (concurrency.Channel). An exception in a goroutine
is reported by the thread's own hook (threading.excepthook), as an
uncaught exception of any thread is.
"""

import queue
import threading
import time

import torch

from ..core.registry import register_op
from .util import first, out


def _status(ctx, ok):
    return torch.tensor([bool(ok)], device=ctx.device)


@register_op("channel_create", lod_aware=True)
def channel_create_op(ctx, ins, attrs):
    from ..concurrency import Channel

    return out(Out=Channel(capacity=int(attrs.get("capacity", 0))))


@register_op("channel_send", lod_aware=True)
def channel_send_op(ctx, ins, attrs):
    ch = first(ins, "Channel")
    ch.send(first(ins, "X"))
    return out(Status=_status(ctx, True))


@register_op("channel_recv", lod_aware=True)
def channel_recv_op(ctx, ins, attrs):
    ch = first(ins, "Channel")
    value, ok = ch.recv()
    res = {"Status": [_status(ctx, ok)]}
    if ok:
        res["Out"] = [value]
    return res


@register_op("channel_close", lod_aware=True)
def channel_close_op(ctx, ins, attrs):
    first(ins, "Channel").close()
    return {}


@register_op("go", lod_aware=True)
def go_op(ctx, ins, attrs):
    """Run the sub-block on a daemon thread (goroutine). The thread gets a
    snapshot of the spawning env — channel objects are shared by reference,
    which is the CSP communication path; plain tensors copy in like the
    reference's captured inputs. On a card the goroutine's stream first
    waits for what the spawning stream has enqueued."""
    from ..core import executor_core

    block = attrs["sub_block"]
    env_snapshot = dict(ctx.env)
    place, rng, scope, device = ctx.place, ctx.rng, ctx.scope, ctx.device
    spawned = None
    if device.type == "cuda":
        spawned = torch.cuda.Event()
        spawned.record(torch.cuda.current_stream(device))

    def body():
        thread_ctx = executor_core.OpContext(place, rng, scope=scope)
        executor_core.run_ops(block.ops, env_snapshot, thread_ctx)

    def run():
        if spawned is None:
            body()
            return
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            stream.wait_event(spawned)
            with torch.cuda.stream(stream):
                body()

    threading.Thread(target=run, daemon=True).start()
    return {}


@register_op("select", lod_aware=True)
def select_op(ctx, ins, attrs):
    """Wait until one case's channel operation can proceed, perform it,
    then run that case's sub-block (reference select_op.cc)."""
    cases = attrs["cases"]           # [(kind, channel name, value name)]
    blocks = attrs["case_blocks"]
    env = ctx.env
    SEND, RECV, DEFAULT = 0, 1, 2

    def run_case(i, extra=None):
        if extra:
            env.update(extra)
        ctx.run_block(blocks[i], env)

    while True:
        default_idx = None
        for i, (kind, ch_name, val_name) in enumerate(cases):
            if kind == DEFAULT:
                default_idx = i
                continue
            ch = env.get(ch_name)
            if ch is None:
                continue
            if kind == RECV:
                # non-blocking attempt: a can_recv()-then-recv() pair races
                # other selects on the same channel (the loser would block
                # past its default case)
                try:
                    value, ok = ch.try_recv()
                except queue.Empty:
                    continue
                run_case(i, {val_name: value} if ok and val_name else None)
                return {}
            if kind == SEND and ch.try_send(env[val_name]):
                run_case(i)
                return {}
        if default_idx is not None:
            run_case(default_idx)
            return {}
        time.sleep(0.001)
