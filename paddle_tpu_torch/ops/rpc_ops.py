"""Distributed RPC ops: send_vars / send_barrier / recv / fetch_barrier /
send / listen_and_serv, and the pserver checkpoint.

Reference parity: operators/send_vars_op.cc, send_barrier_op.cc, recv_op.cc,
fetch_barrier_op.cc, send_op.cc:29, listen_and_serv_op.{h:36,cc} (sync loop,
ParallelExecuteBlocks:54, port save); the JAX package's
paddle_tpu/ops/rpc_ops.py. The transport is the TCP variable runtime of
parallel/rpc.py. All six are host ops with side effects
(core/executor_core.py HOST_OPS): a program holding one runs on the
interpreter, as the reference runs RPC ops on the CPU control plane while
the dense math rides the device.

The trainer's `recv` (and `send`'s fetch) returns a received parameter
as a new tensor on the step's device; the Executor writes it into the
scope, and a captured step of another program sharing the scope copies
it into the tensor its graph reads before its next replay
(`CapturedStep.sync_scope`). `listen_and_serv` runs its optimize, table and prefetch
blocks on the place of the Executor that runs the pserver program: on a
card unless that Executor was given CPUPlace().
"""

import collections
import contextlib
import os
import sys
import threading
import time

import numpy as np
import torch

from ..core import registry
from ..core.dtypes import to_host
from ..core.lod_tensor import LoDTensor
from ..core.places import CUDAPlace, device_for
from ..core.registry import SeqTensor, register_op
from ..core.selected_rows import SelectedRows, SparseTable
from ..parallel import rpc as rpc_runtime

# seconds a parameter-server RPC (send, get, barrier, prefetch) waits for
# its reply before it raises (the reference Fluid's FLAGS_rpc_deadline
# default, 180 s); a sync round's get waits for the slowest trainer's step
RPC_DEADLINE_S = 180.0

# host seconds ("<part>_s") and bytes ("<part>_bytes") of the trainer's RPC
# ops by part: compute_wait (the send's wait for the step's device work),
# send (device-to-host copies and the wire), send_barrier (the pservers'
# round), recv (the wire and host-to-device copies), fetch_barrier,
# prefetch (and prefetch_rows); reset_stats() zeroes them. `send_event` is
# a CUDA event recorded where the last send found the step's device work
# queued (its compute ends there).
stats = collections.Counter()
send_event = None


def reset_stats():
    global send_event
    stats.clear()
    send_event = None


@contextlib.contextmanager
def _timed(part):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats[part + "_s"] += time.perf_counter() - t0


# (thread, endpoint) -> VariableClient: one connection per endpoint for
# each thread, so trainers in threads of one process do not share a socket
_client_cache = {}
_client_lock = threading.Lock()


def _client(ep):
    key = (threading.get_ident(), ep)
    with _client_lock:
        c = _client_cache.get(key)
    if c is None:
        c = rpc_runtime.VariableClient(ep, timeout=RPC_DEADLINE_S)
        with _client_lock:
            _client_cache[key] = c
    return c


def reset_clients():
    """Shut down every cached client (each asks its server to stop), as
    the JAX package's reset_clients does."""
    with _client_lock:
        clients = list(_client_cache.values())
        _client_cache.clear()
    for c in clients:
        try:
            c.shutdown()
        except OSError:
            pass


def _send(ctx, ins, attrs):
    global send_event
    if ctx.device.type == "cuda":
        # the first copy to the host would wait for the step's device work
        # anyway; waiting here first keeps that time out of the send's
        with _timed("compute_wait"):
            send_event = torch.cuda.Event(enable_timing=True)
            send_event.record()
            send_event.synchronize()
    wire_names = attrs.get("send_as") or ctx.current_op.input("X")
    with _timed("send"):
        for value, wire, ep in zip(ins.get("X", []), wire_names,
                                   attrs["epmap"]):
            stats["send_bytes"] += _client(ep).send_var(wire, value)


def to_device(value, device):
    """A received value as the step's: a numpy array a tensor on `device`,
    a LoDTensor with a LoD a SeqTensor, a SelectedRows of numpy one of
    tensors; a SparseTable (a host object) as it is."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value).to(device)
    if isinstance(value, SelectedRows):
        return SelectedRows(to_device(np.asarray(value.rows), device),
                            to_device(np.asarray(value.values), device),
                            value.height)
    if isinstance(value, LoDTensor):
        data = to_device(np.asarray(value.numpy()), device)
        if not value.lod():
            return data
        lengths = np.diff(np.asarray(value.last_level_offsets())).astype(
            np.int32)
        return SeqTensor(data, torch.from_numpy(lengths).to(device), lengths)
    return value


def _recv(ctx, attrs):
    names = ctx.current_op.output("Out")
    out = []
    with _timed("recv"):
        for name, ep in zip(names, attrs["epmap"]):
            value = _client(ep).get_var(name)
            stats["recv_bytes"] += getattr(value, "nbytes", 0)
            out.append(to_device(value, ctx.device))
    return out


def _barrier(kind, endpoints):
    with _timed(kind):
        for ep in endpoints:
            getattr(_client(ep), "batch_barrier" if kind == "send_barrier"
                    else "fetch_barrier")()


@register_op("send_vars", lod_aware=True)
def send_vars_op(ctx, ins, attrs):
    """Send each of X to its pserver (`epmap`) under its wire name
    (`send_as`: the multi-trainer `.trainer_<id>` names)."""
    _send(ctx, ins, attrs)
    return {}


@register_op("send_barrier")
def send_barrier_op(ctx, ins, attrs):
    _barrier("send_barrier", attrs["endpoints"])
    return {}


@register_op("recv", lod_aware=True)
def recv_op(ctx, ins, attrs):
    """Get each of Out from its pserver, as a new tensor on the step's
    device (see the module docstring)."""
    return {"Out": _recv(ctx, attrs)}


@register_op("fetch_barrier")
def fetch_barrier_op(ctx, ins, attrs):
    _barrier("fetch_barrier", attrs["endpoints"])
    return {}


@register_op("send", lod_aware=True)
def send_op(ctx, ins, attrs):
    """Send the grads, barrier, fetch the params, barrier (reference
    send_op.cc:29; layers.Send). Takes the `send_as` wire names as
    send_vars does."""
    _send(ctx, ins, attrs)
    eps = sorted(set(attrs["epmap"]))
    _barrier("send_barrier", eps)
    result = {}
    if ctx.current_op.output("Out"):
        result["Out"] = _recv(ctx, attrs)
    _barrier("fetch_barrier", eps)
    return result


# ---------------------------------------------------------------------------
# Pserver checkpointing (reference go/pserver/service.go:146 Checkpoint /
# :175 LoadCheckpoint: a CRC-guarded dump of params and optimizer state so
# a restarted pserver resumes where it died).
# ---------------------------------------------------------------------------
def save_pserver_checkpoint(path, scope, names):
    """Dump `names` of `scope` (tensors as numpy, a SparseTable whole) to
    `path` (rpc.dump_crc_blob)."""
    state = {}
    for n in names:
        v = scope.find_var(n)
        if v is None:
            continue
        state[n] = v if isinstance(v, SparseTable) else \
            to_host(v)
    rpc_runtime.dump_crc_blob(path, state)


def load_pserver_checkpoint(path, scope, device=None):
    """Put the state of `path` back into `scope`, tensors on `device` (a
    torch.device or its name); returns the names, sorted. With no device
    the tensors go to the card, CUDAPlace(0), which raises where there is
    none: the host only when the caller names it."""
    device = device_for(CUDAPlace(0)) if device is None else \
        torch.device(device)
    state = rpc_runtime.load_crc_blob(path)
    for n, v in state.items():
        scope.var(n)
        scope.set_var(n, to_device(v, device))
    return sorted(state)


@register_op("listen_and_serv", lod_aware=True)
def listen_and_serv_op(ctx, ins, attrs):
    """Blocking pserver service (reference listen_and_serv_op.cc): receive
    grad shards from Fanin trainers, run the optimize sub-blocks, serve
    the updated params; returns when a client sends exit. Its blocks run
    on this op's place (an Executor of ctx.place); a received tensor is
    copied to that device once, at receipt."""
    from ..executor import Executor

    scope = ctx.scope
    endpoint = attrs["endpoint"]
    fan_in = int(attrs.get("Fanin", 1))
    sync_mode = attrs.get("sync_mode", True)
    opt_blocks = attrs.get("OptimizeBlocks") or (
        [attrs["OptimizeBlock"]] if attrs.get("OptimizeBlock") else [])

    exe = Executor(ctx.place)
    device = exe.device

    # a restarted pserver restores params and optimizer state (and its
    # sparse table) from its last checkpoint before serving
    ckpt_path = attrs.get("checkpoint_path")
    ckpt_every = int(attrs.get("checkpoint_every", 1))
    if ckpt_path and os.path.exists(ckpt_path):
        try:
            load_pserver_checkpoint(ckpt_path, scope, device)
        except (IOError, EOFError, ValueError) as e:
            # a torn checkpoint must not brick the pserver: it serves its
            # startup's params and checkpoints afresh
            print(f"[paddle_tpu_torch] WARNING: ignoring unreadable "
                  f"pserver checkpoint {ckpt_path!r}: {e}", file=sys.stderr)
    persistables = sorted({
        n for blk in ctx.current_op.block.program.blocks
        for n, v in blk.vars.items() if v.persistable
    }) if ckpt_path else []
    rounds = [0]

    def checkpoint():
        if ckpt_path:
            rounds[0] += 1
            if rounds[0] % ckpt_every == 0:
                save_pserver_checkpoint(ckpt_path, scope, persistables)

    def get_var(name):
        v = scope.find_var(name)
        if v is None:
            raise KeyError(name)
        return v

    def put_var(name, value):
        scope.var(name)
        scope.set_var(name, to_device(value, device))

    def on_round(received):
        # each param shard's optimize block, in order (reference
        # ParallelExecuteBlocks)
        for block in opt_blocks:
            exe.run_block_eager(block, scope)
        checkpoint()

    # async mode: one optimize block a grad (grad_to_block_id)
    grad_to_block = {}
    for entry in attrs.get("grad_to_block_id", []):
        gname, bidx = entry.rsplit(":", 1)
        for b in opt_blocks:
            if getattr(b, "idx", None) == int(bidx):
                grad_to_block[gname] = b

    def on_grad(name):
        block = grad_to_block.get(name)
        if block is not None:
            exe.run_block_eager(block, scope)
        checkpoint()

    # distributed lookup table: a prefetch runs the transpiler's prefetch
    # block (lookup_sparse_table over this pserver's shard)
    prefetch_block = attrs.get("PrefetchBlock")
    pf_in = attrs.get("prefetch_in_name")
    pf_out = attrs.get("prefetch_out_name")

    def on_prefetch(table_name, ids):
        scope.var(pf_in)
        scope.set_var(pf_in, np.asarray(ids).reshape(-1, 1))
        # the out slot exists in the scope, so the block's write-back
        # (persistable or existing vars only) keeps it
        scope.var(pf_out)
        scope.set_var(pf_out, np.zeros((0,), np.float32))
        exe.run_block_eager(prefetch_block, scope)
        return scope.find_var(pf_out)

    host, _, port = endpoint.rpartition(":")
    server = rpc_runtime.VariableServer(
        bind=f"{host or '127.0.0.1'}:{port or 0}", num_trainers=fan_in,
        get_var=get_var, put_var=put_var, on_round=on_round,
        sync_mode=sync_mode, on_grad=on_grad,
        on_prefetch=on_prefetch if prefetch_block is not None else None)
    try:
        server.save_port()
        server.serve_forever()
    finally:
        server.close()
    return {}


# listen_and_serv's X inputs are the recv buffers, made only when trainers
# send
registry.set_lazy_inputs("listen_and_serv")
