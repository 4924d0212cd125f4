"""Host IO ops: save/load (+combine) and delete_var, in the JAX package's
file format (paddle_tpu/ops/io_ops.py), so either package reads the
other's files.

One var is a numpy `.npy` file, plus a `.lod.json` sidecar holding the
sequence lengths of a ragged value; save_combine packs several vars into
one `.npz`. The arrays are written as the JAX package holds them: it runs
with 64-bit types off, so an int64 var is written as int32 and a float64
one as float32. A load lands on the executor's device as the var's
declared dtype. These are host ops (core/executor_core.py HOST_OPS): a
program holding one runs on the interpreter, never in a CUDA graph.

Under ParallelExecutor's zero1 a rank holds its [1, shard] row of each
sharded accumulator: a save writes the whole [W, shard] array, gathered
over the ranks, as the JAX package does, and a load gives each rank its
row of it (parallel/zero1.py saved_layout, loaded_row). A var sharded
over the mp axis is written whole, gathered over its ranks
(parallel/autoshard/lower.py full_value); a load leaves it whole, and the
next ParallelExecutor step keeps the rank's slice.
"""

import json
import os

import numpy as np
import torch

from ..core import dtypes
from ..core.registry import SeqTensor, register_op
from ..parallel import zero1
from ..parallel.autoshard import lower as _lower
from .util import first, many, out

# the JAX package runs with 64-bit types off: what it writes is 32-bit
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32}


def _host(t):
    """A tensor as the numpy array the JAX package would write for it."""
    if t.dtype == torch.bfloat16:
        raise TypeError(
            "save: a bfloat16 tensor has no numpy dtype; persistables are "
            "float32 master state, also under amp")
    a = t.detach().cpu().numpy()
    narrow = _NARROW.get(a.dtype)
    return a.astype(narrow) if narrow is not None else a


def _to_numpy(v):
    if isinstance(v, SeqTensor):
        return _host(v.data), _host(v.lengths).astype(np.int32)
    return _host(v), None


def _save_one(path, v):
    data, lengths = _to_numpy(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path + ".npy", data, allow_pickle=False)
    if lengths is not None:
        with open(path + ".lod.json", "w") as f:
            json.dump({"lengths": lengths.tolist()}, f)


def _on_device(ctx, data, name):
    """`data` (numpy) as a tensor on the step's device, of the dtype the
    op's block declares for var `name`."""
    var = ctx.current_op.block.vars.get(name)
    dtype = dtypes.to_torch(var.dtype) if var is not None \
        and var.dtype is not None else None
    return torch.from_numpy(np.array(data, copy=True)).to(
        device=ctx.device, dtype=dtype)


def _value(ctx, name, data, lengths):
    t = _on_device(ctx, data, name)
    if lengths is None:
        return zero1.loaded_row(name, t)
    host = np.asarray(lengths, np.int32)
    return SeqTensor(t, torch.from_numpy(host.copy()).to(ctx.device), host)


def _load_one(ctx, name, path):
    data = np.load(path + ".npy", allow_pickle=False)
    lengths = None
    lod_path = path + ".lod.json"
    if os.path.exists(lod_path):
        with open(lod_path) as f:
            lengths = json.load(f)["lengths"]
    return _value(ctx, name, data, lengths)


@register_op("save", lod_aware=True)
def save_op(ctx, ins, attrs):
    x = first(ins, "X")
    path = attrs["file_path"]
    if os.path.exists(path + ".npy") and not attrs.get("overwrite", True):
        raise RuntimeError(f"{path} exists and overwrite=False")
    name = ctx.current_op.input("X")[0]
    _save_one(path, _lower.full_value(name, zero1.saved_layout(name, x)))
    return {}


@register_op("load", lod_aware=True)
def load_op(ctx, ins, attrs):
    name = ctx.current_op.output("Out")[0]
    return out(Out=_load_one(ctx, name, attrs["file_path"]))


@register_op("save_combine", lod_aware=True)
def save_combine_op(ctx, ins, attrs):
    xs = many(ins, "X")
    names = ctx.current_op.input("X")
    path = attrs["file_path"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for n, v in zip(names, xs):
        data, lengths = _to_numpy(
            _lower.full_value(n, zero1.saved_layout(n, v)))
        arrays[n] = data
        if lengths is not None:
            arrays[n + "@@lod"] = lengths
    np.savez(path, **arrays)
    if not path.endswith(".npz"):
        os.replace(path + ".npz", path)
    return {}


@register_op("load_combine", lod_aware=True)
def load_combine_op(ctx, ins, attrs):
    z = np.load(attrs["file_path"], allow_pickle=False)
    vals = [_value(ctx, n, z[n], z[n + "@@lod"] if n + "@@lod" in z
                   else None)
            for n in ctx.current_op.output("Out")]
    return out(Out=vals)


@register_op("delete_var", lod_aware=True)
def delete_var_op(ctx, ins, attrs):
    for n in ctx.current_op.input("X"):
        if ctx.env is not None:
            ctx.env.pop(n, None)
        if ctx.scope is not None:
            ctx.scope.erase(n)
    return {}
