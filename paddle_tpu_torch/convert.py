"""Carry a program's persistable state between the JAX package and the
port as plain numpy.

The same layer calls under a fresh `unique_name.guard()` give the same var
names in both packages, so a `{var name: np.ndarray}` dict maps one to one:
`numpy_state` reads the port's scope into such a dict, and
`load_numpy_state` places one — for example built from a JAX scope with
`np.asarray(jax_scope.find_var(name))` — into the port's scope, after
checking every array against the program's declared shape and dtype.
State crosses in that full layout under ParallelExecutor's zero1 too: a
rank keeps its row of a loaded accumulator at its next step
(parallel/zero1.py), and `numpy_state` gathers the rows back.
"""

import numpy as np
import torch

from .core import dtypes
from .core.framework import VarType
from .core.places import device_for
from .parallel import zero1


def _persistable_vars(program):
    """The persistable vars of `program` that hold tensors: not its reader
    vars, whose readers are host objects (ops/reader_ops.py)."""
    return {n: v for b in program.blocks for n, v in b.vars.items()
            if v.persistable and v.type != VarType.READER}


def load_numpy_state(scope, program, arrays, place):
    """Place `arrays` ({name: np.ndarray}) into `scope` on `place`'s device.
    Every persistable var of `program` must be present with its declared
    shape; int arrays may arrive narrower than declared (the JAX package
    runs int64 vars as int32) and are widened. Raises on a missing or
    mis-shaped array, and on a name the program does not declare."""
    device = device_for(place)
    want = _persistable_vars(program)
    unknown = sorted(set(arrays) - set(want))
    if unknown:
        raise KeyError(f"arrays name vars the program does not declare as "
                       f"persistable: {unknown[:5]}")
    missing = sorted(set(want) - set(arrays))
    if missing:
        raise KeyError(f"no array for persistable vars {missing[:5]}")
    for name, var in want.items():
        arr = np.asarray(arrays[name])
        if var.shape is not None and tuple(arr.shape) != tuple(var.shape):
            raise ValueError(f"{name}: array shape {arr.shape} != declared "
                             f"{tuple(var.shape)}")
        kind, declared = arr.dtype.kind, dtypes.canonicalize(var.dtype)
        if (kind == "f") != dtypes.is_float(declared):
            raise ValueError(f"{name}: array dtype {arr.dtype} does not "
                             f"match declared {declared}")
        scope.var(name)
        scope.set_var(name, torch.from_numpy(np.array(arr, copy=True)).to(
            device=device, dtype=dtypes.to_torch(declared)))


def numpy_state(scope, program):
    """{name: np.ndarray} of every persistable var of `program` in scope,
    in the full layout: a zero1 accumulator, of which this rank holds its
    row, is gathered over the ranks (parallel.zero1.full_layout), so every
    rank of a ParallelExecutor calls this together."""
    out = {}
    # sorted: the gathers are collectives, issued in one order on every rank
    for name in sorted(_persistable_vars(program)):
        v = scope.find_var(name)
        if v is not None:
            # a copy: the scope's tensors may be updated in place
            out[name] = zero1.full_layout(name, v).detach().to(
                "cpu", copy=True).numpy()
    return out
