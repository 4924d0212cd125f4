"""Dtype registry: canonical string names <-> torch dtypes.

Reference parity: framework.proto VarType (:94) dtype enum +
platform/float16.h. int64 stays a real 64-bit integer here (the JAX
package runs with x64 off and truncates it to int32).
"""

import numpy as np
import torch

# canonical name -> torch dtype
_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
    "fp16": "float16",
    "bf16": "bfloat16",
    "fp32": "float32",
    "fp64": "float64",
}

FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def canonicalize(dtype):
    """Return the canonical string name of a dtype given as str, numpy
    dtype, python type or torch dtype."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = np.dtype(dtype).name if not hasattr(dtype, "name") \
            else dtype.name
    name = _ALIASES.get(name, name)
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"Unknown dtype: {dtype!r}")
    return name


def to_torch(dtype):
    return _NAME_TO_DTYPE[canonicalize(dtype)]


def is_float(dtype):
    return canonicalize(dtype) in FLOAT_DTYPES


def to_host(value):
    """A tensor as numpy, after one device-to-host copy; bf16, which numpy
    lacks, widened to float32 (exactly). Anything else through
    np.asarray."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)
