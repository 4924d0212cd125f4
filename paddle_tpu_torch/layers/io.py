"""IO layers (reference python/paddle/fluid/layers/io.py). The port carries
`data` only; ListenAndServ, Send/Recv and the reader family wait for the
slices that port the parameter server and the input path."""

from ..layer_helper import LayerHelper
from ..core.framework import VarType

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """reference layers/io.py:30."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    for i in range(len(shape)):
        if shape[i] is None:
            shape[i] = -1
            append_batch_size = False
        elif shape[i] < 0:
            append_batch_size = False
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name,
        shape=shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
    )
