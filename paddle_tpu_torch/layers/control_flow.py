"""Control-flow layers (reference python/paddle/fluid/layers/
control_flow.py): the comparison and counter helpers of the JAX package's
paddle_tpu/layers/control_flow.py. `While`, `Switch`, `IfElse`, the RNN
builders and the tensor arrays come with the control-flow slice."""

from ..layer_helper import LayerHelper

__all__ = ["increment", "less_than", "equal", "zeros_like"]


def less_than(x, y, cond=None, **ignored):
    helper = LayerHelper("less_than", **locals())
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool", shape=x.shape)
        cond.stop_gradient = True
    helper.append_op("less_than", {"X": [x], "Y": [y]}, {"Out": [cond]})
    return cond


def equal(x, y, cond=None, **ignored):
    helper = LayerHelper("equal", **locals())
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool", shape=x.shape)
        cond.stop_gradient = True
    helper.append_op("equal", {"X": [x], "Y": [y]}, {"Out": [cond]})
    return cond


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", **locals())
    if not in_place:
        out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    else:
        out = x
    helper.append_op("increment", {"X": [x]}, {"Out": [out]},
                     {"step": float(value)})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like", **locals())
    if out is None:
        out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op("fill_zeros_like", {"X": [x]}, {"Out": [out]})
    return out
