"""Learning-rate decay schedules (reference python/paddle/fluid/layers/
learning_rate_scheduler.py), as the JAX package's
paddle_tpu/layers/learning_rate_scheduler.py builds them: ops on the
global step counter (nn.autoincreased_step_counter, an int64 persistable
that an `increment` op advances at the start of every step), so the
learning rate is computed on the device inside the step, and a captured
step computes each replay's from the counter it advances."""

import math

from .nn import autoincreased_step_counter
from . import control_flow
from . import tensor
from . import ops

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay",
]


def _decay_step_counter(begin=0):
    global_step = autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return tensor.cast(global_step, "float32")


def noam_decay(d_model, warmup_steps):
    global_step = _decay_step_counter(1)
    a = ops.pow(global_step, factor=-0.5)
    b = ops.scale(global_step, scale=warmup_steps ** -1.5)
    lr_value = ops.elementwise_min(a, b)
    return ops.scale(lr_value, scale=d_model ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = ops.scale(global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    # lr * decay_rate ^ div_res = lr * exp(div_res * ln(decay_rate))
    exponent = ops.scale(div_res, scale=math.log(decay_rate))
    return ops.scale(ops.exp(exponent), scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = ops.scale(global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return ops.scale(ops.exp(ops.scale(div_res, scale=-decay_rate)),
                     scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _decay_step_counter()
    div_res = ops.scale(global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    denom = ops.scale(div_res, scale=decay_rate, bias=1.0,
                      bias_after_scale=True)
    return ops.scale(ops.reciprocal(denom), scale=float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(ops.scale(global_step, scale=1.0 / decay_steps))
        # at step 0 ceil gives 0: use max(div, 1)
        one = tensor.fill_constant(shape=(1,), dtype="float32", value=1.0)
        div_res = ops.elementwise_max(div_res, one)
        decay_steps_var = ops.scale(div_res, scale=float(decay_steps))
        ratio = ops.elementwise_div(global_step, decay_steps_var)
    else:
        ratio = ops.scale(global_step, scale=1.0 / decay_steps)
        one = tensor.fill_constant(shape=(), dtype="float32", value=1.0)
        ratio = ops.elementwise_min(ratio, one)
    # (lr - end) * (1 - ratio) ^ power + end
    base = ops.scale(ratio, scale=-1.0, bias=1.0)
    powd = ops.pow(base, factor=power)
    return ops.scale(powd,
                     scale=float(learning_rate) - float(end_learning_rate),
                     bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """values[i] while the step counter is below boundaries[i], then the
    last value: a persistable learning rate that a Switch of conditional
    blocks assigns at every step (ops/control_flow_ops.py keeps each
    block's write where its case holds, so the step stays capturable)."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) - len(boundaries) should be 1")
    global_step = _decay_step_counter()
    from .. import unique_name
    from ..layer_helper import LayerHelper

    helper = LayerHelper("piecewise_decay")
    lr = helper.create_or_get_global_variable(
        unique_name.generate("learning_rate"), "float32", (1,), persistable=True
    )
    from ..initializer import Constant

    helper.set_variable_initializer(lr, Constant(values[0]))
    with control_flow.Switch() as switch:
        for i in range(len(boundaries)):
            boundary_val = tensor.fill_constant(shape=(1,), dtype="float32",
                                                value=float(boundaries[i]))
            value_var = tensor.fill_constant(shape=(1,), dtype="float32",
                                             value=float(values[i]))
            with switch.case(control_flow.less_than(global_step, boundary_val)):
                tensor.assign(value_var, lr)
        last_value_var = tensor.fill_constant(shape=(1,), dtype="float32",
                                              value=float(values[len(values) - 1]))
        with switch.default():
            tensor.assign(last_value_var, lr)
    return lr
