"""LayerHelper (reference python/paddle/fluid/layer_helper.py): shared
machinery for layer functions — parameter creation (+ init op into the
startup program), temp vars, bias/activation application."""

import copy

from .core.framework import (
    Parameter,
    Variable,
    default_main_program,
    default_startup_program,
)
from .core import dtypes
from . import unique_name
from .param_attr import ParamAttr
from .initializer import Constant, Xavier

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name", None)
        if name is None:
            self.kwargs["name"] = unique_name.generate(self.layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.main_program.current_block().append_op(type, inputs, outputs, attrs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            inputs = [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise f"{self.layer_type} layer takes only one input"
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr", None))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError("parameter number mismatch")
        elif len(param_attr) == 1 and length != 1:
            tmp = [None] * length
            for i in range(length):
                tmp[i] = copy.deepcopy(param_attr[0])
            param_attr = tmp
        return param_attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, param_attr in zip(inputs, param_attrs):
            yield ipt, param_attr

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("Data Type mismatch")
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False, default_initializer=None):
        assert isinstance(attr, ParamAttr)
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w"]))
        startup_block = self.startup_program.global_block()
        sp_param = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs(with_initializer=True)
        )
        attr.initializer(sp_param, startup_block)
        main_block = self.main_program.global_block()
        return main_block.create_parameter(
            shape=shape, dtype=dtype, name=attr.name, **{
                k: v for k, v in attr.to_kwargs().items() if k != "name"
            }
        )

    def get_parameter(self, name):
        param = self.main_program.global_block().var(name)
        if not isinstance(param, Parameter):
            raise ValueError(f"no Parameter name {name} found")
        return param

    def create_tmp_variable(self, dtype, shape=None, stop_gradient=False, lod_level=0):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            shape=shape,
            lod_level=lod_level,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs
        )

    def create_or_get_global_variable(self, name, dtype, shape, persistable=True):
        gb = self.main_program.global_block()
        if gb.has_var(name):
            return gb.var(name)
        var = gb.create_var(name=name, dtype=dtype, shape=shape, persistable=persistable)
        return var

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        startup_block.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype, persistable=True
        )
        initializer(var, startup_block)
        return var

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        """Add a bias over dims [dim_start, dim_end) of input."""
        size = list(input_var.shape[dim_start:dim_end]) if input_var.shape else None
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_tmp_variable(dtype=input_var.dtype, shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op(
            "elementwise_add",
            {"X": [input_var], "Y": [b]},
            {"Out": [tmp]},
            {"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = copy.deepcopy(act)
        act_type = act.pop("type")
        tmp = input_var
        if "use_cudnn" in self.kwargs:
            act.pop("use_cudnn", None)
        tmp = self.create_tmp_variable(dtype=input_var.dtype, shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op(act_type, {"X": [input_var]}, {"Out": [tmp]}, act)
        return tmp

    def is_instance(self, param_name, cls):
        param = self.kwargs.get(param_name, None)
        if not isinstance(param, cls):
            raise TypeError(f"The input {param_name} should be {cls}")
