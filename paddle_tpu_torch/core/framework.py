"""Program IR: Program / Block / Operator / Variable / Parameter.

Reference parity: paddle/fluid/framework/framework.proto (ProgramDesc:179,
BlockDesc:166, OpDesc:34, VarDesc:160) and python/paddle/fluid/framework.py
(Variable:119, Operator:365, Block:684, Program:1021). This build keeps the IR
in plain Python (serialized to JSON for save_inference_model) — the IR's job
on TPU is to be a *traceable* description that the Executor lowers to one XLA
computation, not a wire format for a C++ interpreter.

Key semantic carry-overs:
  - blocks with parent links (sub-blocks for control flow ops)
  - ops hold {slot -> [var names]} inputs/outputs + attrs (attrs may hold
    Block references for control flow)
  - persistable vars live across runs (parameters, optimizer state)
  - Program.clone(for_test), prune(targets), inference_optimize
  - default main/startup program globals + program_guard
"""

import contextlib
import copy
import json
import re

import numpy as np

from . import dtypes
from .. import unique_name

GRAD_VAR_SUFFIX = "@GRAD"
ZERO_VAR_SUFFIX = "@ZERO"
TEMP_VAR_NAME = "_generated_var"


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


# ---------------------------------------------------------------------------
# Op role attrs (reference: op_proto_maker.h OpRole) — used by transpilers and
# ParallelExecutor to identify forward/backward/optimize/RPC ops.
# ---------------------------------------------------------------------------
class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Loss = 256  # bit flag OR'd with Forward


OP_ROLE_ATTR_NAME = "op_role"
OP_ROLE_VAR_ATTR_NAME = "op_role_var"


class VarType:
    """Reference framework.proto VarType:94."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    READER = "reader"
    FETCH_LIST = "fetch_list"
    FEED_MINIBATCH = "feed_minibatch"
    STEP_SCOPES = "step_scopes"
    LOD_RANK_TABLE = "lod_rank_table"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    RAW = "raw"


class Variable:
    """A symbolic variable in a Block (reference framework.py:119).

    shape uses -1 for the (leading) dynamic batch dimension.
    """

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype=None,
        lod_level=0,
        persistable=False,
        stop_gradient=False,
        is_data=False,
        type=VarType.LOD_TENSOR,
        initializer=None,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate(TEMP_VAR_NAME)
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtypes.canonicalize(dtype) if dtype is not None else "float32"
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.initializer = initializer
        self.error_clip = kwargs.get("error_clip", None)
        # user-declared mesh placement (parallel.set_sharding): a tuple of
        # mesh-axis names / None per dim, honored by ParallelExecutor
        self.sharding = kwargs.get("sharding", None)

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "type": self.type,
            "is_parameter": isinstance(self, Parameter),
        }

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype}, "
            f"lod_level={self.lod_level}, persistable={self.persistable})"
        )

    __str__ = __repr__

    # -- operator sugar (reference layers.ops elementwise overloads) --------
    def _binary(self, other, op):
        from .. import layers

        return layers.elementwise_binary_dispatch(self, other, op)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        # other - self: scale(-1) then add the scalar/tensor
        return (-self) + other

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        from .. import layers

        # other / self via reciprocal (reference layers/ops.py reciprocal op)
        return layers.reciprocal(self) * other

    def __neg__(self):
        from .. import layers

        return layers.scale(self, scale=-1.0)


class Parameter(Variable):
    """A trainable persistable variable (reference framework.py Parameter).

    Carries trainable/optimize_attr/regularizer/gradient_clip metadata used by
    Optimizer, regularizer, and clip passes.
    """

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


# Called (newest first) with each Parameter right after Block.create_parameter
# registers it — parallel.sharding_scope uses this to seed-annotate params
# built inside a layer block without threading state through every layer.
_param_creation_hooks = []


class Operator:
    """An op node: type + {slot: [var names]} inputs/outputs + attrs

    (reference framework.py:365 / framework.proto OpDesc:34). Attr values may
    be python scalars/lists/strings, numpy arrays, or Block references (for
    control-flow ops, mirroring AttrType BLOCK).
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = _normalize_slots(inputs)
        self.outputs = _normalize_slots(outputs)
        self.attrs = dict(attrs or {})
        # a grad op's forward op (backward.py sets it); not part of the desc
        self.fwd_op = None
        prog = block.program
        self.attrs.setdefault(OP_ROLE_ATTR_NAME, prog._op_role)
        if prog._op_role_var:
            self.attrs.setdefault(OP_ROLE_VAR_ATTR_NAME, list(prog._op_role_var))

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name):
        return self.attrs[name]

    def set_attr(self, name, val):
        self.attrs[name] = val

    def rename_input(self, old, new):
        for slot, names in self.inputs.items():
            self.inputs[slot] = [new if n == old else n for n in names]

    def rename_output(self, old, new):
        for slot, names in self.outputs.items():
            self.outputs[slot] = [new if n == old else n for n in names]

    def to_dict(self):
        def enc_attr(v):
            if isinstance(v, Block):
                return {"__block__": v.idx}
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            return v

        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": {k: enc_attr(v) for k, v in self.attrs.items()},
        }

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{', '.join(self.output_arg_names())}}} = {self.type}({ins}) -> {outs}"


def _normalize_slots(slots):
    """{slot: Variable | name | list of either} -> {slot: [names]}"""
    out = {}
    for k, v in (slots or {}).items():
        if v is None:
            continue
        if not isinstance(v, (list, tuple)):
            v = [v]
        names = []
        for item in v:
            if item is None:
                continue
            names.append(item.name if isinstance(item, Variable) else str(item))
        out[k] = names
    return out


class Block:
    """An ordered op list + var map, with a parent link

    (reference framework.py:684 / framework.proto BlockDesc:166)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}  # name -> Variable
        self.ops = []  # [Operator]

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- vars ---------------------------------------------------------------
    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype", "float32")
        global_block = self.program.global_block()
        param = Parameter(global_block, shape=shape, dtype=dtype, **kwargs)
        global_block.vars[param.name] = param
        for hook in reversed(list(_param_creation_hooks)):
            hook(param)
        return param

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return name in self.vars

    def var_recursive(self, name):
        """Look up through parent blocks (reference Scope parent lookup)."""
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise ValueError(f"Variable {name!r} not found (recursive)")

    def has_var_recursive(self, name):
        try:
            self.var_recursive(name)
            return True
        except ValueError:
            return False

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def rename_var(self, old, new):
        v = self.vars.pop(old)
        v.name = new
        self.vars[new] = v
        for op in self.ops:
            op.rename_input(old, new)
            op.rename_output(old, new)
        return v

    # -- ops ----------------------------------------------------------------
    def _new_op(self, type, inputs, outputs, attrs):
        op = Operator(self, type, inputs, outputs, attrs)
        # compile-time shape contract (reference op_desc.cc InferShape at
        # desc build): validates inputs and sets output shapes so malformed
        # programs fail HERE with op context, not mid-run
        from . import shape_inference

        shape_inference.infer(op, self)
        return op

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = self._new_op(type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._mutation += 1
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = self._new_op(type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._mutation += 1
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = self._new_op(type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._mutation += 1
        return op

    def remove_op(self, index):
        self.program._mutation += 1
        return self.ops.pop(index)

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {n: v.to_dict() for n, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        lines = [f"Block[{self.idx}] parent={self.parent_idx}"]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


class Program:
    """A list of blocks; block 0 is the global block

    (reference framework.py:1021 / framework.proto ProgramDesc:179)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._seed = 0
        self._op_role = OpRole.Forward
        self._op_role_var = []
        self._version = 1
        self._mutation = 0  # bumped on IR edits; part of the compile-cache key

    # -- seeds (reference Program.random_seed) -------------------------------
    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = int(seed)

    # -- block management ----------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def create_block(self, parent_idx=None):
        if parent_idx is None:
            parent_idx = self.current_block_idx
        b = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    # -- op role guards (used by backward/optimizer/transpiler) -------------
    @contextlib.contextmanager
    def optimized_guard(self, param_and_grads):
        prev_role, prev_var = self._op_role, self._op_role_var
        self._op_role = OpRole.Optimize
        self._op_role_var = [
            v.name if isinstance(v, Variable) else str(v) for v in param_and_grads
        ]
        try:
            yield
        finally:
            self._op_role, self._op_role_var = prev_role, prev_var

    @contextlib.contextmanager
    def backward_role_guard(self):
        prev = self._op_role
        self._op_role = OpRole.Backward
        try:
            yield
        finally:
            self._op_role = prev

    # -- clone/prune ---------------------------------------------------------
    def clone(self, for_test=False):
        """Deep copy. for_test=True keeps forward ops only and flips is_test
        attrs (dropout/batch_norm), like the reference's test clone
        (reference framework.py:1085)."""
        p = copy.deepcopy(self)
        if for_test:
            for block in p.blocks:
                block.ops = [
                    op
                    for op in block.ops
                    if op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)
                    in (OpRole.Forward, OpRole.Forward | OpRole.Loss)
                ]
                for op in block.ops:
                    if "is_test" in op.attrs or op.type in ("dropout", "batch_norm"):
                        op.attrs["is_test"] = True
        return p

    def prune(self, targets):
        """Keep only ops needed to compute targets (reference prune, pybind.cc:294)."""
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        target_names = set(
            t.name if isinstance(t, Variable) else str(t) for t in targets
        )
        p = copy.deepcopy(self)
        for block in p.blocks:
            needed = set(target_names)
            kept = []
            for op in reversed(block.ops):
                # optimizer ops alias ParamOut to the param name — walking
                # through them would drag the whole backward in
                role = op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)
                if role not in (OpRole.Forward, OpRole.Forward | OpRole.Loss):
                    continue
                has_sub_block = any(
                    isinstance(v, Block) for v in op.attrs.values()
                )
                if op.type in ("feed", "fetch") or has_sub_block or (
                    set(op.output_arg_names()) & needed
                ):
                    kept.append(op)
                    needed.update(op.input_arg_names())
                    # vars read only inside control-flow sub-blocks are
                    # live too (same rule as executor_core DCE)
                    stack = [
                        v for v in op.attrs.values() if isinstance(v, Block)
                    ]
                    while stack:
                        blk = stack.pop()
                        for sub in blk.ops:
                            needed.update(sub.input_arg_names())
                            stack.extend(
                                v for v in sub.attrs.values()
                                if isinstance(v, Block)
                            )
            block.ops = list(reversed(kept))
            used = set()
            for op in block.ops:
                used.update(op.input_arg_names())
                used.update(op.output_arg_names())
            block.vars = {
                n: v
                for n, v in block.vars.items()
                if n in used or n in target_names
            }
        return p

    def inference_optimize(self):
        """Drop backward/optimize ops, set is_test (reference pybind.cc:304)."""
        p = copy.deepcopy(self)
        for block in p.blocks:
            block.ops = [
                op
                for op in block.ops
                if op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)
                in (OpRole.Forward, OpRole.Forward | OpRole.Loss)
            ]
            for op in block.ops:
                if "is_test" in op.attrs:
                    op.attrs["is_test"] = True
            used = set()
            for op in block.ops:
                used.update(op.input_arg_names())
                used.update(op.output_arg_names())
            block.vars = {n: v for n, v in block.vars.items() if n in used}
        return p

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self):
        return {
            "version": self._version,
            "random_seed": self._seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def to_string(self, throw_on_error=True, with_details=False):
        return json.dumps(self.to_dict(), indent=1)

    def desc_str(self):
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_dict(d):
        p = Program()
        p._seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            p.blocks.append(b)
        for b, bd in zip(p.blocks, d["blocks"]):
            for name, vd in bd["vars"].items():
                vd = dict(vd)  # don't mutate the caller's payload
                cls = Parameter if vd.pop("is_parameter", False) else Variable
                if cls is Parameter:
                    v = Parameter(
                        b,
                        shape=vd["shape"],
                        dtype=vd["dtype"],
                        name=vd["name"],
                        lod_level=vd.get("lod_level", 0),
                        persistable=vd.get("persistable", True),
                        stop_gradient=vd.get("stop_gradient", False),
                        is_data=vd.get("is_data", False),
                        type=vd.get("type", VarType.LOD_TENSOR),
                    )
                else:
                    v = Variable(b, **vd)
                b.vars[name] = v
            for od in bd["ops"]:

                def dec_attr(v):
                    if isinstance(v, dict) and "__block__" in v:
                        return p.blocks[v["__block__"]]
                    if isinstance(v, dict) and "__ndarray__" in v:
                        return np.array(v["__ndarray__"], dtype=v["dtype"])
                    return v

                op = Operator(
                    b,
                    od["type"],
                    {k: v for k, v in od["inputs"].items()},
                    {k: v for k, v in od["outputs"].items()},
                    {k: dec_attr(v) for k, v in od["attrs"].items()},
                )
                b.ops.append(op)
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()


# ---------------------------------------------------------------------------
# Default program globals + guards (reference framework.py:1317-1370)
# ---------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev, _main_program_ = _main_program_, program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev, _startup_program_ = _startup_program_, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


@contextlib.contextmanager
def name_scope(prefix):
    with unique_name.guard_prefix(prefix):
        yield


def _current_op_role():
    return _main_program_._op_role


def _current_op_role_var():
    return list(_main_program_._op_role_var)
