"""Control-flow layers (reference python/paddle/fluid/layers/
control_flow.py: While:608, StaticRNN:383, DynamicRNN:1317, IfElse:1215,
Switch:1126, ConditionalBlock:1069, lod_rank_table, array read/write, the
compare helpers), as the JAX package's paddle_tpu/layers/control_flow.py
builds them: the same calls give the same ops, attrs and var names, with
two exceptions, IfElse's ops and the shapes of DynamicRNN's step inputs
and outputs (see their docstrings). How the ops run on torch:
ops/control_flow_ops.py."""

import contextlib

from ..layer_helper import LayerHelper
from ..core.framework import Variable, VarType
from .. import unique_name
from . import tensor as tensor_layers

__all__ = [
    "While", "Switch", "IfElse", "ConditionalBlock", "StaticRNN", "DynamicRNN",
    "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
    "array_to_lod_tensor", "increment", "array_write", "create_array",
    "less_than", "equal", "array_read", "shrink_memory", "array_length",
    "zeros_like", "reorder_lod_tensor_by_rank", "Print",
]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """reference layers/control_flow.py Print:165 — debug-print a tensor as
    a pass-through op, which prints on the host (a host-sync op: its
    program runs on the interpreter). `summarize` truncates to the first N
    elements; `first_n`, `print_phase` and `print_tensor_*` are accepted
    for signature parity and do nothing, as in the JAX package."""
    helper = LayerHelper("print", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    helper.append_op(
        "print", {"In": [input]}, {"Out": [out]},
        {"message": message or input.name, "summarize": summarize},
    )
    return out


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
    helper.append_op("increment", {"X": [x]}, {"Out": [out]}, {"step": float(value)})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like", **locals())
    if out is None:
        out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op("fill_zeros_like", {"X": [x]}, {"Out": [out]})
    return out


def create_array(dtype):
    helper = LayerHelper("array")
    return helper.create_variable(
        name=unique_name.generate("array"), type=VarType.LOD_TENSOR_ARRAY, dtype=dtype
    )


def array_write(x, i, array=None):
    helper = LayerHelper("array_write", **locals())
    if array is None:
        array = create_array(x.dtype)
    # carry the element shape so array_read outputs stay shape-inferable
    # (downstream fc/reshape need it; all slots share one element shape)
    if getattr(array, "shape", None) is None and x.shape is not None:
        array.shape = x.shape
    helper.append_op("write_to_array", {"X": [x], "I": [i]}, {"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", **locals())
    out = helper.create_tmp_variable(dtype=array.dtype,
                                     shape=getattr(array, "shape", None))
    helper.append_op("read_from_array", {"X": [array], "I": [i]}, {"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length", **locals())
    out = helper.create_tmp_variable(dtype="int64", shape=(1,))
    out.stop_gradient = True
    helper.append_op("lod_array_length", {"X": [array]}, {"Out": [out]})
    return out


def lod_rank_table(x, level=0):
    helper = LayerHelper("lod_rank_table", **locals())
    table = helper.create_variable(
        name=unique_name.generate("lod_rank_table"), type=VarType.LOD_RANK_TABLE
    )
    helper.append_op("lod_rank_table", {"X": [x]}, {"Out": [table]}, {"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_len", **locals())
    res = helper.create_tmp_variable(dtype="int64", shape=(1,))
    res.stop_gradient = True
    helper.append_op("max_sequence_len", {"RankTable": [rank_table]}, {"Out": [res]})
    return res


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array", **locals())
    array = helper.create_variable(
        name=unique_name.generate("lod_tensor_to_array"),
        type=VarType.LOD_TENSOR_ARRAY,
        dtype=x.dtype,
    )
    helper.append_op(
        "lod_tensor_to_array", {"X": [x], "RankTable": [table]}, {"Out": [array]}
    )
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor", **locals())
    tmp = helper.create_tmp_variable(dtype=x.dtype, lod_level=1)
    helper.append_op(
        "array_to_lod_tensor", {"X": [x], "RankTable": [table]}, {"Out": [tmp]}
    )
    return tmp


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        "shrink_rnn_memory", {"X": [x], "I": [i], "RankTable": [table]}, {"Out": [out]}
    )
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=x.lod_level)
    helper.append_op(
        "reorder_lod_tensor_by_rank",
        {"X": [x], "RankTable": [rank_table]},
        {"Out": [out]},
    )
    return out


class BlockGuard:
    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program.rollback()
        return exc_type is None


def _scan_sub_block(sub_block):
    """(reads, writes) name sets of a sub-block — the one definition used
    by the While/ConditionalBlock interface and the recurrent closure."""
    x_names, inner = set(), set()
    for op in sub_block.ops:
        x_names.update(op.input_arg_names())
        inner.update(op.output_arg_names())
    return x_names, inner


def _sub_block_closure(parent_block, sub_block, exclude):
    """Parent-visible names the sub-block READS that are not otherwise
    declared on the op: the recurrent family must list them as inputs so
    the auto-vjp tracks them — undeclared closure reads (weights!) would
    silently get ZERO gradients. Read-AND-written names stay in (their
    first read is of the parent value)."""
    x_names, _inner = _scan_sub_block(sub_block)
    return sorted(
        n for n in x_names
        if n and n not in exclude
        and parent_block.has_var_recursive(n))


def _sub_block_interface(parent_block, sub_block, snap_suffix,
                         all_writes=False):
    """Shared by While and ConditionalBlock: derive the sub-block's
    parent-visible reads and writes, undo constant-initializer
    stop_gradient flags on rewritten float vars (a var the block REWRITES
    is no longer the constant its initializer created — without this the
    backward reach dies at every accumulator; explicit user flags on
    computed vars stay respected), and create one pre-op snapshot var per
    written name (the stand-in for the reference's saved scopes,
    while_op.cc:35 / conditional_block_op.cc grad).

    Returns (in_names, out_names, init_snapshot_names, input_snap_names).
    init_snapshot_names align with out_names (pre-op values of written
    state); input_snap_names align with in_names (values of every read AT
    op entry — grad replay must not see values a LATER forward op wrote
    over). Both snapshot kinds are the entry-time tensors themselves, no
    copies."""
    from .. import unique_name

    x_names, inner = _scan_sub_block(sub_block)
    if all_writes:
        # ALL written names are outputs: the flat step env makes
        # sub-created vars observable downstream (how IfElse branch
        # outputs reach the merge), so the cotangent must route back
        # through the op. Sub-created ones get a parent-block var desc.
        out_names = sorted(n for n in inner if n)
    else:
        # While: loop temps are not observable after the loop (the carry
        # exports only entry-materialized state), so declaring them would
        # be dead IR that scales with body size
        out_names = sorted(
            n for n in inner if parent_block.has_var_recursive(n))
    in_names = sorted(n for n in x_names if parent_block.has_var_recursive(n))
    const_init_types = {
        "fill_constant", "fill_constant_batch_size_like",
        "fill_zeros_like", "uniform_random", "gaussian_random",
    }
    producer = {}
    for p_op in parent_block.ops:
        for n in p_op.output_arg_names():
            producer[n] = p_op.type

    def _var_of(n):
        if parent_block.has_var_recursive(n):
            return parent_block.var_recursive(n)
        sub_v = sub_block.vars.get(n)
        return parent_block.create_var(
            name=n,
            shape=sub_v.shape if sub_v is not None else None,
            dtype=sub_v.dtype if sub_v is not None else "float32")

    init_names = []
    for n in out_names:
        v = _var_of(n)
        if v.dtype and "float" in str(v.dtype) \
                and producer.get(n) in const_init_types:
            v.stop_gradient = False
        snap = unique_name.generate(n + snap_suffix)
        parent_block.create_var(name=snap, shape=v.shape, dtype=v.dtype)
        init_names.append(snap)
    input_snap_names = []
    for n in in_names:
        v = parent_block.var_recursive(n)
        snap = unique_name.generate(n + snap_suffix + "_IN")
        parent_block.create_var(name=snap, shape=v.shape, dtype=v.dtype)
        input_snap_names.append(snap)
    return in_names, out_names, init_names, input_snap_names


class While:
    """reference control_flow.py:608: the `while` op, which reads its
    condition on the host after every trip (its program runs on the
    interpreter).

    `max_trip_count` (the JAX package's extension, no reference
    equivalent): an upper bound on loop trips. Required iff the loop is
    trained through: while_grad replays at most that many trips from the
    loop's entry-time snapshots. Forward-only loops don't need it."""

    BEFORE_WHILE_BLOCK = 0
    IN_WHILE_BLOCK = 1
    AFTER_WHILE_BLOCK = 2

    def __init__(self, cond, name=None, max_trip_count=None):
        self.helper = LayerHelper("while", name=name)
        self.status = While.BEFORE_WHILE_BLOCK
        if not isinstance(cond, Variable):
            raise TypeError("condition should be a variable")
        self.cond_var = cond
        self.max_trip_count = max_trip_count

    def block(self):
        return WhileGuard(self)

    def complete(self, sub_block):
        main_program = self.helper.main_program
        parent_block = main_program.block(sub_block.parent_idx)
        # Out: vars the loop body writes that live in the parent scope —
        # the loop's carried state (reference while_op lists these too).
        # X keeps ALL parent-visible reads, including read-AND-written
        # carried vars: their INITIAL values are loop inputs, which is what
        # makes gradients through the loop expressible at the IR level.
        in_names, out_names, init_names, in_snaps = _sub_block_interface(
            parent_block, sub_block, "@WHILE_INIT")
        attrs = {"sub_block": sub_block}
        if self.max_trip_count is not None:
            attrs["max_trip_count"] = int(self.max_trip_count)
        parent_block.append_op(
            "while",
            {"X": in_names, "Condition": [self.cond_var]},
            {"Out": out_names, "InitStates": init_names,
             "InputSnapshots": in_snaps, "StepScopes": []},
            attrs,
        )


class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        super().__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __enter__(self):
        self.while_op.status = While.IN_WHILE_BLOCK
        return super().__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        sub_block = self.main_program.current_block()
        res = super().__exit__(exc_type, exc_val, exc_tb)
        self.while_op.status = While.AFTER_WHILE_BLOCK
        self.while_op.complete(sub_block)
        return res


class ConditionalBlock:
    """reference control_flow.py:1069: the `conditional_block` op, which
    keeps the block's writes where its predicate holds."""

    def __init__(self, inputs, is_scalar_condition=False, name=None):
        for each_input in inputs:
            if not isinstance(each_input, Variable):
                raise TypeError("Each input should be a Variable")
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper("conditional_block", name=name)

    def block(self):
        return ConditionalBlockGuard(self)

    def complete(self, sub_block):
        main_program = self.helper.main_program
        parent_block = main_program.block(sub_block.parent_idx)
        # Input: parent-visible reads AND writes (grad path — written
        # names must be op inputs so the backward walk applies its
        # in-place pre/post grad semantics to them); Out + InitStates: the
        # written state and its pre-op snapshot, so conditional_block_grad
        # can differentiate BOTH branches (taken: vjp through the block;
        # not taken: identity to the init). Inputs are fetched lazily:
        # a state var first materialized INSIDE the block has no value yet.
        in_names, out_names, init_names, in_snaps = _sub_block_interface(
            parent_block, sub_block, "@COND_INIT", all_writes=True)
        extra = sorted(set(out_names) - set(in_names))
        in_names = in_names + extra  # snapshot lists stay aligned
        in_snaps = in_snaps + [""] * len(extra)
        cond_snaps = []
        for v in self.inputs:
            snap = unique_name.generate(v.name + "@COND_INIT_X")
            parent_block.create_var(name=snap, shape=v.shape, dtype=v.dtype)
            cond_snaps.append(snap)
        parent_block.append_op(
            "conditional_block",
            {"X": self.inputs, "Input": in_names},
            {"Out": out_names, "InitStates": init_names,
             "InputSnapshots": in_snaps, "CondSnapshots": cond_snaps,
             "Scope": []},
            {"sub_block": sub_block, "is_scalar_condition": self.is_scalar_condition},
        )


class ConditionalBlockGuard(BlockGuard):
    def __init__(self, cond_block):
        super().__init__(cond_block.helper.main_program)
        self.cond_block = cond_block

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            # roll back even on error: otherwise the program's current-block
            # pointer stays inside the abandoned sub-block and later layers
            # silently land there
            return super().__exit__(exc_type, exc_val, exc_tb)
        sub_block = self.main_program.current_block()
        res = super().__exit__(exc_type, exc_val, exc_tb)
        self.cond_block.complete(sub_block)
        return res


class Switch:
    """reference control_flow.py:1126 — chained conditional blocks."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    def case(self, condition):
        if not self.inside_scope:
            raise ValueError("case should be called inside with")
        from .ops import logical_and, logical_not

        if len(self.pre_not_conditions) == 0:
            cond_block = ConditionalBlock([condition], is_scalar_condition=True)
            not_cond = logical_not(x=condition)
            self.pre_not_conditions.append(not_cond)
        else:
            pre_cond_num = len(self.pre_not_conditions)
            pre_not_cond = self.pre_not_conditions[pre_cond_num - 1]
            new_not_cond = logical_and(x=pre_not_cond, y=logical_not(x=condition))
            self.pre_not_conditions.append(new_not_cond)
            cond_block = ConditionalBlock(
                [logical_and(x=pre_not_cond, y=condition)], is_scalar_condition=True
            )
        return ConditionalBlockGuard(cond_block)

    def default(self):
        pre_cond_num = len(self.pre_not_conditions)
        if pre_cond_num == 0:
            raise ValueError("there should be at least one condition")
        cond_block = ConditionalBlock(
            [self.pre_not_conditions[pre_cond_num - 1]], is_scalar_condition=True
        )
        return ConditionalBlockGuard(cond_block)

    def __enter__(self):
        self.inside_scope = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside_scope = False
        return exc_type is None


class IfElse:
    """reference control_flow.py:1215: a per-row select by `cond` ([B, 1]
    bool) between the true and the false branch's outputs.

    The JAX package runs each branch on every row under all(cond) and
    all(not cond), so on rows that mix true and false neither runs and
    the merge picks the false branch's zeros (ROADMAP §3 item 10). Here,
    as in the reference Fluid, `input` splits the rows by cond
    (split_lod_tensor) and each branch computes on its own rows only;
    the call merges them back in row order (merge_lod_tensor). So an op
    that is singular on the other branch's rows never sees them, forward
    or backward. The split sits inside each branch's block, which makes
    the block a host-sync one: its predicate (any row takes it: max or
    min of cond as float, against 0.5) is read on the host and a branch
    no row takes does not run. An IfElse program runs on the interpreter.
    Where every row agrees the values are the JAX package's; the program
    holds the two reductions, the 0.5, the two comparisons, a split per
    input and a merge per output, and not the JAX package's logical_not
    and multiplex."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        from .nn import reduce_max, reduce_min

        rows = tensor_layers.cast(cond, "float32")
        half = tensor_layers.fill_constant(shape=[1], dtype="float32",
                                           value=0.5)
        any_true = less_than(half, reduce_max(rows))
        any_false = less_than(reduce_min(rows), half)
        self.conditional_true_block = ConditionalBlock(
            [any_true], is_scalar_condition=True)
        self.conditional_false_block = ConditionalBlock(
            [any_false], is_scalar_condition=True)
        self.output_table = [[], []]  # [true_out, false_out]

    def input(self, x):
        """x's rows that take the branch being built."""
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input must in true/false blocks")
        out_true, out_false = (
            self.helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
            for _ in range(2))
        self.helper.append_op(
            "split_lod_tensor", {"X": [x], "Mask": [self.cond]},
            {"OutTrue": [out_true], "OutFalse": [out_false]}, {"level": 0})
        return out_true if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS \
            else out_false

    @contextlib.contextmanager
    def true_block(self):
        self.status = IfElse.IN_IF_ELSE_TRUE_BLOCKS
        with self.conditional_true_block.block():
            yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    @contextlib.contextmanager
    def false_block(self):
        self.status = IfElse.IN_IF_ELSE_FALSE_BLOCKS
        with self.conditional_false_block.block():
            yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output can only be invoked in the sub-block")
        out_table = self.output_table[
            1 if self.status == IfElse.IN_IF_ELSE_FALSE_BLOCKS else 0
        ]
        for each_out in outs:
            out_table.append(each_out)

    def __call__(self):
        if self.status != self.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ must be out of sub-block")
        rlist = []
        for t_out, f_out in zip(self.output_table[0], self.output_table[1]):
            merged = self.helper.create_tmp_variable(dtype=t_out.dtype,
                                                     shape=t_out.shape)
            self.helper.append_op(
                "merge_lod_tensor",
                {"X": [self.cond], "Mask": [self.cond], "InTrue": [t_out],
                 "InFalse": [f_out]},
                {"Out": [merged]}, {"level": 0})
            rlist.append(merged)
        return rlist


class StaticRNN:
    """reference control_flow.py:383 — fixed-length RNN over time steps.

    Built on a sub-block that the `recurrent` op runs once for each row of
    its inputs' leading dim (ops/control_flow_ops.py)."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.memories = {}  # mem var name -> (init var, pre_mem var, mem var)
        self.inputs = []
        self.outputs = []
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.seq_len = None
        self._sub_block = None

    @contextlib.contextmanager
    def step(self):
        self.status = StaticRNN.IN_RNN_BLOCK
        self.helper.main_program.create_block()
        yield
        self._sub_block = self.helper.main_program.current_block()
        self.helper.main_program.rollback()
        self.status = StaticRNN.AFTER_RNN_BLOCK
        self._complete_op()

    def _assert_in_rnn_block_(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError(f"You must invoke {method} in rnn block")

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_rnn_block_("memory")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("if init is None, memory at least need shape and batch_ref")
            parent_block = self._parent_block()
            var_name = unique_name.generate("@".join([self.helper.name, "memory_boot"]))
            boot_var = parent_block.create_var(
                name=var_name, shape=shape, dtype=batch_ref.dtype, persistable=False
            )
            parent_block.append_op(
                "fill_constant_batch_size_like",
                {"Input": [batch_ref]},
                {"Out": [boot_var]},
                {
                    "value": init_value,
                    "shape": [1 if i == init_batch_dim_idx else s for i, s in enumerate(boot_var.shape)],
                    "dtype": boot_var.dtype,
                    "input_dim_idx": ref_batch_dim_idx,
                    "output_dim_idx": init_batch_dim_idx,
                },
            )
            return self.memory(init=boot_var)
        pre_mem = self.helper.create_variable(
            name=unique_name.generate("@".join([self.helper.name, "mem"])),
            dtype=init.dtype,
            shape=init.shape,
        )
        self.memories[pre_mem.name] = [init, pre_mem, None]
        return pre_mem

    def step_input(self, x):
        self._assert_in_rnn_block_("step_input")
        if self.seq_len is None:
            self.seq_len = x.shape[0]
        ipt = self.helper.create_variable(
            name=unique_name.generate("@".join([self.helper.name, "step_in"])),
            dtype=x.dtype,
            shape=tuple(x.shape[1:]) if x.shape else None,
        )
        self.inputs.append((x, ipt))
        return ipt

    def step_output(self, o):
        self._assert_in_rnn_block_("step_output")
        self.outputs.append(o)

    def output(self, *outputs):
        for each in outputs:
            self.step_output(each)

    def update_memory(self, mem, var):
        if not isinstance(mem, Variable) or not isinstance(var, Variable):
            raise TypeError("update memory should take variables")
        self.memories[mem.name][2] = var

    def _parent_block(self):
        prog = self.helper.main_program
        return prog.block(self._sub_block.parent_idx) if self._sub_block else prog.current_block()

    def _complete_op(self):
        sub_block = self._sub_block
        parent_block = self._parent_block()
        step_inputs = [x for x, _ in self.inputs]
        inner_inputs = [i for _, i in self.inputs]
        boots = [self.memories[k][0] for k in self.memories]
        pre_mems = [self.memories[k][1] for k in self.memories]
        new_mems = [self.memories[k][2] for k in self.memories]
        if any(m is None for m in new_mems):
            raise ValueError("every memory needs update_memory")
        step_outs = [
            self.helper.create_variable(
                name=unique_name.generate("@".join([self.helper.name, "out"])),
                dtype=o.dtype,
            )
            for o in self.outputs
        ]
        self._outputs_vars = step_outs
        # boots stay ELIGIBLE: a boot var read directly inside the step
        # (beyond its carry role) needs the closure path for that read's
        # gradient; double declaration sums via the multi-slot machinery
        closure = _sub_block_closure(
            parent_block, sub_block,
            exclude=set([v.name for v in inner_inputs]
                        + [v.name for v in pre_mems]))
        parent_block.append_op(
            "recurrent",
            {
                "inputs": step_inputs,
                "initial_states": boots,
                "Closure": closure,
            },
            {"outputs": step_outs, "step_scopes": []},
            {
                "sub_block": sub_block,
                "ex_states": [v.name for v in pre_mems],
                "states": [v.name for v in new_mems],
                "step_input_names": [v.name for v in inner_inputs],
                "step_output_names": [o.name for o in self.outputs],
                "closure_names": closure,
            },
        )

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError("RNN output can only be retrieved after rnn block")
        if not self.outputs:
            raise ValueError("RNN has no output")
        elif len(self.outputs) == 1:
            return self._outputs_vars[0]
        return self._outputs_vars


class DynamicRNN:
    """reference control_flow.py:1317 — variable-length RNN.

    Instead of the reference's rank-table bucketing and per-step shrinking
    batches, the `dynamic_recurrent` op steps over the padded [B, T, *]
    view with per-step masks in one loop of static length, and the
    results are made ragged again: the same semantics, static shapes."""

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.inputs = []  # (outer ragged var, inner step var)
        self.static_inputs = []
        self.memories = []  # (init or None, shape, value, pre_mem, new_mem)
        self.outputs = []
        self._sub_block = None
        self._first_input = None

    def step_input(self, x):
        """The step's rows of ragged `x`, a var shaped as x is: [-1, ...]
        (B rows a step). The JAX package gives it no shape, so a layer
        that needs one (fc) cannot read it (ROADMAP §3 item 12); the
        reference's shape inference gives it x's."""
        self._assert_in_rnn_block_("step_input")
        if self._first_input is None:
            self._first_input = x
        ipt = self.helper.create_variable(
            name=unique_name.generate("@".join([self.helper.name, "step_in"])),
            dtype=x.dtype,
            shape=x.shape,
        )
        self.inputs.append((x, ipt))
        return ipt

    def static_input(self, x):
        self._assert_in_rnn_block_("static_input")
        self.static_inputs.append(x)
        return x

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be invoked once")
        self.status = DynamicRNN.IN_RNN
        self.helper.main_program.create_block()
        yield
        self._sub_block = self.helper.main_program.current_block()
        self.helper.main_program.rollback()
        self.status = DynamicRNN.AFTER_RNN
        self._complete_op()

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        self._assert_in_rnn_block_("memory")
        pre_mem = self.helper.create_variable(
            name=unique_name.generate("@".join([self.helper.name, "mem"])),
            dtype=init.dtype if init is not None else dtype,
            shape=init.shape if init is not None else tuple([None] + list(shape or [])),
        )
        self.memories.append([init, shape, value, pre_mem, None])
        return pre_mem

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn_block_("update_memory")
        for m in self.memories:
            if m[3] is ex_mem:
                m[4] = new_mem
                return
        raise ValueError("unknown memory")

    def output(self, *outputs):
        self._assert_in_rnn_block_("output")
        for o in outputs:
            self.outputs.append(o)

    def _assert_in_rnn_block_(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{method} can only be invoked inside rnn block")

    def _complete_op(self):
        sub_block = self._sub_block
        parent_block = self.helper.main_program.block(sub_block.parent_idx)
        # shaped as the step output (the JAX package gives no shape, as
        # for step inputs: ROADMAP §3 item 12)
        outs = [
            self.helper.create_variable(
                name=unique_name.generate("@".join([self.helper.name, "out"])),
                dtype=o.dtype,
                shape=o.shape,
                lod_level=1,
            )
            for o in self.outputs
        ]
        self._outputs_vars = outs
        closure = _sub_block_closure(
            parent_block, sub_block,
            exclude=set([i.name for _, i in self.inputs]
                        + [m[3].name for m in self.memories]
                        + [v.name for v in self.static_inputs]))
        parent_block.append_op(
            "dynamic_recurrent",
            {
                "inputs": [x for x, _ in self.inputs],
                "static_inputs": self.static_inputs,
                "initial_states": [m[0] for m in self.memories if m[0] is not None],
                "Closure": closure,
            },
            {"outputs": outs},
            {
                "sub_block": sub_block,
                "closure_names": closure,
                "static_input_names": [v.name for v in self.static_inputs],
                "step_input_names": [i.name for _, i in self.inputs],
                "mem_init_names": [m[0].name if m[0] is not None else "" for m in self.memories],
                "mem_shapes": [list(m[1]) if m[1] else [] for m in self.memories],
                "mem_values": [float(m[2]) for m in self.memories],
                "pre_mem_names": [m[3].name for m in self.memories],
                "new_mem_names": [m[4].name if m[4] is not None else "" for m in self.memories],
                "step_output_names": [o.name for o in self.outputs],
            },
        )

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("Dynamic RNN outputs can only be retrieved after rnn.block()")
        if len(self._outputs_vars) == 1:
            return self._outputs_vars[0]
        return self._outputs_vars
