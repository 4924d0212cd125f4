"""Memory optimization transpiler (reference
python/paddle/fluid/transpiler/memory_optimization_transpiler.py:
ControlFlowGraph:37, liveness dataflow, var-reuse pool, memory_optimize:361,
release_memory:380; the JAX package's transpiler of the same name).

`memory_optimize` renames a var whose value is dead into a pool slot of
its dtype and shape, so a later var reuses it, exactly as the reference
does: the program's ops then hold fewer distinct vars, and the
interpreter's env drops the dead values as they are overwritten.
`release_memory` inserts `delete_var` ops after each var's last use; that
op is a host op (core/executor_core.py HOST_OPS), so such a program runs
on the interpreter.
"""

from collections import defaultdict

SUB_BLOCK_OPS = ["while", "while_grad", "parallel_do", "parallel_do_grad",
                 "conditional_block", "conditional_block_grad", "recurrent",
                 "dynamic_recurrent"]

PRINT_LOG = False


class ControlFlowGraph:
    def __init__(self, program, ops, forward_num, skip_opt):
        self._program = program
        self._ops = ops
        self._forward_num = forward_num
        self._successors = defaultdict(set)
        self._presuccessors = defaultdict(set)
        self._uses = defaultdict(set)
        self._defs = defaultdict(set)
        self._live_in = defaultdict(set)
        self._live_out = defaultdict(set)
        self._skip_opt = skip_opt

    def _add_connections(self, connections):
        for node1, node2 in connections:
            self._add(node1, node2)

    def _add(self, node1, node2):
        self._successors[node1].add(node2)
        self._presuccessors[node2].add(node1)

    def _build_graph(self):
        self.op_size = len(self._ops)
        op_node_connections = [(i, i + 1) for i in range(self.op_size - 1)]
        self._add_connections(op_node_connections)
        for i in range(self.op_size):
            self._uses[i].update(self._ops[i].input_arg_names())
            self._defs[i].update(self._ops[i].output_arg_names())

    def _reach_fixed_point(self, live_in, live_out):
        if len(live_in) != len(self._live_in):
            return False
        if len(live_out) != len(self._live_out):
            return False
        for i in range(self.op_size):
            if (live_in[i] != self._live_in[i]) or (live_out[i] != self._live_out[i]):
                return False
        return True

    def _dataflow_analyze(self):
        self._build_graph()
        live_in = defaultdict(set)
        live_out = defaultdict(set)
        while True:
            for i in reversed(range(self.op_size)):
                live_in[i] = set(self._live_in[i])
                live_out[i] = set(self._live_out[i])
                for s in self._successors[i]:
                    self._live_out[i] |= self._live_in[s]
                self._live_in[i] = self._uses[i] | (self._live_out[i] - self._defs[i])
            if self._reach_fixed_point(live_in, live_out):
                break

    def _get_diff(self, a, b):
        u = a & b
        return a - u, b - u

    def _has_var(self, block, var_name):
        return block.has_var(var_name)

    def _find_var(self, block, var_name):
        return block.var(var_name)

    def _check_var_validity(self, block, x):
        if not self._has_var(block, x):
            return False
        var = self._find_var(block, x)
        if var.persistable:
            return False
        if var.shape is None or any(s in (-1, None) for s in var.shape[1:] if True):
            # only reuse fully-known shapes beyond the batch dim
            if var.shape is None:
                return False
        if x in self._skip_opt:
            return False
        return True

    def memory_optimize(self, level=0):
        """rename dead vars into a reuse pool keyed by (dtype, shape).

        A var that more than one op writes (a gradient that a `sum`
        accumulates in place, x@GRAD = sum(x@GRAD, x@GRAD@RENAME_0))
        keeps its name and gives none: a rename applies to every op, so
        renaming it at its last write into a var that died just before
        would also move its first write into that var while it is still
        live (the JAX package's pass does, and corrupts the gradients of
        every residual network; ROADMAP §3)."""
        self._dataflow_analyze()
        self.pool = []
        renamed = {}
        block = self._program.global_block()
        writers = defaultdict(int)
        for i in range(self.op_size):
            for x in self._defs[i]:
                writers[x] += 1

        def valid(x):
            return writers[x] <= 1 and self._check_var_validity(block, x)

        for i in range(self.op_size):
            op = self._ops[i]
            if op.type in SUB_BLOCK_OPS:
                continue
            in_diff, _ = self._get_diff(self._live_in[i], self._live_out[i])
            can_optimize = [x for x in in_diff if valid(x)]
            for x in can_optimize:
                var = self._find_var(block, x)
                key = (var.dtype, tuple(var.shape or ()))
                self.pool.append((x, key))
            defs_can_optimize = [x for x in self._defs[i] if valid(x)]
            for x in defs_can_optimize:
                var = self._find_var(block, x)
                key = (var.dtype, tuple(var.shape or ()))
                for idx, (cache_var, cache_key) in enumerate(self.pool):
                    if cache_key == key and cache_var != x and cache_var not in self._defs[i]:
                        if PRINT_LOG:
                            print(f"reuse {cache_var} for {x}")
                        renamed[x] = cache_var
                        self.pool.pop(idx)
                        break
        # apply renames
        for x, new_name in renamed.items():
            for op in self._ops:
                op.rename_input(x, new_name)
                op.rename_output(x, new_name)
            block.vars.pop(x, None)
        self._program._mutation += 1
        return renamed


def _get_cfgs(input_program):
    ops_list = []
    pdesc = input_program
    block = pdesc.global_block()
    ops_list.append(([op for op in block.ops], len(block.ops), set()))
    cfgs = [
        ControlFlowGraph(input_program, ops, forward_num, skip_opt)
        for ops, forward_num, skip_opt in ops_list
    ]
    return cfgs


def memory_optimize(input_program, print_log=False, level=0):
    """reference memory_optimization_transpiler.py:361."""
    global PRINT_LOG
    PRINT_LOG = print_log
    cfgs = _get_cfgs(input_program)
    result = {}
    for cfg in cfgs:
        result.update(cfg.memory_optimize(level))
    return result


def release_memory(input_program):
    """reference :380 — insert delete_var ops after last use (eager path)."""
    cfgs = _get_cfgs(input_program)
    for cfg in cfgs:
        cfg._dataflow_analyze()
        block = input_program.global_block()
        inserts = []
        for i in range(cfg.op_size):
            in_diff, _ = cfg._get_diff(cfg._live_in[i], cfg._live_out[i])
            can_del = [
                x for x in in_diff if cfg._check_var_validity(block, x)
            ]
            if can_del:
                inserts.append((i, can_del))
        for offset, (i, names) in enumerate(inserts):
            block.insert_op(
                i + 1 + offset, "delete_var", {"X": names}, {}, {}
            )
