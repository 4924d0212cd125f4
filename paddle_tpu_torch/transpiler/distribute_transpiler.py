"""DistributeTranspiler: rewrite a single-process program into trainer +
parameter-server programs.

Reference parity: python/paddle/fluid/transpiler/distribute_transpiler.py:169
(the JAX package's paddle_tpu/transpiler/distribute_transpiler.py):
  - split_dense_variable(:98): params/grads chopped into ~min_block_size
    element blocks for shard balance
  - trainer rewrite: split_byref + send_vars + send_barrier + recv +
    fetch_barrier + concat (:288-380)
  - get_pserver_program(:413): per-param-block optimize sub-blocks under a
    listen_and_serv op
  - get_startup_program(:569)
  - the distributed lookup table (:624-822): prefetch block, table
    optimize block, the table pruned from the trainer.

The transport behind send/recv/listen_and_serv is parallel/rpc.py's TCP
runtime. Where no parameter splits, the programs are the JAX package's.
Where one does, they differ by the reference Fluid's three repairs of
the JAX package's faults (ROADMAP §3): the trainer's split_byref has a
kernel here (ops/tensor_ops.py); a pserver's startup runs the
parameter's own initializer at a block's shape (the JAX package fills
the block with zeros); and a block's accumulators (Momentum's velocity,
Adam's moments: inputs of the parameter's shape) take the block's shape,
as `<accumulator>.block<i>` (the JAX package passes the whole
accumulator beside the block, and its pserver program raises).
"""

import math

from ..core.framework import (
    Program,
    default_main_program,
    default_startup_program,
    OpRole,
    OP_ROLE_ATTR_NAME,
    OP_ROLE_VAR_ATTR_NAME,
)
from .ps_dispatcher import RoundRobin

LOOKUP_TABLE_TYPE = "lookup_table"
RPC_OP_ROLE_ATTR_VALUE = OpRole.RPC


class VarBlock:
    def __init__(self, varname, offset, size):
        self.varname = varname
        self.offset = offset
        self.size = size

    def __str__(self):
        return "%s:%d:%d" % (self.varname, self.offset, self.size)


def same_or_split_var(p_name, var_name):
    return p_name == var_name or p_name.startswith(var_name + ".block")


def split_dense_variable(var_list, service_count, min_block_size=8192):
    """Plan the pserver sharding of each dense variable.

    Policy (role parity with reference distribute_transpiler.py:98-140):
    at most `service_count` shards per var, no shard below `min_block_size`
    elements (tiny vars stay whole), and rank>=2 vars cut on whole rows so
    every shard is a contiguous row range of the original tensor.
    """
    plans = []
    for var in var_list:
        numel = int(math.prod(var.shape)) if var.shape else 1
        # widest shard count this var supports while honouring the floor
        shards = max(1, min(service_count, numel // min_block_size))
        per_shard = -(-numel // shards)  # ceil div
        if len(var.shape) >= 2:
            row = int(math.prod(var.shape[1:]))
            per_shard = -(-per_shard // row) * row  # round UP to whole rows
        for i in range(-(-numel // per_shard)):
            plans.append(str(VarBlock(
                var.name, i, min(per_shard, numel - i * per_shard))))
    return plans


class DistributeTranspiler:
    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, split_method=RoundRobin, sync_mode=True,
                  startup_program=None):
        assert callable(split_method) or isinstance(split_method, type)
        if program is None:
            program = default_main_program()
        if startup_program is None:
            startup_program = default_startup_program()
        self.origin_program = program
        self.startup_program = startup_program
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.trainer_id = trainer_id
        # endpoint -> {block accumulator: (its accumulator, block shape)}
        self._accumulator_blocks = {}
        pserver_endpoints = pservers.split(",")
        self.pserver_endpoints = pserver_endpoints
        self.optimize_ops, self.params_grads = self._get_optimize_pass()
        # distributed lookup table (reference :169 — the EP-precursor):
        # the table param leaves the dense split/send/recv path entirely;
        # lookups become prefetch RPCs and its gradient rides as
        # mod-sharded SelectedRows
        self.table_name = self._find_distributed_table(program)
        if self.table_name:
            self.params_grads = [
                pg for pg in self.params_grads
                if pg[0].name != self.table_name
            ]
        ps_dispatcher = split_method(self.pserver_endpoints)

        # split params/grads into blocks
        param_list = [pg[0] for pg in self.params_grads]
        grad_list = [pg[1] for pg in self.params_grads]
        grad_blocks = split_dense_variable(grad_list, len(pserver_endpoints))
        param_blocks = split_dense_variable(param_list, len(pserver_endpoints))
        self.param_grad_ep_mapping = {
            ep: {"params": [], "grads": []} for ep in pserver_endpoints
        }

        # create split vars on the trainer side
        self.param_var_mapping = self._create_vars_from_blocklist(program, param_blocks)
        self.grad_var_mapping = self._create_vars_from_blocklist(
            program, grad_blocks
        )
        self.grad_param_mapping = {}
        for g, p in zip(grad_blocks, param_blocks):
            g_name, g_bid, _ = g.split(":")
            p_name, p_bid, _ = p.split(":")
            self.grad_param_mapping[
                self.grad_var_mapping[g_name][int(g_bid)]
            ] = self.param_var_mapping[p_name][int(p_bid)]

        # dispatch grads to endpoints
        grad_var_mapping_items = sorted(self.grad_var_mapping.items())
        send_vars = []
        self.grad_name_to_send_dummy_out = {}
        eplist_all = []
        for orig_varname, splited_vars in grad_var_mapping_items:
            eplist = ps_dispatcher.dispatch(splited_vars)
            eplist_all.extend(eplist)
            for i, var in enumerate(splited_vars):
                send_vars.append(var)
                self.param_grad_ep_mapping[eplist[i]]["grads"].append(var)

        block = program.global_block()
        # insert split ops after the op producing each grad
        for orig_varname, splited_vars in grad_var_mapping_items:
            if len(splited_vars) <= 1:
                continue
            orig_var = block.var(orig_varname)
            index = self._find_op_index_by_output(block, orig_varname)
            sections = [int(math.prod(v.shape)) // (int(math.prod(v.shape[1:])) or 1)
                        if len(v.shape) >= 2 else int(math.prod(v.shape))
                        for v in splited_vars]
            block.insert_op(
                index + 1,
                "split_byref",
                {"X": [orig_var]},
                {"Out": splited_vars},
                {"sections": sections, "axis": 0,
                 OP_ROLE_ATTR_NAME: OpRole.Backward},
            )

        # send ops
        dummy_output = block.create_var(name="RPC_OP_ROLE_DUMMY")
        # multi-trainer sync: each trainer sends its grads under a
        # trainer-suffixed WIRE name so the pserver's per-trainer recv
        # buffers (and its aggregating sum op) see distinct vars — the
        # reference renames the local grad vars instead
        # (add_trainer_suffix); a wire alias keeps the trainer program
        # untouched
        if self.sync_mode and self.trainer_num > 1:
            send_as = [f"{v.name}.trainer_{self.trainer_id}"
                       for v in send_vars]
        else:
            send_as = [v.name for v in send_vars]
        block.append_op(
            "send_vars",
            {"X": send_vars},
            {"Out": [dummy_output]},
            {
                "epmap": eplist_all,
                "send_as": send_as,
                "sync_send": self.sync_mode,
                OP_ROLE_ATTR_NAME: RPC_OP_ROLE_ATTR_VALUE,
                OP_ROLE_VAR_ATTR_NAME: [v.name for v in send_vars],
            },
        )
        if self.sync_mode:
            block.append_op(
                "send_barrier",
                {},
                {"Out": []},
                {
                    "endpoints": pserver_endpoints,
                    "sync_mode": self.sync_mode,
                    OP_ROLE_ATTR_NAME: RPC_OP_ROLE_ATTR_VALUE,
                },
            )

        # recv each param shard back
        recv_vars = []
        for ep in pserver_endpoints:
            for g in self.param_grad_ep_mapping[ep]["grads"]:
                p = self.grad_param_mapping[g]
                self.param_grad_ep_mapping[ep]["params"].append(p)
        for orig_varname, splited_vars in sorted(self.param_var_mapping.items()):
            eps = []
            for var in splited_vars:
                for ep in pserver_endpoints:
                    if var in self.param_grad_ep_mapping[ep]["params"]:
                        eps.append(ep)
                        break
            block.append_op(
                "recv",
                {"X": []},
                {"Out": splited_vars},
                {"epmap": eps, OP_ROLE_ATTR_NAME: RPC_OP_ROLE_ATTR_VALUE},
            )
        block.append_op(
            "fetch_barrier",
            {},
            {"Out": []},
            {
                "endpoints": pserver_endpoints,
                OP_ROLE_ATTR_NAME: RPC_OP_ROLE_ATTR_VALUE,
            },
        )
        for orig_varname, splited_vars in sorted(self.param_var_mapping.items()):
            if len(splited_vars) <= 1:
                continue
            orig_var = block.var(orig_varname)
            block.append_op(
                "concat",
                {"X": splited_vars},
                {"Out": [orig_var]},
                {"axis": 0},
            )

        self._delete_trainer_optimize_ops(block)

        if self.table_name:
            self._replace_lookup_table_op_with_prefetch(
                program, pserver_endpoints)
            self._split_table_grad_and_add_send_vars(
                program, pserver_endpoints)
            self._prune_table_from_trainer(program)

    def _prune_table_from_trainer(self, program):
        """A distributed table exists because it exceeds one worker's
        memory — after the prefetch rewrite nothing on the trainer reads a
        row of it, so drop its dense init and detach it from the grad op
        (which only needed W for the vocab size)."""
        block = program.global_block()
        table_var = block.vars[self.table_name]
        for op in block.ops:
            if op.type == "lookup_table_grad" and \
                    op.input("W") == [self.table_name]:
                op.inputs["W"] = []
                op.attrs["height"] = int(table_var.shape[0])
        sb = self.startup_program.global_block()
        sb.ops = [op for op in sb.ops
                  if self.table_name not in op.output_arg_names()]
        self.startup_program._mutation += 1
        program._mutation += 1

    # ------------------------------------------------------------------
    # distributed lookup table (reference :624-822)
    # ------------------------------------------------------------------
    def _find_distributed_table(self, program):
        """reference :169: at most one lookup_table with is_distributed."""
        dist_ops = [
            op for op in program.global_block().ops
            if op.type == LOOKUP_TABLE_TYPE
            and op.attrs.get("is_distributed", False)
        ]
        names = {op.input("W")[0] for op in dist_ops}
        assert len(names) <= 1, (
            "all distributed lookup_table ops must share one table; got "
            f"{sorted(names)}")
        # the table gradient must ride as SelectedRows (split_ids mod-shards
        # its rows); a dense grad would be misread as an ids tensor
        assert all(op.attrs.get("is_sparse", False) for op in dist_ops), (
            "is_distributed=True requires is_sparse=True on the embedding")
        return names.pop() if names else None

    def _replace_lookup_table_op_with_prefetch(self, program, eplist):
        """reference :624 — swap every distributed lookup_table for
        split_ids -> prefetch -> merge_ids (merge_ids rather than the
        reference-era concat: mod-sharded ids come back out of order)."""
        block = program.global_block()
        n = len(eplist)
        table_var = block.vars[self.table_name]
        emb_dim = int(table_var.shape[1])
        self.prefetch_input_vars = [
            block.create_var(name=f"{self.table_name}.prefetch_in_{i}",
                             dtype="int64", shape=(-1, 1))
            for i in range(n)
        ]
        self.prefetch_output_vars = [
            block.create_var(name=f"{self.table_name}.prefetch_out_{i}",
                             dtype=table_var.dtype, shape=(-1, emb_dim))
            for i in range(n)
        ]
        while True:
            idx = next(
                (i for i, op in enumerate(block.ops)
                 if op.type == LOOKUP_TABLE_TYPE
                 and op.input("W")[0] == self.table_name),
                None,
            )
            if idx is None:
                break
            op = block.ops[idx]
            ids_var = block.vars[op.input("Ids")[0]]
            out_var = block.vars[op.output("Out")[0]]
            del block.ops[idx]
            block.insert_op(
                idx, "split_ids",
                {"Ids": [ids_var]}, {"Out": self.prefetch_input_vars}, {})
            block.insert_op(
                idx + 1, "prefetch",
                {"X": self.prefetch_input_vars},
                {"Out": self.prefetch_output_vars},
                {"epmap": list(eplist), "table_name": self.table_name,
                 "emb_dim": emb_dim, "dtype": table_var.dtype,
                 OP_ROLE_ATTR_NAME: RPC_OP_ROLE_ATTR_VALUE},
            )
            block.insert_op(
                idx + 2, "merge_ids",
                {"Ids": [ids_var], "X": self.prefetch_input_vars,
                 "Rows": self.prefetch_output_vars},
                {"Out": [out_var]}, {},
            )
        block.program._mutation += 1

    def _split_table_grad_and_add_send_vars(self, program, pserver_endpoints):
        """reference :695 — after the op producing the table's SelectedRows
        gradient, mod-shard it and send one shard to each pserver."""
        block = program.global_block()
        grad_name = f"{self.table_name}@GRAD"
        # anchor on the LAST writer: with several lookups of one table the
        # earlier writers are partial contributions that a trailing sum op
        # accumulates into the canonical grad
        idxs = [i for i, op in enumerate(block.ops)
                if grad_name in op.output_arg_names()]
        if not idxs:
            return  # inference-only program: no table gradient
        idx = idxs[-1]
        grad_var = block.vars.get(grad_name) or block.create_var(
            name=grad_name, dtype="float32", shape=(-1,))
        self.table_grad_list = [
            block.create_var(name=f"{grad_name}.block_{i}",
                             dtype="float32", shape=(-1,))
            for i in range(len(pserver_endpoints))
        ]
        if self.sync_mode and self.trainer_num > 1:
            send_as = [f"{v.name}.trainer_{self.trainer_id}"
                       for v in self.table_grad_list]
        else:
            send_as = [v.name for v in self.table_grad_list]
        block.insert_op(
            idx + 1, "split_ids",
            {"Ids": [grad_var]}, {"Out": self.table_grad_list}, {})
        block.insert_op(
            idx + 2, "send_vars",
            {"X": self.table_grad_list}, {"Out": []},
            {"epmap": list(pserver_endpoints), "send_as": send_as,
             "sync_send": True,
             OP_ROLE_ATTR_NAME: RPC_OP_ROLE_ATTR_VALUE},
        )
        block.program._mutation += 1

    def _create_prefetch_block(self, pserver_index, pserver_program):
        """reference :726 — pserver-side block: lookup_sparse_table over the
        local table shard."""
        gb = pserver_program.global_block()
        table_var = gb.vars[self.table_name]
        pf_in = gb.create_var(name=f"{self.table_name}.prefetch_ids",
                              dtype="int64", shape=(-1, 1))
        pf_out = gb.create_var(name=f"{self.table_name}.prefetch_rows",
                               dtype=table_var.dtype,
                               shape=(-1, int(self.table_shape[1])))
        blk = pserver_program.create_block(0)
        pserver_program.rollback()
        blk.append_op(
            "lookup_sparse_table",
            {"Ids": [pf_in], "W": [table_var]}, {"Out": [pf_out]},
            {"is_distributed": True, "auto_grown_table": True},
        )
        return blk, pf_in.name, pf_out.name

    def _create_table_optimize_block(self, pserver_index, pserver_program,
                                     table_opt_op):
        """reference :751 — sum the trainers' SelectedRows table-grad
        shards (scaled 1/trainers like the dense path), then sparse-sgd into
        the SparseTable. Only sgd is supported for the table (same
        restriction as the reference)."""
        gb = pserver_program.global_block()
        table_var = gb.vars[self.table_name]
        assert table_opt_op.type == "sgd", (
            "distributed lookup table only supports the sgd optimizer "
            f"(reference restriction); got {table_opt_op.type}")
        grad_name = f"{self.table_name}@GRAD.block_{pserver_index}"
        dtype = table_var.dtype
        blk = pserver_program.create_block(0)
        pserver_program.rollback()
        if self.sync_mode and self.trainer_num > 1:
            trainer_grads = [
                gb.create_var(name=f"{grad_name}.trainer_{t}",
                              dtype=dtype, shape=(-1,))
                for t in range(self.trainer_num)
            ]
            merged = blk.create_var(name=grad_name + ".merged",
                                    dtype=dtype, shape=(-1,))
            blk.append_op("sum", {"X": trainer_grads}, {"Out": [merged]}, {})
            scaled = blk.create_var(name=grad_name + ".scaled",
                                    dtype=dtype, shape=(-1,))
            blk.append_op("scale", {"X": [merged]}, {"Out": [scaled]},
                          {"scale": 1.0 / self.trainer_num})
            grad_in = scaled
            recv_names = [v.name for v in trainer_grads]
        else:
            grad_in = gb.create_var(name=grad_name, dtype=dtype,
                                    shape=(-1,))
            recv_names = [grad_name]
        lr_name = table_opt_op.input("LearningRate")[0]
        lr_var = gb.vars.get(lr_name)
        if lr_var is None:
            orig_lr = self.origin_program.global_block().vars[lr_name]
            lr_var = self._clone_var(gb, orig_lr)
        blk.append_op(
            "sgd",
            {"Param": [table_var], "Grad": [grad_in],
             "LearningRate": [lr_var]},
            {"ParamOut": [table_var]},
            dict(table_opt_op.attrs),
        )
        return blk, recv_names

    def _delete_trainer_optimize_ops(self, block):
        block.ops = [
            op
            for op in block.ops
            if op.attrs.get(OP_ROLE_ATTR_NAME) != OpRole.Optimize
        ]
        block.program._mutation += 1

    def get_trainer_program(self):
        """reference :406."""
        return self.origin_program

    def get_pserver_program(self, endpoint):
        """reference :413 — build the pserver-side program: per-param-shard
        optimize sub-blocks under listen_and_serv."""
        pserver_program = Program()
        recv_inputs = []
        for v in self.param_grad_ep_mapping[endpoint]["params"]:
            self._clone_var(pserver_program.global_block(), v)
        for v in self.param_grad_ep_mapping[endpoint]["grads"]:
            # trainer-suffixed grad receive buffers
            for trainer_id in range(self.trainer_num):
                if self.trainer_num > 1:
                    name = f"{v.name}.trainer_{trainer_id}"
                else:
                    name = v.name
                var = pserver_program.global_block().create_var(
                    name=name, persistable=False, dtype=v.dtype, shape=v.shape
                )
                recv_inputs.append(var)

        optimize_block_ids = []
        for idx, (param, grad) in enumerate(
            self._endpoint_param_grads(endpoint)
        ):
            per_opt_block = pserver_program.create_block(0)
            pserver_program.rollback()
            for op in self.optimize_ops:
                if (
                    "Param" in op.inputs
                    and same_or_split_var(param.name, op.input("Param")[0])
                ):
                    self._append_pserver_optimize_op(
                        pserver_program, per_opt_block, op, param, grad, endpoint
                    )
            optimize_block_ids.append(per_opt_block)

        grad_to_block_id = [
            f"{g.name}:{b.idx}"
            for g, b in zip(
                self.param_grad_ep_mapping[endpoint]["grads"],
                optimize_block_ids,
            )
        ]
        attrs = {
            "OptimizeBlocks": optimize_block_ids,
            "endpoint": endpoint,
            "Fanin": self.trainer_num,
            "sync_mode": self.sync_mode,
            "grad_to_block_id": grad_to_block_id,
        }
        if self.table_name:
            pserver_index = self.pserver_endpoints.index(endpoint)
            origin_param = \
                self.origin_program.global_block().vars[self.table_name]
            self.table_shape = origin_param.shape
            pserver_program.global_block().create_var(
                name=self.table_name, persistable=True,
                dtype=origin_param.dtype, shape=origin_param.shape)
            table_opt_ops = [
                op for op in self.optimize_ops
                if "Param" in op.inputs
                and op.input("Param")[0] == self.table_name
            ]
            if table_opt_ops:  # frozen/inference tables serve prefetch only
                table_opt_block, table_recv_names = \
                    self._create_table_optimize_block(
                        pserver_index, pserver_program, table_opt_ops[0])
                optimize_block_ids.append(table_opt_block)
                for name in table_recv_names:
                    recv_inputs.append(
                        pserver_program.global_block().vars[name]
                        if name in pserver_program.global_block().vars
                        else pserver_program.global_block().create_var(
                            name=name, dtype=origin_param.dtype, shape=(-1,)))
                grad_to_block_id.append(
                    f"{self.table_name}@GRAD.block_{pserver_index}"
                    f":{table_opt_block.idx}")
            prefetch_block, pf_in, pf_out = self._create_prefetch_block(
                pserver_index, pserver_program)
            attrs.update(
                PrefetchBlock=prefetch_block,
                prefetch_in_name=pf_in,
                prefetch_out_name=pf_out,
                table_name=self.table_name,
            )

        pserver_program.global_block().append_op(
            "listen_and_serv", {"X": recv_inputs}, {}, attrs,
        )
        return pserver_program

    def _endpoint_param_grads(self, endpoint):
        return list(
            zip(
                self.param_grad_ep_mapping[endpoint]["params"],
                self.param_grad_ep_mapping[endpoint]["grads"],
            )
        )

    def _block_accumulators(self, op, param):
        """{accumulator name: its block var's name} for optimizer op `op`
        updating `param`, a block of a split parameter: the inputs of the
        parameter's shape beside Param and Grad (reference
        _get_optimizer_input_shape). Empty for an unsplit parameter."""
        if ".block" not in param.name:
            return {}
        gb = self.origin_program.global_block()
        orig = gb.vars[op.input("Param")[0]]
        suffix = param.name[len(orig.name):]
        accs = {}
        for key, names in op.inputs.items():
            if key in ("Param", "Grad", "LearningRate"):
                continue
            for n in names:
                v = gb.vars.get(n)
                if v is not None and tuple(v.shape or ()) == \
                        tuple(orig.shape or ()):
                    accs[n] = n + suffix
        return accs

    def _append_pserver_optimize_op(self, program, block, op, param, grad, endpoint):
        """clone one optimizer op onto the pserver block, rewired to the
        shard vars (reference __append_optimize_op__:494); a split
        parameter's accumulators become block vars of the block's shape
        (`_block_accumulators`), whose init get_startup_program makes."""
        accs = self._block_accumulators(op, param)
        gblock = block.program.global_block()
        for n, bn in accs.items():
            if not gblock.has_var(bn):
                orig_var = self.origin_program.global_block().vars[n]
                gblock.create_var(name=bn, shape=list(param.shape),
                                  dtype=orig_var.dtype,
                                  lod_level=orig_var.lod_level,
                                  persistable=True)
            self._accumulator_blocks.setdefault(endpoint, {})[bn] = \
                (n, list(param.shape))
        new_inputs = {}
        for key, names in op.inputs.items():
            if key == "Param":
                new_inputs[key] = [param.name]
            elif key == "Grad":
                if self.sync_mode and self.trainer_num > 1:
                    # aggregate trainer grads: sum op first
                    merged = block.create_var(
                        name=grad.name + ".merged", dtype=grad.dtype, shape=grad.shape
                    )
                    block.append_op(
                        "sum",
                        {
                            "X": [
                                f"{grad.name}.trainer_{tid}"
                                for tid in range(self.trainer_num)
                            ]
                        },
                        {"Out": [merged]},
                    )
                    scaled = block.create_var(
                        name=grad.name + ".scaled", dtype=grad.dtype, shape=grad.shape
                    )
                    block.append_op(
                        "scale",
                        {"X": [merged]},
                        {"Out": [scaled]},
                        {"scale": 1.0 / self.trainer_num},
                    )
                    new_inputs[key] = [scaled.name]
                else:
                    new_inputs[key] = [grad.name]
            else:
                for n in names:
                    orig_var = self.origin_program.global_block().vars.get(n)
                    if n not in accs and orig_var is not None and \
                            not block.program.global_block().has_var(n):
                        self._clone_var(block.program.global_block(), orig_var)
                new_inputs[key] = [accs.get(n, n) for n in names]
        new_outputs = {}
        for key, names in op.outputs.items():
            rewired = []
            for n in names:
                if same_or_split_var(param.name, n):
                    rewired.append(param.name)
                elif n in accs:
                    rewired.append(accs[n])
                else:
                    if not block.program.global_block().has_var(n):
                        orig_var = self.origin_program.global_block().vars.get(n)
                        if orig_var is not None:
                            self._clone_var(block.program.global_block(), orig_var)
                    rewired.append(n)
            new_outputs[key] = rewired
        block.append_op(op.type, new_inputs, new_outputs, dict(op.attrs))

    def get_startup_program(self, endpoint, pserver_program):
        """reference :569 — startup program for one pserver: create + init
        only the vars that live on this endpoint."""
        s_prog = Program()
        orig_s_prog = self.startup_program
        params = self.param_grad_ep_mapping[endpoint]["params"]
        param_names = {p.name for p in params}

        def _is_on_endpoint(var_name):
            return any(same_or_split_var(p, var_name) for p in param_names) or any(
                same_or_split_var(var_name, p.split(".block")[0]) for p in param_names
            )

        # vars the pserver program actually uses (params + optimizer aux
        # vars cloned by _append_pserver_optimize_op: learning rate,
        # accumulators) — their init ops must run on this pserver too
        pserver_vars = set()
        for blk in pserver_program.blocks:
            pserver_vars.update(blk.vars.keys())

        created = set()
        for op in orig_s_prog.global_block().ops:
            out_names = op.output_arg_names()
            if not out_names:
                continue
            target = out_names[0]
            if self.table_name and target == self.table_name:
                continue  # the table is a SparseTable, not a dense init
            if target in pserver_vars or any(
                same_or_split_var(p, target) or p == target for p in param_names
            ) or any(
                target == p.split(".block")[0] for p in param_names
            ):
                orig_var = orig_s_prog.global_block().vars.get(target)
                if orig_var is not None and target not in created:
                    self._clone_var(s_prog.global_block(), orig_var)
                    created.add(target)
                s_prog.global_block().append_op(
                    op.type, dict(op.inputs), dict(op.outputs), dict(op.attrs)
                )
        # a block of a split param runs the param's own initializer at the
        # block's shape, and so does each of its block accumulators
        # (reference Fluid; the JAX package fills the block with zeros)
        blocks = [(p.name, p.name.split(".block")[0], list(p.shape))
                  for p in params
                  if p.name not in created and "block" in p.name]
        blocks += [(bn, n, shape) for bn, (n, shape) in
                   self._accumulator_blocks.get(endpoint, {}).items()]
        for name, orig_name, shape in blocks:
            init = self._init_op(orig_name)
            var = pserver_program.global_block().vars.get(name)
            self._clone_var(s_prog.global_block(), var)
            if init is not None and "shape" in init.attrs:
                attrs = dict(init.attrs)
                attrs["shape"] = shape
                s_prog.global_block().append_op(
                    init.type, dict(init.inputs),
                    {slot: [name] for slot in init.outputs}, attrs)
            else:
                s_prog.global_block().append_op(
                    "fill_constant",
                    {},
                    {"Out": [name]},
                    {"shape": shape, "value": 0.0, "dtype": var.dtype},
                )
        if self.table_name:
            # the table shard is an auto-growing SparseTable (rows are
            # initialized deterministically on first touch), not a dense init
            tv = s_prog.global_block().create_var(
                name=self.table_name, persistable=True,
                dtype="float32", shape=self.table_shape)
            s_prog.global_block().append_op(
                "init_sparse_table", {}, {"Out": [tv]},
                {"value_dim": int(self.table_shape[1]),
                 "height": int(self.table_shape[0]),
                 "seed": 0},
            )
        return s_prog

    def _init_op(self, name):
        """The op of the original startup program that initializes
        `name`, or None."""
        for op in self.startup_program.global_block().ops:
            if op.output_arg_names()[:1] == [name]:
                return op
        return None

    # ------------------------------------------------------------------
    def _get_optimize_pass(self):
        block = self.origin_program.global_block()
        opt_ops = []
        params_grads = []
        for op in block.ops:
            if op.attrs.get(OP_ROLE_ATTR_NAME) == OpRole.Optimize:
                opt_ops.append(op)
                if "Param" in op.inputs and "Grad" in op.inputs:
                    p_name = op.input("Param")[0]
                    g_name = op.input("Grad")[0]
                    params_grads.append(
                        (block.vars[p_name], block.vars[g_name])
                    )
        return opt_ops, params_grads

    def _create_vars_from_blocklist(self, program, block_list):
        """reference create_vars_from_blocklist — materialize split vars."""
        block_map = {}
        var_mapping = {}
        for block_str in block_list:
            varname, offset, size = block_str.split(":")
            block_map.setdefault(varname, []).append((int(offset), int(size)))
        for varname, split in sorted(block_map.items()):
            orig_var = program.global_block().var(varname)
            if len(split) == 1:
                var_mapping[varname] = [orig_var]
                continue
            var_mapping[varname] = []
            orig_shape = orig_var.shape
            orig_dim1_flatten = int(math.prod(orig_shape[1:])) if len(orig_shape) >= 2 else 1
            for i, (offset, size) in enumerate(split):
                rows = size // orig_dim1_flatten
                splited_shape = [rows] + list(orig_shape[1:])
                new_var_name = "%s.block%d" % (varname, i)
                var = program.global_block().create_var(
                    name=new_var_name,
                    persistable=False,
                    dtype=orig_var.dtype,
                    shape=splited_shape,
                )
                var_mapping[varname].append(var)
        return var_mapping

    def _clone_var(self, block, var, persistable=True):
        return block.create_var(
            name=var.name,
            shape=var.shape,
            dtype=var.dtype,
            lod_level=var.lod_level,
            persistable=persistable,
        )

    def _find_op_index_by_output(self, block, varname):
        for i, op in enumerate(block.ops):
            if varname in op.output_arg_names():
                return i
        return len(block.ops) - 1
