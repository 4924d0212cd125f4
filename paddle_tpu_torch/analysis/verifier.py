"""Structural ProgramDesc verification (the `basic` level).

Walks the block tree in execution order, tracking which variable names are
defined at each program point:

  * PTA008 — an op references a name declared in no reachable block
  * PTA001 — a name is read before any op defines it (and it is not a
    feed, not persistable, and not runtime-managed)
  * PTA002 — one op lists the same output name twice
  * PTA003 — a declared var no op ever touches (dangling)
  * PTA004 — replaying the `core.shape_inference` contract for the op
    raises ShapeError (dtype/shape inconsistency)
  * PTA005 — the op type has no infer_shape contract (coverage signal;
    this is how the missing-contract worklist is surfaced)
  * PTA006 — the op type has no registered kernel at all
  * PTA007 — a `<T>_grad` op with no forward `<T>` op in the program

Sub-block scoping: ops carrying a Block-valued attr (while/cond and
friends) execute their sub-block against the parent's defined-set; names
the sub-block writes into parent-declared vars escape back conservatively.
What such an op binds for its block at run time (`bound_names`: a
recurrent op's memories and step inputs, a conditional_block's own
outputs) is written at the op, and the grads of those names count as
declared.

The walk never mutates the input program: contract replay runs against a
throwaway clone because `InferShapeContext.set_output_dim` refines var
shapes in place.

A copy of the JAX package's verifier (paddle_tpu/analysis/verifier.py)
over the port's IR, registry and shape contracts, with the same codes,
messages and locations, but two: the partial gradients backward.py sums
(`_ACCUMULATION_PART`) are not PTA008, and the names control-flow ops bind
(`bound_names`) are neither PTA001 nor, as grads, PTA008 (ROADMAP §3 item
18). The port's registry has no
`no_trace` mark: every such op type of the JAX package has a shape
contract, so the mark never decides a PTA005 there, and the port leaves it
out.
"""

import re

from ..core import registry
from ..core import shape_inference
from ..core.framework import Block, OpRole, OP_ROLE_ATTR_NAME, VarType

__all__ = ["check_structure", "check_contracts", "check_grad_pairing",
           "op_role", "sub_blocks", "written_names", "bound_names",
           "COLLECTIVE_OPS"]

# op types that move data across replicas; their issue order must be a
# single total order on every replica (see safety.check_collective_order)
COLLECTIVE_OPS = ("zero1_scatter", "zero1_gather", "all_reduce",
                  "all_gather", "reduce_scatter", "broadcast",
                  "shard_gather", "shard_lookup_table")

# var types the runtime materializes outside the op dataflow
_RUNTIME_VAR_TYPES = (VarType.READER, VarType.FEED_MINIBATCH,
                      VarType.FETCH_LIST, VarType.STEP_SCOPES,
                      VarType.LOD_RANK_TABLE, VarType.RAW)

# ops whose semantics are control/host-side; a missing shape contract for
# these is by design, not a coverage gap
_NO_CONTRACT_EXPECTED = {
    "feed", "fetch", "while", "conditional_block", "go", "select",
    "parallel_do", "print", "save", "load", "save_combine", "load_combine",
    "read", "create_random_data_generator", "create_recordio_file_reader",
    "create_shuffle_reader", "create_batch_reader",
    "create_double_buffer_reader", "create_multi_pass_reader",
    "open_recordio_file", "open_files", "channel_create", "channel_send",
    "channel_recv", "channel_close",
}


# the partial gradients backward.py sums a var's gradient from
# (`<x>@GRAD@RENAME_<n>`, `<x>@GRAD@PRE_<n>`): temporaries of the step's env
# that backward never declares. The JAX package's verifier reports each
# write of one as PTA008, which refuses every training program whose
# gradients accumulate — every residual network, the headline among them
# (ROADMAP §3); the port's verifier takes them as declared.
_ACCUMULATION_PART = re.compile(r"@GRAD@(RENAME|PRE)_\d+$")


def op_role(op):
    """Base OpRole with the Loss bit masked off."""
    return int(op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)) \
        & ~OpRole.Loss


def sub_blocks(op):
    """Block-valued attrs of a control-flow op, in attr order."""
    return [v for v in op.attrs.values() if isinstance(v, Block)]


def written_names(block):
    """Every name any op in `block` (or a nested sub-block) writes."""
    out = set()
    for op in block.ops:
        out.update(op.output_arg_names())
        for sb in sub_blocks(op):
            out.update(written_names(sb))
    return out


# attrs of the recurrent ops naming what the op binds in its block at run
# time (recurrent, dynamic_recurrent: layers/control_flow.py)
_BOUND_ATTRS = ("pre_mem_names", "step_input_names", "static_input_names",
                "closure_names")


def bound_names(op):
    """The names a control-flow op binds for its block at run time, which
    the verifier takes as written at the op: a recurrent op's memories and
    step inputs, and every name an op reads that its own block writes —
    a conditional_block's outputs, whose value where the predicate fails
    the op keeps (IfElse's branch outputs). Empty for an op without a
    block. The JAX package's verifier follows none of them (ROADMAP §3
    item 18)."""
    blocks = sub_blocks(op)
    if not blocks:
        return set()
    out = {n for key in _BOUND_ATTRS for n in op.attrs.get(key, ()) if n}
    written = set().union(*(written_names(b) for b in blocks))
    out.update(n for n in op.input_arg_names() if n in written)
    return out


def _bound_grads(program):
    """`<x>@GRAD` of every name a control-flow op of `program` binds: the
    grads backward makes for them (IfElse's branch outputs are declared in
    their branch's block, their grads in none)."""
    return {f"{n}@GRAD" for b in program.blocks for op in b.ops
            for n in bound_names(op)}


def _registered(op_type):
    if registry.get_op_def(op_type) is not None:
        return True
    # `<T>_grad` kernels are auto-derived from the forward kernel by the
    # registry on first lookup; statically, a registered forward is enough
    if op_type.endswith("_grad"):
        return registry.get_op_def(op_type[:-5]) is not None
    return False


def _walk(block, defined, feed_names, report, touched, bound_grads):
    """Verify one block's ops against the inherited defined-set. Returns
    the set of names written by this block (for parent escape)."""
    # names written later in THIS block — used to tell "use before def"
    # (PTA001 with a forward reference) from "never defined anywhere"
    writes_here = written_names(block)

    for i, op in enumerate(block.ops):
        loc = dict(block_idx=block.idx, op_idx=i, op_type=op.type)
        # what a control-flow op binds for its block is written at the op
        bound = bound_names(op)
        defined.update(bound)
        # ---- inputs: declared? defined yet? -------------------------------
        for name in op.input_arg_names():
            if not name:   # empty slot entry = optional input, skipped
                continue
            touched.add(name)
            if name in defined:
                continue
            var = block.var_recursive(name) \
                if block.has_var_recursive(name) else None
            if var is None:
                report.add(
                    "PTA008",
                    f"op reads {name!r} which is declared in no reachable "
                    f"block", var=name, **loc)
                continue
            if var.persistable or var.is_data \
                    or var.type in _RUNTIME_VAR_TYPES:
                defined.add(name)
                continue
            if feed_names is not None and name in feed_names:
                defined.add(name)
                continue
            if name in writes_here:
                report.add(
                    "PTA001",
                    f"op reads {name!r} before any op defines it (defined "
                    f"later in block {block.idx})", var=name, **loc)
            elif feed_names is not None:
                report.add(
                    "PTA001",
                    f"op reads {name!r} which is never defined: not a feed "
                    f"({sorted(feed_names)}), not persistable, not written "
                    f"by any op", var=name, **loc)
            else:
                # feeds unknown (e.g. mid-build verification): a never-
                # written non-persistable read is assumed to be a feed
                defined.add(name)
        # ---- duplicate outputs within one op ------------------------------
        seen = set()
        for name in op.output_arg_names():
            if not name:
                continue
            touched.add(name)
            if name in seen:
                report.add(
                    "PTA002",
                    f"op lists output {name!r} more than once",
                    var=name, **loc)
            seen.add(name)
            if not block.has_var_recursive(name) \
                    and not _ACCUMULATION_PART.search(name) \
                    and name not in bound_grads:
                report.add(
                    "PTA008",
                    f"op writes {name!r} which is declared in no reachable "
                    f"block", var=name, **loc)
        # ---- op type known? ----------------------------------------------
        if not _registered(op.type) \
                and not shape_inference.has_contract(op.type):
            report.add(
                "PTA006",
                f"op type {op.type!r} has no registered kernel", **loc)
        # ---- sub-blocks (while/cond) --------------------------------------
        for sb in sub_blocks(op):
            escaped = _walk(sb, set(defined), feed_names, report, touched,
                            bound_grads)
            # writes to parent-declared vars escape the sub-block
            defined.update(escaped)
        defined.update(seen)
    return written_names(block)


def check_structure(program, report, feed_names=None, fetch_names=None):
    """PTA001/002/003/006/008 over the whole block tree."""
    feed_set = set(feed_names) if feed_names is not None else None
    gb = program.global_block()
    defined = set()
    for b in program.blocks:
        for name, var in b.vars.items():
            if var.persistable or var.is_data \
                    or var.type in _RUNTIME_VAR_TYPES:
                defined.add(name)
    touched = set()
    _walk(gb, defined, feed_set, report, touched, _bound_grads(program))
    # dangling vars: declared, never read or written anywhere, and not an
    # input/output the runtime manages
    keep = set(fetch_names or ())
    if feed_set:
        keep |= feed_set
    for b in program.blocks:
        for name, var in b.vars.items():
            if name in touched or name in keep:
                continue
            if var.persistable or var.is_data \
                    or var.type in _RUNTIME_VAR_TYPES:
                continue
            report.add(
                "PTA003",
                f"variable {name!r} is declared but no op reads or writes "
                f"it", block_idx=b.idx, var=name)
    report.summary.update(
        n_blocks=len(program.blocks),
        n_ops=sum(len(b.ops) for b in program.blocks),
        n_vars=sum(len(b.vars) for b in program.blocks))


def check_contracts(program, report):
    """PTA004/005: replay every available infer_shape contract, in op
    order, on a clone (contracts refine shapes in place)."""
    clone = program.clone()
    missing = set()
    for b in clone.blocks:
        for i, op in enumerate(b.ops):
            if not shape_inference.has_contract(op.type):
                if op.type not in _NO_CONTRACT_EXPECTED \
                        and op.type not in missing:
                    missing.add(op.type)
                    report.add(
                        "PTA005",
                        f"op type {op.type!r} has no infer_shape contract; "
                        f"`basic` verification cannot check its "
                        f"shapes/dtypes", block_idx=b.idx, op_idx=i,
                        op_type=op.type)
                continue
            try:
                shape_inference.infer(op, b)
            except shape_inference.ShapeError as e:
                report.add(
                    "PTA004", str(e), block_idx=b.idx, op_idx=i,
                    op_type=op.type)
            except Exception as e:  # var missing etc — already PTA001/008
                report.add(
                    "PTA004",
                    f"contract replay for {op.type!r} failed: "
                    f"{type(e).__name__}: {e}",
                    block_idx=b.idx, op_idx=i, op_type=op.type)


def check_grad_pairing(program, report):
    """PTA007: every `<T>_grad` op should have a forward `<T>` op."""
    fwd_types = set()
    grad_ops = []
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            if op.type.endswith("_grad"):
                grad_ops.append((b.idx, i, op))
            else:
                fwd_types.add(op.type)
    for bidx, i, op in grad_ops:
        base = op.type[:-5]
        if base not in fwd_types:
            report.add(
                "PTA007",
                f"grad op {op.type!r} has no matching forward "
                f"{base!r} op in the program",
                block_idx=bidx, op_idx=i, op_type=op.type)
