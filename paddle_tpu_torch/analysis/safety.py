"""Safety analyses (the `full` level): donation, write-after-read, and
cross-replica collective order.

PTA010 — read-after-donate. `executor_core.compile_step_fn` donates the
buffers of every written persistable (donate_state) to the compiled step,
and the weight update is the program's semantic step boundary. A Forward-
or Backward-role op that reads a persistable AFTER the op that updates it
therefore observes the *post-update* value where the graph's intent (op
role) says it belongs to the pre-update phase — a silent off-by-one-step
bug, and exactly the buffer-aliasing pattern XLA's donation rules exist
to forbid.

In the port there is no XLA donation: a captured step
(executor_core.CapturedStep) and the interpreter write every written
persistable back into the scope's own tensor, in place. The hazard is the
same one: a read placed after the update sees the new value. The code,
its severity and its verdicts are the JAX package's.

PTA011 — write-after-read. backward.py's REPLACE rewiring lets an op
update a var in place. If a forward op read var X, a later op overwrote X
(in place or by plain redefinition), and X's grad op then reads X again,
the grad observes the OVERWRITTEN value — the recompute-from-stale-state
class of silent numerical corruption.

PTA012/PTA013 — collective order. Under SPMD every replica runs the same
traced program, so collectives deadlock only when replicas disagree on
issue order. Two statically checkable violations: a collective issued
under control flow (a replica-dependent predicate can skip it — PTA013),
and a zero1 scatter/update/gather group whose members are out of order or
incomplete (PTA012): the gather must consume the updated shard produced
AFTER its optimizer op, and a param whose shard-layout vars exist must
have its regathering collective.
"""

from ..core.framework import OpRole
from .verifier import COLLECTIVE_OPS, op_role, sub_blocks, written_names

__all__ = ["check_donation", "check_war_hazards",
           "check_collective_order"]


def _sub_reads_after_update(block, pos, updated_at, report, sev_note):
    """PTA010 inside a sub-block tree: the whole tree executes at program
    point `pos` (the parent op's block-0 index), so a read of a
    persistable updated before `pos` is the same stale-donated-buffer
    observation the top-level scan flags."""
    for i, op in enumerate(block.ops):
        role = op_role(op)
        if role not in (OpRole.Optimize, OpRole.RPC) \
                and op.type not in COLLECTIVE_OPS:
            for name in op.input_arg_names():
                j = updated_at.get(name)
                if j is not None and j < pos:
                    report.add(
                        "PTA010",
                        f"op inside a control-flow sub-block (entered at "
                        f"top-level op#{pos}) reads persistable {name!r} "
                        f"after its weight update at op#{j} "
                        f"donated/overwrote the buffer{sev_note}",
                        block_idx=block.idx, op_idx=i, op_type=op.type,
                        var=name)
        for sb in sub_blocks(op):
            _sub_reads_after_update(sb, pos, updated_at, report, sev_note)


def check_donation(program, report, donate_state=True):
    """PTA010 over block 0 AND control-flow sub-blocks (updates land in
    block 0 — optimizer ops never sit in sub-blocks — but a while/cond
    body placed after the update can still read the donated param)."""
    ops = program.global_block().ops
    gb = program.global_block()
    # program point where each persistable's update lands: outputs of
    # Optimize-role ops, plus zero1_gather (the regathered param write —
    # role-tagged Forward by the rewrite pass, semantically the update)
    updated_at = {}
    for i, op in enumerate(ops):
        if op_role(op) == OpRole.Optimize or op.type == "zero1_gather":
            for name in op.output_arg_names():
                var = gb.vars.get(name)
                if var is not None and var.persistable:
                    updated_at.setdefault(name, i)
    if not updated_at:
        return
    sev_note = "" if donate_state else \
        " (donate_state is off here, but the stale-read remains)"
    for i, op in enumerate(ops):
        role = op_role(op)
        if role not in (OpRole.Optimize, OpRole.RPC) \
                and op.type not in COLLECTIVE_OPS:
            for name in op.input_arg_names():
                j = updated_at.get(name)
                if j is not None and j < i:
                    report.add(
                        "PTA010",
                        f"{'forward' if role == OpRole.Forward else 'backward'}"
                        f"-role op reads persistable {name!r} after its "
                        f"weight update at op#{j} donated/overwrote the "
                        f"buffer{sev_note}",
                        block_idx=0, op_idx=i, op_type=op.type, var=name)
        for sb in sub_blocks(op):
            _sub_reads_after_update(sb, i, updated_at, report, sev_note)


def check_war_hazards(program, report):
    """PTA011 over block 0, with sub-block writes folded in: a grad op
    reading a forward value that was overwritten after the paired forward
    op consumed it.  An op carrying a sub-block (while/cond) counts as
    writing, at its own index, every name its body writes into the parent
    scope — so an in-body overwrite of a forward activation is visible to
    the flat scan."""
    gb = program.global_block()
    ops = gb.ops
    writers = {}  # name -> [op indices that write it]
    for i, op in enumerate(ops):
        for name in op.output_arg_names():
            writers.setdefault(name, []).append(i)
        for sb in sub_blocks(op):
            for name in written_names(sb):
                # only names resolving in the parent scope escape
                if name not in sb.vars and gb.has_var_recursive(name):
                    ws = writers.setdefault(name, [])
                    if not ws or ws[-1] != i:
                        ws.append(i)
    for k, g in enumerate(ops):
        if op_role(g) != OpRole.Backward or not g.type.endswith("_grad"):
            continue
        base = g.type[:-5]
        for name in g.input_arg_names():
            if not name or name.endswith("@GRAD"):
                continue
            ws = [i for i in writers.get(name, ()) if i < k]
            if len(ws) < 2:
                continue  # single definition: grad reads what forward read
            last_w = ws[-1]
            # the paired forward op: the latest forward-section op of the
            # grad's base type that consumed `name` BEFORE the overwrite
            f = None
            for i in range(last_w - 1, -1, -1):
                if ops[i].type == base \
                        and name in ops[i].input_arg_names():
                    f = i
                    break
            if f is None:
                continue
            report.add(
                "PTA011",
                f"grad op reads {name!r}, but op#{last_w}"
                f"({ops[last_w].type}) overwrote it after the paired "
                f"forward op#{f} consumed the original value "
                f"(write-after-read; backward needs the pre-overwrite "
                f"value)",
                block_idx=0, op_idx=k, op_type=g.type, var=name)


def _collect_collectives(block, depth, out):
    for i, op in enumerate(block.ops):
        if op.type in COLLECTIVE_OPS:
            out.append((block.idx, i, op, depth))
        for sb in sub_blocks(op):
            _collect_collectives(sb, depth + 1, out)


def check_collective_order(program, report):
    """PTA012/PTA013 as described in the module docstring."""
    colls = []
    _collect_collectives(program.global_block(), 0, colls)
    for bidx, i, op, depth in colls:
        if depth > 0:
            report.add(
                "PTA013",
                f"collective {op.type!r} sits inside a control-flow "
                f"sub-block; a replica-dependent predicate would skip it "
                f"on some replicas and deadlock the others",
                block_idx=bidx, op_idx=i, op_type=op.type)

    # zero1 group invariants: for every param with shard-layout plumbing,
    # order must be scatter(grad) < update < gather, and the gather must
    # exist and consume the update's output.  Group members are collected
    # through sub-blocks too (a nested member executes at its top-level
    # op's program point — PTA013 flags the nesting itself separately, but
    # the group-completeness invariants still apply).
    groups = {}  # param name -> dict of indices

    def _scan(block, pos=None):
        for i, op in enumerate(block.ops):
            p = i if pos is None else pos
            if op.type == "zero1_scatter":
                out = (op.outputs.get("Out") or [""])[0]
                if out.endswith("@zero1_rs"):
                    groups.setdefault(
                        out[:-len("@zero1_rs")], {})["rs"] = p
                elif out.endswith("@zero1_shard"):
                    groups.setdefault(
                        out[:-len("@zero1_shard")], {})["pshard"] = p
            elif op.type == "zero1_gather":
                out = (op.outputs.get("Out") or [""])[0]
                if out:
                    groups.setdefault(out, {})["gather"] = p
            else:
                for name in op.output_arg_names():
                    if name.endswith("@zero1_upd"):
                        groups.setdefault(
                            name[:-len("@zero1_upd")], {})["upd"] = p
            for sb in sub_blocks(op):
                _scan(sb, p)

    _scan(program.global_block())
    # `groups` keys mix grad and param names; a param group is one with an
    # update or gather or param-shard scatter
    for key, g in sorted(groups.items()):
        if "upd" not in g and "gather" not in g and "pshard" not in g:
            continue  # pure grad-side entry (keyed by grad name)
        upd, gather = g.get("upd"), g.get("gather")
        if upd is not None and gather is None:
            report.add(
                "PTA012",
                f"param {key!r} has a shard-layout update at op#{upd} but "
                f"no zero1_gather regathers it; replicas would diverge on "
                f"the replicated copy",
                block_idx=0, op_idx=upd, var=key)
        if upd is not None and gather is not None and gather < upd:
            report.add(
                "PTA012",
                f"zero1_gather for param {key!r} at op#{gather} is issued "
                f"BEFORE its shard update at op#{upd}; the collective "
                f"order diverges from the update order",
                block_idx=0, op_idx=gather, op_type="zero1_gather",
                var=key)
        pshard = g.get("pshard")
        if pshard is not None and upd is not None and pshard > upd:
            report.add(
                "PTA012",
                f"param-shard zero1_scatter for {key!r} at op#{pshard} is "
                f"issued after the update it feeds at op#{upd}",
                block_idx=0, op_idx=pshard, op_type="zero1_scatter",
                var=key)
