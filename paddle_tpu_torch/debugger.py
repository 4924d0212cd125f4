"""Program debugging / visualization (reference python/paddle/fluid/
debuger.py + graphviz.py): human-readable program dump and graphviz export
with role-colored ops, typed var nodes, slot-labeled edges, and sub-block
clusters. The JAX package's debugger (paddle_tpu/debugger.py): the same text
and the same .dot bytes on the same program."""

__all__ = ["pprint_program_codes", "pprint_block_codes",
           "draw_block_graphviz", "draw_program_graphviz"]


def _fmt_attr(v):
    if hasattr(v, "ops"):  # Block attr
        return f"<block {v.idx}>"
    s = repr(v)
    return s if len(s) <= 40 else s[:37] + "..."


def pprint_block_codes(block, show_backward=False, show_attrs=False):
    from .core.framework import OpRole, OP_ROLE_ATTR_NAME

    lines = [f"# block {block.idx} (parent {block.parent_idx})"]
    for v in block.vars.values():
        kind = "param" if getattr(v, "trainable", None) is not None else "var"
        lines.append(
            f"{kind} {v.name} : shape={v.shape} dtype={v.dtype} "
            f"persistable={v.persistable} lod={v.lod_level}"
        )
    for op in block.ops:
        role = op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)
        if not show_backward and role not in (OpRole.Forward, OpRole.Forward | OpRole.Loss):
            continue
        outs = ", ".join(f"{k}={v}" for k, v in op.outputs.items())
        ins = ", ".join(f"{k}={v}" for k, v in op.inputs.items())
        line = f"{outs} = {op.type}({ins})"
        if show_attrs:
            extras = {k: v for k, v in op.attrs.items()
                      if not k.startswith("op_role")}
            if extras:
                line += "  # " + ", ".join(
                    f"{k}={_fmt_attr(v)}" for k, v in sorted(extras.items()))
        lines.append(line)
    return "\n".join(lines)


def pprint_program_codes(program, show_backward=True, show_attrs=False):
    return "\n\n".join(
        pprint_block_codes(b, show_backward, show_attrs)
        for b in program.blocks
    )


def _esc(s):
    return str(s).replace('"', '\\"')


# role -> op-node fill color (reference debuger.py's per-role styles)
_ROLE_COLORS = {
    "forward": "#90ee90",    # light green
    "backward": "#ffb347",   # orange
    "optimize": "#b19cd9",   # purple
    "rpc": "#d3d3d3",        # grey
    "loss": "#32cd32",
}


def _op_role(op):
    from .core.framework import OpRole, OP_ROLE_ATTR_NAME

    role = op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)
    if role == OpRole.RPC:
        return "rpc"
    if role == OpRole.Optimize:
        return "optimize"
    if role & OpRole.Backward:  # incl. Backward|Loss (the loss-grad op)
        return "backward"
    if role & OpRole.Loss:
        return "loss"
    return "forward"


def _var_label(v):
    shape = "x".join(str(d) for d in (v.shape or ())) or "?"
    return f"{v.name}\\n{v.dtype}[{shape}]"


def _var_fill(name, v, highlights):
    from .core.framework import Parameter

    if name in highlights:
        return "red"
    if isinstance(v, Parameter):
        return "gold"
    if v.persistable:
        return "lightblue"
    return "white"


def _emit_block(block, lines, prefix, highlights, drawn_vars):
    """Emit one block's nodes/edges; returns var names referenced."""

    used = set()
    for i, op in enumerate(block.ops):
        op_node = f"{prefix}op_{i}_{op.type}"
        color = _ROLE_COLORS[_op_role(op)]
        lines.append(
            f'  "{op_node}" [shape=box, style=filled, '
            f'fillcolor="{color}", label="{_esc(op.type)}"];')
        for slot, names in op.inputs.items():
            for n in names:
                if n:
                    used.add(n)
                    lines.append(
                        f'  "{_esc(n)}" -> "{op_node}" '
                        f'[label="{_esc(slot)}", fontsize=8];')
        for slot, names in op.outputs.items():
            for n in names:
                if n:
                    used.add(n)
                    lines.append(
                        f'  "{op_node}" -> "{_esc(n)}" '
                        f'[label="{_esc(slot)}", fontsize=8];')
    for name in sorted(used - drawn_vars):
        try:
            v = block.var_recursive(name)  # full parent chain, not just
        except ValueError:                 # current + global blocks
            v = None
        if v is None:
            lines.append(f'  "{_esc(name)}" [shape=oval];')
        else:
            lines.append(
                f'  "{_esc(name)}" [shape=oval, style=filled, '
                f'fillcolor="{_var_fill(name, v, highlights)}", '
                f'label="{_esc(_var_label(v))}"];')
        drawn_vars.add(name)
    # vars declared in the block but not (yet) wired to any op still get a
    # node — a highlighted feed var with no consumer must not vanish
    for name, v in block.vars.items():
        if name in drawn_vars:
            continue
        lines.append(
            f'  "{_esc(name)}" [shape=oval, style=filled, '
            f'fillcolor="{_var_fill(name, v, highlights)}", '
            f'label="{_esc(_var_label(v))}"];')
        drawn_vars.add(name)
    return used


def draw_block_graphviz(block, highlights=None, path="./temp.dot"):
    """Emit a graphviz dot file of one block's dataflow. Ops are boxes
    colored by role (forward/backward/optimize/RPC), parameters gold,
    persistables blue, highlighted vars red; edges carry slot names."""
    lines = ["digraph G {", "  rankdir=TB;",
             '  node [fontsize=10]; edge [color="#555555"];']
    _emit_block(block, lines, "", set(highlights or []), set())
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def draw_program_graphviz(program, highlights=None, path="./program.dot"):
    """Whole-program export: block 0 at top level, every sub-block
    (control flow, pserver optimize blocks) as a labeled cluster."""
    lines = ["digraph G {", "  rankdir=TB;",
             '  node [fontsize=10]; edge [color="#555555"];']
    drawn = set()
    highlights = set(highlights or [])
    for b in program.blocks:
        if b.idx == 0:
            _emit_block(b, lines, "b0_", highlights, drawn)
        else:
            lines.append(f'  subgraph cluster_{b.idx} {{')
            lines.append(f'    label="block {b.idx}"; style=dashed;')
            _emit_block(b, lines, f"b{b.idx}_", highlights, drawn)
            lines.append("  }")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path
