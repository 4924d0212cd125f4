"""Sharding / plan validation (the `full` level).

Three inputs, all optional, validated when present:

  * the program's own `Variable.sharding` seed annotations against a
    {axis: size} mesh — PTA020 (unknown axis / spec longer than rank) and
    PTA021 (static dim not divisible);
  * an autoshard `ShardingPlan` — every assigned spec revalidated against
    the plan's mesh and recorded shapes, plan totality (PTA022), and an
    audit of the recorded reshard edges: each edge's var must be in the
    plan and its byte estimate must reproduce under the current cost
    model (PTA023);
  * a zero1 `Zero1Plan` — shard geometry consistency (parts/shard/padded
    arithmetic, accumulator shapes in the rewritten program) and the dp
    axis's existence in the mesh when one is given.

The JAX package's checks (paddle_tpu/analysis/plans.py) over the port's
programs, its parallel.zero1 plan and its parallel.autoshard plan.
"""

import numpy as np

__all__ = ["check_var_sharding", "check_autoshard_plan",
           "check_zero1_plan"]


def _spec_issues(name, spec, shape, mesh_axes, report, origin,
                 block_idx=None):
    spec = tuple(spec)
    rank = None if shape is None else len(shape)
    if rank is not None and len(spec) > rank:
        report.add(
            "PTA020",
            f"{origin}: sharding spec {spec} for {name!r} is longer than "
            f"its rank {rank} (shape {tuple(shape)})",
            var=name, block_idx=block_idx)
        return
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if ax not in mesh_axes:
            report.add(
                "PTA020",
                f"{origin}: spec {spec} for {name!r} names mesh axis "
                f"{ax!r}, mesh has {sorted(mesh_axes)}",
                var=name, block_idx=block_idx)
            continue
        if shape is None:
            continue
        dim = shape[d]
        if dim is None or int(dim) < 0:
            continue  # dynamic dim: the runtime check is authoritative
        size = int(mesh_axes[ax])
        if size > 0 and int(dim) % size != 0:
            report.add(
                "PTA021",
                f"{origin}: dim {d} of {name!r} (shape {tuple(shape)}) is "
                f"not divisible by mesh axis {ax!r} (size {size})",
                var=name, block_idx=block_idx)


def check_var_sharding(program, mesh_axes, report):
    """PTA020/PTA021 for user `set_sharding` annotations on the program."""
    if not mesh_axes:
        return
    for b in program.blocks:
        for name, var in b.vars.items():
            spec = getattr(var, "sharding", None)
            if spec is None:
                continue
            _spec_issues(name, spec, var.shape, mesh_axes, report,
                         "set_sharding seed", block_idx=b.idx)


def check_autoshard_plan(plan, report):
    """PTA020/021/022/023 for a built ShardingPlan."""
    if plan is None:
        return
    mesh_axes = plan.mesh_axes
    for name, spec in sorted(plan.specs.items()):
        if not spec:
            continue
        _spec_issues(name, spec, plan.shapes.get(name), mesh_axes, report,
                     "autoshard plan")
    if plan.unresolved:
        report.add(
            "PTA022",
            f"autoshard plan has {len(plan.unresolved)} unresolved "
            f"var(s): {sorted(plan.unresolved)[:8]}")
    unassigned = [n for n, s in plan.specs.items() if s is None]
    if unassigned:
        report.add(
            "PTA022",
            f"autoshard plan is not total: {len(unassigned)} var(s) have "
            f"no spec assigned: {sorted(unassigned)[:8]}")
    # reshard-edge audit: the recorded bytes must reproduce under the
    # current transition model, and the edge must reference plan vars
    from ..parallel.autoshard.plan import transition_bytes
    for e in plan.reshard_edges:
        name = e.get("var")
        if name not in plan.specs:
            report.add(
                "PTA023",
                f"reshard edge references {name!r} which is not in the "
                f"plan", var=name)
            continue
        want = transition_bytes(
            plan.shapes.get(name), plan.dtypes.get(name, "float32"),
            e.get("src"), e.get("dst"), mesh_axes)
        got = int(e.get("bytes", 0))
        if want and abs(got - want) > max(1, want // 100):
            report.add(
                "PTA023",
                f"reshard edge for {name!r} records {got} B but the "
                f"transition model yields {want} B "
                f"({e.get('src')} -> {e.get('dst')})", var=name)


def check_zero1_plan(plan, program, report, mesh_axes=None):
    """Shard-geometry consistency for a Zero1Plan (PTA020/PTA021)."""
    if plan is None or not plan.entries:
        return
    if mesh_axes and plan.axis not in mesh_axes:
        report.add(
            "PTA020",
            f"zero1 plan shards over axis {plan.axis!r}, mesh has "
            f"{sorted(mesh_axes)}")
    gb = program.global_block()
    for e in plan.entries:
        if plan.parts <= 0 or e.shard * plan.parts != e.padded \
                or e.padded < e.numel:
            report.add(
                "PTA021",
                f"zero1 entry for {e.param!r} has inconsistent shard "
                f"geometry: numel={e.numel} padded={e.padded} "
                f"shard={e.shard} parts={plan.parts}", var=e.param)
        pvar = gb.vars.get(e.param)
        if pvar is not None and pvar.shape is not None:
            numel = int(np.prod(pvar.shape)) if pvar.shape else 1
            if numel != e.numel:
                report.add(
                    "PTA021",
                    f"zero1 entry for {e.param!r} was planned at numel "
                    f"{e.numel} but the program declares shape "
                    f"{tuple(pvar.shape)} (numel {numel})", var=e.param)
        for _, _, name, _ in e.accums:
            avar = gb.vars.get(name)
            if avar is None or avar.shape is None:
                continue
            shp = tuple(avar.shape)
            if shp not in (tuple(e.shape), (plan.parts, e.shard)):
                report.add(
                    "PTA021",
                    f"zero1 accumulator {name!r} has shape {shp}; expected "
                    f"the full layout {tuple(e.shape)} or the shard layout "
                    f"{(plan.parts, e.shard)}", var=name)
