"""GSPMD-style sharding propagation over a Program (a copy of the JAX
package's parallel/autoshard/propagate.py).

The fixpoint sweeps the global block with while/cond sub-block ops
folded inline (their def-use summarized onto the parent walk, like
analysis.dataflow does), so specs flow into loop bodies and back out
through escaping writes.

Seeds (user `parallel.set_sharding` annotations, plus the batch axis on
data vars) are pushed through the op graph by the per-op rules in
rules.py, forward and backward, until a fixpoint. Gradient vars are
linked to their forward vars through backward.py's naming convention
(`X@GRAD`, including the `@GRAD@RENAME@...` fresh names), so one seed on
a parameter lands on its grad and optimizer slots too. Conflicting
proposals are arbitrated once per var with the analytic collective-bytes
model in plan.py and then locked; later disagreeing proposals become
recorded reshard edges. Finalization assigns `()` (replicated) to
everything still unknown, so the resulting plan is always *total*.
"""

from ... import flags
from ...core.framework import GRAD_VAR_SUFFIX
from ...backward import _strip_grad_suffix
from .plan import (ShardingPlan, transition_bytes, _axes_factor,
                   SRC_SEED, SRC_FEED, SRC_DERIVED, SRC_GRAD,
                   SRC_RESOLVED, SRC_DEFAULT, _PRIORITY)
from .rules import rule_for, default_rule, grad_mirror_rule
from .spec import normalize_spec, canon, validate_seed_spec

__all__ = ["build_plan", "validate_seeds", "register_plan",
           "active_plan", "reset_registry", "manifest_section"]

flags.define(
    "autoshard", bool, False,
    "Propagate sharding seeds over the whole Program, register the plan "
    "(checkpoint manifests) and set its gauges; ParallelExecutor lowers "
    "it to each rank's program (lower.py), which it also does with the "
    "flag off wherever the mesh has an mp axis of more than one rank "
    "(BuildStrategy.auto_sharding overrides per-executor).")

_MAX_ITERS = 64


class _Ctx:
    """Read-only view the rules use."""

    __slots__ = ("_specs", "_shapes", "mesh_axes")

    def __init__(self, specs, shapes, mesh_axes):
        self._specs = specs
        self._shapes = shapes
        self.mesh_axes = mesh_axes

    def spec(self, name):
        st = self._specs.get(name)
        return None if st is None else st[0]

    def shape(self, name):
        return self._shapes.get(name)

    def rank(self, name):
        s = self._shapes.get(name)
        return None if s is None else len(s)


def validate_seeds(program, mesh_axes):
    """Validate every `set_sharding` annotation in `program` against the
    mesh. Raises ValueError (naming the var, the spec, and the mesh axes)
    at plan-construction time, before any step is prepared."""
    mesh_axes = dict(mesh_axes)
    for name, v in program.global_block().vars.items():
        s = getattr(v, "sharding", None)
        if s is None:
            continue
        s = normalize_spec(s)
        validate_seed_spec(name, s, v.shape, mesh_axes)


def build_plan(program, mesh_axes, batch_axis="dp", extra_seeds=None,
               ignore_program_seeds=False):
    """Produce a total ShardingPlan for `program` on a {axis: size} mesh.

    `extra_seeds` ({name: spec}) adds seeds without mutating the program
    (used by the CLI; program annotations still win on collision).
    `ignore_program_seeds` drops the program's own `set_sharding`
    annotations so `extra_seeds` fully define the seeding — the search in
    search.py uses this to evaluate candidate placements side by side.
    Raises ValueError on invalid seeds."""
    mesh_axes = {str(k): int(v) for k, v in dict(mesh_axes).items()}
    block = program.global_block()
    plan = ShardingPlan(mesh_axes, batch_axis=batch_axis)

    # Register vars and flatten ops across while/cond sub-blocks: the
    # sweep visits sub-block ops inline, right after the op that owns
    # them (the way dataflow._summarize_sub folds their def-use onto the
    # parent node), so a loop body reading a sharded param propagates
    # specs through body-locals and back out via escaping writes. Names
    # the sub-block does NOT redeclare resolve to the parent var, which
    # is already registered — parent entries win on collision.
    def _register_vars(blk):
        for name, v in blk.vars.items():
            if name in plan.specs:
                continue
            plan.shapes[name] = None if v.shape is None else tuple(v.shape)
            plan.dtypes[name] = str(getattr(v, "dtype", "float32"))
            plan.specs[name] = None

    def _flatten_ops(blk, into):
        for op in blk.ops:
            into.append(op)
            for a in op.attrs.values():
                if hasattr(a, "ops") and hasattr(a, "vars"):
                    _register_vars(a)
                    _flatten_ops(a, into)

    _register_vars(block)

    state = {}  # name -> (canonical spec, source)

    def assign(name, spec, src):
        state[name] = (canon(spec), src)

    seen_edges = set()

    def offer(name, spec, src, via):
        """Propose `spec` for `name`; returns True if the assignment
        changed. Locked entries (seeds, feeds, resolved conflicts) never
        change — disagreement is recorded as a reshard edge instead."""
        if name not in plan.specs:
            return False
        spec = canon(spec)
        cur = state.get(name)
        if cur is None:
            assign(name, spec, src)
            return True
        cur_spec, cur_src = cur
        if cur_spec == spec:
            return False
        shape = plan.shapes.get(name)
        dtype = plan.dtypes.get(name, "float32")
        cost_in = transition_bytes(shape, dtype, spec, cur_spec, mesh_axes)
        if _PRIORITY[cur_src] >= _PRIORITY[SRC_RESOLVED]:
            edge = (name, spec)
            if edge not in seen_edges:
                seen_edges.add(edge)
                plan.reshard_edges.append({
                    "var": name, "src": spec, "dst": cur_spec,
                    "op": via, "bytes": cost_in})
            return False
        # derived-vs-derived: arbitrate once with the cost model, lock
        cost_out = transition_bytes(shape, dtype, cur_spec, spec, mesh_axes)
        if cost_out < cost_in:
            kept, dropped, cost = spec, cur_spec, cost_out
        elif cost_in < cost_out:
            kept, dropped, cost = cur_spec, spec, cost_in
        else:  # tie: prefer the more-sharded layout (less resident memory)
            if _axes_factor(spec, mesh_axes) > \
                    _axes_factor(cur_spec, mesh_axes):
                kept, dropped, cost = spec, cur_spec, cost_out
            else:
                kept, dropped, cost = cur_spec, spec, cost_in
        plan.conflicts.append({
            "var": name, "kept": kept, "dropped": dropped,
            "op": via, "reshard_bytes": cost})
        changed = kept != cur_spec
        assign(name, kept, SRC_RESOLVED)
        return changed

    # -- seeds ------------------------------------------------------------
    seeds = {}
    if not ignore_program_seeds:
        for name, v in block.vars.items():
            s = getattr(v, "sharding", None)
            if s is not None:
                seeds[name] = s
    for name, s in dict(extra_seeds or {}).items():
        seeds.setdefault(name, s)
    for name, s in seeds.items():
        s = normalize_spec(s)
        shape = plan.shapes.get(name)
        validate_seed_spec(name, s, shape, mesh_axes)
        assign(name, s, SRC_SEED)
    if batch_axis and batch_axis in mesh_axes:
        for name, v in block.vars.items():
            if v.is_data and name not in seeds and \
                    plan.shapes.get(name):
                assign(name, (batch_axis,), SRC_FEED)

    # -- fixpoint ---------------------------------------------------------
    ops = []
    _flatten_ops(block, ops)
    ctx = _Ctx(state, plan.shapes, mesh_axes)
    grad_names = [n for n in plan.specs if GRAD_VAR_SUFFIX in n]

    def sweep(op_seq):
        changed = False
        for op in op_seq:
            rule = rule_for(op.type)
            if rule is None:
                # grad ops mirror their forward twins; guessing with the
                # generic same-rank copy there picks arbitrary inputs
                rule = grad_mirror_rule if op.type.endswith("_grad") \
                    else default_rule
            for name, spec in (rule(op, ctx) or ()):
                changed |= offer(name, spec, SRC_DERIVED, op.type)
        return changed

    def link_grads():
        changed = False
        for g in grad_names:
            f = _strip_grad_suffix(g)
            if f not in plan.specs or \
                    plan.shapes.get(f) != plan.shapes.get(g):
                continue  # only link same-shape pairs (sum'd renames etc.)
            gs, fs = ctx.spec(g), ctx.spec(f)
            if fs is not None and gs is None:
                changed |= offer(g, fs, SRC_GRAD, "grad-link")
            elif gs is not None and fs is None:
                changed |= offer(f, gs, SRC_GRAD, "grad-link")
        return changed

    for it in range(_MAX_ITERS):
        changed = link_grads()  # before the sweeps: seeds reach grads first
        changed |= sweep(ops)
        changed |= sweep(reversed(ops))
        changed |= link_grads()
        plan.iterations = it + 1
        if not changed:
            break

    # -- finalize: total plan ---------------------------------------------
    for name in plan.specs:
        st = state.get(name)
        if st is None:
            plan.specs[name] = ()
            plan.sources[name] = SRC_DEFAULT
        else:
            plan.specs[name] = st[0]
            plan.sources[name] = st[1]
    return plan


# ---------------------------------------------------------------------------
# process-wide registry: resilience.checkpoint records the active plan's
# digest + param layouts in manifest.json (mirrors zero1's contract —
# snapshots are always written in full/unsharded layout, gathered over
# the mp axis by lower.full_value, so restores are layout-independent and
# the manifest section is purely descriptive)
# ---------------------------------------------------------------------------
_ACTIVE_PLAN = None


def register_plan(plan):
    global _ACTIVE_PLAN
    _ACTIVE_PLAN = plan


def active_plan():
    return _ACTIVE_PLAN


def reset_registry():
    global _ACTIVE_PLAN
    _ACTIVE_PLAN = None


def manifest_section(snapshot_names):
    """Manifest entry for a checkpoint covering `snapshot_names`, or None
    when no autoshard plan is active or none of the saved vars are in it."""
    p = _ACTIVE_PLAN
    if p is None:
        return None
    names = [n for n in snapshot_names if n in p.specs]
    if not names:
        return None
    return {
        "digest": p.digest(),
        "mesh_axes": dict(p.mesh_axes),
        "layout": "full",
        "params": {n: list(canon(p.spec_of(n)) or ())
                   for n in names if canon(p.spec_of(n))},
    }
