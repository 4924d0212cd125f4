"""Model-health statistics computed inside the step.

When FLAGS_health > 0 the executors extend the step they are about to
prepare: the per-param gradients (intermediates of the step — they feed
the optimizer ops) are appended to the fetch list, and
`HealthPlan.wrap_step` folds them into ONE compact stats row per parameter
inside the step:

    stats[param] = [sum(g^2), sum(w^2), sum((w_new - w_old)^2),
                    nonfinite(g)]          (float32, shape [4])

so on the card the reductions ride the captured CUDA graph, and only the
[P, 4] rows come back (stacked [K, P, 4] under iters=K) — no full-tensor
readback. w_old is a float32 copy taken before the step runs, since the
fused updates write the scope's parameters in place.

Under FLAGS_zero1 the optimizer op reads `grad@zero1_rs`, the
reduce-scattered [1, shard] grad of this rank; its zero padding makes the
shard-local sum of squares this rank's part of the full grad's.

The off path (FLAGS_health == 0) is a single flag check in
`plan_if_enabled`. Host readback, ledger writes, gauges, and detectors
run only every FLAGS_health_interval steps (health/__init__.on_step).
The JAX package's paddle_tpu/health/stats.py, on torch tensors.
"""

import functools
import hashlib

from .. import flags
from ..core.framework import VarType

flags.define("health", int, 0,
             "Model-health telemetry: 0 = off (one flag check per run "
             "call), >0 = compute per-param grad/weight/update-ratio/"
             "non-finite stats inside the step (on the card, inside its "
             "CUDA graph) and journal them to FLAGS_health_ledger every "
             "FLAGS_health_interval steps.")
flags.define("health_interval", int, 1,
             "Sample model-health stats every N steps. The reductions "
             "run inside the step each step (keeping one captured graph); "
             "readback + ledger + detectors fire only on sampled steps.")

# Fields of each per-param stats row, in order.
STAT_FIELDS = ("grad_sq", "weight_sq", "delta_sq", "nonfinite")

# zero1.apply rewrites the optimizer op's Param input to the shard-layout
# alias; the canonical (full, persistable) parameter keeps its plain name.
_PARAM_SUFFIXES = ("@zero1_shard",)

_plan_cache = {}  # (id(program), mutation) -> HealthPlan


class HealthPlan:
    """Which (param, grad) pairs a program's step collects stats for."""

    __slots__ = ("pairs", "digest")

    def __init__(self, pairs):
        self.pairs = tuple(pairs)  # (label, grad_env_name)
        self.digest = hashlib.sha1(
            repr(self.pairs).encode()).hexdigest()[:12]

    @property
    def fetch_names(self):
        """Grad env names to append to the step's fetch list."""
        return [g for _, g in self.pairs]

    @property
    def labels(self):
        return [label for label, _ in self.pairs]

    def wrap_step(self, step, n_user):
        """Wrap a built step (executor_core.build_step_fn, its fetch list
        extended by `fetch_names`): consume the appended grad fetches and
        emit one [P, 4] float32 stats tensor (rows in `pairs` order) as a
        single extra fetch. The wrapper keeps the step's attributes (ops,
        blocker, caps)."""
        import torch

        from ..core.registry import seq_data

        pairs = self.pairs

        @functools.wraps(step)
        def health_step(mut_state, const_state, feeds, rng, **kw):
            # the update may write a parameter in place: keep its value
            w_old = {label: mut_state[label].to(torch.float32, copy=True)
                     for label, _ in pairs if label in mut_state}
            fetches, new_mut = step(mut_state, const_state, feeds, rng,
                                    **kw)
            user, grads = fetches[:n_user], fetches[n_user:]
            rows = []
            with torch.no_grad():
                for (label, _), g in zip(pairs, grads):
                    g32 = seq_data(g).to(torch.float32)
                    grad_sq = torch.sum(g32 * g32)
                    bad = torch.sum((~torch.isfinite(g32)).to(
                        torch.float32))
                    wo = w_old.get(label)
                    if wo is None:
                        wo = const_state.get(label)
                        wo = None if wo is None else wo.to(torch.float32)
                    if wo is not None:
                        wn = new_mut.get(label)
                        wn = wo if wn is None else wn.to(torch.float32)
                        weight_sq = torch.sum(wn * wn)
                        d = wn - wo
                        delta_sq = torch.sum(d * d)
                    else:
                        weight_sq = delta_sq = grad_sq.new_zeros(())
                    rows.append(torch.stack(
                        [grad_sq, weight_sq, delta_sq, bad]))
                stats = torch.stack(rows)
            return list(user) + [stats], new_mut

        return health_step


def plan_for(program):
    """Scan a (resolved) program for optimizer (Param, Grad) pairs.

    Every optimizer op names its inputs through the "Param"/"Grad" slots
    (a fused update names its bucket's members there, pair by pair); under
    FLAGS_zero1 the resolved program carries `p@zero1_shard` / `g@zero1_rs`
    instead — the label strips the shard suffix back to the canonical
    param name. Sparse (SELECTED_ROWS) and ragged grads have no dense norm
    and are skipped, mirroring zero1.build_plan.
    """
    key = (id(program), program._mutation)
    plan = _plan_cache.get(key)
    if plan is not None:
        return plan
    gb = program.global_block()
    pairs, seen = [], set()
    for op in gb.ops:
        for pname, gname in zip(op.inputs.get("Param") or (),
                                op.inputs.get("Grad") or ()):
            if not pname or not gname:
                continue
            label = pname
            for suf in _PARAM_SUFFIXES:
                if label.endswith(suf):
                    label = label[:-len(suf)]
            if label in seen:
                continue
            gvar = gb.vars.get(gname)
            if gvar is not None and (
                    gvar.type == VarType.SELECTED_ROWS
                    or getattr(gvar, "lod_level", 0)):
                continue
            pvar = gb.vars.get(label)
            if pvar is None or not getattr(pvar, "persistable", False):
                continue
            seen.add(label)
            pairs.append((label, gname))
    plan = HealthPlan(pairs)
    if len(_plan_cache) > 256:
        _plan_cache.clear()
    _plan_cache[key] = plan
    return plan


def plan_if_enabled(program):
    """One flag check when health is off; else the program's plan
    (None when the program has no optimizer ops to watch)."""
    if not flags.get("health"):
        return None
    plan = plan_for(program)
    return plan if plan.pairs else None


def reset():
    _plan_cache.clear()
