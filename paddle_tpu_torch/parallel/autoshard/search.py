"""Autoshard plan SEARCH: from propagate-from-seeds to pick-the-seeds.

`build_plan` answers "given these seeds, what does every var get?";
`search_plan` answers "which seeds?". It enumerates candidate seed
placements for the largest parameters across the mesh axes
(replicated, or one (dim, axis) shard per candidate), propagates each
trial to a full plan with ``build_plan``, scores whole plans with one
unified cost model, and keeps the cheapest:

    score_s = compute_s + comm_s [+ infeasible penalty]
    compute_s = sum(flops_i / shard_factor(out_i)) / peak_flops
    comm_s    = (reshard bytes + dp grad-sync bytes) / link_bytes_per_s
    penalty   = applied when analysis.hbm peak-HBM-per-replica exceeds
                the budget — infeasible plans lose to any feasible one

The manual seed set (the program's own `set_sharding` annotations) is
always evaluated first and the greedy ascent only ever accepts strict
improvements, so `search_plan(...).cost <= plan_cost(manual)` holds by
construction.

A copy of the JAX package's parallel/autoshard/search.py with the card's
figures in place of a TPU's: `peak_flops` and `link_bytes_per_s` are
arguments of `plan_cost` and `search_plan`, defaulting to one H100 SXM
(PEAK_FLOPS, LINK_BYTES_PER_S below); passing the JAX package's
constants (275e12 and 9e10) gives the JAX package's search.
"""

from ...core.framework import GRAD_VAR_SUFFIX
from ...monitor.mfu import CHIP_PEAK_TFLOPS
from .plan import _DTYPE_BYTES, _axes_factor, _numel
from .propagate import build_plan
from .spec import canon, normalize_spec, spec_str, validate_seed_spec

__all__ = ["plan_cost", "enumerate_seed_candidates", "search_plan",
           "SearchResult", "PEAK_FLOPS", "LINK_BYTES_PER_S"]

# the analytic score's device constants, both from NVIDIA's data sheets
# for the H100 SXM ("NVIDIA H100 80GB HBM3", 700 W), neither measured:
#   * the dense bf16 peak, monitor/mfu.py's table (989.4 TFLOP/s);
#   * one direction of its NVLink: 900 GB/s of bidirectional bandwidth a
#     card, so 450 GB/s each way, which a ring collective's per-card
#     bytes cross. One card cannot measure it.
# Absolute values only scale the score; plans are ranked by the
# compute/comm *ratio*.
PEAK_FLOPS = CHIP_PEAK_TFLOPS["H100 80GB HBM3"] * 1e12
LINK_BYTES_PER_S = 450e9
_INFEASIBLE_S = 1e9


def _param_bytes(plan, name):
    shape = plan.shapes.get(name)
    dt = plan.dtypes.get(name, "float32")
    return _numel(shape, plan.mesh_axes) * _DTYPE_BYTES.get(str(dt), 4)


def plan_cost(program, plan, batch_size=1, hbm_budget=None,
              peak_flops=PEAK_FLOPS, link_bytes_per_s=LINK_BYTES_PER_S):
    """Score one total plan; returns a dict with `score_s` plus its
    breakdown (compute_s, comm_s, peak_hbm_bytes, feasible)."""
    # imported at call time: analysis (and transitively ops) imports the
    # parallel package, which imports this module
    from ...analysis.hbm import estimate_peak_hbm
    from ...trace.costs import op_costs

    mesh_axes = plan.mesh_axes
    compute_flops = 0.0
    for row in op_costs(program, batch_size=batch_size):
        spec = plan.spec_of(row["out"]) if row["out"] else None
        factor = _axes_factor(spec, mesh_axes) if spec else 1
        compute_flops += row["flops_est"] / max(1, factor)

    comm_bytes = plan.reshard_bytes_per_step()
    # dp gradient synchronization: any param grad NOT sharded over the
    # batch axis is all-reduced across it (ring: 2(n-1)/n x bytes)
    dp = plan.batch_axis
    n_dp = int(mesh_axes.get(dp, 1)) if dp else 1
    if n_dp > 1:
        gb = program.global_block()
        for name, v in gb.vars.items():
            if not getattr(v, "persistable", False):
                continue
            g = name + GRAD_VAR_SUFFIX
            if g not in plan.specs:
                continue
            gspec = canon(plan.spec_of(g)) or ()
            if dp in gspec:
                continue
            comm_bytes += int(2 * (n_dp - 1) / n_dp
                              * _param_bytes(plan, name))

    est = estimate_peak_hbm(program, mesh_axes=mesh_axes, aplan=plan,
                            nominal_batch=batch_size)
    peak = int(est["peak_bytes_per_replica"])
    feasible = hbm_budget is None or peak <= int(hbm_budget)

    compute_s = compute_flops / peak_flops
    comm_s = comm_bytes / link_bytes_per_s
    score = compute_s + comm_s + (0.0 if feasible else _INFEASIBLE_S)
    return {
        "score_s": score,
        "compute_s": compute_s,
        "comm_s": comm_s,
        "compute_flops": compute_flops,
        "comm_bytes": int(comm_bytes),
        "peak_hbm_bytes": peak,
        "feasible": feasible,
        "digest": plan.digest(),
    }


def enumerate_seed_candidates(program, mesh_axes, batch_axis="dp",
                              max_params=8, min_bytes=1 << 10):
    """{param name: [candidate specs]} for the largest `max_params`
    parameters: replicated plus every valid single-(dim, axis) shard
    over the non-batch mesh axes (the batch axis stays the data axis;
    sharding weights over it is zero1's job, not the plan search's)."""
    mesh_axes = {str(k): int(v) for k, v in dict(mesh_axes).items()}
    gb = program.global_block()
    params = []
    for name, v in gb.vars.items():
        if not getattr(v, "persistable", False) or not v.shape:
            continue
        if any(d is None or int(d) < 0 for d in v.shape):
            continue
        nbytes = _numel(tuple(v.shape), mesh_axes) * 4
        if nbytes >= min_bytes:
            params.append((nbytes, name, tuple(v.shape)))
    params.sort(key=lambda t: (-t[0], t[1]))

    out = {}
    axes = [a for a in mesh_axes if a != batch_axis and mesh_axes[a] > 1]
    for _, name, shape in params[:max_params]:
        cands = [()]
        for ax in axes:
            for d in range(len(shape)):
                spec = (None,) * d + (ax,)
                try:
                    validate_seed_spec(name, spec, shape, mesh_axes)
                except ValueError:
                    continue
                cands.append(spec)
        out[name] = cands
    return out


class SearchResult:
    __slots__ = ("plan", "seeds", "cost", "manual_cost", "evaluated",
                 "improved", "trace")

    def __init__(self, plan, seeds, cost, manual_cost, evaluated, trace):
        self.plan = plan
        self.seeds = seeds
        self.cost = cost
        self.manual_cost = manual_cost
        self.evaluated = evaluated
        self.improved = cost["score_s"] < manual_cost["score_s"]
        self.trace = trace

    def to_dict(self):
        return {
            "seeds": {n: list(s) for n, s in sorted(self.seeds.items())},
            "cost": dict(self.cost),
            "manual_cost": dict(self.manual_cost),
            "evaluated": self.evaluated,
            "improved": self.improved,
            "digest": self.plan.digest(),
            "mesh_axes": dict(self.plan.mesh_axes),
            "trace": list(self.trace),
        }

    def render(self):
        c, m = self.cost, self.manual_cost
        lines = [
            f"autoshard search  mesh["
            + "×".join(f"{k}={v}"
                       for k, v in self.plan.mesh_axes.items())
            + f"]  {self.evaluated} plans evaluated",
            f"  manual   score {m['score_s']:.3e} s  "
            f"(compute {m['compute_s']:.3e}  comm {m['comm_s']:.3e}  "
            f"hbm {m['peak_hbm_bytes'] / 1e6:.1f} MB"
            + ("" if m["feasible"] else "  INFEASIBLE") + ")",
            f"  searched score {c['score_s']:.3e} s  "
            f"(compute {c['compute_s']:.3e}  comm {c['comm_s']:.3e}  "
            f"hbm {c['peak_hbm_bytes'] / 1e6:.1f} MB"
            + ("" if c["feasible"] else "  INFEASIBLE") + ")",
        ]
        if self.seeds:
            for n, s in sorted(self.seeds.items()):
                lines.append(f"  seed {n}: {spec_str(s)}")
        else:
            lines.append("  seed set: empty (pure batch-axis plan)")
        lines.append(f"  improved={self.improved}  "
                     f"digest {self.plan.digest()}")
        return "\n".join(lines)


def search_plan(program, mesh_axes, batch_axis="dp", batch_size=1,
                hbm_budget=None, max_params=8, rounds=2,
                peak_flops=PEAK_FLOPS, link_bytes_per_s=LINK_BYTES_PER_S):
    """Greedy coordinate-descent over seed placements.

    Starts from the program's own annotations (the manual plan), then
    per parameter (largest first) tries every candidate spec while the
    others stay fixed, accepting strict score improvements; repeats up
    to `rounds` passes or until a pass changes nothing."""
    mesh_axes = {str(k): int(v) for k, v in dict(mesh_axes).items()}

    manual_seeds = {}
    for name, v in program.global_block().vars.items():
        s = getattr(v, "sharding", None)
        if s is not None:
            manual_seeds[name] = canon(normalize_spec(s)) or ()

    def evaluate(seeds):
        plan = build_plan(program, mesh_axes, batch_axis=batch_axis,
                          extra_seeds={n: s for n, s in seeds.items() if s},
                          ignore_program_seeds=True)
        return plan, plan_cost(program, plan, batch_size=batch_size,
                               hbm_budget=hbm_budget, peak_flops=peak_flops,
                               link_bytes_per_s=link_bytes_per_s)

    best_seeds = dict(manual_seeds)
    best_plan, manual_cost = evaluate(best_seeds)
    best_cost = manual_cost
    evaluated = 1
    trace = [{"seeds": dict(best_seeds),
              "score_s": best_cost["score_s"], "kept": True}]

    candidates = enumerate_seed_candidates(
        program, mesh_axes, batch_axis=batch_axis, max_params=max_params)
    for _ in range(max(1, int(rounds))):
        changed = False
        for name, cands in candidates.items():
            for spec in cands:
                spec = canon(spec) or ()
                if best_seeds.get(name, ()) == spec:
                    continue
                trial = dict(best_seeds)
                if spec:
                    trial[name] = spec
                else:
                    trial.pop(name, None)
                plan, cost = evaluate(trial)
                evaluated += 1
                kept = cost["score_s"] < best_cost["score_s"]
                trace.append({"var": name, "spec": list(spec),
                              "score_s": cost["score_s"], "kept": kept})
                if kept:
                    best_seeds, best_plan, best_cost = trial, plan, cost
                    changed = True
        if not changed:
            break
    return SearchResult(best_plan, best_seeds, best_cost, manual_cost,
                        evaluated, trace)
