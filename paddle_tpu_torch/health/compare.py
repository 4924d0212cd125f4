"""Run-comparison engine: convergence parity between two health ledgers.

Two runs "converged equivalently" when, over their step-aligned loss
trajectories:

  * the final loss (at the last common sampled step) differs by at most
    `tol_final`,
  * the max step-aligned deviation stays within `tol_traj`,
  * they agree on divergence: either neither run fired a divergence-class
    detector event, or both did.

This is the parity gate that asserts e.g. FLAGS_zero1 on-vs-off
equivalence, or the port against the JAX package on the same run; the CLI
(`python -m paddle_tpu_torch health compare A B`) exits 0 on parity, 1 on
a violated tolerance, 2 on an unreadable ledger. A copy of the JAX
package's paddle_tpu/health/compare.py.
"""

import math

# Detector kinds that mean "this run left the healthy regime" — used for
# the divergence-step component of parity.
DIVERGENCE_KINDS = ("loss_spike", "loss_divergence", "loss_nonfinite",
                    "grad_explode", "param_nonfinite")


def _loss_curve(records):
    """-> {step: loss} over records that carry a finite-or-not loss."""
    curve = {}
    for r in records:
        step, loss = r.get("step"), r.get("loss")
        if step is None or loss is None:
            continue
        curve[int(step)] = float(loss)
    return curve


def _divergence_step(records):
    for r in records:
        events = r.get("events") or ()
        if any(k in DIVERGENCE_KINDS for k in events):
            return int(r.get("step", -1))
    return None


def summarize_ledger(records):
    """Aggregate a health ledger -> summary dict (cli renders it)."""
    curve = _loss_curve(records)
    steps = sorted(curve)
    finite = [curve[s] for s in steps if math.isfinite(curve[s])]
    events = {}
    for r in records:
        for k in (r.get("events") or ()):
            events[k] = events.get(k, 0) + 1
    norms = [float(r["global_grad_norm"]) for r in records
             if r.get("global_grad_norm") is not None
             and math.isfinite(float(r["global_grad_norm"]))]
    emas = [r["loss_ema"] for r in records
            if r.get("loss_ema") is not None]
    return {
        "records": len(records),
        "steps": len(steps),
        "first_step": steps[0] if steps else None,
        "last_step": steps[-1] if steps else None,
        "final_loss": curve[steps[-1]] if steps else None,
        "min_loss": min(finite) if finite else None,
        "loss_ema_final": emas[-1] if emas else None,
        "max_global_grad_norm": max(norms) if norms else None,
        "nonfinite_steps": sum(
            1 for s in steps if not math.isfinite(curve[s])),
        "events": events,
        "divergence_step": _divergence_step(records),
    }


def compare_ledgers(a, b, tol_final=1e-3, tol_traj=5e-3):
    """Parity report between two ledgers (lists of records)."""
    ca, cb = _loss_curve(a), _loss_curve(b)
    common = sorted(set(ca) & set(cb))
    report = {
        "steps_a": len(ca), "steps_b": len(cb),
        "common_steps": len(common),
        "tol_final": tol_final, "tol_traj": tol_traj,
    }
    if not common:
        report.update(ok=False, reason="no overlapping sampled steps")
        return report

    def dev(s):
        d = abs(ca[s] - cb[s])
        return d if math.isfinite(d) else float("inf")

    worst = max(common, key=dev)
    traj_dev = dev(worst)
    final_step = common[-1]
    final_delta = dev(final_step)
    div_a, div_b = _divergence_step(a), _divergence_step(b)
    div_ok = (div_a is None) == (div_b is None)

    checks = {
        "final_loss": final_delta <= tol_final,
        "trajectory": traj_dev <= tol_traj,
        "divergence": div_ok,
    }
    report.update(
        final_step=final_step,
        final_loss_a=ca[final_step], final_loss_b=cb[final_step],
        final_loss_delta=final_delta,
        traj_max_abs_diff=traj_dev, traj_worst_step=worst,
        divergence_step_a=div_a, divergence_step_b=div_b,
        checks=checks,
        ok=all(checks.values()),
    )
    if not report["ok"]:
        report["reason"] = ", ".join(
            f"{k} check failed" for k, v in checks.items() if not v)
    return report


def format_ledger_summary(s):
    lines = [f"records: {s['records']}  sampled steps: {s['steps']}  "
             f"range: [{s['first_step']}, {s['last_step']}]"]
    if s["final_loss"] is not None:
        ema = (f"  ema={s['loss_ema_final']:.6g}"
               if s["loss_ema_final"] is not None else "")
        lines.append(f"loss: final={s['final_loss']:.6g} "
                     f"min={s['min_loss']:.6g}{ema}")
    if s["max_global_grad_norm"] is not None:
        lines.append(
            f"max global grad norm: {s['max_global_grad_norm']:.6g}")
    if s["nonfinite_steps"]:
        lines.append(f"non-finite loss steps: {s['nonfinite_steps']}")
    if s["events"]:
        lines.append("events: " + ", ".join(
            f"{k} x{n}" for k, n in sorted(s["events"].items())))
    ds = s["divergence_step"]
    lines.append("divergence: none" if ds is None
                 else f"divergence: first at step {ds}")
    return "\n".join(lines)


def format_compare(r):
    lines = [f"common sampled steps: {r['common_steps']} "
             f"(a={r['steps_a']}, b={r['steps_b']})"]
    if r["common_steps"]:
        lines.append(
            f"final loss @step {r['final_step']}: "
            f"a={r['final_loss_a']:.6g} b={r['final_loss_b']:.6g} "
            f"delta={r['final_loss_delta']:.3g} "
            f"(tol {r['tol_final']:.3g})")
        lines.append(
            f"trajectory max |a-b|: {r['traj_max_abs_diff']:.3g} "
            f"@step {r['traj_worst_step']} (tol {r['tol_traj']:.3g})")
        da, db = r["divergence_step_a"], r["divergence_step_b"]
        lines.append(
            f"divergence: a={'none' if da is None else f'step {da}'} "
            f"b={'none' if db is None else f'step {db}'}")
        for k, ok in r["checks"].items():
            lines.append(f"  [{'ok' if ok else 'FAIL'}] {k}")
    lines.append("PARITY: " + ("ok" if r["ok"]
                               else f"FAIL ({r.get('reason', '?')})"))
    return "\n".join(lines)
