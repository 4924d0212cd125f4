"""paddle_tpu_torch.analysis — static ProgramDesc verification.

The JAX package's analysis (paddle_tpu/analysis/__init__.py), with the
same codes and verdicts, over the port's IR:

  * structural graph verification (def-before-use with sub-block scoping,
    duplicate outputs, dangling vars, shape-contract replay, fwd/grad
    pairing) — the `basic` level;
  * safety analyses (read-after-update of a persistable the step writes
    in place, write-after-read from in-place rewiring, cross-replica
    collective order) — `full`;
  * SSA dataflow-graph hazards (PTA03x, `dataflow`) plus the static
    overlap scheduler (`schedule`) — `full`;
  * sharding/plan validation (mesh axes, divisibility, the zero1 plan's
    geometry, the autoshard plan's totality and reshard-edge audit) —
    `full`, when a mesh or plan is in scope;
  * a liveness-based peak-HBM estimate per replica — `full`, exported as
    the `analysis_peak_hbm_bytes_per_replica` gauge and the `check` CLI
    table.

Wired behind FLAGS_verify into the Executor's prepare: the verify runs on
a prepared step's miss only, memoized per (program identity, mutation,
level, feeds/fetches/mesh), so the steady-state cost of an enabled flag is
zero and of the flag itself one check; it raises before anything of the
step is launched.
"""

from .. import flags
from .diagnostics import (CATALOG, Diagnostic, ProgramVerificationError,
                          Report, Severity)
from . import dataflow
from . import schedule
from . import plans as _plans
from . import safety as _safety
from . import verifier as _verifier
from .hbm import estimate_peak_hbm, measured_live_bytes

__all__ = ["verify", "ensure_verified", "reset", "LEVELS",
           "Diagnostic", "Report", "Severity", "ProgramVerificationError",
           "CATALOG", "estimate_peak_hbm", "measured_live_bytes",
           "dataflow", "schedule"]

flags.define(
    "verify", str, "off",
    "Static program verification when a step is prepared: 'off' "
    "(default), 'basic' (graph structure + shape contracts), or 'full' "
    "(basic + in-place update/collective safety, the dataflow hazards, "
    "sharding-plan validation, and the peak-HBM estimate gauge). Runs once "
    "per prepared program, memoized, before any of its steps is launched, "
    "and raises ProgramVerificationError on error-severity findings.")

LEVELS = ("off", "basic", "full")


def verify(program, level="basic", feed_names=None, fetch_names=None,
           mesh_axes=None, zplan=None, aplan=None, donate_state=True,
           context=""):
    """Run the static checks and return a Report (never raises on
    findings — that is ensure_verified's job)."""
    if level not in LEVELS:
        raise ValueError(
            f"FLAGS_verify level must be one of {LEVELS}, got {level!r}")
    report = Report(level=level, context=context)
    if level == "off":
        return report
    _verifier.check_structure(program, report, feed_names=feed_names,
                              fetch_names=fetch_names)
    _verifier.check_contracts(program, report)
    _verifier.check_grad_pairing(program, report)
    if level == "full":
        _safety.check_donation(program, report, donate_state=donate_state)
        _safety.check_war_hazards(program, report)
        _safety.check_collective_order(program, report)
        dataflow.check_hazards(program, report, feed_names=feed_names,
                               donate_state=donate_state)
        _plans.check_var_sharding(program, mesh_axes, report)
        _plans.check_autoshard_plan(aplan, report)
        _plans.check_zero1_plan(zplan, program, report,
                                mesh_axes=mesh_axes)
        report.hbm = estimate_peak_hbm(
            program, mesh_axes=mesh_axes, aplan=aplan,
            fetch_names=fetch_names)
    return report


# verified-program memo: one verify per prepared program, not per step.
# Keyed the way the Executor's compile cache is (program identity +
# mutation + the verify-relevant config); FIFO-bounded.
_MEMO = {}
_MEMO_CAP = 512


def reset():
    _MEMO.clear()


def ensure_verified(program, level=None, feed_names=None, fetch_names=None,
                    mesh_axes=None, zplan=None, aplan=None,
                    donate_state=True, context="executor"):
    """Verify once per (program, mutation, config); raise
    ProgramVerificationError when error-severity diagnostics exist.

    Returns the Report (a memoized one on repeat calls), or None when the
    resolved level is 'off'. Called from the Executor's prepare on a miss,
    so steady-state runs never reach here."""
    lvl = level if level is not None else flags.get("verify")
    if not lvl or lvl == "off":
        return None
    key = (
        id(program), program._mutation, lvl,
        tuple(sorted(feed_names)) if feed_names is not None else None,
        tuple(fetch_names) if fetch_names is not None else None,
        tuple(sorted(mesh_axes.items())) if mesh_axes else None,
        id(zplan) if zplan is not None else None,
        id(aplan) if aplan is not None else None,
        bool(donate_state),
    )
    hit = _MEMO.get(key)
    if hit is not None:
        if not hit.ok:
            raise ProgramVerificationError(hit)
        return hit
    report = verify(program, level=lvl, feed_names=feed_names,
                    fetch_names=fetch_names, mesh_axes=mesh_axes,
                    zplan=zplan, aplan=aplan, donate_state=donate_state,
                    context=context)
    while len(_MEMO) >= _MEMO_CAP:
        _MEMO.pop(next(iter(_MEMO)))
    _MEMO[key] = report
    if report.hbm is not None:
        from .. import monitor
        monitor.registry().gauge(
            "analysis_peak_hbm_bytes_per_replica",
            help="liveness-based static peak-HBM estimate per replica",
            context=context,
        ).set(float(report.hbm["peak_bytes_per_replica"]))
    if not report.ok:
        raise ProgramVerificationError(report)
    return report
