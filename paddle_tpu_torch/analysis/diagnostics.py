"""Structured diagnostics for the static ProgramDesc analyses.

Every check emits Diagnostic records with a STABLE error code (PTAxxx) so
tooling — green_gate, the `check` CLI, tests — can match on codes instead
of message text. Codes are append-only: once shipped, a code keeps its
meaning forever; retired checks leave a hole rather than renumbering.

Code ranges:
  PTA001-PTA009  structural (graph well-formedness, shape contracts)
  PTA010-PTA019  safety (donation, write-after-read, collective order)
  PTA020-PTA029  sharding/plan validation (mesh axes, divisibility, audit)
  PTA030-PTA039  dataflow-graph hazards (SSA def-use analysis; the checks
                 that make static reordering/overlap scheduling safe)
  PTA040-PTA049  pipeline-partition legality (parallel.pipeline stage
                 splits over the pp mesh axis)
"""

__all__ = ["Severity", "Diagnostic", "Report", "ProgramVerificationError",
           "CATALOG"]


class Severity:
    ERROR = "error"      # program is malformed/unsafe; rc 1
    WARNING = "warning"  # suspicious but runnable; rc stays 0
    INFO = "info"


# code -> (default severity, one-line summary). The summary documents the
# check; the Diagnostic message carries the specific location/details.
CATALOG = {
    # -- structural ---------------------------------------------------------
    "PTA001": (Severity.ERROR,
               "use of an undefined variable (def-before-use)"),
    "PTA002": (Severity.ERROR,
               "duplicate output name within a single op"),
    "PTA003": (Severity.WARNING,
               "dangling variable: declared but never read or written"),
    "PTA004": (Severity.ERROR,
               "shape/dtype contract violation (infer_shape replay)"),
    "PTA005": (Severity.WARNING,
               "op type has no infer_shape contract"),
    "PTA006": (Severity.WARNING,
               "unknown op type: no kernel registered"),
    "PTA007": (Severity.WARNING,
               "grad op without a matching forward op"),
    "PTA008": (Severity.ERROR,
               "reference to a variable not declared in any reachable block"),
    # -- safety -------------------------------------------------------------
    "PTA010": (Severity.ERROR,
               "read of updated (donated) state after its weight update"),
    "PTA011": (Severity.ERROR,
               "write-after-read hazard: grad op observes an overwritten "
               "forward value"),
    "PTA012": (Severity.ERROR,
               "cross-replica collective order violation"),
    "PTA013": (Severity.ERROR,
               "collective op under control flow (replica divergence risk)"),
    # -- sharding / plans ---------------------------------------------------
    "PTA020": (Severity.ERROR,
               "sharding spec names a mesh axis not present in the mesh"),
    "PTA021": (Severity.ERROR,
               "sharded dim not divisible by its mesh-axis size"),
    "PTA022": (Severity.WARNING,
               "autoshard plan is not total (unresolved/unassigned vars)"),
    "PTA023": (Severity.WARNING,
               "reshard-edge audit mismatch"),
    # -- dataflow-graph hazards (analysis.dataflow) -------------------------
    "PTA030": (Severity.ERROR,
               "cyclic def-use dependency: no execution order satisfies "
               "the graph"),
    "PTA031": (Severity.ERROR,
               "WAR hazard (SSA): grad op reads a later variable version "
               "than its paired forward op consumed"),
    "PTA032": (Severity.ERROR,
               "WAW hazard: persistable written more than once per step "
               "(lost update under buffer donation)"),
    "PTA033": (Severity.ERROR,
               "collective-order divergence: zero1 group member not "
               "linked to its update by a dependency path"),
    "PTA034": (Severity.ERROR,
               "donation-aliasing race: stale view of a donated buffer "
               "read after the root's update"),
    # -- pipeline-partition legality (parallel.pipeline) --------------------
    "PTA040": (Severity.ERROR,
               "pipeline partition crosses a dependency backwards: a "
               "same-phase def-use edge runs from a later stage to an "
               "earlier one, so no 1F1B order exists"),
    "PTA041": (Severity.ERROR,
               "pipeline boundary var rewritten after its send: the "
               "receiving stage would observe a stale version"),
}


class Diagnostic:
    """One finding: stable code + severity + op/var location + message."""

    __slots__ = ("code", "severity", "message", "block_idx", "op_idx",
                 "op_type", "var")

    def __init__(self, code, message, severity=None, block_idx=None,
                 op_idx=None, op_type=None, var=None):
        if code not in CATALOG:
            raise ValueError(f"unknown diagnostic code {code!r}")
        self.code = code
        self.severity = severity or CATALOG[code][0]
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var = var

    def location(self):
        parts = []
        if self.block_idx is not None:
            parts.append(f"block{self.block_idx}")
        if self.op_idx is not None:
            op = f"op#{self.op_idx}"
            if self.op_type:
                op += f"({self.op_type})"
            parts.append(op)
        if self.var:
            parts.append(f"var {self.var!r}")
        return " ".join(parts)

    def to_dict(self):
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "block_idx": self.block_idx,
            "op_idx": self.op_idx,
            "op_type": self.op_type,
            "var": self.var,
        }

    def __str__(self):
        loc = self.location()
        return f"{self.code} {self.severity}" + (f" [{loc}]" if loc else "") \
            + f": {self.message}"

    __repr__ = __str__


class Report:
    """The result of one verify() run: diagnostics + optional HBM estimate.

    rc follows the CLI contract: 0 clean (warnings allowed), 1 when any
    error-severity diagnostic is present."""

    def __init__(self, level="basic", context=""):
        self.level = level
        self.context = context
        self.diagnostics = []
        self.hbm = None          # estimate dict from hbm.estimate_peak_hbm
        self.summary = {}        # program stats (ops/blocks/vars)

    def add(self, code, message, **loc):
        self.diagnostics.append(Diagnostic(code, message, **loc))

    def sorted_diagnostics(self):
        """Diagnostics in (block, op index, code) order — check order is
        an implementation detail, so render()/to_dict() sort to keep
        `check --json` output and green_gate diffs deterministic."""
        return sorted(
            self.diagnostics,
            key=lambda d: (d.block_idx if d.block_idx is not None else -1,
                           d.op_idx if d.op_idx is not None else -1,
                           d.code, d.var or "", d.message))

    def errors(self):
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    def warnings(self):
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    def codes(self):
        return {d.code for d in self.diagnostics}

    @property
    def ok(self):
        return not self.errors()

    @property
    def rc(self):
        return 0 if self.ok else 1

    def to_dict(self):
        return {
            "level": self.level,
            "context": self.context,
            "ok": self.ok,
            "rc": self.rc,
            "n_errors": len(self.errors()),
            "n_warnings": len(self.warnings()),
            "summary": dict(self.summary),
            "diagnostics": [d.to_dict() for d in self.sorted_diagnostics()],
            "hbm": self.hbm,
        }

    def render(self, verbose=True):
        s = self.summary
        head = (f"verify[{self.level}] "
                f"{s.get('n_ops', '?')} ops / {s.get('n_blocks', '?')} "
                f"blocks / {s.get('n_vars', '?')} vars — "
                f"{len(self.errors())} error(s), "
                f"{len(self.warnings())} warning(s)")
        lines = [head]
        shown = self.sorted_diagnostics()
        if not verbose:
            shown = [d for d in shown if d.severity == Severity.ERROR]
        lines += [f"  {d}" for d in shown]
        if self.hbm:
            from .hbm import render_table
            lines.append(render_table(self.hbm))
        return "\n".join(lines)


class ProgramVerificationError(ValueError):
    """Raised by ensure_verified() when FLAGS_verify finds errors. Carries
    the full Report so callers can inspect codes programmatically."""

    def __init__(self, report):
        self.report = report
        errs = report.errors()
        head = (f"program verification failed ({len(errs)} error(s), "
                f"level={report.level})")
        detail = "\n".join(f"  {d}" for d in errs[:20])
        if len(errs) > 20:
            detail += f"\n  ... and {len(errs) - 20} more"
        super().__init__(head + ("\n" + detail if detail else ""))
