"""Static ProgramDesc analyses. The port carries the dataflow hazard checks
(PTA030-PTA034, analysis.dataflow) that the fusion pass runs before and
after it rewrites a program; the `FLAGS_verify` levels, the schedule and
the HBM estimate wait for a later slice."""

from .diagnostics import (CATALOG, Diagnostic, ProgramVerificationError,
                          Report, Severity)
from . import dataflow

__all__ = ["CATALOG", "Diagnostic", "ProgramVerificationError", "Report",
           "Severity", "dataflow"]
