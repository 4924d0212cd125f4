"""Inter-op pipeline parallelism over the `pp` mesh axis.

The counterpart of paddle_tpu/parallel/pipeline/. NOT the input pipeline:
the top-level module ``paddle_tpu_torch/pipeline.py`` is the legacy
*device-staged input feeder* shim (backed by ``paddle_tpu_torch.datapipe``). THIS package is model-parallel
*pipeline* parallelism — it splits a ProgramDesc into stages along the
``pp`` mesh axis and runs them with microbatched 1F1B scheduling
(docs/pipeline.md).

Three layers:

  * ``partition`` — min-cut the SSA dependency graph
    (``analysis.dataflow``) into ``n_stages`` contiguous forward
    intervals, balancing per-stage FLOPs (``trace.costs``) against the
    activation bytes crossing each cut, then fold backward/optimizer ops
    onto their forward twins' stages. ``check_partition`` emits the
    PTA040/PTA041 legality codes.
  * ``rewrite`` — split the program into per-(stage, phase) sub-programs
    with explicit ``pipeline_send``/``pipeline_recv`` boundary ops
    (identity off the mesh, a permute over the pp axis's group on it). The
    source and every stage program are hazard-checked (PTA030-034 +
    PTA040/041) — an illegal split raises ProgramVerificationError, it is
    never silently run.
  * ``schedule``/``runner`` — the 1F1B microbatch order, its analytic
    bubble bound (p-1)/(m+p-1), and a host-driven ``PipelineRunner`` that
    executes the stage programs through the Executor with every value on
    the device, accumulates microbatch gradients, and
    reports the measured bubble fraction.
"""

from ... import flags
from .partition import (StagePlan, partition, check_partition, op_phase,
                        PHASE_FWD, PHASE_BWD, PHASE_OPT)
from .rewrite import (StageProgram, build_stage_programs,
                      PP_IN_SUFFIX, PP_OUT_SUFFIX)
from .schedule import analytic_bubble, schedule_1f1b, simulate_schedule
from .runner import PipelineRunner

__all__ = [
    "StagePlan", "partition", "check_partition", "op_phase",
    "PHASE_FWD", "PHASE_BWD", "PHASE_OPT",
    "StageProgram", "build_stage_programs",
    "PP_IN_SUFFIX", "PP_OUT_SUFFIX",
    "analytic_bubble", "schedule_1f1b", "simulate_schedule",
    "PipelineRunner",
    "register_pipeline", "active_pipeline", "reset_registry",
    "manifest_section",
]

flags.define(
    "pipeline_stages", int, 0,
    "Pipeline-parallel stage count over the pp mesh axis (0 = off). The "
    "PipelineRunner takes explicit arguments; this flag is the default of "
    "`analyze pipeline --stages` (2 where it is 0).")


# ---------------------------------------------------------------------------
# process-wide registry: resilience.checkpoint stamps the active pipeline
# geometry (stage count, pp axis, schedule, microbatches) into
# manifest.json next to the mesh/zero1/autoshard sections, so `checkpoint
# inspect` can render it and a pp-mismatched restore fails loudly through
# check_mesh_compat (the mesh section carries pp too).
# ---------------------------------------------------------------------------
_ACTIVE = None


def register_pipeline(info):
    """Record the running pipeline geometry: a dict with at least
    `stages`; `axis`, `microbatches`, `schedule`, `digest` ride along."""
    global _ACTIVE
    _ACTIVE = dict(info) if info else None


def active_pipeline():
    return None if _ACTIVE is None else dict(_ACTIVE)


def reset_registry():
    global _ACTIVE
    _ACTIVE = None


def manifest_section():
    """Manifest entry describing the active pipeline, or None."""
    if _ACTIVE is None:
        return None
    sec = {"axis": "pp", "schedule": "1f1b"}
    sec.update(_ACTIVE)
    return sec
