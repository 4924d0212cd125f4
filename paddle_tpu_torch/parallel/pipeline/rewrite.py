"""Stage-program rewriter: one program -> per-(stage, phase) sub-programs.

The counterpart of paddle_tpu/parallel/pipeline/rewrite.py. Each
sub-program keeps only the ops assigned to its (stage, phase) cell and
turns every cross-subprogram value into an explicit interface:

  * a value crossing a STAGE boundary gets a ``pipeline_recv`` op at the
    consumer (fed through a fresh ``name@PPIN`` data var) and a
    ``pipeline_send`` op at the producer (fetched as ``name@PPOUT``) —
    identities off the mesh, a permute over the pp axis's group on it
    (ops/collective_ops.py);
  * a value crossing only a PHASE boundary within one stage (stashed
    activations for the backward, parameter grads for the optimizer)
    becomes a plain feed/fetch pair — it never leaves the stage's
    devices, so no collective is emitted;
  * persistable vars (params, optimizer state, lr) stay in the shared
    scope, untouched.

The rewrite refuses unsafe programs instead of mutating them quietly: the
SOURCE program must be free of PTA030-034 dataflow hazards and PTA040/041
partition-legality errors, and every rewritten stage program is
re-verified before it is returned. A backward cell holds grad ops whose
forward ops are in another cell, so the PTA031 check pairs them as the
JAX package does, by (op type, name), and finds no forward op of their
types there.
"""

from .partition import (PHASE_BWD, PHASE_FWD, PHASE_OPT, _PSEUDO_OPS,
                        check_partition)

__all__ = ["StageProgram", "build_stage_programs",
           "PP_IN_SUFFIX", "PP_OUT_SUFFIX", "PIPELINE_CODES"]

PP_IN_SUFFIX = "@PPIN"
PP_OUT_SUFFIX = "@PPOUT"
PIPELINE_CODES = ("PTA040", "PTA041")

_PHASES = (PHASE_FWD, PHASE_BWD, PHASE_OPT)


class StageProgram:
    """One executable cell of the pipeline: (stage, phase) + interface."""

    __slots__ = ("program", "stage", "phase", "data_feeds", "boundary_in",
                 "local_in", "boundary_out", "local_out", "user_fetches",
                 "fetch_names")

    def __init__(self, program, stage, phase):
        self.program = program
        self.stage = stage
        self.phase = phase
        self.data_feeds = []     # original is_data feeds this cell reads
        self.boundary_in = {}    # var name -> producing stage
        self.local_in = []       # same-stage cross-phase feeds
        self.boundary_out = {}   # var name -> [consuming stages]
        self.local_out = []      # same-stage cross-phase fetches
        self.user_fetches = []   # caller fetch_names owned by this cell
        self.fetch_names = []    # full fetch list passed to the executor

    def describe(self):
        return (f"stage {self.stage} {self.phase}: "
                f"{len(self.program.global_block().ops)} ops, "
                f"feeds {self.data_feeds}, "
                f"recv {sorted(self.boundary_in)}, "
                f"send {sorted(self.boundary_out)}, "
                f"stash in/out {len(self.local_in)}/{len(self.local_out)}")


def _require_hazard_free(program, feed_names, what, plan=None, graph=None):
    """check_hazards (+ check_partition when a plan is given); raises
    ProgramVerificationError on any error-severity finding."""
    # analysis imported at call time: analysis.dataflow itself imports the
    # ops package, which imports parallel (and therefore this package)
    from ...analysis.dataflow import DATAFLOW_CODES, check_hazards
    from ...analysis.diagnostics import ProgramVerificationError, Report

    report = Report(level="full", context=f"pipeline-{what}")
    g = check_hazards(program, report, feed_names=feed_names, graph=graph)
    if plan is not None:
        check_partition(program, plan, report, graph=g,
                        feed_names=feed_names)
    bad = [d for d in report.diagnostics
           if d.code in DATAFLOW_CODES + PIPELINE_CODES
           and d.severity == "error"]
    if bad:
        raise ProgramVerificationError(report)
    return g


def _block_reads(op):
    names = set(op.input_arg_names())
    for v in op.attrs.values():
        if hasattr(v, "ops"):
            for sub in v.ops:
                names |= _block_reads(sub)
    return names


def build_stage_programs(program, plan, feed_names=(), fetch_names=(),
                         check=True):
    """Split `program` along `plan` into {(stage, phase): StageProgram}.

    `feed_names` are the program's data feeds; `fetch_names` (e.g. the
    loss) are routed to the sub-program that defines them. With `check`
    (default) the source and every stage program are hazard-verified."""
    gb = program.global_block()
    ops = gb.ops
    feed_names = list(feed_names)
    fetch_names = list(fetch_names)
    if check:
        _require_hazard_free(program, feed_names, "source", plan=plan)

    # -- cell membership --------------------------------------------------
    cell_of = {}  # op idx -> (stage, phase)
    for i, op in enumerate(ops):
        if op.type in _PSEUDO_OPS:
            continue
        st = plan.stage_of(i)
        if st is None:
            raise ValueError(f"op#{i}({op.type}) has no stage assignment")
        cell_of[i] = (st, plan.phases[i])
    cells = sorted({c for c in cell_of.values()},
                   key=lambda c: (c[0], _PHASES.index(c[1])))

    # name -> cell that first defines it (program order)
    def_cell = {}
    for i, op in enumerate(ops):
        if i not in cell_of:
            continue
        for n in op.output_arg_names():
            def_cell.setdefault(n, cell_of[i])

    out = {}
    for cell in cells:
        stage, phase = cell
        kept = [i for i in range(len(ops)) if cell_of.get(i) == cell]
        clone = program.clone()
        cgb = clone.global_block()
        clone_ops = cgb.ops
        cgb.ops = [clone_ops[i] for i in kept]
        sp = StageProgram(clone, stage, phase)

        reads, defined = set(), set()
        for i in kept:
            reads |= _block_reads(ops[i])
            defined |= set(ops[i].output_arg_names())
        external = []
        for n in sorted(reads):
            if n in defined:
                # defined within the cell before/at the read (program
                # order preserved); a pre-def read would be an external
                # version, which PTA041 already rejects for boundaries
                first_def_here = min(i for i in kept
                                     if n in ops[i].output_arg_names())
                first_read_here = min(
                    i for i in kept if n in _block_reads(ops[i]))
                if first_read_here >= first_def_here:
                    continue
            v = cgb.vars.get(n)
            if v is None or v.persistable:
                continue  # scope-resident state
            if v.is_data:
                sp.data_feeds.append(n)
                continue
            external.append(n)

        for n in external:
            src = def_cell.get(n)
            if src is None:
                # never written anywhere: treat as an extra data feed
                cgb.vars[n].is_data = True
                sp.data_feeds.append(n)
            elif src[0] != stage:
                sp.boundary_in[n] = src[0]
            else:
                cgb.vars[n].is_data = True
                sp.local_in.append(n)

        # recv ops (front, in name order) for cross-stage arrivals
        for k, n in enumerate(sorted(sp.boundary_in)):
            src_stage = sp.boundary_in[n]
            v = cgb.vars[n]
            cgb.create_var(name=n + PP_IN_SUFFIX, shape=v.shape,
                           dtype=v.dtype, is_data=True)
            cgb.insert_op(
                k, "pipeline_recv",
                inputs={"X": [n + PP_IN_SUFFIX]}, outputs={"Out": [n]},
                attrs={"axis_name": plan.axis,
                       "peer": stage - src_stage})
        out[cell] = sp

    # -- producer-side interface ------------------------------------------
    for cell, sp in out.items():
        stage, phase = cell
        cgb = sp.program.global_block()
        consumers = {}  # name -> set of consuming cells
        for other, osp in out.items():
            if other == cell:
                continue
            for n in osp.boundary_in:
                if def_cell.get(n) == cell:
                    consumers.setdefault(n, set()).add(other)
            for n in osp.local_in:
                if def_cell.get(n) == cell:
                    consumers.setdefault(n, set()).add(other)
        for n in sorted(consumers):
            dst_stages = sorted({c[0] for c in consumers[n]} - {stage})
            if dst_stages:
                v = cgb.vars[n]
                cgb.create_var(name=n + PP_OUT_SUFFIX, shape=v.shape,
                               dtype=v.dtype)
                cgb.append_op(
                    "pipeline_send",
                    inputs={"X": [n]}, outputs={"Out": [n + PP_OUT_SUFFIX]},
                    attrs={"axis_name": plan.axis,
                           "peer": dst_stages[0] - stage})
                sp.boundary_out[n] = dst_stages
            if any(c[0] == stage for c in consumers[n]):
                sp.local_out.append(n)
        for n in fetch_names:
            if def_cell.get(n) == cell:
                sp.user_fetches.append(n)
        sp.fetch_names = (
            [n + PP_OUT_SUFFIX for n in sorted(sp.boundary_out)]
            + sorted(sp.local_out) + list(sp.user_fetches))
        sp.program._mutation += 1
        sp.program._pipeline_stage = (plan.digest(), stage, phase)
        if check:
            from ...analysis.dataflow import DATAFLOW_CODES, check_hazards
            from ...analysis.diagnostics import (ProgramVerificationError,
                                                 Report)

            report = Report(level="full",
                            context=f"pipeline-stage{stage}-{phase}")
            check_hazards(sp.program, report,
                          feed_names=sp.data_feeds + sp.local_in
                          + [n + PP_IN_SUFFIX for n in sp.boundary_in])
            bad = [d for d in report.diagnostics
                   if d.code in DATAFLOW_CODES and d.severity == "error"]
            if bad:
                raise ProgramVerificationError(report)
    return out
