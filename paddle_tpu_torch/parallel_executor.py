"""ParallelExecutor: data parallelism over the ranks of a torch.distributed
group, one process per card.

Reference parity: paddle/fluid/framework/parallel_executor.cc:54 +
python/paddle/fluid/parallel_executor.py: an SSA graph with one NCCL
all-reduce per gradient. The JAX package compiles the global program over
a device mesh and lets XLA insert the collectives, so every op computes
over the global batch. The port runs one rank per card (NCCL refuses two
ranks on one device) and gives each rank's step the same global-batch
semantics explicitly:
  - every rank receives the global batch and keeps rows [r*B/W,
    (r+1)*B/W) of each feed (W, the group's size, must divide B);
  - the ops that reduce over the batch (mean, batch_norm in training,
    accuracy; dropout's draw) read the group from OpContext.dp and
    compute the global batch's result (ops/math_ops.py, nn_ops.py,
    metric_ops.py);
  - BuildStrategy.AllReduce: the program gets one `all_reduce` (sum) per
    parameter gradient, after the gradient's last writer, under the
    gradient's own name — the reference's one NCCL all-reduce per
    gradient — so regularization, clipping, the optimizer and a fetch of
    the gradient all see the global batch's gradient;
  - BuildStrategy.Reduce / FLAGS_zero1 at dp >= 2: parallel.zero1
    rewrites each shardable update onto this rank's 1/W shard, its
    gradient reduce-scattered, the updated shards all-gathered;
  - a fetch whose var leads with the batch dim comes back as the global
    [B, ...] (all-gathered in rank order); any other is this rank's
    value, the same on every rank.
Then the fusion pass (FLAGS_fuse) and the step run through this rank's
Executor, so the captured CUDA graph — collectives inside it — AMP and the
fused update kernels stay the single-card code path.

The step monitor rides every run as it does the Executor's (kind
"parallel_executor"; per-rank skew under FLAGS_monitor_replica_skew), and
so do FLAGS_health, `async_fetch` (executor.FetchFuture, over the
gathered fetches), the resilience hooks (chaos.on_run and the hang
watchdog, labelled "parallel_executor") and the compile cache (the rank's
Executor's, kind "parallel_executor"). FLAGS_verify checks the rewritten
program with the mesh and the zero1 plan in scope, and at `full` sets the
measured `hbm_live_bytes_per_replica` gauge after a prepare's first run.
Ranks that share one card (NCCL refuses two ranks on one device) form a
gloo group on it (`distributed.initialize(..., local_device_ids=[card],
backend="gloo")`): `use_cuda=True` then runs each rank's step on the card
with its collectives over gloo, whose wire is pinned host memory
(ops/collective_ops.py). A gloo collective cannot be captured in a CUDA
graph, so such a step runs on the interpreter (`step_mode()` says
"interpreter"), and zero1's gradient reduce-scatter there is the
all-reduce and this rank's slice (gloo has none). The prepared key and the
persistent cache's digest take in the mesh geometry and backend, so a
rank whose group an elastic resize re-formed takes a clean miss and never
loads a plan made for another world; a ParallelExecutor made before the
re-form refuses to run (parallel.mesh.Mesh.check_live).
Not ported yet, each refused with NotImplementedError: autoshard and
tensor parallelism and the overlap schedule (ROADMAP queue 1 item 6),
DataPipe feeds and ragged feeds (item 3).
"""

import time

import numpy as np
import torch

from . import analysis, flags, monitor
from .core.framework import Variable, default_main_program, grad_var_name
from .core.framework import Operator, OpRole
from .core.lod_tensor import LoDTensor
from .core.places import CPUPlace, CUDAPlace
from .core.registry import SeqTensor
from .core.scope import global_scope
from .core.executor_core import collect_state_names as _collect_state
from .executor import Executor, as_numpy, fetch_futures
from .ops import collective_ops
from .parallel import distributed as _distributed
from .parallel import mesh as _mesh
from .parallel import zero1 as _zero1
from .resilience import chaos as _chaos
from .resilience import watchdog as _watchdog

__all__ = ["ParallelExecutor", "ExecutionStrategy", "BuildStrategy"]

# flags the JAX package reads here; the port refuses them while they are on
_UNPORTED_FLAGS = {
    "autoshard": ("GSPMD-style autoshard: ROADMAP queue 1 item 6's "
                  "tensor-parallel leftover"),
    "overlap_plan": ("the static overlap schedule of the zero1 "
                     "collectives: ROADMAP queue 1 item 6"),
}
for _name, _what in _UNPORTED_FLAGS.items():
    flags.define(_name, bool, False,
                 f"Not ported: {_what}. ParallelExecutor.run raises "
                 f"NotImplementedError while it is on.")


def _not_ported(what):
    return NotImplementedError(f"ParallelExecutor: {what} is not ported "
                               f"to paddle_tpu_torch yet")


class ExecutionStrategy:
    """reference framework/details/execution_strategy.h. Advisory: the
    step runs as one captured graph (or the interpreter) per rank."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.use_event = True


class BuildStrategy:
    """reference framework/details/build_strategy.h:22-31."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1  # -> shard optimizer state over the ranks (ZeRO-1)

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        # ZeRO-1 sharded weight update (arXiv 2004.13336): None defers to
        # FLAGS_zero1; True/False overrides the flag for this executor
        self.sharded_weight_update = None
        # GSPMD-style autoshard: not ported (None defers to FLAGS_autoshard)
        self.auto_sharding = None
        self.debug_graphviz_path = ""


def _optimized_params(program):
    """{param name: the gradient its optimizer op reads}, in program
    order, for every op with Param and Grad inputs and a ParamOut."""
    found = {}
    for op in program.global_block().ops:
        p, g = op.inputs.get("Param"), op.inputs.get("Grad")
        if p and g and op.outputs.get("ParamOut"):
            found.setdefault(p[0], g[0])
    return found


def insert_grad_all_reduce(program, params, reduced):
    """Clone `program` with one `all_reduce` (sum) per gradient of
    `params` ({param: the grad its optimizer reads}), written under the
    gradient's own name right after its last writer. The gradient is the
    parameter's raw one (`<param>@GRAD`, before any regularization or
    clipping, which then apply once to the global gradient) where the
    program has it, else the one the optimizer reads. Gradients in
    `reduced` (reduce-scattered by zero1) are left alone."""
    clone = program.clone()
    gb = clone.global_block()
    targets = set()
    for p, g in params.items():
        raw = grad_var_name(p)
        g = raw if raw in gb.vars else g
        if g not in reduced:
            targets.add(g)
    last = {}
    for i, op in enumerate(gb.ops):
        for n in op.output_arg_names():
            if n in targets:
                last[n] = i
    after = {}
    for n, i in last.items():
        after.setdefault(i, []).append(n)
    new_ops = []
    for i, op in enumerate(gb.ops):
        new_ops.append(op)
        for n in sorted(after.get(i, ())):
            new_ops.append(Operator(
                gb, "all_reduce", {"X": [n]}, {"Out": [n]},
                {"reduction": "sum", "axis_name": _mesh.DP_AXIS,
                 "op_role": OpRole.Backward}))
    gb.ops = new_ops
    clone._mutation += 1
    return clone


class ParallelExecutor:
    """Data-parallel training over the default process group
    (parallel.distributed.initialize), this process being one rank; with
    no group, one rank whose collectives are identities. use_cuda runs on
    this rank's card (the one initialize selected, or devices[rank]) over
    NCCL, and raises without a card; use_cuda=False runs on the host over
    gloo. mesh_shape must cover the whole group; its dp axis carries the
    data parallelism (an mp axis of more than one rank raises
    NotImplementedError), and its pp and sp axes the boundary ops and
    permutes of the programs run on it."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 mesh_shape=None, devices=None):
        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._build_strategy = build_strategy or BuildStrategy()
        self._scope = (share_vars_from._scope if share_vars_from is not None
                       else global_scope())
        self._mesh = _mesh.make_mesh(mesh_shape, devices=devices)
        backend = self._mesh.backend
        card = _distributed.card()
        # a card rank runs over NCCL, or over gloo where its group was
        # formed on a card it shares with other ranks; a CPU rank over gloo
        if backend is not None and (
                (not use_cuda and backend != "gloo")
                or (use_cuda and backend not in ("nccl", "gloo"))
                or (use_cuda and backend == "gloo" and card is None)):
            raise ValueError(
                f"ParallelExecutor(use_cuda={use_cuda}) runs over "
                f"{'nccl, or gloo on a card' if use_cuda else 'gloo'}, "
                f"but the process group's backend is {backend}"
                f"{' on no card' if card is None else ''}")
        if devices is not None:
            place = devices[self._mesh.world_rank]
        elif not use_cuda:
            place = CPUPlace()
        elif backend is None:
            place = CUDAPlace(0)
        else:
            place = CUDAPlace(torch.cuda.current_device())
        self._exe = Executor(place)  # raises for a card that is not there
        self._exe.dp = self._mesh if self._mesh.distributed else None
        self._exe._prepared.kind = "parallel_executor"
        # rewritten program clones, keyed on the source program identity +
        # mutation counter and the strategy; strong refs keep id() stable
        # for the Executor's caches
        self._rewrite_cache = {}
        self.num_trainers = num_trainers
        self.trainer_id = trainer_id

    @property
    def device_count(self):
        """The number of ranks on the dp axis."""
        return self._mesh.size

    def step_mode(self):
        """"graph" or "interpreter": how this rank ran its last step
        (Executor.step_mode of the program it ran)."""
        return self._exe.step_mode(self._last_program)

    def compile_cache_info(self):
        """This rank's compile-cache payload (Executor.compile_cache_info
        of the Executor its steps run on; cache.CompileCache.info)."""
        return self._exe.compile_cache_info()

    # ------------------------------------------------------------------
    def _prepare_program(self, program, use_zero1, gss, dp_n):
        """The program this rank runs: zero1's rewrite (its gradient
        reduce-scatters carrying the GradientScaleStrategy) or the
        GradientScaleStrategy.One scale ops, then, inside a group, the
        all-reduce of every gradient zero1 does not reduce-scatter. Cached
        per (program identity, mutation, zero1, scale strategy, dp size).
        Returns (program, Zero1Plan)."""
        key = (id(program), program._mutation, use_zero1, gss, dp_n)
        hit = self._rewrite_cache.get(key)
        if hit is not None:
            return hit
        one = gss == BuildStrategy.GradientScaleStrategy.One
        scale = float(dp_n) if one else 1.0
        if use_zero1:
            run, plan = _zero1.apply(program, dp_n, grad_scale=scale,
                                     mesh=self._mesh)
            if not plan.entries:
                run = program
        else:
            plan = _zero1.build_plan(program, dp_n, mesh=self._mesh)
            run = program
            if one and plan.entries:
                run = _zero1.apply_grad_scale(program, plan, scale)
        if self._mesh.distributed:
            reduced = {op.inputs["X"][0] for op in run.global_block().ops
                       if op.type == "zero1_scatter" and op.attrs.get(
                           "reduce", False)}
            run = insert_grad_all_reduce(run, _optimized_params(program),
                                         reduced)
        self._rewrite_cache[key] = (run, plan)
        return run, plan

    def _local_feed(self, feed, axis):
        """This rank's rows of a global-batch feed dict (batch on `axis`)."""
        n_ranks, rank = self._mesh.size, self._mesh.rank
        local = {}
        for name, value in feed.items():
            if isinstance(value, SeqTensor) or (
                    isinstance(value, LoDTensor) and value.lod()):
                raise _not_ported(
                    f"a ragged feed ({name!r}) under ParallelExecutor "
                    f"(ROADMAP queue 1 item 3)")
            if isinstance(value, LoDTensor):
                value = value.numpy()
            if not isinstance(value, torch.Tensor):
                value = np.asarray(value)
            if value.ndim <= axis:
                raise ValueError(f"feed {name!r} of shape "
                                 f"{tuple(value.shape)} has no batch axis "
                                 f"{axis}")
            n = value.shape[axis]
            if n % n_ranks:
                raise ValueError(
                    f"feed {name!r}: global batch {n} is not divisible by "
                    f"the {n_ranks} ranks of the dp axis")
            b = n // n_ranks
            index = (slice(None),) * axis + (slice(rank * b,
                                                   (rank + 1) * b),)
            local[name] = value[index]
        return local

    def _gathered(self, program, name, value, axis):
        """A batch-leading fetch (its var's dim 0 is -1) as the global
        batch, every rank's rows in rank order; any other as it is."""
        var = program.global_block().vars.get(name)
        if self._mesh.size == 1 or var is None or not var.shape \
                or var.shape[0] != -1 or not isinstance(value, torch.Tensor):
            return value
        rows = collective_ops.all_gather(value, self._mesh)
        return torch.cat(rows.unbind(0), dim=axis)

    # ------------------------------------------------------------------
    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True,
            iters=None, async_fetch=False):
        """One data-parallel step over the ranks — or, with `iters=K`, K
        steps (feeds carry a leading [K] axis, the batch on axis 1, or are
        a list of K global-batch dicts; fetches come back stacked
        [K, ...]). A list of per-device feed dicts without `iters` is
        concatenated into the global batch first (reference
        feed_parallel). `async_fetch=True` returns a FetchFuture a fetch
        (return_numpy is then ignored)."""
        # single flag check when monitoring is off (same contract as
        # Executor.run); every site below gates on `mon is not None`
        mon = monitor.step_begin("parallel_executor") \
            if monitor.enabled() else None
        self._mesh.check_live()
        for name, what in _UNPORTED_FLAGS.items():
            if flags.get(name):
                raise _not_ported(f"FLAGS_{name} ({what})")
        bs = self._build_strategy
        if bs.auto_sharding:
            raise _not_ported(f"BuildStrategy.auto_sharding "
                              f"({_UNPORTED_FLAGS['autoshard']})")
        feed = feed if feed is not None else feed_dict
        if hasattr(feed, "next_feed"):
            raise _not_ported("a DataPipe feed (ROADMAP queue 1 item 3)")
        feed = feed if feed is not None else {}
        if isinstance(feed, list) and iters is None:
            # per-device feed list (reference feed_parallel): concatenate
            merged = {}
            for d in feed:
                for k, v in d.items():
                    if isinstance(v, LoDTensor):
                        v = v.numpy()
                    merged.setdefault(k, []).append(np.asarray(v))
            feed = {k: np.concatenate(vs, axis=0) for k, vs in merged.items()}
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]

        program, scope = self._program, self._scope
        use_zero1 = bs.sharded_weight_update
        if use_zero1 is None:
            use_zero1 = bool(flags.get("zero1")) or (
                bs.reduce_strategy == BuildStrategy.ReduceStrategy.Reduce)
        dp_n = self._mesh.shape[_mesh.DP_AXIS]
        use_zero1 = bool(use_zero1) and dp_n >= 2
        run_program, zplan = self._prepare_program(
            program, use_zero1, bs.gradient_scale_strategy, dp_n)
        if use_zero1 and zplan.entries:
            # accumulators live in this rank's [1, shard] row; a full-layout
            # scope (startup, or convert.load_numpy_state) converts here
            zplan.ensure_scope_sharded(scope)
        else:
            _zero1.ensure_scope_unsharded(scope, program)
        if mon is not None and zplan.entries:
            # analytic ring-collective accounting for the dp gradient path
            # (bytes, not time); journal extras ride into the JSONL record
            # for `python -m paddle_tpu_torch monitor`
            cb = zplan.collective_bytes(sharded=use_zero1)
            osb = zplan.optimizer_state_bytes(sharded=use_zero1)
            reg = monitor.registry()
            for op_name, nbytes in sorted(cb.items()):
                reg.gauge(
                    "collective_bytes_per_step",
                    help="analytic per-step dp-collective traffic (ring)",
                    op=op_name).set(float(nbytes))
            reg.gauge(
                "optimizer_state_bytes_per_replica",
                help="optimizer accumulator bytes resident per replica",
            ).set(float(osb))
            if mon.extra is None:
                mon.extra = {}
            mon.extra["collective_bytes"] = {
                k: int(v) for k, v in cb.items()}
            mon.extra["optimizer_state_bytes"] = int(osb)
            mon.extra["zero1"] = bool(use_zero1)
        t_enc = time.perf_counter()
        if isinstance(feed, list):
            local = [self._local_feed(f, 0) for f in feed]
        else:
            local = self._local_feed(feed, 0 if iters is None else 1)
        if mon is not None:
            mon.phase("feed_encode", time.perf_counter() - t_enc)
        self._last_program = run_program
        # the watchdog watches the step, the gathers of its fetches and
        # their readback
        with _watchdog.armed("parallel_executor"):
            _chaos.on_run("parallel_executor")
            verify = {"mesh_axes": dict(self._mesh.shape),
                      "zplan": zplan if use_zero1 and zplan.entries
                      else None,
                      "context": "parallel_executor"}
            outs, done = self._exe._run(run_program, scope, local, fetch_names,
                                        iters, mon, kind="parallel_executor",
                                        verify=verify)
            if done.times is not None and flags.get("verify") == "full":
                # measured counterpart of the analysis_peak_hbm gauge: the
                # bytes this rank holds for the step's state and fetches
                # (the estimate is held against it within 2x in the tests)
                state_in, _ = _collect_state(run_program, scope)
                live = analysis.measured_live_bytes(
                    [scope.find_var(n) for n in state_in] + list(outs))
                monitor.registry().gauge(
                    "hbm_live_bytes_per_replica",
                    help="measured per-device resident bytes of the step "
                         "state + fetches",
                ).set(float(live))
            replica_ms = replica_ids = None
            if mon is not None and flags.get("monitor_replica_skew"):
                # wait for this rank's step, then all-gather every rank's
                # completion time: a host sync, hence the separate opt-in flag
                leaf = outs[0] if outs else torch.empty(0,
                                                       device=self._exe.device)
                res = monitor.measure_replica_ms(leaf, done.t_dispatch)
                if res is not None:
                    replica_ms, replica_ids = res
            axis = 0 if iters is None else 1
            outs = [self._gathered(program, n, o, axis)
                    for n, o in zip(fetch_names, outs)]
            if async_fetch:
                outs = fetch_futures(outs, self._exe.device)
            elif return_numpy:
                if mon is not None:
                    with mon.timed("fetch_readback"):
                        outs = as_numpy(outs)
                else:
                    outs = as_numpy(outs)
        if mon is not None:
            monitor.step_end(mon, iters=done.iters, replica_ms=replica_ms,
                             replica_ids=replica_ids)
        return outs

    def bcast_params(self):
        """reference parallel_executor.py:242: every parameter takes rank
        0's value (ranks that ran one startup program from one seed hold
        the same values already)."""
        if not self._mesh.distributed:
            return
        for p in self._program.global_block().all_parameters():
            t = self._scope.find_var(p.name)
            if t is not None:
                self._scope.set_var(p.name, collective_ops.broadcast(
                    t, self._mesh, 0))
