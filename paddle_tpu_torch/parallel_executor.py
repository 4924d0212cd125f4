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
Tensor parallelism: a mesh with an mp axis of more than one rank (dp
outer, mp inner) runs the program the port's partitioner writes for this
rank (parallel/autoshard/lower.py) from the ShardingPlan that
propagation builds over the resolved program (after zero1, before the
gradient all-reduce and the fusion pass, so buckets see local shapes):
local shapes, local kernels, and explicit collectives over the mp
sub-group. Each rank runs the startup program whole and keeps its slice
of every mp-sharded persistable (lower.ensure_scope_local), so a sharded
parameter is exactly the slice of the one-rank parameter; a fetch of an
mp-sharded var comes back whole, gathered over mp. The plan's digest
joins the prepared key and the persistent cache's digest
(Executor.plan_digest).
A stated difference: the JAX package propagates the seeds only with
FLAGS_autoshard / BuildStrategy.auto_sharding on, and otherwise leaves
the annotated state to XLA's partitioner. The port has no partitioner,
so it propagates the seeds and lowers the plan whenever the mesh has an
mp axis of more than one rank, auto_sharding on or off; "off" means, as
in the JAX package, that the plan is not registered (no checkpoint
manifest section) and sets no gauges.
The static overlap schedule (FLAGS_overlap_plan, analysis/schedule.py)
reorders the zero1-resolved program under zero1 at dp >= 2, before the
autoshard plan, the gradient all-reduce and the fusion pass (the JAX
order: zero1, overlap, fuse): each bucket of gradient reduce-scatters
moves up to just after the last of its gradients is made, the reorder
refused (ProgramVerificationError) on any PTA03x hazard. Over NCCL a
hoisted scatter is issued asynchronously and waited for on the step's
stream before the first op that reads its shard (OpContext.defer), so in
a captured graph the collective is a branch beside the rest of the
backward; over gloo (synchronous) the reorder changes only the order.
The plan's digest joins the prepared key and the persistent cache's
digest (Executor.plan_digest): toggling the flag prepares anew. The step
is bitwise the same with the flag on and off.
A ragged feed (a LoDTensor with a LoD, or a SeqTensor) splits by
sequences: rank r takes sequences [r*B/W, (r+1)*B/W) and their tokens,
zero-padded to the global feed's token count, so a rank's shape is
static for one global bucket and its loops keep their trip counts; the
lod-aware reductions over the batch (`mean` over a SeqTensor,
edit_distance's SequenceNum, chunk_eval's counts) sum over the ranks. A
DataPipe feed is pulled in the monitor's `feed_wait` phase (iters
defaults to its chunk size); each rank keeps its rows of the staged
global chunk as views on the device and releases the chunk's lease after
the step, as Executor.run does. `parallel.pipeline.PipelineRunner(
parallel_executor=...)` runs each pipeline cell through `_run_cell` on
this rank's rows (dp x pp).
"""

import math
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
from .core import executor_core
from .datapipe.transfer import pull_feed, staged_feed
from .executor import Executor, as_numpy, fetch_futures
from .ops import collective_ops
from .parallel import autoshard as _autoshard
from .parallel import distributed as _distributed
from .parallel import mesh as _mesh
from .parallel import zero1 as _zero1
from .parallel.autoshard import lower as _lower
from .resilience import chaos as _chaos
from .resilience import watchdog as _watchdog

__all__ = ["ParallelExecutor", "ExecutionStrategy", "BuildStrategy"]


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
        # GSPMD-style autoshard (parallel.autoshard): register the plan and
        # set its gauges; the plan is lowered whenever the mesh has an mp
        # axis of more than one rank. None defers to FLAGS_autoshard.
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
    gradient's own name right after its last writer, or first of all
    where the program reads it but writes it nowhere (a pipeline's
    optimizer cell, fed the gradients accumulated over the microbatches).
    The gradient is the parameter's raw one (`<param>@GRAD`, before any
    regularization or clipping, which then apply once to the global
    gradient) where the program has it, else the one the optimizer reads.
    Gradients in `reduced` (reduce-scattered by zero1) are left alone."""
    clone = program.clone()
    gb = clone.global_block()
    targets = set()
    for p, g in params.items():
        raw = grad_var_name(p)
        g = raw if raw in gb.vars else g
        if g not in reduced:
            targets.add(g)
    last, read = {}, set()
    for i, op in enumerate(gb.ops):
        read.update(n for n in op.input_arg_names() if n in targets)
        for n in op.output_arg_names():
            if n in targets:
                last[n] = i
    after = {}
    for n, i in last.items():
        after.setdefault(i, []).append(n)
    after[-1] = sorted(read - set(last))

    def reduce_op(n):
        return Operator(gb, "all_reduce", {"X": [n]}, {"Out": [n]},
                        {"reduction": "sum", "axis_name": _mesh.DP_AXIS,
                         "op_role": OpRole.Backward})

    new_ops = [reduce_op(n) for n in after[-1]]
    for i, op in enumerate(gb.ops):
        new_ops.append(op)
        for n in sorted(after.get(i, ())):
            new_ops.append(reduce_op(n))
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
    data parallelism, its mp axis the tensor parallelism of the
    set_sharding seeds (module docstring), and its pp and sp axes the
    boundary ops and permutes of the programs run on it."""

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
    def _prepare_program(self, program, use_zero1, gss, dp_n, use_auto,
                         overlap=None, feed_names=None):
        """The program this rank runs: zero1's rewrite (its gradient
        reduce-scatters carrying the GradientScaleStrategy) or the
        GradientScaleStrategy.One scale ops; then, with `overlap` (the
        bucket bytes of FLAGS_overlap_plan) under zero1, the static
        overlap schedule's reorder (_overlap_program); then, with
        autoshard on or an mp axis of more than one rank, the ShardingPlan
        over that program and its lowering for this rank
        (parallel/autoshard); then, inside a group whose dp axis has more
        than one rank (or a group of one), the all-reduce of every
        gradient zero1 does not reduce-scatter. Cached per (program
        identity, mutation, zero1, scale strategy, dp size, autoshard,
        overlap). Returns a _Prepared."""
        key = (id(program), program._mutation, use_zero1, gss, dp_n,
               use_auto, overlap)
        hit = self._rewrite_cache.get(key)
        if hit is not None:
            return hit
        one = gss == BuildStrategy.GradientScaleStrategy.One
        scale = float(dp_n) if one else 1.0
        zero1_on = False
        if use_zero1:
            run, plan = _zero1.apply(program, dp_n, grad_scale=scale,
                                     mesh=self._mesh)
            if not plan.entries:
                run = program
            zero1_on = bool(plan.entries)
        else:
            plan = _zero1.build_plan(program, dp_n, mesh=self._mesh)
            run = program
            if one and plan.entries:
                run = _zero1.apply_grad_scale(program, plan, scale)
        osched = None
        if overlap is not None and zero1_on:
            run, osched = self._overlap_program(run, plan, overlap,
                                                feed_names)
        # the gradients zero1 reduce-scatters (before a lowering renames
        # the scatters' inputs to their gathered whole)
        reduced = {op.inputs["X"][0] for op in run.global_block().ops
                   if op.type == "zero1_scatter" and op.attrs.get(
                       "reduce", False)}
        mesh_axes = dict(self._mesh.shape)
        # the program in the JAX package's layout ([W, shard] zero1
        # accumulators over dp): what the plan and the checks read
        view = _zero1.global_view(run, plan) if zero1_on else run
        aplan = low = None
        if use_auto or mesh_axes.get(_mesh.MP_AXIS, 1) > 1:
            aplan = _autoshard.build_plan(view, mesh_axes)  # bad seed: raise
            low = _lower.lower(run, aplan)
            run = low.program
        else:
            _autoshard.validate_seeds(program, mesh_axes)
        if self._mesh.distributed and (
                dp_n > 1 or math.prod(mesh_axes.values()) == 1):
            run = insert_grad_all_reduce(run, _optimized_params(program),
                                         reduced)
        hit = _Prepared(run, plan, view, aplan, low,
                        zero1_on or (low is not None and bool(low.local)),
                        osched)
        self._rewrite_cache[key] = hit
        return hit

    def _overlap_program(self, program, zplan, bucket_bytes,
                         feed_names=None):
        """The static overlap schedule (analysis.schedule) applied to the
        zero1-resolved `program`: the legal zero1_scatter reduce-scatters
        hoisted into the backward section, bucketed under `bucket_bytes`,
        each marked `overlap_async` (issued asynchronously over NCCL and
        waited for before its first reader: ops/collective_ops.py).
        Returns (program', ScheduleReport); _prepare_program caches it. A
        program carrying any PTA03x dataflow hazard raises
        ProgramVerificationError: it is never silently reordered. The
        costs are read off the program in the JAX package's layout
        (zero1.global_view of `zplan`'s rewrite), so the report is the
        JAX package's."""
        sched = analysis.schedule.analyze(
            _zero1.global_view(program, zplan),
            mesh_axes=dict(self._mesh.shape), feed_names=feed_names,
            bucket_bytes=bucket_bytes)
        reordered, plan = analysis.schedule.apply_plan(
            program, sched.plan, feed_names=feed_names)
        if reordered is not program:
            pos = {i: p for p, i in enumerate(plan.order)}
            ops = reordered.global_block().ops
            for i, _ in plan.moves:
                ops[pos[i]].attrs["overlap_async"] = True
            reordered._mutation += 1
        return reordered, sched

    def _local_feed(self, feed, axis):
        """This rank's rows of a global-batch feed dict (batch on `axis`);
        a ragged feed's sequences and their tokens (_local_seq)."""
        n_ranks, rank = self._mesh.size, self._mesh.rank
        local = {}
        for name, value in feed.items():
            if isinstance(value, LoDTensor) and value.lod():
                lengths = np.diff(np.asarray(
                    value.last_level_offsets())).astype(np.int32)
                value = SeqTensor(value.numpy(), lengths, lengths)
            if isinstance(value, SeqTensor):
                local[name] = self._local_seq(name, value, axis)
                continue
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

    def _local_seq(self, name, seq, axis):
        """This rank's part of a ragged feed: sequences [r*b, (r+1)*b) of
        the B (b = B/W) and their tokens, zero-padded to the global feed's
        token count N, so the rank's shape is the same for every batch of
        one global bucket. With `axis` 1 (iters' stacked [K, ...] feed)
        each step is split alike."""
        data, lengths = (torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v for v in (seq.data, seq.lengths))
        host = seq.host_lengths
        if host is None:
            host = lengths.cpu().numpy()
        host = np.asarray(host, dtype=np.int32)
        if axis == 1:
            steps = [self._local_seq(name, SeqTensor(
                data[k], lengths[k], host[k]), 0)
                for k in range(data.shape[0])]
            return SeqTensor(torch.stack([t.data for t in steps]),
                             torch.stack([t.lengths for t in steps]),
                             np.stack([t.host_lengths for t in steps]))
        n_ranks, rank = self._mesh.size, self._mesh.rank
        if host.shape[0] % n_ranks:
            raise ValueError(
                f"ragged feed {name!r}: {host.shape[0]} sequences are not "
                f"divisible by the {n_ranks} ranks of the dp axis")
        b = host.shape[0] // n_ranks
        offs = np.concatenate([[0], np.cumsum(host, dtype=np.int64)])
        lo, hi = int(offs[rank * b]), int(offs[(rank + 1) * b])
        rows = data[lo:hi]
        if hi - lo < data.shape[0]:
            rows = torch.cat([rows, rows.new_zeros(
                (data.shape[0] - (hi - lo),) + tuple(data.shape[1:]))])
        return SeqTensor(rows, lengths[rank * b:(rank + 1) * b],
                         host[rank * b:(rank + 1) * b])

    def _gathered(self, program, name, value, axis, low):
        """A fetch whole: an mp-sharded var's local block gathered over
        mp (its dim shifted by `axis`, the batch axis, for iters' leading
        step axis), then a batch-leading one (its var's dim 0 is -1) as
        the global batch, every rank's rows in rank order; any other as
        it is."""
        if isinstance(value, SeqTensor):
            return self._gathered_seq(value, axis)
        if not isinstance(value, torch.Tensor):
            return value
        entry = low.local.get(name) if low is not None else None
        if entry is not None:
            d, whole, local = entry
            if whole[d] != local[d] and value.shape[d + axis] == local[d]:
                value = collective_ops.gather_dim(
                    value, self._mesh.axis(_mesh.MP_AXIS), d + axis)
        var = program.global_block().vars.get(name)
        if self._mesh.size == 1 or var is None or not var.shape \
                or var.shape[0] != -1:
            return value
        rows = collective_ops.all_gather(value, self._mesh)
        return torch.cat(rows.unbind(0), dim=axis)

    def _gathered_seq(self, seq, axis):
        """A ragged fetch whole: every rank's sequences in rank order, their
        real tokens first and the tail zero, in the rank's token count
        (the global feed's: _local_seq). With `axis` 1 each step alike."""
        if self._mesh.size == 1:
            return seq
        if axis == 1:
            steps = [self._gathered_seq(SeqTensor(seq.data[k],
                                                  seq.lengths[k]), 0)
                     for k in range(seq.data.shape[0])]
            return SeqTensor(torch.stack([t.data for t in steps]),
                             torch.stack([t.lengths for t in steps]))
        data = collective_ops.all_gather(seq.data, self._mesh)
        lengths = collective_ops.all_gather(seq.lengths, self._mesh)
        counts = lengths.sum(dim=1).tolist()
        real = [data[r, :int(c)] for r, c in enumerate(counts)]
        n = seq.data.shape[0]
        flat = torch.cat(real)
        if flat.shape[0] < n:
            flat = torch.cat([flat, flat.new_zeros(
                (n - flat.shape[0],) + tuple(flat.shape[1:]))])
        return SeqTensor(flat, lengths.reshape(-1))

    # ------------------------------------------------------------------
    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True,
            iters=None, async_fetch=False):
        """One data-parallel step over the ranks — or, with `iters=K`, K
        steps (feeds carry a leading [K] axis, the batch on axis 1, or are
        a list of K global-batch dicts; fetches come back stacked [K, ...]).
        A list of per-device feed dicts without `iters` is concatenated
        into the global batch first (reference feed_parallel). `feed` may
        be a DataPipe: its next staged chunk is pulled in the monitor's
        `feed_wait` phase, `iters` defaults to its chunk size, and its
        transfer-engine markers are honoured as Executor.run honours them.
        `async_fetch=True` returns a FetchFuture a fetch (return_numpy is
        then ignored)."""
        # single flag check when monitoring is off (same contract as
        # Executor.run); every site below gates on `mon is not None`
        mon = monitor.step_begin("parallel_executor") \
            if monitor.enabled() else None
        self._mesh.check_live()
        feed = feed if feed is not None else feed_dict
        feed, iters, pipe = pull_feed(feed, iters, mon)
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
        # the watchdog watches the step, the gathers of its fetches and
        # their readback
        with _watchdog.armed("parallel_executor"):
            # fault injection, before the chunk's lease is waited on or
            # released: a retried run finds the feed as it was
            _chaos.on_run("parallel_executor")
            device = self._exe.device
            with staged_feed(feed, device) as (feed, wire, keep):
                outs, done, skew = self._run_global(feed, fetch_names,
                                                    iters, mon, wire)
                outs = keep(outs)
            if async_fetch:
                outs = fetch_futures(outs, device)
            elif return_numpy:
                if mon is not None:
                    with mon.timed("fetch_readback"):
                        outs = as_numpy(outs)
                else:
                    outs = as_numpy(outs)
        if mon is not None:
            monitor.step_end(mon, iters=done.iters, datapipe=pipe,
                             replica_ms=skew[0], replica_ids=skew[1])
        return outs

    def _run_global(self, feed, fetch_names, iters, mon, wire):
        """The step of run() on the global batch: this rank's rows, its
        step, and the fetches gathered whole: (fetches, the Executor's
        _Run, (replica_ms, replica_ids) under FLAGS_monitor_replica_skew
        or Nones)."""
        t_enc = time.perf_counter()
        axis = 0 if iters is None else 1
        if isinstance(feed, list):
            local = [self._local_feed(f, 0) for f in feed]
        else:
            local = self._local_feed(feed, axis)
        if mon is not None:
            mon.phase("feed_encode", time.perf_counter() - t_enc)
        program = self._program
        outs, done, prep = self._run_rank(program, local, fetch_names,
                                          iters, mon, wire)
        skew = (None, None)
        if mon is not None and flags.get("monitor_replica_skew"):
            # wait for this rank's step, then all-gather every rank's
            # completion time: a host sync, hence the separate opt-in flag
            leaf = outs[0] if outs else torch.empty(0,
                                                   device=self._exe.device)
            res = monitor.measure_replica_ms(leaf, done.t_dispatch)
            if res is not None:
                skew = res
        outs = [self._gathered(program, n, o, axis, prep.lowering)
                for n, o in zip(fetch_names, outs)]
        return outs, done, skew

    def _run_cell(self, program, feed, fetch_names):
        """One step of `program` (a pipeline cell: parallel.pipeline's
        PipelineRunner) on `feed`, already this rank's rows: {fetch name:
        this rank's tensor}. Nothing is gathered: boundary values stay on
        the rank, and the runner gathers only the caller's fetches."""
        mon = monitor.step_begin("parallel_executor") \
            if monitor.enabled() else None
        self._mesh.check_live()
        with _watchdog.armed("parallel_executor"):
            _chaos.on_run("parallel_executor")
            outs, done, _ = self._run_rank(program, feed, fetch_names, None,
                                           mon)
        if mon is not None:
            monitor.step_end(mon, iters=done.iters)
        return dict(zip(fetch_names, outs))

    def _run_rank(self, program, local, fetch_names, iters, mon, wire=None):
        """This rank's step of `program` on its rows `local`: the program
        resolved for the strategy and the flags (_prepare_program), the
        scope's layouts, the gauges, then the rank's Executor. Returns
        (this rank's fetch tensors, the Executor's _Run, the
        _Prepared)."""
        bs = self._build_strategy
        scope = self._scope
        use_zero1 = bs.sharded_weight_update
        if use_zero1 is None:
            use_zero1 = bool(flags.get("zero1")) or (
                bs.reduce_strategy == BuildStrategy.ReduceStrategy.Reduce)
        dp_n = self._mesh.shape[_mesh.DP_AXIS]
        use_zero1 = bool(use_zero1) and dp_n >= 2
        use_auto = bs.auto_sharding
        if use_auto is None:
            use_auto = bool(flags.get("autoshard"))
        use_auto = bool(use_auto) and math.prod(self._mesh.shape.values()) > 1
        overlap = None
        if flags.get("overlap_plan"):
            overlap = int(flags.get("overlap_bucket_bytes")) \
                or analysis.schedule.DEFAULT_BUCKET_BYTES
        prep = self._prepare_program(
            program, use_zero1, bs.gradient_scale_strategy, dp_n, use_auto,
            overlap, _feed_names_of(local))
        run_program, zplan, aplan, low = (prep.program, prep.zplan,
                                          prep.aplan, prep.lowering)
        self._exe.plan_digest = prep.digest()
        if use_zero1 and zplan.entries:
            # accumulators live in this rank's [1, shard] row; a full-layout
            # scope (startup, or convert.load_numpy_state) converts here
            zplan.ensure_scope_sharded(scope)
        else:
            _zero1.ensure_scope_unsharded(scope, program)
        if low is not None and low.local:
            # this rank's slice of every mp-sharded persistable that the
            # scope holds whole (startup, a restore, load_numpy_state)
            _lower.register_lowering(low, self._mesh.axis(_mesh.MP_AXIS))
            _lower.ensure_scope_local(scope, low)
        if use_auto:
            _autoshard.register_plan(aplan)
            if mon is not None:
                _plan_gauges(mon, aplan)
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
        osched = prep.osched
        if mon is not None and osched is not None:
            analysis.schedule.record_gauges(
                osched, context="parallel_executor")
            if mon.extra is None:
                mon.extra = {}
            mon.extra["overlap"] = {
                "critical_path_ms": float(osched.critical_path_ms),
                "hoistable_bytes": int(osched.plan.hoistable_bytes),
                "buckets": len(osched.plan.buckets),
                "moves": len(osched.plan.moves),
                "digest": osched.plan.digest(),
            }
        self._last_program = run_program
        verify = {"mesh_axes": dict(self._mesh.shape),
                  "zplan": zplan if use_zero1 and zplan.entries else None,
                  "aplan": aplan if use_auto else None,
                  "context": "parallel_executor"}
        if prep.local_layout:
            # the checks read the global layout (the sharding and plan
            # checks, the shape contracts of zero1's ops): they run on the
            # program in the JAX package's layout, and not again on the
            # rank's, whose descs hold this rank's shapes
            analysis.ensure_verified(
                prep.view, feed_names=_feed_names_of(local),
                fetch_names=fetch_names,
                donate_state=not flags.get("debug_nans"), **verify)
            verify = {"level": "off"}
        outs, done = self._exe._run(run_program, scope, local, fetch_names,
                                    iters, mon, kind="parallel_executor",
                                    wire=wire, verify=verify)
        if done.times is not None and flags.get("verify") == "full":
            # measured counterpart of the analysis_peak_hbm gauge: the
            # bytes this rank holds for the step's state and fetches
            # (the estimate is held against it within 2x in the tests)
            state_in, _ = executor_core.collect_state_names(run_program,
                                                            scope)
            live = analysis.measured_live_bytes(
                [scope.find_var(n) for n in state_in] + list(outs))
            monitor.registry().gauge(
                "hbm_live_bytes_per_replica",
                help="measured per-device resident bytes of the step "
                     "state + fetches",
            ).set(float(live))
        return outs, done, prep

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


class _Prepared:
    """What ParallelExecutor._prepare_program resolved: the program this
    rank runs, the Zero1Plan, `view` (the program before the lowering and
    the gradient all-reduce, in the JAX package's layout: what the plan
    is built on and FLAGS_verify checks), the ShardingPlan and its
    Lowering (None where no plan was built), whether the rank's program
    holds local shapes (zero1's rows or an mp lowering), and the overlap
    schedule's ScheduleReport (None with FLAGS_overlap_plan off or
    nothing to reorder)."""

    __slots__ = ("program", "zplan", "view", "aplan", "lowering",
                 "local_layout", "osched")

    def __init__(self, program, zplan, view, aplan, lowering,
                 local_layout, osched=None):
        self.program = program
        self.zplan = zplan
        self.view = view
        self.aplan = aplan
        self.lowering = lowering
        self.local_layout = local_layout
        self.osched = osched

    def digest(self):
        """The plans' part of the prepared key (Executor.plan_digest): the
        autoshard plan's digest and the overlap plan's, or None."""
        parts = []
        if self.aplan is not None:
            parts.append(self.aplan.digest())
        if self.osched is not None:
            parts.append("overlap:" + self.osched.plan.digest())
        return "|".join(parts) or None


def _feed_names_of(feed):
    """The names a local feed (a dict, or iters' list of dicts) feeds."""
    if isinstance(feed, list):
        return list(feed[0]) if feed else []
    return list(feed)


def _plan_gauges(mon, aplan):
    """The autoshard plan's gauges and journal extra, as the JAX
    package's ParallelExecutor sets them."""
    reg = monitor.registry()
    reg.gauge(
        "autoshard_reshard_bytes_per_step",
        help="analytic per-step reshard traffic forced by plan "
             "conflicts and locked-seed boundaries",
    ).set(float(aplan.reshard_bytes_per_step()))
    reg.gauge(
        "autoshard_plan_vars",
        help="variables covered by the active autoshard plan",
    ).set(float(len(aplan.specs)))
    reg.gauge(
        "autoshard_plan_sharded_vars",
        help="plan variables with at least one sharded dim",
    ).set(float(len(aplan.sharded_names())))
    reg.gauge(
        "autoshard_conflicts_resolved",
        help="propagation conflicts arbitrated by the cost model",
    ).set(float(len(aplan.conflicts)))
    reg.gauge(
        "autoshard_unresolved_vars",
        help="plan variables with no resolvable layout (should be 0)",
    ).set(float(len(aplan.unresolved)))
    if mon.extra is None:
        mon.extra = {}
    mon.extra["autoshard"] = {
        "digest": aplan.digest(),
        "sharded_vars": len(aplan.sharded_names()),
        "conflicts": len(aplan.conflicts),
        "reshard_bytes": int(aplan.reshard_bytes_per_step()),
    }
