"""Executor core: the op-by-op interpreter and the whole-block step.

Reference parity: paddle/fluid/framework/executor.cc:133 runs the op list
one kernel launch at a time against a Scope. `run_ops` does the same: it
walks the (dead-code-eliminated) op list and calls each op's registered
torch kernel on an env of tensors.

On top of it sit the counterparts of the JAX package's whole-block step
(paddle_tpu/core/executor_core.py):
  * `build_step_fn` — the pure step(mut_state, const_state, feeds) ->
    (fetches, new_mut) over the block, which the Executor runs as it is on
    the CPU (and for programs a CUDA graph cannot hold);
  * `compile_step_fn` — on a CUDA place, one call of that step captured as
    a CUDA graph over static buffers (`CapturedStep`), the counterpart of
    `jax.jit` with donated state;
  * `build_multi_step_fn` — `iters=K` as K calls of one step over a
    device-resident [K, ...] feed stack, the counterpart of the lax.scan
    multi-step; on the card each call is one graph replay.
`capture_blocker` is the static rule that keeps a step out of a graph.
FLAGS_check_nan_inf (`check_values_finite`) checks every op's outputs in
an eager step, naming the op; a captured step is checked by the Executor
once after its replays. The FLAGS_fuse_optimizer_ops concat path has no
counterpart yet.
"""

import numpy as np
import torch

from .. import cuda_build, flags, profiler
from . import registry
from .places import device_for

# The reader ops (ops/reader_ops.py): readers are host objects held in the
# scope, and `read` pops the next batch on the host.
READER_OPS = frozenset({
    "create_recordio_file_reader", "open_files",
    "create_random_data_generator", "create_shuffle_reader",
    "create_batch_reader", "create_double_buffer_reader",
    "create_datapipe_reader", "create_multi_pass_reader", "read"})
# Op types whose kernels run on the host, which a graph cannot hold (the
# JAX package's `no_trace` ops, paddle_tpu/executor.py:121-127): the file
# IO ops (ops/io_ops.py) and the reader ops, which also have side effects,
# so dead-code elimination keeps them. Random ops are not among them: they
# draw from a RandomStream, whose generator the captured graph advances at
# every replay.
HOST_OPS = frozenset({"save", "load", "save_combine", "load_combine",
                      "delete_var"}) | READER_OPS
# Op types that read device values on the host: no side effects, so
# dead-code elimination may drop them, but a graph cannot hold them. A
# program with one runs through the interpreter, prepared and cached as
# any other. They are ops/metric_ops.py's chunk_eval (the JAX package's
# no_trace metric) and, from ops/control_flow_ops.py, `while` and its
# grad (the condition is read after every trip, as the reference's
# while_op.cc does), the tensor-array ops (the index is read on the
# host), the rank-table family (the JAX package's no_trace ops, which
# read the lengths), IfElse's row split and merge (the rows are found on
# the host), `print` and the JAX package's other no_trace ops (feed,
# fetch, get_places). A data-dependent loop inside a CUDA graph
# needs the graph's conditional nodes (ROADMAP).
HOST_SYNC_OPS = frozenset({
    "chunk_eval", "while", "while_grad",
    "write_to_array", "read_from_array", "write_to_array_grad",
    "read_from_array_grad", "lod_array_length",
    "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
    "array_to_lod_tensor", "reorder_lod_tensor_by_rank",
    "reorder_lod_tensor_by_rank_grad", "shrink_rnn_memory",
    "print", "feed", "fetch", "get_places",
    "split_lod_tensor", "split_lod_tensor_grad", "merge_lod_tensor",
    "merge_lod_tensor_grad"})


def first_non_finite(named_values):
    """(name, "NaN" or "Inf") of the first of `named_values` ((name,
    value) pairs) that holds NaN/Inf, or None. A SeqTensor is checked by
    its data; values that are not floating-point tensors are skipped. One
    reduction over all of them gives one flag, read once; the culprit is
    looked for only when it is set."""
    named = []
    for name, v in named_values:
        v = registry.seq_data(v)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            named.append((name, v))
    if not named:
        return None
    finite = torch.stack([torch.isfinite(v).all() for _, v in named])
    if bool(finite.all()):
        return None
    bad = int(torch.nonzero(~finite)[0, 0])
    name, v = named[bad]
    return name, "NaN" if bool(torch.isnan(v).any()) else "Inf"


def check_values_finite(named_values, context=""):
    """FLAGS_check_nan_inf (reference executor.cc:343 CheckTensorNANOrInf):
    raise naming the first variable of `named_values` ((name, value)
    pairs) that holds NaN/Inf (first_non_finite)."""
    bad = first_non_finite(named_values)
    if bad is not None:
        raise RuntimeError(
            f"Variable {bad[0]!r} contains {bad[1]}{context} "
            f"(FLAGS_check_nan_inf)")


def trap_non_finite(op_type, named_values):
    """FLAGS_debug_nans (the JAX package's jax_debug_nans trap): raise
    FloatingPointError naming op `op_type` and the first of its outputs
    (`named_values`, (name, value) pairs) that holds NaN/Inf. Runs before
    the op's outputs reach the step's env, so nothing the op wrote is
    kept."""
    bad = first_non_finite(named_values)
    if bad is not None:
        raise FloatingPointError(
            f"op {op_type!r} wrote {bad[1]} to its output {bad[0]!r} "
            f"(FLAGS_debug_nans)")


class RandomStream:
    """The random numbers of one (Executor, program): one torch.Generator
    on the program's device, seeded once from `program.random_seed`, that
    every step's random ops draw from in turn (an op whose `seed` attr is
    0). The generator's state advances with every draw in the interpreter,
    and by the same amount at every replay of a captured step, which
    registers it with its graph (`CapturedStep`): k steps draw the same
    numbers through either path from the same state. The JAX package
    draws each step's numbers from fold_in(PRNGKey(seed), step) instead;
    the two packages draw different numbers.

    An op with a non-zero `seed` attr draws the same numbers at every step
    (the JAX package's PRNGKey(seed)): `fixed` makes them once, with a
    generator of their own, and holds them as a constant of the step.
    `held` holds any such constant, for example one copied from the host,
    which a capture cannot copy."""

    def __init__(self, device, seed):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._held = {}

    def held(self, key, make):
        """A copy of make(), made at the first call with this `key` and
        held. The first call of a program's step is never a capture (the
        executor runs one step eagerly before it), so make() stays out of
        the graph and a replay copies the held tensor on the device."""
        t = self._held.get(key)
        if t is None:
            t = self._held[key] = make()
        return t.clone()

    def fixed(self, key, seed, draw):
        """A copy of draw(generator seeded by `seed`), drawn at the first
        call with this `key` and `seed` and held (`held`)."""
        seed = int(seed)
        return self.held(("fixed", seed) + tuple(key), lambda: draw(
            torch.Generator(device=self.device).manual_seed(seed)))


def check_cap(host_lengths, cap, what, op_type):
    """Raise ValueError when a sequence of `host_lengths` (numpy) is longer
    than the static scan bound `cap`, which would truncate it silently."""
    mx = int(np.max(host_lengths)) if len(host_lengths) else 0
    if mx > cap:
        raise ValueError(
            f"{op_type}: {what} sequence of length {mx} exceeds static cap "
            f"{cap}; raise max_{what}_len")


def check_caps(caps, feeds):
    """The cap checks a step recorded ({(feed name, cap, what, op type)},
    OpContext.check_cap) against the host lengths of `feeds`: what a
    replay, which runs no op's Python, checks before it runs."""
    for name, cap, what, op_type in caps:
        host = getattr(feeds.get(name), "host_lengths", None)
        if host is not None:
            check_cap(host, cap, what, op_type)


class OpContext:
    """Per-step context passed to kernels: the device every allocation
    lands on, the random stream the step draws from, the test-mode flag,
    the host copies of the fed sequence lengths
    ({id(lengths tensor): (feed name, numpy lengths or None)}), and the
    data-parallel group the step runs on (`dp`, a parallel.mesh.Mesh:
    ParallelExecutor's; None for a plain Executor), over which the ops
    that reduce over the batch (mean, batch_norm, accuracy, dropout's
    draw) give the global batch's result and the collective ops
    communicate. `env` is the step's {name: value} map while run_ops
    runs, and `scope` the Scope an interpreted step reads (None inside a
    capture): the host op delete_var drops names from both. `eager` is
    False while a CUDA graph captures the step: nothing may then wait
    for the device (`check_nan_inf`, each op's outputs checked after it)
    or time the ops on the host (`profile`, each op a profiler event)."""

    def __init__(self, place, rng=None, is_test=False, fed_lengths=None,
                 caps=None, dp=None, scope=None, eager=True, feed=None):
        self.place = place
        self.feed = feed or {}  # the step's feeds (the feed op)
        self.device = device_for(place)
        self.rng = rng if rng is not None else RandomStream(self.device, 0)
        self.is_test = is_test
        self.dp = dp
        self.current_op = None  # the op being run (derived grad kernels)
        self.fed_lengths = fed_lengths or {}
        self.caps = caps if caps is not None else set()
        self.env = None
        self.scope = scope
        self.eager = eager
        self.check_nan_inf = eager and flags.get("check_nan_inf")
        # FLAGS_debug_nans keeps its runs on the interpreter (eager)
        self.debug_nans = eager and flags.get("debug_nans")
        self.profile = eager and profiler.enabled()

    def run_block(self, block, env):
        """Run a sub-block's ops against `env` (the control-flow ops).
        The running op and the env are per-op state that the sub-block's
        ops overwrite: both come back as they were, for the kernel that
        called this (and a derived grad's `_wanted`, which reads the
        running op)."""
        op, outer = self.current_op, self.env
        try:
            run_ops(block.ops, env, self)
        finally:
            self.current_op, self.env = op, outer
        return env

    def check_cap(self, lengths, cap, what, op_type):
        """Raise ValueError when a sequence of `lengths` is longer than
        `cap`, reading the lengths on the host only: a feed's from the
        numpy copy it came with (and the check joins `self.caps`, which a
        captured step repeats before every replay), a CPU tensor as it is.
        Lengths made on the device inside the step are not read: that
        would wait for the device, which a capture refuses."""
        name, host = self.fed_lengths.get(id(lengths), (None, None))
        if name is not None:
            self.caps.add((name, cap, what, op_type))
        if host is None and lengths.device.type == "cpu":
            host = lengths.numpy()
        if host is not None:
            check_cap(host, cap, what, op_type)


def env_get(env, name):
    if name in env:
        return env[name]
    raise KeyError(
        f"Variable {name!r} not materialized (missing feed or init?)")


def run_ops(ops, env, ctx, fetch_names=(), state_names=()):
    """Run `ops` in order on `env`. Before an op that writes a name of
    `state_names` (the persistables the step writes), every one of
    `fetch_names` already computed that shares that name's memory becomes
    a copy (copy_aliased_fetches)."""
    state = set(state_names)
    watch = [n for n in fetch_names if n not in state]
    ctx.env = env
    for op in ops:
        if watch:
            written = [n for n in op.output_arg_names() if n in state]
            if written:
                copy_aliased_fetches(env, watch, written)
        _run_one_op(op, env, ctx)
    return env


def _run_one_op(op, env, ctx):
    op_def = registry.lookup(op.type)
    ctx.current_op = op
    # an op with lazy inputs (conditional_block, its grad, while_grad)
    # takes None for a name not yet made: a state var first written
    # inside its sub-block
    get = env.get if op_def.lazy_inputs else (lambda n: env_get(env, n))
    ins = {slot: [None if n == "" else get(n) for n in names]
           for slot, names in op.inputs.items()}
    try:
        if ctx.profile:
            with profiler.record_event(f"op::{op.type}"):
                outs = registry.run_kernel(op_def, ctx, ins, op.attrs) or {}
        else:
            outs = registry.run_kernel(op_def, ctx, ins, op.attrs) or {}
    except Exception as e:
        raise type(e)(f"while running op {op.type!r} ({op!r}): {e}") from e
    finally:
        ctx.current_op = None
    if ctx.check_nan_inf or ctx.debug_nans:
        named = []
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for i, n in enumerate(names):
                if n and i < len(vals) and vals[i] is not None:
                    named.append((n, vals[i]))
        if ctx.debug_nans:
            trap_non_finite(op.type, named)
        if ctx.check_nan_inf:
            check_values_finite(named, context=f" after op {op.type!r}")
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for i, name in enumerate(names):
            if name and i < len(vals) and vals[i] is not None:
                env[name] = vals[i]


def _persistables(program):
    return {n for b in program.blocks for n, v in b.vars.items()
            if v.persistable}


def written_persistables(program):
    """Persistable vars some op of the program writes, sorted."""
    written = {n for b in program.blocks for op in b.ops
               for n in op.output_arg_names()}
    return sorted(written & _persistables(program))


def collect_state_names(program, scope):
    """Persistable vars the block reads or writes and that exist in scope,
    and the persistable vars it writes."""
    touched = set()
    for b in program.blocks:
        for op in b.ops:
            touched.update(op.input_arg_names())
            touched.update(op.output_arg_names())
    state_in = sorted(n for n in _persistables(program) & touched
                      if scope.has_var(n))
    return state_in, written_persistables(program)


def _block_read_names(op):
    """All var names read anywhere inside an op's sub-blocks (control flow)."""
    names = set()
    for v in op.attrs.values():
        if hasattr(v, "ops"):  # a Block attr
            for sub in v.ops:
                names.update(sub.input_arg_names())
                names.update(_block_read_names(sub))
    return names


def dead_code_eliminate(ops, needed_names):
    """Drop ops whose outputs feed neither fetches nor persistable state,
    so a clone(for_test=True) program runs with only its data inputs fed
    (the reference relies on Program.prune, framework.py:1112)."""
    needed = set(needed_names)
    live = []
    for op in reversed(ops):
        outs = set(op.output_arg_names())
        # control-flow ops (any Block attr) write into env by kernel side
        # effect with empty declared outputs — always keep them
        has_sub_block = any(hasattr(v, "ops") for v in op.attrs.values())
        keep = (bool(outs & needed) or has_sub_block
                or op.type in ("print", "assert_op") or op.type in HOST_OPS)
        if keep:
            live.append(op)
            needed |= set(op.input_arg_names())
            needed |= _block_read_names(op)
    live.reverse()
    return live


def capture_blocker(ops):
    """The first op of `ops` that keeps their step out of a CUDA graph (a
    host op, sub-blocks included), or None: the static rule, decided
    before any capture."""
    for op in ops:
        if op.type in HOST_OPS or op.type in HOST_SYNC_OPS:
            return op
        for v in op.attrs.values():
            if hasattr(v, "ops"):  # a Block attr
                sub = capture_blocker(v.ops)
                if sub is not None:
                    return sub
    return None


def build_step_fn(program, fetch_names, state_out_names, place, dp=None):
    """The pure step of a program's global block (counterpart of
    paddle_tpu/core/executor_core.py::build_step_fn):

        step(mut_state, const_state, feeds, rng, scope=None, eager=True)
            -> (fetches, new_mut)

    mut_state holds the persistables the block writes, const_state those it
    only reads; new_mut maps each of `state_out_names` the step holds to its
    new value; its random ops draw from `rng`, a RandomStream. It runs the
    dead-code-eliminated op list (`step.ops`) through the interpreter; a
    fetch computed before an op writes a persistable whose memory it
    shares is copied first (run_ops). A feed may be a SeqTensor; the cap
    checks its ops make join `step.caps` (OpContext.check_cap).
    `step.blocker` is the op that keeps it out of a CUDA graph, or None
    (`capture_blocker`). `dp` is the data-parallel group its ops run
    over (OpContext.dp); `scope` is the Scope an interpreted step reads
    (OpContext.scope); `eager` is False while a CUDA graph captures it
    (OpContext.eager)."""
    ops = dead_code_eliminate(program.global_block().ops,
                              list(fetch_names) + list(state_out_names))

    def step(mut_state, const_state, feeds, rng, scope=None, eager=True):
        env = {}
        env.update(const_state)
        env.update(mut_state)
        env.update(feeds)
        ctx = OpContext(place, rng, caps=step.caps, dp=dp, scope=scope,
                        eager=eager, feed=feeds,
                        fed_lengths={
                            id(v.lengths): (n, v.host_lengths)
                            for n, v in feeds.items()
                            if isinstance(v, registry.SeqTensor)})
        with torch.no_grad():
            run_ops(ops, env, ctx, fetch_names, state_out_names)
        fetches = [env_get(env, n) for n in fetch_names]
        new_mut = {n: env[n] for n in state_out_names if n in env}
        return fetches, new_mut

    step.ops = ops
    step.blocker = capture_blocker(ops)
    step.caps = set()  # the cap checks its runs made (OpContext.check_cap)
    return step


def copy_aliased_fetches(env, fetch_names, written):
    """Before an op writes the persistables `written`: every fetch of
    `fetch_names` already computed whose memory is one of theirs (a view of
    a parameter, say) becomes a copy, so it keeps the value it was computed
    with, as in the JAX package. The write may be in place (the fused adam
    update) or the captured step's write-back into the scope's tensors at
    the end of the step; either would change the fetch."""
    held = {_storage(registry.seq_data(env[n])) for n in written
            if n in env and _is_tensor(env[n])}
    for n in fetch_names:
        v = env.get(n)
        if isinstance(registry.seq_data(v), torch.Tensor) \
                and _storage(registry.seq_data(v)) in held:
            env[n] = clone_value(v)


def _storage(t):
    return t.untyped_storage().data_ptr()


def _is_tensor(v):
    """A tensor or SeqTensor (not a host object such as a reader)."""
    return isinstance(registry.seq_data(v), torch.Tensor)


def clone_value(v):
    """A copy of a tensor, or of a SeqTensor's data (its lengths are never
    written in place)."""
    if isinstance(v, registry.SeqTensor):
        return registry.SeqTensor(v.data.clone(), v.lengths, v.host_lengths)
    return v.clone()


def unshared(fetches, state):
    """`fetches` with a clone in place of each tensor that shares memory
    with a tensor of `state`. An update in place (the fused adam update)
    writes those tensors again at the next step, so a fetch of one, or of
    a view of one taken after its update, would change under the caller
    (a view taken before it is copied earlier: copy_aliased_fetches)."""
    held = {_storage(registry.seq_data(t)) for t in state if _is_tensor(t)}
    return [clone_value(f)
            if isinstance(registry.seq_data(f), torch.Tensor)
            and _storage(registry.seq_data(f)) in held else f
            for f in fetches]


def _buffer_like(v):
    if isinstance(v, registry.SeqTensor):
        return registry.SeqTensor(_buffer_like(v.data),
                                  _buffer_like(v.lengths))
    return torch.empty(v.shape, dtype=v.dtype, device=v.device)


def _fill(name, buf, v):
    """Copy feed `v` into its static buffer `buf`, both tensors or both
    SeqTensors (data and lengths) of the buffer's shapes and dtypes."""
    if isinstance(buf, registry.SeqTensor):
        if not isinstance(v, registry.SeqTensor):
            raise ValueError(f"feed {name!r} is dense; the captured step "
                             f"takes a ragged (SeqTensor) value")
        _fill(name, buf.data, v.data)
        _fill(name + ".lengths", buf.lengths, v.lengths)
        return
    if isinstance(v, registry.SeqTensor) or v.shape != buf.shape \
            or v.dtype != buf.dtype:
        got = (f"ragged {tuple(v.data.shape)}"
               if isinstance(v, registry.SeqTensor)
               else f"{v.dtype}{tuple(v.shape)}")
        raise ValueError(
            f"feed {name!r} is {got}; the captured step takes "
            f"{buf.dtype}{tuple(buf.shape)}")
    buf.copy_(v)


class CapturedStep:
    """One call of a step, captured as a CUDA graph over static buffers
    (`compile_step_fn` builds it).

    The graph reads the scope's own persistable tensors at their addresses
    and one feed buffer per feed, of fixed shape. At its end every written
    persistable that an op did not already update in place (as the fused
    adam update does) is copied in place (`copy_`) back into its scope
    tensor, so
    the addresses the graph reads stay valid and the scope always holds the
    current state, as the JAX package's donated buffers do. The step's
    RandomStream generator is registered with the graph: the capture
    consumes none of its numbers, and every replay draws the next ones, as
    an interpreter step would. `run(feeds)`
    copies a step's feeds into the buffers, replays the graph on the
    current stream and returns the graph's own fetch tensors, which the
    next replay overwrites.

    A step of a ParallelExecutor holds collectives: the eager step before
    the capture has created the NCCL communicator, and the capture records
    each collective's launch on NCCL's stream, joined to the capture stream
    by events, as one more node of the graph.

    A capture runs no Python at replay: each kernel wrapper's launch count
    (cuda_build.launch_counts) moves during the capture although nothing
    launches, so the capture's moves are undone and added again at every
    replay."""

    def __init__(self, step, scope, state_in, written, feeds, rng, stream):
        self.state = {n: scope.find_var(n) for n in state_in}
        self.mut = {n: self.state[n] for n in written if n in self.state}
        const = {n: t for n, t in self.state.items() if n not in self.mut}
        self.feeds = {n: _buffer_like(t) for n, t in feeds.items()}
        self.caps = step.caps
        self._load(feeds)
        static = {_storage(t) for t in self.state.values()}
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(rng.generator)
        before = cuda_build.launch_counts()
        # thread_local: a capture fails on an unsafe call made by this
        # thread only. Under the default "global" mode, the event queries
        # of NCCL's watchdog thread invalidate a capture that holds a
        # collective (a ParallelExecutor step)
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            fetches, new_mut = step(self.mut, const, self.feeds, rng,
                                    eager=False)
            news = {}
            for n, dst in self.mut.items():
                new = new_mut.get(n, dst)
                if new is dst:
                    continue
                if new.dtype != dst.dtype or new.shape != dst.shape:
                    raise TypeError(
                        f"persistable {n!r} would change from "
                        f"{dst.dtype}{tuple(dst.shape)} to "
                        f"{new.dtype}{tuple(new.shape)} in the scope")
                # a new value that is (a view of) another static input is
                # copied out first: the in-place copies would overwrite it
                news[n] = new.clone() if _storage(new) in static else new
            for n, new in news.items():
                self.mut[n].copy_(new)
        self.fetches = fetches
        after = cuda_build.launch_counts()
        cuda_build.set_launch_counts(before)
        self.recorded = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}

    def _load(self, feeds):
        check_caps(self.caps, feeds)
        for n, buf in self.feeds.items():
            _fill(n, buf, feeds[n])

    def sync_scope(self, scope):
        """Bring a tensor of `scope` (the capture's) that was replaced since
        the capture (by load_numpy_state, an interpreter run, a user) into
        the tensor the graph reads, and put that tensor back in the
        scope."""
        for n, t in self.state.items():
            cur = scope.find_var(n)
            if cur is not t:
                if cur.shape != t.shape or cur.dtype != t.dtype:
                    raise ValueError(
                        f"scope var {n!r} is now {cur.dtype}"
                        f"{tuple(cur.shape)}; the captured step holds "
                        f"{t.dtype}{tuple(t.shape)}")
                t.copy_(cur)
                scope.set_var(n, t)

    def run(self, feeds):
        self._load(feeds)
        self.graph.replay()
        counts = cuda_build.launch_counts()
        cuda_build.set_launch_counts(
            {k: counts[k] + n for k, n in self.recorded.items()})
        return self.fetches


def compile_step_fn(step, scope, state_in, written, feeds, rng, stream):
    """Capture one call of `step` as a CUDA graph (counterpart of
    paddle_tpu/core/executor_core.py::compile_step_fn): a `CapturedStep`
    over the scope's persistables `state_in`, of which `written` are
    written back in place, and static buffers shaped like `feeds`, drawing
    from the RandomStream `rng`. The
    capture runs on `stream`, where the caller has already run one step
    eagerly (cuDNN plans, cuBLAS workspaces and autograd's device threads
    exist only after a first run). A capture records and runs nothing; one
    that fails raises."""
    return CapturedStep(step, scope, state_in, written, feeds, rng, stream)


def build_multi_step_fn(run_step, iters):
    """`iters` steps over a device-resident [iters, ...] feed stack
    (counterpart of paddle_tpu/core/executor_core.py::build_multi_step_fn,
    a lax.scan there):

        multi(stacked_feeds) -> [fetch stacked [iters, ...], ...]

    `run_step(feeds)` runs one step on step k's slice of the stack and
    returns its fetch tensors; each is copied into a preallocated
    [iters, ...] output before the next step. On the card a step is one
    graph replay, and nothing here waits for the device."""

    def multi(stacked_feeds):
        outs = None
        for k in range(iters):
            fetches = run_step({n: step_slice(t, k)
                                for n, t in stacked_feeds.items()})
            if outs is None:
                outs = [_stack_buffer(f, iters) for f in fetches]
            for o, f in zip(outs, fetches):
                _put(step_slice(o, k), f)
        return outs

    return multi


def step_slice(v, k):
    """Step k of a [K, ...] stack: a tensor's row, or a SeqTensor's data,
    lengths and host lengths rows."""
    if isinstance(v, registry.SeqTensor):
        host = None if v.host_lengths is None else v.host_lengths[k]
        return registry.SeqTensor(v.data[k], v.lengths[k], host)
    return v[k]


def _stack_buffer(v, iters):
    if isinstance(v, registry.SeqTensor):
        return registry.SeqTensor(_stack_buffer(v.data, iters),
                                  _stack_buffer(v.lengths, iters))
    return torch.empty((iters,) + tuple(v.shape), dtype=v.dtype,
                       device=v.device)


def _put(dst, v):
    if isinstance(dst, registry.SeqTensor):
        dst.data.copy_(v.data)
        dst.lengths.copy_(v.lengths)
    else:
        dst.copy_(v)
