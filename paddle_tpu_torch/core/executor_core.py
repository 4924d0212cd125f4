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
The FLAGS_fuse_optimizer_ops concat path has no counterpart yet.
"""

import torch

from .. import cuda_build
from . import registry
from .places import device_for

# Op types whose kernels run on the host, which a graph cannot hold (the
# JAX package's `no_trace` ops, paddle_tpu/executor.py:121-127). Empty so
# far: the port has no host kernel yet; one that is ported is named here.
# Random ops are not among them: they draw from a RandomStream, whose
# generator the captured graph advances at every replay.
HOST_OPS = frozenset()


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
    generator of their own, and holds them as a constant of the step."""

    def __init__(self, device, seed):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._fixed = {}

    def fixed(self, key, seed, draw):
        """A copy of draw(generator seeded by `seed`), drawn at the first
        call with this `key` and `seed` and held. The first call of a
        program's step is never a capture (the executor runs one step
        eagerly before it), so the draw itself stays out of the graph."""
        key = (int(seed),) + tuple(key)
        t = self._fixed.get(key)
        if t is None:
            gen = torch.Generator(device=self.device).manual_seed(key[0])
            t = self._fixed[key] = draw(gen)
        return t.clone()


class OpContext:
    """Per-step context passed to kernels: the device every allocation
    lands on, the random stream the step draws from, and the test-mode
    flag."""

    def __init__(self, place, rng=None, is_test=False):
        self.place = place
        self.device = device_for(place)
        self.rng = rng if rng is not None else RandomStream(self.device, 0)
        self.is_test = is_test
        self.current_op = None  # the op being run (derived grad kernels)


def env_get(env, name):
    if name in env:
        return env[name]
    raise KeyError(
        f"Variable {name!r} not materialized (missing feed or init?)")


def run_ops(ops, env, ctx):
    for op in ops:
        _run_one_op(op, env, ctx)
    return env


def _run_one_op(op, env, ctx):
    op_def = registry.lookup(op.type)
    ctx.current_op = op
    ins = {slot: [None if n == "" else env_get(env, n) for n in names]
           for slot, names in op.inputs.items()}
    try:
        outs = registry.run_kernel(op_def, ctx, ins, op.attrs) or {}
    except Exception as e:
        raise type(e)(f"while running op {op.type!r} ({op!r}): {e}") from e
    finally:
        ctx.current_op = None
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
                or op.type in ("print", "assert_op"))
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
        if op.type in HOST_OPS:
            return op
        for v in op.attrs.values():
            if hasattr(v, "ops"):  # a Block attr
                sub = capture_blocker(v.ops)
                if sub is not None:
                    return sub
    return None


def build_step_fn(program, fetch_names, state_out_names, place):
    """The pure step of a program's global block (counterpart of
    paddle_tpu/core/executor_core.py::build_step_fn):

        step(mut_state, const_state, feeds, rng) -> (fetches, new_mut)

    mut_state holds the persistables the block writes, const_state those it
    only reads; new_mut maps each of `state_out_names` the step holds to its
    new value; its random ops draw from `rng`, a RandomStream. It runs the
    dead-code-eliminated op list (`step.ops`) through the interpreter and
    allocates fresh outputs: no input is written.
    `step.blocker` is the op that keeps it out of a CUDA graph, or None
    (`capture_blocker`)."""
    ops = dead_code_eliminate(program.global_block().ops,
                              list(fetch_names) + list(state_out_names))

    def step(mut_state, const_state, feeds, rng):
        env = {}
        env.update(const_state)
        env.update(mut_state)
        env.update(feeds)
        ctx = OpContext(place, rng)
        with torch.no_grad():
            run_ops(ops, env, ctx)
        fetches = [env_get(env, n) for n in fetch_names]
        new_mut = {n: env[n] for n in state_out_names if n in env}
        return fetches, new_mut

    step.ops = ops
    step.blocker = capture_blocker(ops)
    return step


def _storage(t):
    return t.untyped_storage().data_ptr()


class CapturedStep:
    """One call of a step, captured as a CUDA graph over static buffers
    (`compile_step_fn` builds it).

    The graph reads the scope's own persistable tensors at their addresses
    and one feed buffer per feed, of fixed shape. At its end every written
    persistable is copied in place (`copy_`) back into its scope tensor, so
    the addresses the graph reads stay valid and the scope always holds the
    current state, as the JAX package's donated buffers do. The step's
    RandomStream generator is registered with the graph: the capture
    consumes none of its numbers, and every replay draws the next ones, as
    an interpreter step would. `run(feeds)`
    copies a step's feeds into the buffers, replays the graph on the
    current stream and returns the graph's own fetch tensors, which the
    next replay overwrites.

    A capture runs no Python at replay: each kernel wrapper's launch count
    (cuda_build.launch_counts) moves during the capture although nothing
    launches, so the capture's moves are undone and added again at every
    replay."""

    def __init__(self, step, scope, state_in, written, feeds, rng, stream):
        self.state = {n: scope.find_var(n) for n in state_in}
        self.mut = {n: self.state[n] for n in written if n in self.state}
        const = {n: t for n, t in self.state.items() if n not in self.mut}
        self.feeds = {n: torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for n, t in feeds.items()}
        self._load(feeds)
        static = {_storage(t) for t in self.state.values()}
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(rng.generator)
        before = cuda_build.launch_counts()
        with torch.cuda.graph(self.graph, stream=stream):
            fetches, new_mut = step(self.mut, const, self.feeds, rng)
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
        for n, buf in self.feeds.items():
            t = feeds[n]
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise ValueError(
                    f"feed {n!r} is {t.dtype}{tuple(t.shape)}; the captured "
                    f"step takes {buf.dtype}{tuple(buf.shape)}")
            buf.copy_(t)

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
            fetches = run_step({n: t[k] for n, t in stacked_feeds.items()})
            if outs is None:
                outs = [torch.empty((iters,) + tuple(f.shape), dtype=f.dtype,
                                    device=f.device) for f in fetches]
            for o, f in zip(outs, fetches):
                o[k].copy_(f)
        return outs

    return multi
