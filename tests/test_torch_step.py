"""The whole-block step (paddle_tpu_torch/core/executor_core.py): the pure
step function, the multi-step wrapper, the capture rule, and on a CUDA card
the captured step against the interpreter.

On the CPU the executor runs `build_step_fn`'s step, so it must equal the
plain op-by-op interpreter (`run_ops` over the dead-code-eliminated op
list, the executor's loop before the step function existed) bitwise, and
`iters=K` must equal K single steps bitwise. The static rule sends only a
step with a host op to the interpreter: ResNet, its startup program and a
step that draws random numbers go to the graph. The executor's graph path
itself (warm-up, capture, replays, write-back,
launch counts) also runs on the CPU, with a stand-in for the CUDA graph
that records the aten calls of the capture and replays them into the same
tensors: it must equal the interpreter bitwise.

Tests marked `cuda` need a card and skip elsewhere: graph vs interpreter
bitwise over 3 steps and over an iters=4 call (cuDNN in deterministic mode
on both sides, so that run-to-run nondeterminism of its algorithms cannot
hide or fake a difference), a capture that synchronises with the host
raises (no interpreter retry), and the momentum kernel's launch count grows
by buckets x steps over replays.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import fused_ops

import test_torch_train as train

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    fk.reset_launch_counts()
    yield
    tamp.disable()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs capture only there")
    return torch.device("cuda", 0)


@pytest.fixture
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


def _init_state(model):
    """The port's own startup state of `model`, as numpy arrays."""
    main, startup, _, _ = train._build(tfluid, tresnet, model)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    return convert.numpy_state(scope, main)


def _interpret(model, init, batches, place):
    """STEPS steps of `model` by the plain op-by-op loop: run_ops over the
    live ops with the scope's state, written persistables set back."""
    main, _, loss, _ = train._build(tfluid, tresnet, model)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    device = tcore.device_for(place)
    ops = tcore.dead_code_eliminate(
        main.global_block().ops,
        [loss.name] + tcore.written_persistables(main))
    rng = tcore.RandomStream(device, main.random_seed)
    losses = []
    for b in batches:
        state_in, written = tcore.collect_state_names(main, scope)
        env = {n: scope.find_var(n) for n in state_in}
        env.update({n: torch.from_numpy(v).to(device) for n, v in b.items()})
        ctx = tcore.OpContext(place, rng)
        with torch.no_grad():
            tcore.run_ops(ops, env, ctx)
        for n in written:
            scope.set_var(n, env[n])
        losses.append(env[loss.name].cpu().numpy())
    return np.stack(losses).reshape(-1), convert.numpy_state(scope, main)


def _executor_run(model, init, batches, place, iters=False):
    main, _, loss, _ = train._build(tfluid, tresnet, model)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    exe = tfluid.Executor(place)
    with tfluid.scope_guard(scope):
        if iters:
            stacked = {n: np.stack([b[n] for b in batches])
                       for n in batches[0]}
            (losses,) = exe.run(main, feed=stacked, fetch_list=[loss],
                                iters=len(batches))
        else:
            losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                      for b in batches]
    return (np.stack(losses).reshape(-1), convert.numpy_state(scope, main),
            exe.step_mode(main))


def _assert_same(got, want):
    (gl, gs), (wl, ws) = got, want
    np.testing.assert_array_equal(gl, wl)
    assert set(gs) == set(ws)
    for n in ws:
        np.testing.assert_array_equal(gs[n], ws[n], err_msg=n)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["mlp_adam", "bottleneck_nhwc"])
def test_step_fn_equals_the_op_by_op_interpreter(model, amp):
    init = _init_state(model)
    batches = train._batches(train._build(tfluid, tresnet, model)[3])
    place = tfluid.CPUPlace()
    with tamp.auto_cast(enabled=amp):
        want = _interpret(model, init, batches, place)
        *got, mode = _executor_run(model, init, batches, place)
        *got_k, mode_k = _executor_run(model, init, batches, place,
                                       iters=True)
    assert mode == mode_k == "interpreter"
    _assert_same(got, want)
    _assert_same(got_k, want)


def test_build_step_fn_is_pure_and_multi_step_stacks():
    """step() writes none of its inputs and returns the new state;
    build_multi_step_fn stacks K steps' fetches [K, ...]."""
    model = "mlp_adam"
    init = _init_state(model)
    main, _, loss, _ = train._build(tfluid, tresnet, model)
    written = tcore.written_persistables(main)
    step = tcore.build_step_fn(main, [loss.name], written, tfluid.CPUPlace())
    assert step.blocker is None
    state = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    mut = {n: t for n, t in state.items() if n in written}
    const = {n: t for n, t in state.items() if n not in written}
    before = {n: t.clone() for n, t in state.items()}
    b = train._batches([784])[0]
    feeds = {n: torch.from_numpy(v) for n, v in b.items()}
    rng = tcore.RandomStream("cpu", 0)
    fetches, new_mut = step(mut, const, feeds, rng)
    for n, t in state.items():
        assert torch.equal(t, before[n]), n
    assert set(new_mut) == set(mut)
    assert not any(torch.equal(new_mut[n], mut[n]) for n in mut
                   if n.startswith("fc_0.w"))

    calls = []

    def run_step(f):
        calls.append(f)
        return [f["img"].sum().reshape(1), f["label"][:2]]

    stacked = {n: torch.from_numpy(np.stack([b[n]] * 3)) for n in b}
    outs = tcore.build_multi_step_fn(run_step, 3)(stacked)
    assert len(calls) == 3
    assert [tuple(o.shape) for o in outs] == [(3, 1), (3, 2, 1)]
    assert outs[1].dtype == torch.int64


def _random_step_program(op):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        if op == "dropout":
            y = tfluid.layers.dropout(x, dropout_prob=0.5)
        else:
            noise = tfluid.layers.uniform_random([4, 8])
            y = tfluid.layers.elementwise_add(x, noise)
        loss = tfluid.layers.mean(y)
    return main, startup, loss


@pytest.mark.parametrize("op", ["uniform_random", "dropout"])
def test_a_step_that_draws_random_numbers_is_interpreter_only(op):
    """Interpreter-only on the CPU alone: a random op no longer keeps its
    step out of a CUDA graph (it draws from the program's RandomStream,
    whose generator the graph advances at every replay), so the step has
    no blocker and only the place decides."""
    main, startup, loss = _random_step_program(op)
    step = tcore.build_step_fn(main, [loss.name], [], tfluid.CPUPlace())
    assert step.blocker is None
    assert op in {o.type for o in step.ops}
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed={"x": np.ones((4, 8), np.float32)},
                fetch_list=[loss])
    assert exe.step_mode(main) == "interpreter"


def test_resnet_is_capturable_and_its_startup_is_not():
    """ResNet's step is capturable, fused or not; its startup program,
    whose initializers draw random numbers, is capturable too now that
    random ops draw from a stream the graph advances (the name is the
    rule's before that): run twice on a card, its second run is a
    capture."""
    main, startup, loss, _ = train._build(tfluid, tresnet, "resnet_cifar10_8")
    for fuse in (False, True):
        with tflags.flag_guard(fuse=fuse):
            prog = main
            if fuse:
                from paddle_tpu_torch import fusion
                prog, _ = fusion.apply(main, feed_names=["img", "label"],
                                       fetch_names=[loss.name])
            step = tcore.build_step_fn(prog, [loss.name],
                                       tcore.written_persistables(prog),
                                       tfluid.CPUPlace())
            assert step.blocker is None
    init = tcore.build_step_fn(startup, [], tcore.written_persistables(
        startup), tfluid.CPUPlace())
    assert init.blocker is None
    assert {"uniform_random", "gaussian_random"} & {o.type for o in init.ops}


def test_capture_blocker_looks_into_sub_blocks(monkeypatch):
    """A host op inside a sub-block keeps the step out of the graph (a
    stand-in host op); a random op there does not. The sub-block's owner
    is a conditional_block, which a graph holds (a `while` is a host-sync
    op itself)."""
    monkeypatch.setattr(tcore, "HOST_OPS", frozenset({"host_probe"}))

    class Block:
        def __init__(self, ops):
            self.ops = ops

    class Op:
        def __init__(self, type, attrs=None):
            self.type, self.attrs = type, attrs or {}

    inner = Op("host_probe")
    ops = [Op("mul"), Op("conditional_block",
                         {"sub_block": Block([Op("relu"), inner])})]
    assert tcore.capture_blocker(ops) is inner
    assert tcore.capture_blocker(ops[:1]) is None
    random = [Op("conditional_block",
                 {"sub_block": Block([Op("gaussian_random")])})]
    assert tcore.capture_blocker(random) is None
    loop = Op("while", {"sub_block": Block([Op("relu")])})
    assert tcore.capture_blocker([loop]) is loop


def test_the_cpu_runs_the_interpreter_and_says_so():
    model = "mlp_adam"
    main, startup, loss, shape = train._build(tfluid, tresnet, model)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        assert exe.step_mode(startup) == "interpreter"
        exe.run(main, feed=train._batches(shape)[0], fetch_list=[loss])
    assert exe.step_mode(main) == "interpreter"
    with pytest.raises(KeyError):
        exe.step_mode(tfluid.Program())


def test_prepare_key_holds_feed_shapes_and_dtypes():
    """A captured step has static buffers, so a new feed shape or dtype
    must prepare (and on the card capture) a new entry."""
    model = "mlp_adam"
    main, startup, loss, shape = train._build(tfluid, tresnet, model)
    exe = tfluid.Executor(tfluid.CPUPlace())
    b = train._batches(shape)[0]
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=b, fetch_list=[loss])
        exe.run(main, feed=b, fetch_list=[loss])
        exe.run(main, feed={n: v[:2] for n, v in b.items()},
                fetch_list=[loss])
    assert len([k for k in exe._prepared if k[0] == id(main)]) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["bottleneck_nhwc", "resnet_cifar10_8"])
def test_graph_equals_interpreter_on_the_card(cuda_device, deterministic_cudnn,
                                              model, amp):
    """3 single steps and one iters=3 call through the captured step equal
    3 interpreter steps bitwise: losses and every persistable."""
    init = _init_state(model)
    batches = train._batches(train._build(tfluid, tresnet, model)[3])
    place = tfluid.CUDAPlace(0)
    with tamp.auto_cast(enabled=amp), tflags.flag_guard(fuse=True):
        with tflags.flag_guard(cuda_graph=False):
            *want, mode_i = _executor_run(model, init, batches, place)
        *got, mode = _executor_run(model, init, batches, place)
        *got_k, mode_k = _executor_run(model, init, batches, place,
                                       iters=True)
    assert (mode_i, mode, mode_k) == ("interpreter", "graph", "graph")
    _assert_same(got, want)
    _assert_same(got_k, want)
    for n, v in got[1].items():
        assert v.dtype != np.dtype("bfloat16") and v.dtype.kind != "V", n


@pytest.mark.cuda
def test_iters_four_makes_four_updates_on_the_card(cuda_device,
                                                   deterministic_cudnn):
    """The first call warms up eagerly, captures (which runs nothing) and
    replays: iters=4 is still 4 updates, equal to 4 interpreter steps."""
    model = "bottleneck_nhwc"
    init = _init_state(model)
    shape = train._build(tfluid, tresnet, model)[3]
    rs = np.random.RandomState(9)
    batches = [{"img": rs.rand(4, *shape).astype(np.float32),
                "label": rs.randint(0, 10, (4, 1)).astype(np.int64)}
               for _ in range(4)]
    place = tfluid.CUDAPlace(0)
    with tflags.flag_guard(fuse=True):
        with tflags.flag_guard(cuda_graph=False):
            want = _executor_run(model, init, batches, place)[:2]
        got = _executor_run(model, init, batches, place, iters=True)[:2]
    _assert_same(got, want)


@pytest.mark.cuda
def test_momentum_launches_grow_by_buckets_times_steps(cuda_device):
    model = "resnet_cifar10_8"
    init = _init_state(model)
    main, _, loss, shape = train._build(tfluid, tresnet, model)
    b = train._batches(shape)[0]
    scope = tfluid.Scope()
    place = tfluid.CUDAPlace(0)
    convert.load_numpy_state(scope, main, init, place)
    exe = tfluid.Executor(place)
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        stacked = {n: np.stack([v] * 5) for n, v in b.items()}
        exe.run(main, feed=stacked, fetch_list=[loss], iters=5)
        torch.cuda.synchronize()
        plan = next(p for _, p, _ in exe._prepared.values() if p is not None)
        buckets = len([x for x in plan.buckets if x["opt"] == "momentum"])
        assert exe.step_mode(main) == "graph"
        assert fk.momentum_bucket.launches == buckets * 5
        fk.reset_launch_counts()
        exe.run(main, feed=stacked, fetch_list=[loss], iters=5)
        exe.run(main, feed=b, fetch_list=[loss])
        torch.cuda.synchronize()
    assert fk.momentum_bucket.launches == buckets * 6


@treg.register_op("host_sync_probe", override=True)
def _host_sync_probe(ctx, ins, attrs):
    """A kernel that reads a value back to the host, as no kernel on a
    captured path may."""
    x = ins["X"][0]
    return {"Out": [x * float(x.sum().item() > 0)]}


@pytest.mark.cuda
def test_a_capture_that_synchronises_raises(cuda_device):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        y = main.global_block().create_var(name="probe_out",
                                           dtype="float32", shape=[-1, 8])
        main.global_block().append_op(type="host_sync_probe",
                                      inputs={"X": [x]},
                                      outputs={"Out": [y]})
        loss = tfluid.layers.mean(y)
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    feed = {"x": np.ones((4, 8), np.float32)}
    with tfluid.scope_guard(tfluid.Scope()):
        (first,) = exe.run(main, feed=feed, fetch_list=[loss])  # eager
        assert first.reshape(-1)[0] == 1.0
        with pytest.raises(RuntimeError):
            exe.run(main, feed=feed, fetch_list=[loss])  # the capture
    assert exe.step_mode(main) == "graph"


# ---------------------------------------------------------------------------
# the graph path's bookkeeping on the CPU, with a recording stand-in
# ---------------------------------------------------------------------------
class _Recorder(TorchDispatchMode):
    """Records every aten call made under it, with its tensors."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.calls.append((func, args, kwargs, out))
        return out


class _RecordedGraph:
    """A stand-in for torch.cuda.CUDAGraph on the CPU: replay() runs the
    recorded aten calls again on the same tensors and writes each result
    into the tensor the capture produced, which is what a graph's fixed
    addresses amount to."""

    calls = ()

    def register_generator_state(self, generator):
        self.generator = generator

    @torch.no_grad()
    def replay(self):
        for func, args, kwargs, out in self.calls:
            new = func(*args, **kwargs)
            for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                if isinstance(o, torch.Tensor) and o is not n:
                    o.copy_(n)


@pytest.fixture
def recorded_graphs(monkeypatch):
    """Executors on the CPU take the graph path, captured by _Recorder. A
    capture runs nothing on the card, so the state it wrote while being
    recorded is put back, and so is its random stream's generator (a CUDA
    capture consumes none of its numbers; each replay of the recorded
    calls draws the next ones from it); the plain momentum twin counts
    launches as the kernel's wrapper does."""

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global"):
        # thread_local, so that NCCL's watchdog thread cannot invalidate a
        # capture that holds a collective (executor_core.CapturedStep)
        assert capture_error_mode == "thread_local"
        rec = _Recorder()
        with rec:
            yield
        g.calls = rec.calls

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordedGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(
        tfluid.Executor, "_mode_of",
        lambda self, step: "graph" if step.blocker is None
        and tflags.get("cuda_graph") and not tflags.get("debug_nans")
        else "interpreter")
    init = tcore.CapturedStep.__init__

    def capture(self, step, scope, state_in, written, feeds, rng, stream):
        before = {n: scope.find_var(n).clone() for n in state_in}
        drawn = rng.generator.get_state()
        init(self, step, scope, state_in, written, feeds, rng, stream)
        for n, t in before.items():
            self.state[n].copy_(t)
        rng.generator.set_state(drawn)
        assert self.graph.generator is rng.generator

    monkeypatch.setattr(tcore.CapturedStep, "__init__", capture)
    plain = fk.momentum_bucket_plain

    def counted(p, g, v, lr, mu, nesterov):
        fk.momentum_bucket.launches += 1
        return plain(p, g, v, lr, mu, nesterov)

    monkeypatch.setattr(fused_ops.fk, "momentum_bucket_plain", counted)
    plain_ = fk.adam_bucket_plain_

    def counted_(*args):
        fk.adam_bucket.launches += 1
        return plain_(*args)

    monkeypatch.setattr(fused_ops.fk, "adam_bucket_plain_", counted_)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["bottleneck_nhwc", "resnet_cifar10_8",
                                   "mlp_adam"])
def test_recorded_graph_path_equals_the_interpreter(recorded_graphs, model,
                                                    amp):
    """The executor's graph path — eager first step, capture at the
    second, replays into static feed buffers, in-place write-back into the
    scope's tensors (the fused adam update writes them itself), replayed
    launch counts — gives the interpreter's losses and state bitwise, for
    single steps and for iters=3."""
    init = _init_state(model)
    batches = train._batches(train._build(tfluid, tresnet, model)[3])
    place = tfluid.CPUPlace()
    with tamp.auto_cast(enabled=amp), tflags.flag_guard(fuse=True):
        with tflags.flag_guard(cuda_graph=False):
            *want, mode_i = _executor_run(model, init, batches, place)
        for iters in (False, True):
            fk.reset_launch_counts()
            *got, mode = _executor_run(model, init, batches, place, iters)
            assert (mode_i, mode) == ("interpreter", "graph")
            kernel = (fk.adam_bucket if model == "mlp_adam"
                      else fk.momentum_bucket)
            assert kernel.launches == STEPS  # 1 bucket a step
            _assert_same(got, want)


def test_recorded_graph_reads_a_replaced_scope_var(recorded_graphs):
    """State loaded into the scope after the capture (new tensors) reaches
    the graph: the replays start from it, as the interpreter does."""
    model = "bottleneck_nhwc"
    init = _init_state(model)
    batches = train._batches(train._build(tfluid, tresnet, model)[3])
    main, _, loss, _ = train._build(tfluid, tresnet, model)
    place = tfluid.CPUPlace()
    runs = {}
    for graph in (False, True):
        scope = tfluid.Scope()
        convert.load_numpy_state(scope, main, init, place)
        exe = tfluid.Executor(place)
        with tfluid.scope_guard(scope), \
                tflags.flag_guard(fuse=True, cuda_graph=graph):
            losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                      for b in batches]
            convert.load_numpy_state(scope, main, init, place)
            losses += [exe.run(main, feed=b, fetch_list=[loss])[0]
                       for b in batches]
            assert exe.step_mode(main) == ("graph" if graph
                                           else "interpreter")
        runs[graph] = (np.stack(losses).reshape(-1),
                       convert.numpy_state(scope, main))
    _assert_same(runs[True], runs[False])
    np.testing.assert_array_equal(runs[True][0][:STEPS],
                                  runs[True][0][STEPS:])
