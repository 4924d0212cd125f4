"""The Executor's rest in the port against the JAX package: fetch_var,
run(async_fetch=True) and its FetchFutures (on Executor, on the recorded
stand-in of the captured graph, and on ParallelExecutor at W = 2 gloo
ranks), FLAGS_debug_nans (the two tests of tests/test_flags_debug.py, the
flag flipping between runs and the program going back to its captured
graph), the resilience hooks every run passes (chaos.on_run before
anything of the run is touched), and the top-level names the slice adds
(CUDAPinnedPlace, Tensor).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert, flags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.resilience import TransientError, chaos

import test_torch_parallel as tp
import torch_dp_worker as worker
from test_torch_step import recorded_graphs  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    flags.reset()
    chaos.uninstall()
    yield
    chaos.uninstall()
    flags.reset()
    jflags.reset()


def _mlp(package):
    main, startup = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(main, startup):
        x = package.layers.data(name="x", shape=[3], dtype="float32")
        h = package.layers.fc(input=x, size=4, act="relu")
        loss = package.layers.mean(h)
        package.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, h


def _feeds(n=3):
    rs = np.random.RandomState(4)
    return [{"x": rs.rand(5, 3).astype(np.float32)} for _ in range(n)]


# -- fetch_var ------------------------------------------------------------


def test_fetch_var_reads_the_scope_as_the_jax_package():
    jmain, jstartup, _, _ = _mlp(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    init = {n: np.asarray(jscope.find_var(n))
            for n, v in jmain.global_block().vars.items()
            if v.persistable and jscope.find_var(n) is not None}
    main, _, _, _ = _mlp(fluid)
    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, fluid.CPUPlace())
    for name in sorted(init):
        with jfluid.scope_guard(jscope):
            want = jfluid.fetch_var(name)
        with fluid.scope_guard(scope):
            got = fluid.fetch_var(name)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert isinstance(fluid.fetch_var(name, scope, return_numpy=False),
                          torch.Tensor)
    with pytest.raises(ValueError, match="not found"):
        fluid.fetch_var("nope", scope)


def test_fetch_var_gives_a_sequences_flat_data():
    from paddle_tpu_torch.core.registry import SeqTensor

    scope = fluid.Scope()
    data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    scope.var("seq")
    scope.set_var("seq", SeqTensor(data, torch.tensor([2, 4],
                                                      dtype=torch.int32)))
    np.testing.assert_array_equal(fluid.fetch_var("seq", scope),
                                  data.numpy())


# -- async_fetch ----------------------------------------------------------


def _runs(async_fetch, iters=None, graph=False):
    main, startup, loss, h = _mlp(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope), flags.flag_guard(cuda_graph=graph):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        feeds = _feeds()
        if iters:
            feeds = [{"x": np.stack([f["x"] for f in feeds])}]
        outs = [exe.run(main, feed=f, fetch_list=[loss, h], iters=iters,
                        async_fetch=async_fetch) for f in feeds]
        mode = exe.step_mode(main)
    return outs, mode


@pytest.mark.parametrize("iters", [None, 3], ids=["steps", "iters3"])
def test_async_fetch_futures_equal_synchronous_fetches(iters):
    want, _ = _runs(False, iters)
    got, _ = _runs(True, iters)
    for futs, outs in zip(got, want):
        assert all(isinstance(f, fluid.FetchFuture) for f in futs)
        for f, w in zip(futs, outs):
            assert f.done()
            assert isinstance(f.value, torch.Tensor)
            r = f.result()
            assert r is f.result()  # cached
            np.testing.assert_array_equal(r, w)


def test_async_fetch_on_the_captured_graph_keeps_each_steps_value(
        recorded_graphs):  # noqa: F811
    """On the graph path every replay rewrites the graph's own fetch
    tensors: futures read one run behind still hold their own step's
    values, equal to the interpreter's synchronous fetches."""
    want, mode = _runs(False, graph=False)
    assert mode == "interpreter"
    got, mode = _runs(True, graph=True)
    assert mode == "graph"
    for futs, outs in zip(got, want):
        for f, w in zip(futs, outs):
            np.testing.assert_array_equal(f.result(), w)


def test_async_fetch_a_sequence_gives_a_lod_tensor():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        w = fluid.layers.data(name="w", shape=[1], dtype="int64",
                              lod_level=1)
        e = fluid.layers.embedding(input=w, size=[10, 2])
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        feed = {"w": fluid.create_lod_tensor(
            np.arange(5).reshape(5, 1).astype(np.int64), [[2, 3]],
            fluid.CPUPlace())}
        want, = exe.run(main, feed=feed, fetch_list=[e])
        fut, = exe.run(main, feed=feed, fetch_list=[e], async_fetch=True)
    got = fut.result()
    assert got.lod() == want.lod()
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_async_fetch_on_parallel_executor_at_two_ranks(tmp_path):
    """ParallelExecutor at W = 2 gloo ranks: every step's fetches through
    FetchFutures equal the synchronous run's on each rank, bitwise."""
    files = tp.write_inputs(str(tmp_path), [("mlp", "momentum")])
    f = files[("mlp", "momentum")]
    res = worker.launch(2, [
        tp.port_case("sync", "mlp", "momentum", f, fetch_batch=True),
        tp.port_case("async", "mlp", "momentum", f, fetch_batch=True,
                     async_fetch=True)], str(tmp_path / "ranks"))
    for rank in (0, 1):
        for key in ("losses", "probs"):
            np.testing.assert_array_equal(res["async"][rank][key],
                                          res["sync"][rank][key])
        for n, v in tp.state_of(res["sync"][rank]).items():
            np.testing.assert_array_equal(
                tp.state_of(res["async"][rank])[n], v, err_msg=n)


# -- FLAGS_debug_nans -----------------------------------------------------


def _log_program(package):
    prog, sp = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(prog, sp):
        x = package.layers.data(name="x", shape=[2], dtype="float32")
        y = package.layers.log(x)  # log(-1) -> NaN
    return prog, y


def test_debug_nans_traps_at_the_op():
    """tests/test_flags_debug.py:112 on both packages: under the flag the
    first NaN-producing op raises FloatingPointError (the port names the
    op and its output); with the flag off the NaN flows through."""
    bad = np.array([[-1.0, 2.0]], np.float32)
    for package, exe_place in ((jfluid, jfluid.CPUPlace()),
                               (fluid, fluid.CPUPlace())):
        prog, y = _log_program(package)
        exe = package.Executor(exe_place)
        with package.flags.flag_guard(debug_nans=True):
            with pytest.raises(FloatingPointError) as ei:
                exe.run(prog, feed={"x": bad}, fetch_list=[y])
        out, = exe.run(prog, feed={"x": bad}, fetch_list=[y])
        assert np.isnan(np.asarray(out)).any()
    assert "'log'" in str(ei.value) and y.name in str(ei.value)
    assert "NaN" in str(ei.value)


def _sgd_program(package):
    main, startup = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(main, startup):
        x = package.layers.data(name="x", shape=[3], dtype="float32")
        h = package.layers.fc(input=x, size=2)
        y = package.layers.sums([package.layers.mean(package.layers.log(x)),
                                 package.layers.mean(h)])
        package.optimizer.SGD(learning_rate=0.1).minimize(y)
    return main, startup, y


@pytest.mark.parametrize("graph", [False, True],
                         ids=["interpreter", "graph"])
def test_debug_nans_with_persistable_state_keeps_scope_alive(graph,
                                                             request):
    """tests/test_flags_debug.py:133: a training program traps under the
    flag, its scope keeps every persistable unchanged, and the same scope
    trains afterwards (also when the program was on its captured graph,
    the recorded stand-in here)."""
    if graph:
        request.getfixturevalue("recorded_graphs")
    main, startup, y = _sgd_program(fluid)
    scope = fluid.Scope()
    good = np.abs(np.random.RandomState(0).randn(4, 3)).astype(
        "float32") + 5
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if graph:  # warm-up and capture first
            for _ in range(2):
                exe.run(main, feed={"x": good}, fetch_list=[y])
            assert exe.step_mode(main) == "graph"
        params = [v.name for v in main.global_block().all_parameters()]
        before = {p: fluid.fetch_var(p) for p in params}
        with flags.flag_guard(debug_nans=True):
            with pytest.raises(FloatingPointError, match="'log'"):
                exe.run(main, feed={"x": -np.ones((4, 3), np.float32)},
                        fetch_list=[y])
            assert exe.step_mode(main) == "interpreter"
        for p in params:
            after = fluid.fetch_var(p)
            assert np.isfinite(after).all()
            np.testing.assert_array_equal(after, before[p])
        out, = exe.run(main, feed={"x": good}, fetch_list=[y])
        assert np.isfinite(out).all()


def test_debug_nans_flips_between_runs_and_the_graph_comes_back(
        recorded_graphs):  # noqa: F811
    """The flag is read at every run: a run under it goes to the
    interpreter, the next one without it replays the program's one
    captured step, which reads what the interpreted runs wrote; the
    losses equal an interpreter-only run's bitwise."""
    main, startup, y = _sgd_program(fluid)
    feed = {"x": np.abs(np.random.RandomState(1).randn(4, 3)).astype(
        "float32") + 5}
    pattern = [False, False, True, False, True, True, False, False]
    runs = {}
    for graph in (False, True):
        scope = fluid.Scope()
        with fluid.scope_guard(scope), flags.flag_guard(cuda_graph=graph):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            modes, losses = [], []
            for on in pattern:
                with flags.flag_guard(debug_nans=on):
                    losses.append(exe.run(main, feed=feed,
                                          fetch_list=[y])[0])
                modes.append(exe.step_mode(main))
            runs[graph] = (losses, modes,
                           len(exe.captured_steps(main, scope)))
    assert runs[True][1] == ["graph" if not on else "interpreter"
                             for on in pattern]
    assert runs[True][2] == 1
    for a, b in zip(runs[True][0], runs[False][0]):
        np.testing.assert_array_equal(a, b)


# -- the resilience hooks -----------------------------------------------


def test_chaos_fires_before_the_run_touches_anything():
    """An injected transient raises from Executor.run before the step:
    the scope is as it was, and the retried run trains on."""
    main, startup, loss, _ = _mlp(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        before = convert.numpy_state(scope, main)
        monkey = chaos.install(chaos.ChaosMonkey([
            chaos.Fault("transient", at=0)]))
        with pytest.raises(TransientError):
            exe.run(main, feed=_feeds(1)[0], fetch_list=[loss])
        after = convert.numpy_state(scope, main)
        for n in before:
            np.testing.assert_array_equal(after[n], before[n])
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss])
    assert monkey.run_calls == 2
    assert [k for k, _, label in monkey.injected] == ["transient"]
    assert monkey.injected[0][2] == "executor"


# -- top-level names ------------------------------------------------------


def test_pinned_place_and_tensor_alias():
    assert fluid.Tensor is fluid.LoDTensor
    pinned = fluid.CUDAPinnedPlace()
    assert isinstance(pinned, fluid.CPUPlace)
    assert pinned != fluid.CPUPlace() and pinned == fluid.CUDAPinnedPlace()
    from paddle_tpu_torch.core.places import device_for

    assert device_for(pinned) == torch.device("cpu")
