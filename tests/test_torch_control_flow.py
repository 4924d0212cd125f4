"""Control flow in the port (ops/control_flow_ops.py, layers/
control_flow.py) against the JAX package.

One counterpart for each test of tests/test_control_flow.py: each builds
its program with the same layer calls in both packages (the same
desc_str()), carries the JAX package's initial state into the port,
runs both on the same seeded numpy inputs, and holds the port's values
and grads within rtol 1e-5 (fp32) of the JAX package's, besides the
JAX test's own analytic checks. Added: a While nested in a StaticRNN
(the sub-block's ops overwrite the running op and env, which run_block
puts back), a Switch program through the prepared step and its graph
path (bitwise equal to the interpreter), a conditional block holding a
host op (its predicate read on the host), the rank-table family, the
small ops, IfElse on rows that mix true and false (reference fault 10:
the port splits the rows between the branches, the JAX package gives
zeros), and a branch that is singular where it is not taken (its NaN
reaches no grad).
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import backward as jbackward
from paddle_tpu.analysis import dataflow as jdataflow
from paddle_tpu.analysis import diagnostics as jdiagnostics

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch.analysis import dataflow as tdataflow
from paddle_tpu_torch.analysis import diagnostics as tdiagnostics
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope

from test_torch_step import recorded_graphs  # noqa: F401

RTOL = 1e-5
ATOL = 1e-7
PACKAGES = {"jax": (jfluid, jbackward), "port": (tfluid, tbackward)}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid, PACKAGES["jax" if fluid is jfluid
                                      else "port"][1])
    return main, startup, fetch


def _as_array(v):
    if hasattr(v, "lod") and hasattr(v, "numpy"):
        v = v.numpy()
    return np.asarray(v, dtype=np.float64 if np.asarray(v).dtype.kind
                      in "biuf" else None)


def jax_desc(program):
    """A program's desc_str(), comparable across the packages: a program
    with a DynamicRNN is compared without var shapes (the port gives its
    step inputs and outputs their shapes, so that fc can read them, and
    shape inference carries them on: ROADMAP §3 item 12)."""
    d = json.loads(program.desc_str())
    if any(op["type"] == "dynamic_recurrent"
           for b in d["blocks"] for op in b["ops"]):
        for block in d["blocks"]:
            for var in block["vars"].values():
                var["shape"] = None
    return json.dumps(d, sort_keys=True)


def run_both(build, feeds, steps=1, flag=None):
    """`build(fluid, backward)` -> fetch vars, under a fresh unique_name
    and program_guard in each package; `feeds(fluid)` -> one feed dict.
    The JAX package runs its startup, the port takes that state, and each
    runs `steps` steps of the same feed. Returns ([jax fetches a step],
    [port fetches a step], jax main, port main)."""
    guard = (lambda f: f.flags.flag_guard(**flag)) if flag \
        else (lambda f: contextlib.nullcontext())
    jmain, jstart, jfetch = _build(jfluid, build)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope), guard(jfluid):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in jmain.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        want = [exe.run(jmain, feed=feeds(jfluid), fetch_list=jfetch)
                for _ in range(steps)]
    tmain, tstart, tfetch = _build(tfluid, build)
    tsc = tfluid.Scope()
    convert.load_numpy_state(tsc, tmain, init, tfluid.CPUPlace())
    with tfluid.scope_guard(tsc), guard(tfluid):
        exe = tfluid.Executor(tfluid.CPUPlace())
        got = [exe.run(tmain, feed=feeds(tfluid), fetch_list=tfetch)
               for _ in range(steps)]
    assert jax_desc(tmain) == jax_desc(jmain)
    return want, got, jmain, tmain


def assert_same(want, got, rtol=RTOL, atol=ATOL):
    for w_step, g_step in zip(want, got):
        assert len(w_step) == len(g_step)
        for w, g in zip(w_step, g_step):
            w, g = _as_array(w), _as_array(g)
            assert w.shape == g.shape, (w.shape, g.shape)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _ones(*shape):
    return np.ones(shape, np.float32)


# ---------------------------------------------------------------------------
# While, tensor arrays
# ---------------------------------------------------------------------------
def _accumulate(fluid, backward):
    i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
    limit = fluid.layers.fill_constant(shape=[1], dtype="int64", value=5)
    acc = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = fluid.layers.less_than(x=i, y=limit)
    w = fluid.layers.While(cond=cond)
    with w.block():
        new_acc = fluid.layers.elementwise_add(
            acc, fluid.layers.fill_constant(
                shape=[1], dtype="float32", value=2.0))
        fluid.layers.assign(new_acc, acc)
        fluid.layers.increment(x=i, value=1, in_place=True)
        fluid.layers.less_than(x=i, y=limit, cond=cond)
    return [acc, i]


def test_while_loop_accumulates():
    want, got, _, tmain = run_both(_accumulate, lambda f: {})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], [10.0], atol=1e-6)
    assert int(got[0][1][0]) == 5
    # `while` reads its condition on the host: the step is not capturable
    step = tcore.build_step_fn(tmain, [], [], tfluid.CPUPlace())
    assert step.blocker is not None and step.blocker.type == "while"


def _array_write_read(fluid, backward):
    x = fluid.layers.fill_constant(shape=[2], dtype="float32", value=3.0)
    i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
    arr = fluid.layers.array_write(x, i)
    return [fluid.layers.array_read(arr, i), fluid.layers.array_length(arr)]


def test_array_write_read():
    want, got, _, _ = run_both(_array_write_read, lambda f: {})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], [3.0, 3.0], atol=1e-6)
    assert got[0][1].tolist() == [1]


# ---------------------------------------------------------------------------
# reorder_lod_tensor_by_rank
# ---------------------------------------------------------------------------
def _rank_program(fluid, x_lod_level):
    x = fluid.layers.data(name="x", shape=[1], dtype="float32",
                          lod_level=x_lod_level)
    x.stop_gradient = False
    ref = fluid.layers.data(name="ref", shape=[1], dtype="float32",
                            lod_level=1)
    table = fluid.layers.lod_rank_table(ref, level=0)
    return x, fluid.layers.reorder_lod_tensor_by_rank(x, table)


def _ref(fluid):
    return fluid.create_lod_tensor(np.zeros((10, 1), np.float32),
                                   [[2, 3, 1, 4]], fluid.CPUPlace())


def test_reorder_dense_rows_by_rank_of_other_sequence():
    want, got, _, _ = run_both(
        lambda f, b: [_rank_program(f, 0)[1]],
        lambda f: {"x": np.arange(4, dtype=np.float32).reshape(4, 1),
                   "ref": _ref(f)})
    assert_same(want, got)
    np.testing.assert_allclose(np.asarray(got[0][0]).ravel(), [3, 1, 0, 2])


def test_reorder_ragged_sequences_by_rank():
    """X ragged: whole sequences move, and the output LoD is permuted."""
    def feeds(f):
        return {"x": f.create_lod_tensor(
            np.arange(10, dtype=np.float32).reshape(10, 1), [[2, 3, 1, 4]],
            f.CPUPlace()), "ref": _ref(f)}

    def build(fluid, backward):
        return [_rank_program(fluid, 1)[1]]

    main, startup, fetch = _build(tfluid, build)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, = exe.run(main, feed=feeds(tfluid), fetch_list=fetch)
    np.testing.assert_allclose(np.asarray(got.numpy()).ravel(),
                               [6, 7, 8, 9, 2, 3, 4, 0, 1, 5])
    assert got.lod() == [[0, 4, 7, 9, 10]]
    jmain, _, jfetch = _build(jfluid, build)
    want, = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feeds(jfluid), fetch_list=jfetch, return_numpy=False)
    np.testing.assert_allclose(np.asarray(got.numpy()),
                               np.asarray(want.numpy()), rtol=RTOL)
    assert main.desc_str() == jmain.desc_str()


def test_reorder_grad_restores_original_order():
    """d(sum(w * reorder(x)))/dx lands back in X's original order."""
    def build(fluid, backward):
        x, out = _rank_program(fluid, 0)
        w = fluid.layers.data(name="w", shape=[1], dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))
        return backward.calc_gradient([loss], [x])

    want, got, _, _ = run_both(build, lambda f: {
        "x": np.arange(4, dtype=np.float32).reshape(4, 1), "ref": _ref(f),
        "w": np.array([[10.], [20.], [30.], [40.]], np.float32)})
    assert_same(want, got)
    np.testing.assert_allclose(np.asarray(got[0][0]).ravel(),
                               [30., 20., 40., 10.])


# ---------------------------------------------------------------------------
# while_grad
# ---------------------------------------------------------------------------
def _while_sum(max_trip_count, grad=True):
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=3)
        h = fluid.layers.fc(input=x, size=4)
        acc = fluid.layers.fill_constant(
            shape=[1, 4], dtype="float32", value=0.0)
        cond = fluid.layers.less_than(x=i, y=n)
        w = fluid.layers.While(cond=cond, max_trip_count=max_trip_count)
        with w.block():
            acc2 = fluid.layers.elementwise_add(acc, h)
            fluid.layers.assign(acc2, acc)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(x=i, y=n, cond=cond)
        loss = fluid.layers.mean(acc)
        w_fc = [p for p in fluid.default_main_program().global_block()
                .all_parameters() if p.name.endswith(".w_0")]
        return [loss] + (backward.calc_gradient(loss, [x]) if grad
                         else []) + w_fc

    return build


@pytest.mark.parametrize("name", ["jax", "port"])
def test_while_grad_unbounded_refuses_loudly(name):
    fluid, backward = PACKAGES[name]
    with fluid.unique_name.guard(), fluid.program_guard(fluid.Program(),
                                                        fluid.Program()):
        with pytest.raises(RuntimeError, match="max_trip_count"):
            _while_sum(None)(fluid, backward)


def test_while_grad_masked_scan_value():
    """3 live trips under an 8-trip bound: grads count the LIVE trips
    only, d(mean(3·xW))/dx analytically."""
    xv = np.array([[1., -2., 3., 0.5]], np.float32)
    want, got, _, _ = run_both(_while_sum(8), lambda f: {"x": xv})
    assert_same(want, got)
    lv, gv, W = got[0]
    np.testing.assert_allclose(
        gv, (3.0 / 4.0) * W.sum(axis=1, keepdims=True).T, rtol=1e-5)
    np.testing.assert_allclose(lv, 3.0 * np.mean(xv @ W), rtol=1e-4)


def test_while_training_converges():
    """SGD through a While-looped forward: the loss falls, step for step
    with the JAX package's."""
    rs = np.random.RandomState(3)
    Wt = rs.randn(8, 1).astype(np.float32)
    batches = [rs.randn(16, 8).astype(np.float32) for _ in range(40)]

    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=2)
        h = fluid.layers.fc(input=x, size=8, act="tanh")
        acc = fluid.layers.fill_constant_batch_size_like(
            input=h, shape=[-1, 8], dtype="float32", value=0.0)
        cond = fluid.layers.less_than(x=i, y=n)
        w = fluid.layers.While(cond=cond, max_trip_count=4)
        with w.block():
            step = fluid.layers.fc(input=h, size=8, act="tanh")
            acc2 = fluid.layers.elementwise_add(acc, step)
            fluid.layers.assign(acc2, acc)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(x=i, y=n, cond=cond)
        pred = fluid.layers.fc(input=acc, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return [loss]

    it = {"jax": iter(batches), "port": iter(batches)}

    def feeds(f):
        xv = next(it["jax" if f is jfluid else "port"])
        return {"x": xv, "y": (xv @ Wt).astype(np.float32)}

    want, got, _, _ = run_both(build, feeds, steps=40)
    assert_same(want, got, rtol=1e-4, atol=1e-6)
    losses = [float(np.asarray(g[0]).reshape(-1)[0]) for g in got]
    assert losses[-1] < 0.5 * losses[0], losses


# ---------------------------------------------------------------------------
# conditional_block and its grad
# ---------------------------------------------------------------------------
def _cond_scale(flag_val):
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        flag = fluid.layers.fill_constant(shape=[1], dtype="bool",
                                          value=flag_val)
        out = fluid.layers.fill_constant(shape=[1, 4], dtype="float32",
                                         value=1.0)
        cb = fluid.layers.ConditionalBlock([flag], is_scalar_condition=True)
        with cb.block():
            fluid.layers.assign(fluid.layers.scale(x, scale=3.0), out)
        loss = fluid.layers.mean(out)
        return [loss] + backward.calc_gradient(loss, [x])

    return build


@pytest.mark.parametrize("flag_val,loss,grad", [(True, 3.0, 0.75),
                                                (False, 1.0, 0.0)])
def test_conditional_block_grad_both_branches(flag_val, loss, grad):
    """Taken: the vjp through the block; untaken: the output keeps its
    pre-op value, so dx is zero."""
    want, got, _, _ = run_both(_cond_scale(flag_val),
                               lambda f: {"x": _ones(1, 4)})
    assert_same(want, got)
    assert abs(float(got[0][0].reshape(-1)[0]) - loss) < 1e-5
    np.testing.assert_allclose(got[0][1], np.full((1, 4), grad), atol=1e-7)


@pytest.mark.parametrize("flag_val,gx,gz", [(True, 0.0, 0.75),
                                            (False, 0.5, 0.0)])
def test_conditional_block_grad_overwrite_without_read(flag_val, gx, gz):
    """An Out var the block OVERWRITES but never reads: its producer gets
    where(pred, 0, dOut)."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        z = fluid.layers.data(name="z", shape=[4], dtype="float32")
        x.stop_gradient = False
        z.stop_gradient = False
        y = fluid.layers.scale(x, scale=2.0)
        flag = fluid.layers.fill_constant(shape=[1], dtype="bool",
                                          value=flag_val)
        cb = fluid.layers.ConditionalBlock([flag], is_scalar_condition=True)
        with cb.block():
            fluid.layers.assign(fluid.layers.scale(z, scale=3.0), y)
        loss = fluid.layers.mean(y)
        return backward.calc_gradient(loss, [x, z])

    want, got, _, _ = run_both(build, lambda f: {"x": _ones(1, 4),
                                                 "z": _ones(1, 4)})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], np.full((1, 4), gx), atol=1e-7)
    np.testing.assert_allclose(got[0][1], np.full((1, 4), gz), atol=1e-7)


def test_conditional_block_grad_var_materialized_inside():
    """A state var FIRST made inside the block (the Switch/IfElse
    accumulator idiom): lazy inputs keep the forward working and the grad
    starts it at the zeros the untaken branch would give."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        flag = fluid.layers.fill_constant(shape=[1], dtype="bool",
                                          value=True)
        out = fluid.layers.create_tensor(dtype="float32")
        cb = fluid.layers.ConditionalBlock([flag], is_scalar_condition=True)
        with cb.block():
            fluid.layers.assign(fluid.layers.scale(x, scale=3.0), out)
        loss = fluid.layers.mean(out)
        return backward.calc_gradient(loss, [x])

    want, got, _, _ = run_both(build, lambda f: {"x": _ones(1, 4)})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], np.full((1, 4), 0.75), rtol=1e-6)


def test_conditional_block_grad_ignores_later_overwrites():
    """The grad replay sees ENTRY-time values of the block's reads
    (InputSnapshots): out = y*y inside the block, y := 100 after it."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        y = fluid.layers.scale(x, scale=2.0)
        flag = fluid.layers.fill_constant(shape=[1], dtype="bool",
                                          value=True)
        out = fluid.layers.fill_constant(shape=[1, 4], dtype="float32",
                                         value=0.0)
        cb = fluid.layers.ConditionalBlock([flag], is_scalar_condition=True)
        with cb.block():
            fluid.layers.assign(fluid.layers.elementwise_mul(y, y), out)
        fluid.layers.assign(fluid.layers.fill_constant(
            shape=[1, 4], dtype="float32", value=100.0), y)
        loss = fluid.layers.mean(out)
        return backward.calc_gradient(loss, [x])

    want, got, _, _ = run_both(build,
                               lambda f: {"x": np.full((1, 4), 3.0,
                                                       np.float32)})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], np.full((1, 4), 6.0), rtol=1e-5)


@pytest.mark.parametrize("overwrite", ["after", "inside"],
                         ids=["predicate_snapshot",
                              "self_overwriting_predicate"])
def test_conditional_block_grad_predicate_snapshot(overwrite):
    """The grad replays under the ENTRY-time predicate (CondSnapshots):
    a condition var overwritten after the block, or by the block itself,
    does not flip the differentiated branch (the JAX package's
    test_conditional_block_grad_predicate_snapshot and
    test_conditional_block_grad_self_overwriting_predicate)."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        flag = fluid.layers.fill_constant(shape=[1], dtype="bool",
                                          value=True)
        out_v = fluid.layers.fill_constant(shape=[1, 4], dtype="float32",
                                           value=0.0)
        off = fluid.layers.fill_constant(shape=[1], dtype="bool",
                                         value=False) \
            if overwrite == "after" else None
        cb = fluid.layers.ConditionalBlock([flag], is_scalar_condition=True)
        with cb.block():
            fluid.layers.assign(fluid.layers.scale(x, scale=3.0), out_v)
            if overwrite == "inside":
                fluid.layers.assign(fluid.layers.fill_constant(
                    shape=[1], dtype="bool", value=False), flag)
        if overwrite == "after":
            fluid.layers.assign(off, flag)
        loss = fluid.layers.mean(out_v)
        return backward.calc_gradient(loss, [x])

    want, got, _, _ = run_both(build, lambda f: {"x": _ones(1, 4)})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], np.full((1, 4), 0.75), rtol=1e-6)


# ---------------------------------------------------------------------------
# IfElse and Switch
# ---------------------------------------------------------------------------
def _ifelse(fluid, backward):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    x.stop_gradient = False
    c = fluid.layers.data(name="c", shape=[1], dtype="float32")
    cond = fluid.layers.less_than(x=c, y=fluid.layers.fill_constant(
        shape=[1], dtype="float32", value=0.5))
    ie = fluid.layers.IfElse(cond)
    with ie.true_block():
        ie.output(fluid.layers.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(fluid.layers.scale(ie.input(x), scale=5.0))
    out = ie()[0]
    loss = fluid.layers.mean(out)
    return [out] + backward.calc_gradient(loss, [x])


def _ifelse_run(fluid, feed):
    main, startup, fetch = _build(fluid, _ifelse)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        return [np.asarray(v) for v in exe.run(main, feed=feed,
                                               fetch_list=fetch)]


@pytest.mark.parametrize("cv,expect", [(0.0, 0.5), (1.0, 1.25)])
def test_ifelse_grads_select_taken_branch(cv, expect):
    """Rows that all agree: the JAX package's values and grads; the
    cotangent routes through the block of the branch that ran."""
    feed = {"x": _ones(1, 4), "c": np.full((1, 1), cv, np.float32)}
    want = _ifelse_run(jfluid, feed)
    got = _ifelse_run(tfluid, feed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    np.testing.assert_allclose(got[1], np.full((1, 4), expect), rtol=1e-5)


MIXED = {"x": np.arange(8, dtype=np.float32).reshape(2, 4) + 1.0,
         "c": np.array([[1.0], [0.0]], np.float32)}


def test_ifelse_mixed_rows_select_per_row():
    """Rows that mix true and false: each row takes its own branch, as
    the reference Fluid's split_lod_tensor/merge_lod_tensor give: row 0
    (c = 1, false) x5, row 1 (c = 0, true) x2; grads 5/8 and 2/8."""
    out, grad = _ifelse_run(tfluid, MIXED)
    x = MIXED["x"]
    want = np.where(MIXED["c"] < 0.5, 2.0 * x, 5.0 * x)
    np.testing.assert_allclose(out, want, rtol=RTOL)
    np.testing.assert_allclose(
        grad, np.where(MIXED["c"] < 0.5, 2.0, 5.0) / 8.0 * np.ones((2, 4)),
        rtol=RTOL)
    ones = {"x": _ones(2, 4), "c": np.array([[0.], [1.]], np.float32)}
    np.testing.assert_allclose(_ifelse_run(tfluid, ones)[0],
                               [[2, 2, 2, 2], [5, 5, 5, 5]])


def _ifelse_sqrt(fluid, backward):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    x.stop_gradient = False
    c = fluid.layers.data(name="c", shape=[1], dtype="float32")
    cond = fluid.layers.less_than(x=c, y=fluid.layers.fill_constant(
        shape=[1], dtype="float32", value=0.5))
    ie = fluid.layers.IfElse(cond)
    with ie.true_block():
        ie.output(fluid.layers.sqrt(ie.input(x)))
    with ie.false_block():
        ie.output(fluid.layers.scale(ie.input(x), scale=5.0))
    out = ie()[0]
    loss = fluid.layers.mean(out)
    return [out] + backward.calc_gradient(loss, [x])


SINGULAR_ROWS = {"x": np.array([[-1.0, 0.0, -4.0, 2.0],
                                [1.0, 4.0, 9.0, 16.0]], np.float32),
                 "c": np.array([[1.0], [0.0]], np.float32)}


def test_ifelse_mixed_rows_singular_on_the_other_branch():
    """The true branch's sqrt is NaN or singular on row 0's x, which
    takes the false branch: each branch computes on its own rows, so
    values and grads are the numpy per-row ones and finite, also under
    FLAGS_check_nan_inf. The row split keeps the program on the
    interpreter (its blocker is split_lod_tensor)."""
    main, startup, fetch = _build(tfluid, _ifelse_sqrt)
    step = tcore.build_step_fn(main, [v.name for v in fetch], [],
                               tfluid.CPUPlace())
    assert step.blocker.type == "split_lod_tensor"
    x = SINGULAR_ROWS["x"].astype(np.float64)
    want = np.stack([5.0 * x[0], np.sqrt(x[1])])
    want_grad = np.stack([np.full(4, 5.0), 0.5 / np.sqrt(x[1])]) / 8.0
    for check in (False, True):
        with tfluid.scope_guard(tfluid.Scope()), \
                tflags.flag_guard(check_nan_inf=check):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            out, grad = exe.run(main, feed=dict(SINGULAR_ROWS),
                                fetch_list=fetch)
        np.testing.assert_allclose(out, want, rtol=RTOL)
        np.testing.assert_allclose(grad, want_grad, rtol=RTOL)


@pytest.mark.cuda
def test_ifelse_mixed_rows_singular_on_the_card():
    """The same IfElse on the card: finite, and within rtol 1e-6 of the
    host's values and grads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    main, startup, fetch = _build(tfluid, _ifelse_sqrt)
    runs = []
    for place in (tfluid.CUDAPlace(0), tfluid.CPUPlace()):
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(place)
            exe.run(startup)
            runs.append(exe.run(main, feed=dict(SINGULAR_ROWS),
                                fetch_list=fetch))
    for card, host in zip(*runs):
        assert np.isfinite(card).all()
        np.testing.assert_allclose(card, host, rtol=1e-6)


def test_ifelse_mixed_rows_in_the_jax_package_give_zeros():
    """Reference fault 10, recorded: the JAX package runs each branch
    under all(cond), so on mixed rows neither runs and the merge picks
    the false branch's zeros. Should the JAX package change, this fails
    and the port's note (ROADMAP §3 item 10) goes."""
    out, grad = _ifelse_run(jfluid, MIXED)
    np.testing.assert_array_equal(out, np.zeros((2, 4)))
    np.testing.assert_array_equal(grad, np.zeros((2, 4)))


def test_ifelse_program_differs_from_the_jax_package_by_its_predicates():
    """The repair's ops: the port's IfElse holds reduce_max, reduce_min,
    a 0.5 fill, two less_than and a merge_lod_tensor (and its grad) where
    the JAX package holds one logical_not and a multiplex (and its
    grad), both blocks are
    scalar-conditioned, and each block splits its input's rows
    (split_lod_tensor) before its own op."""
    types, subs = {}, {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main, _, _ = _build(fluid, _ifelse)
        types[name] = [op.type for op in main.global_block().ops]
        subs[name] = [[op.type for op in b.ops] for b in main.blocks[1:]]
    extra = list(types["port"])
    for t in types["jax"]:
        if t in extra:
            extra.remove(t)
    missing = [t for t in types["jax"] if t not in types["port"]]
    assert sorted(extra) == sorted(["reduce_max", "reduce_min",
                                    "fill_constant", "less_than",
                                    "less_than", "merge_lod_tensor",
                                    "merge_lod_tensor_grad"]), extra
    assert missing == ["logical_not", "multiplex", "multiplex_grad"]
    assert subs["port"] == [["split_lod_tensor"] + ops
                            for ops in subs["jax"]]


def _switch(fluid, backward):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    c = fluid.layers.data(name="c", shape=[1], dtype="float32")
    x.stop_gradient = False
    res = fluid.layers.fill_constant(shape=[1, 4], dtype="float32",
                                     value=0.0)
    half = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.5)
    with fluid.layers.Switch() as switch:
        with switch.case(fluid.layers.less_than(x=c, y=half)):
            fluid.layers.assign(fluid.layers.scale(x, scale=2.0), res)
        with switch.default():
            fluid.layers.assign(fluid.layers.scale(x, scale=5.0), res)
    loss = fluid.layers.mean(res)
    return [res] + backward.calc_gradient(loss, [x])


@pytest.mark.parametrize("cv,expect", [(0.0, 0.5), (1.0, 1.25)])
def test_switch_grads_follow_active_case(cv, expect):
    want, got, _, _ = run_both(
        _switch, lambda f: {"x": _ones(1, 4),
                            "c": np.full((1, 1), cv, np.float32)})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][1], np.full((1, 4), expect),
                               rtol=1e-5)


def _guarded_switch(kind):
    """A Switch whose default case is singular on the fed x (sqrt of a
    negative, 1/0) and is guarded off by the first case, which runs. The
    default's block comes last, so the grad hands it the loss's whole
    cotangent."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        c = fluid.layers.data(name="c", shape=[1], dtype="float32")
        x.stop_gradient = False
        res = fluid.layers.fill_constant(shape=[1, 4], dtype="float32",
                                         value=0.0)
        half = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                          value=0.5)
        with fluid.layers.Switch() as switch:
            with switch.case(fluid.layers.less_than(x=c, y=half)):
                fluid.layers.assign(fluid.layers.scale(x, scale=2.0), res)
            with switch.default():
                fluid.layers.assign(getattr(fluid.layers, kind)(x), res)
        loss = fluid.layers.mean(res)
        return [res] + backward.calc_gradient(loss, [x])

    return build


SINGULAR = {"x": np.array([[-1.0, 0.0, 4.0, 9.0]], np.float32),
            "c": np.full((1, 1), 0.0, np.float32)}


@pytest.mark.parametrize("check", [False, True], ids=["plain", "nan_check"])
@pytest.mark.parametrize("kind", ["sqrt", "reciprocal"])
def test_switch_untaken_singular_case_keeps_grads_finite(kind, check):
    """The untaken case's derivative is NaN or Inf at x (sqrt at -1 and
    0, 1/x at 0). The grad selects the block's grads, not its outputs,
    so the cotangent's zeros never multiply it: dx is the first case's
    2/4 everywhere, as the JAX package's lax.cond gives, and
    FLAGS_check_nan_inf raises nothing."""
    want, got, _, _ = run_both(
        _guarded_switch(kind), lambda f: dict(SINGULAR),
        flag={"check_nan_inf": True} if check else None)
    assert_same(want, got)
    np.testing.assert_array_equal(got[0][0], 2.0 * SINGULAR["x"])
    np.testing.assert_array_equal(got[0][1], np.full((1, 4), 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sqrt", "reciprocal"])
def test_switch_untaken_singular_case_on_the_card(kind):
    """The same guarded Switch on the card, in its CUDA graph and on the
    interpreter: finite grads, bitwise equal to the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    main, _, fetch = _build(tfluid, _guarded_switch(kind))
    runs = []
    for place, graph in ((tfluid.CUDAPlace(0), True),
                         (tfluid.CUDAPlace(0), False),
                         (tfluid.CPUPlace(), False)):
        with tflags.flag_guard(cuda_graph=graph):
            exe = tfluid.Executor(place)
            runs.append(exe.run(main, feed=dict(SINGULAR),
                                fetch_list=fetch))
    for run in runs:
        np.testing.assert_array_equal(run[1], np.full((1, 4), 0.5))
        np.testing.assert_array_equal(run[0], runs[2][0])


def test_switch_step_is_capturable_and_graph_equals_interpreter(
        recorded_graphs):  # noqa: F811
    """A Switch program through the prepared step (build_step_fn): no op
    keeps it out of a graph, and its graph path (the recording stand-in
    for a CUDA graph on the CPU) is bitwise equal to the interpreter over
    steps whose case changes."""
    main, _, fetch = _build(tfluid, _switch)
    step = tcore.build_step_fn(main, [v.name for v in fetch], [],
                               tfluid.CPUPlace())
    assert step.blocker is None
    rs = np.random.RandomState(2)
    feeds = [{"x": rs.randn(1, 4).astype(np.float32),
              "c": np.full((1, 1), cv, np.float32)}
             for cv in (0.0, 1.0, 0.2, 0.9)]
    runs = {}
    for graph in (False, True):
        with tflags.flag_guard(cuda_graph=graph):
            exe = tfluid.Executor(tfluid.CPUPlace())
            runs[graph] = [exe.run(main, feed=f, fetch_list=fetch)
                           for f in feeds]
            assert exe.step_mode(main) == ("graph" if graph
                                           else "interpreter")
    for g, i in zip(runs[True], runs[False]):
        for a, b in zip(g, i):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(runs[True][1][0], 5.0 * feeds[1]["x"],
                               rtol=1e-6)


def test_conditional_block_with_a_host_op_reads_its_predicate_on_host():
    """A sub-block holding a host-sync op (print) keeps the program on the
    interpreter, where the predicate is read on the host: an untaken
    block does not run (nothing printed) and a name it would have made
    stays unwritten; a taken one runs as the masked path does."""
    def build(fluid, backward, flag_val):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        flag = fluid.layers.fill_constant(shape=[1], dtype="bool",
                                          value=flag_val)
        out = fluid.layers.fill_constant(shape=[1, 4], dtype="float32",
                                         value=1.0)
        cb = fluid.layers.ConditionalBlock([flag], is_scalar_condition=True)
        with cb.block():
            fluid.layers.assign(fluid.layers.Print(
                fluid.layers.scale(x, scale=3.0), message="taken"), out)
        return [out]

    for flag_val, want in ((True, 3.0), (False, 1.0)):
        main, _, fetch = _build(tfluid, lambda f, b: build(f, b, flag_val))
        step = tcore.build_step_fn(main, [fetch[0].name], [],
                                   tfluid.CPUPlace())
        assert step.blocker is not None and step.blocker.type == "print"
        exe = tfluid.Executor(tfluid.CPUPlace())
        got, = exe.run(main, feed={"x": _ones(1, 4)}, fetch_list=fetch)
        np.testing.assert_allclose(got, np.full((1, 4), want))


# ---------------------------------------------------------------------------
# tensor-array grads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["two_reads_and_unread_slot",
                                  "overwritten_slot"])
def test_tensor_array_grads(case):
    """A write's grad READS the grad array; a read's grad ACCUMULATES
    into it: two reads of one slot sum, a never-read slot gets zero, and
    a slot written twice gives its dead first write zero (the JAX
    package's test_tensor_array_grads and
    test_tensor_array_overwritten_slot_dead_write_zero_grad)."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        z = fluid.layers.data(name="z", shape=[4], dtype="float32")
        x.stop_gradient = False
        z.stop_gradient = False
        i0 = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        i1 = fluid.layers.fill_constant(shape=[1], dtype="int64", value=1)
        arr = fluid.layers.array_write(fluid.layers.scale(x, scale=2.0), i0)
        fluid.layers.array_write(
            fluid.layers.scale(z, scale=7.0),
            i1 if case == "two_reads_and_unread_slot" else i0, array=arr)
        a = fluid.layers.array_read(arr, i0)
        if case == "two_reads_and_unread_slot":
            b = fluid.layers.array_read(arr, i0)
            loss = fluid.layers.mean(fluid.layers.sums([a, b]))
        else:
            loss = fluid.layers.mean(a)
        return backward.calc_gradient(loss, [x, z])

    want, got, _, _ = run_both(build, lambda f: {"x": _ones(1, 4),
                                                 "z": _ones(1, 4)})
    assert_same(want, got)
    gx, gz = (1.0, 0.0) if case == "two_reads_and_unread_slot" \
        else (0.0, 1.75)
    np.testing.assert_allclose(got[0][0], np.full((1, 4), gx), atol=1e-7)
    np.testing.assert_allclose(got[0][1], np.full((1, 4), gz), atol=1e-6)


def test_tensor_array_write_index_read_in_a_capture_refuses():
    """A write whose index would be read while a CUDA graph captures the
    step raises with the JAX package's wording for a traced index."""
    main, _, _ = _build(tfluid, _array_write_read)
    op = [o for o in main.global_block().ops
          if o.type == "write_to_array"][0]
    ctx = tcore.OpContext(tfluid.CPUPlace(), eager=False)
    ctx.current_op, ctx.env = op, {}
    with pytest.raises(NotImplementedError, match="traced index"):
        treg.lookup("write_to_array").fn(
            ctx, {"X": [torch.ones(2)], "I": [torch.zeros(1)]}, {})


# ---------------------------------------------------------------------------
# StaticRNN and DynamicRNN
# ---------------------------------------------------------------------------
def test_static_rnn_grads_exact():
    """h_t = h_{t-1} + 2 x_t; d mean(out)/dx_t = 2 (T-t) / numel."""
    T, B, D = 3, 2, 4

    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[T, B, D],
                              append_batch_size=False, dtype="float32")
        x.stop_gradient = False
        init = fluid.layers.fill_constant(shape=[B, D], dtype="float32",
                                          value=0.0)
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=init)
            nh = fluid.layers.elementwise_add(
                h, fluid.layers.scale(x_t, scale=2.0))
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out_seq = rnn()
        loss = fluid.layers.mean(out_seq)
        return [out_seq] + backward.calc_gradient(loss, [x])

    rs = np.random.RandomState(1)
    xv = rs.randn(T, B, D).astype(np.float32)
    want, got, _, _ = run_both(build, lambda f: {"x": xv})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], np.cumsum(2.0 * xv, axis=0),
                               rtol=1e-5)
    np.testing.assert_allclose(
        got[0][1], np.stack([np.full((B, D), 2.0 * (T - t) / (T * B * D))
                             for t in range(T)]), rtol=1e-5)


def test_static_rnn_closure_weight_trains():
    """Weights read inside the rnn step (the Closure slot) get real
    gradients: SGD through a StaticRNN fc cell converges, loss for loss
    with the JAX package."""
    T, B, D = 3, 4, 6
    rs = np.random.RandomState(8)
    xv = rs.randn(T, B, D).astype("float32")
    yv = np.tanh(rs.randn(B, D)).astype("float32") * 0.5

    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[T, B, D],
                              append_batch_size=False, dtype="float32")
        y = fluid.layers.data(name="y", shape=[B, D],
                              append_batch_size=False, dtype="float32")
        init = fluid.layers.fill_constant(shape=[B, D], dtype="float32",
                                          value=0.0)
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=init)
            nh = fluid.layers.fc(input=fluid.layers.elementwise_add(h, x_t),
                                 size=D, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out_seq = rnn()
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.reduce_mean(out_seq, dim=0) - y))
        fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
        return [loss]

    want, got, _, _ = run_both(build, lambda f: {"x": xv, "y": yv},
                               steps=60)
    assert_same(want, got, rtol=1e-4, atol=1e-6)
    losses = [float(np.asarray(g[0]).reshape(-1)[0]) for g in got]
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


def test_dynamic_rnn_static_input_grads_exact():
    """static_input values come in through ins: with lengths [2, 1] the
    last state of each sequence is len * rowmean(w), d loss/dw = 0.25."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[1], lod_level=1,
                              dtype="float32")
        w = fluid.layers.data(name="w", shape=[2, 3],
                              append_batch_size=False, dtype="float32")
        w.stop_gradient = False
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            drnn.step_input(x)
            s = drnn.static_input(w)
            mem = drnn.memory(shape=[3], value=0.0)
            nh = fluid.layers.elementwise_add(
                mem, fluid.layers.reduce_mean(s, dim=0))
            drnn.update_memory(mem, nh)
            drnn.output(nh)
        outv = drnn()
        loss = fluid.layers.mean(fluid.layers.sequence_pool(outv, "last"))
        return [loss] + backward.calc_gradient(loss, [w])

    rs = np.random.RandomState(5)
    wv = rs.randn(2, 3).astype(np.float32)
    want, got, _, _ = run_both(build, lambda f: {
        "x": f.create_lod_tensor([[1.0, 2.0], [3.0]], None, f.CPUPlace()),
        "w": wv})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][1], np.full((2, 3), 0.25), rtol=1e-5)


def test_while_nested_in_a_static_rnn():
    """A While inside a StaticRNN step: the loop's sub-block ops overwrite
    the context's running op and env, which run_block puts back for the
    recurrent kernel (and for its derived grad, which reads the running
    op). h_t = h_{t-1} + 3 x_t, the 3 from a While adding x_t three
    times; grads through the recurrence by the derived grad."""
    T, B, D = 3, 2, 4

    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[T, B, D],
                              append_batch_size=False, dtype="float32")
        x.stop_gradient = False
        init = fluid.layers.fill_constant(shape=[B, D], dtype="float32",
                                          value=0.0)
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=init)
            i = fluid.layers.fill_constant(shape=[1], dtype="int64",
                                           value=0)
            n = fluid.layers.fill_constant(shape=[1], dtype="int64",
                                           value=3)
            acc = fluid.layers.fill_constant(shape=[B, D], dtype="float32",
                                             value=0.0)
            cond = fluid.layers.less_than(x=i, y=n)
            loop = fluid.layers.While(cond=cond)
            with loop.block():
                fluid.layers.assign(fluid.layers.elementwise_add(acc, x_t),
                                    acc)
                fluid.layers.increment(i, value=1, in_place=True)
                fluid.layers.less_than(x=i, y=n, cond=cond)
            nh = fluid.layers.elementwise_add(h, acc)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out_seq = rnn()
        loss = fluid.layers.mean(out_seq)
        return [out_seq] + backward.calc_gradient(loss, [x])

    rs = np.random.RandomState(4)
    xv = rs.randn(T, B, D).astype(np.float32)
    main, startup, fetch = _build(tfluid, build)
    got = tfluid.Executor(tfluid.CPUPlace()).run(main, feed={"x": xv},
                                                 fetch_list=fetch)
    np.testing.assert_allclose(got[0], np.cumsum(3.0 * xv, axis=0),
                               rtol=1e-5)
    np.testing.assert_allclose(
        got[1], np.stack([np.full((B, D), 3.0 * (T - t) / (T * B * D))
                          for t in range(T)]), rtol=1e-5)
    jmain, _, _ = _build(jfluid, build)
    assert main.desc_str() == jmain.desc_str()


# ---------------------------------------------------------------------------
# the trip-count check
# ---------------------------------------------------------------------------
def test_while_grad_trip_count_debug_check():
    """A forward loop that needs MORE trips than its max_trip_count cuts
    the replayed grad trajectory; under FLAGS_check_nan_inf the replay
    raises, naming max_trip_count. Without the flag it runs (the JAX
    package's grads too); a sufficient bound passes under the flag."""
    xv = _ones(1, 4)
    want, got, _, _ = run_both(_while_sum(2), lambda f: {"x": xv})
    assert_same(want, got)
    main, startup, fetch = _build(tfluid, _while_sum(2))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    with tflags.flag_guard(check_nan_inf=True):
        with pytest.raises(FloatingPointError, match="max_trip_count"):
            exe.run(main, feed={"x": xv}, fetch_list=fetch)
    want, got, _, _ = run_both(_while_sum(8), lambda f: {"x": xv},
                               flag={"check_nan_inf": True})
    assert_same(want, got)


# ---------------------------------------------------------------------------
# rank tables, LoD reshuffles and the small ops
# ---------------------------------------------------------------------------
def test_rank_table_array_round_trip():
    """lod_rank_table, max_sequence_len, lod_tensor_to_array,
    array_to_lod_tensor and shrink_memory, each as the JAX package runs
    it."""
    def build(fluid, backward):
        x = fluid.layers.data(name="x", shape=[2], dtype="float32",
                              lod_level=1)
        table = fluid.layers.lod_rank_table(x)
        mx = fluid.layers.max_sequence_len(table)
        arr = fluid.layers.lod_tensor_to_array(x, table)
        i1 = fluid.layers.fill_constant(shape=[1], dtype="int64", value=1)
        step1 = fluid.layers.array_read(arr, i1)
        shrunk = fluid.layers.shrink_memory(
            fluid.layers.array_read(arr, fluid.layers.fill_constant(
                shape=[1], dtype="int64", value=0)), i1, table)
        back = fluid.layers.array_to_lod_tensor(arr, table)
        return [mx, step1, shrunk, back, fluid.layers.array_length(arr)]

    def feeds(f):
        return {"x": f.create_lod_tensor(
            np.arange(20, dtype=np.float32).reshape(10, 2), [[2, 3, 1, 4]],
            f.CPUPlace())}

    main, _, fetch = _build(tfluid, build)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feeds(tfluid), fetch_list=fetch)
    jmain, _, jfetch = _build(jfluid, build)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feeds(jfluid), fetch_list=jfetch, return_numpy=False)
    assert main.desc_str() == jmain.desc_str()
    assert int(np.asarray(got[0]).reshape(-1)[0]) == 4
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(_as_array(g), _as_array(w), rtol=RTOL)
    # step 1 holds the second token of the 3 sequences longer than 1, in
    # rank order (4, 3, 2 tokens: sequences 3, 1, 0)
    np.testing.assert_allclose(got[1], [[14, 15], [6, 7], [2, 3]])
    assert np.asarray(got[2]).shape == (3, 2)
    np.testing.assert_allclose(np.asarray(got[3].numpy()),
                               np.arange(20).reshape(10, 2))
    assert got[3].lod() == [[0, 2, 5, 6, 10]]
    assert got[4].tolist() == [4]


def test_small_ops_run_as_in_the_jax_package(capsys):
    """is_empty, print (host-printed, value passed through), assert_op,
    get_places, feed and fetch (a no-op: the executor returns its fetch
    list's values)."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ctx = tcore.OpContext(tfluid.CPUPlace(), feed={"x": x})
    run = lambda t, ins, attrs: treg.lookup(t).fn(ctx, ins, attrs)  # noqa
    assert bool(run("is_empty", {"X": [x]}, {})["Out"][0]) is False
    assert bool(run("is_empty", {"X": [x[:0]]}, {})["Out"][0]) is True
    shown = run("print", {"In": [x]}, {"message": "x is", "summarize": 4})
    assert shown["Out"][0] is x
    assert capsys.readouterr().out == "x is [0. 1. 2. 3.]\n"
    assert run("assert_op", {"Cond": [x]}, {}) == {}
    places = run("get_places", {}, {"device_count": 2,
                                    "device_type": "CPU"})["Out"]
    assert places == [tfluid.CPUPlace(), tfluid.CPUPlace()]

    class Op:
        def output(self, slot):
            return ["x"]

    ctx.current_op = Op()
    assert run("feed", {}, {"col": 0})["Out"][0] is x
    assert run("fetch", {"X": [x]}, {}) == {}


def test_every_listed_op_type_is_registered():
    """The op types of the JAX package's control flow and beam search
    (grads included) that the port registers now."""
    types = ["while", "while_grad", "conditional_block",
             "conditional_block_grad", "recurrent", "dynamic_recurrent",
             "write_to_array", "read_from_array", "write_to_array_grad",
             "read_from_array_grad", "lod_array_length", "lod_rank_table",
             "max_sequence_len", "lod_tensor_to_array",
             "array_to_lod_tensor", "reorder_lod_tensor_by_rank",
             "reorder_lod_tensor_by_rank_grad", "shrink_rnn_memory",
             "feed", "fetch", "print", "assert_op", "get_places",
             "is_empty", "beam_search", "beam_search_decode"]
    assert len(types) == len(set(types)) == 26
    for t in types:
        assert treg.get_op_def(t) is not None, t
    for t in ("while", "while_grad", "write_to_array", "lod_rank_table",
              "shrink_rnn_memory", "print"):
        assert t in tcore.HOST_SYNC_OPS
    for t in ("conditional_block", "recurrent", "dynamic_recurrent",
              "is_empty", "beam_search", "beam_search_decode"):
        assert t not in tcore.HOST_SYNC_OPS and t not in tcore.HOST_OPS


def test_dead_code_elimination_keeps_sub_block_ops_and_print():
    """An op carrying a sub-block writes into the env by side effect, and
    print and assert_op have no effect but their own: dead-code
    elimination keeps each, and what they read, with no fetch needing
    them."""
    def build(fluid, backward):
        fetch = _accumulate(fluid, backward)
        x = fluid.layers.fill_constant(shape=[2], dtype="float32",
                                       value=1.0)
        fluid.layers.Print(fluid.layers.scale(x, scale=2.0))
        fluid.default_main_program().current_block().append_op(
            "assert_op", {"Cond": [x]}, {})
        return fetch

    main, _, _ = _build(tfluid, build)
    kept = [op.type for op in tcore.dead_code_eliminate(
        main.global_block().ops, [])]
    assert all(t in kept for t in ("while", "print", "assert_op", "scale")), \
        kept


def _hazards(fluid, dataflow, diagnostics, extra=None):
    main, _, _ = _build(fluid, lambda f, b: [
        f.layers.piecewise_decay([1, 3], [0.1, 0.01, 0.001])])
    if extra is not None:
        extra(main.global_block())
    report = diagnostics.Report()
    dataflow.check_hazards(main, report, feed_names=[])
    return sorted(d.code for d in report.errors())


def test_a_switch_written_rate_is_no_write_after_write_hazard():
    """piecewise_decay's Switch writes the persistable rate once a case,
    each conditional block reading the version the one before it made:
    an update chain, which the port's dataflow check passes, so a fused
    Momentum can read the rate. The JAX package's check calls it PTA032
    and its FLAGS_fuse refuses the program (ROADMAP §3 item 11). Another
    write that does not chain still is one."""
    assert _hazards(jfluid, jdataflow, jdiagnostics) == ["PTA032"]
    assert _hazards(tfluid, tdataflow, tdiagnostics) == []

    def overwrite(gb):
        lr = [n for n, v in gb.vars.items() if v.persistable
              and n.startswith("learning_rate")][0]
        gb.append_op("fill_constant", {}, {"Out": [lr]},
                     {"shape": [1], "dtype": "float32", "value": 0.5})

    assert _hazards(tfluid, tdataflow, tdiagnostics, overwrite) == \
        ["PTA032"]


@pytest.mark.cuda
def test_switch_on_the_card_graph_equals_interpreter_and_host():
    """The masked conditional blocks in a CUDA graph: bitwise equal to the
    interpreter on the card, and to the host within rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    main, _, fetch = _build(tfluid, _switch)
    feeds = [{"x": _ones(1, 4) * (k + 1),
              "c": np.full((1, 1), cv, np.float32)}
             for k, cv in enumerate((0.0, 1.0, 0.2, 0.9))]
    runs = {}
    for place, graph in ((tfluid.CUDAPlace(0), True),
                         (tfluid.CUDAPlace(0), False),
                         (tfluid.CPUPlace(), False)):
        with tflags.flag_guard(cuda_graph=graph):
            exe = tfluid.Executor(place)
            runs[(str(place), graph)] = [
                exe.run(main, feed=f, fetch_list=fetch) for f in feeds]
        if graph:
            assert exe.step_mode(main) == "graph"
    card, interp, host = runs.values()
    for c, i, h in zip(card, interp, host):
        for a, b, w in zip(c, i, h):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, w, rtol=1e-6)


def test_dynamic_rnn_lstm_of_the_reference_benchmark(
        recorded_graphs):  # noqa: F811
    """The reference benchmark's gate-by-gate LSTM in a DynamicRNN
    (chip_smoke.build_drnn_lstm; fc on the step input, which the JAX
    package cannot build: its step input has no shape, ROADMAP §3 item
    12), at width 8 over a vocabulary of 30: the first step's loss equals
    a numpy forward of the same cell from the same weights (rtol 1e-5),
    and 3 steps through the graph path are bitwise the interpreter's."""
    import chip_smoke

    with pytest.raises(ValueError, match="needs a known shape"):
        chip_smoke.build_drnn_lstm(jfluid, vocab=30, emb=8, hidden=8)
    main, startup, loss = chip_smoke.build_drnn_lstm(tfluid, vocab=30,
                                                     emb=8, hidden=8)
    rs = np.random.RandomState(6)
    seqs = [rs.randint(0, 30, n) for n in (5, 2, 7)]
    labels = np.array([[1], [0], [1]], np.int64)
    feed = {"words": tfluid.create_lod_tensor(
        [s.reshape(-1, 1).tolist() for s in seqs], None, tfluid.CPUPlace()),
        "label": labels}
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    init = convert.numpy_state(scope, main)

    W = {n: v.astype(np.float64) for n, v in init.items()}
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    probs = []
    for s in seqs:
        x = np.tanh(W["embedding_0.w_0"][s] @ W["fc_0.w_0"] + W["fc_0.w_1"])
        h = c = np.zeros(8)
        for x_t in x:
            g = [x_t @ W[f"fc_{2 * k + 1}.w_0"] + W[f"fc_{2 * k + 1}.w_1"]
                 + h @ W[f"fc_{2 * k + 2}.w_0"] for k in range(4)]
            c = sig(g[0]) * c + sig(g[1]) * np.tanh(g[3])
            h = sig(g[2]) * np.tanh(c)
        z = h @ W["fc_9.w_0"] + W["fc_9.w_1"]
        probs.append(np.exp(z - z.max()) / np.exp(z - z.max()).sum())
    want = -np.mean([np.log(p[y]) for p, y in zip(probs, labels[:, 0])])

    runs = {}
    for graph in (False, True):
        sc = tfluid.Scope()
        convert.load_numpy_state(sc, main, init, tfluid.CPUPlace())
        with tfluid.scope_guard(sc), tflags.flag_guard(cuda_graph=graph,
                                                       fuse=True):
            exe = tfluid.Executor(tfluid.CPUPlace())
            runs[graph] = [float(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0][0])
                           for _ in range(3)]
            assert exe.step_mode(main) == ("graph" if graph
                                           else "interpreter")
    np.testing.assert_allclose(runs[False][0], want, rtol=1e-5)
    assert runs[True] == runs[False]
    assert runs[False][2] < runs[False][0]
