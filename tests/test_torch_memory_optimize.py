"""memory_optimize and release_memory in the port, held to the JAX
package on the CPU.

The same programs (an MLP under SGD, a conv net with batch norm under
Momentum, an embedding model) give the same renames and the same
desc_str() after memory_optimize, and the same delete_var insertions
after release_memory, in both packages (the conv net: the same vars
renamed and deleted, SAME_PROGRAM below says why); the optimized programs train to
the unoptimized one's losses and parameters, bitwise, on the interpreter
and on the recorded graph path, and memory_optimize's within rtol 1e-4
of the JAX package's optimized program from the same numpy start; on a
residual junction the JAX package's pass corrupts the gradients and the
port's does not (ROADMAP §3 item 25).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert, flags as tflags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

from test_torch_imports import _strip_bn_grad_running_stats
from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    tflags.reset()
    yield
    tflags.reset()


def _mlp(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = x
    for _ in range(3):
        h = fluid.layers.fc(input=h, size=32, act="relu")
    p = fluid.layers.fc(input=h, size=10, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=p, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _conv(fluid):
    x = fluid.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.conv2d(input=x, num_filters=8, filter_size=3,
                            padding=1, bias_attr=False)
    h = fluid.layers.batch_norm(input=h, act="relu")
    h = fluid.layers.conv2d(input=h, num_filters=8, filter_size=3,
                            padding=1, bias_attr=False)
    h = fluid.layers.batch_norm(input=h, act="relu")
    h = fluid.layers.pool2d(input=h, pool_size=2, pool_stride=2,
                            pool_type="max")
    p = fluid.layers.fc(input=h, size=10, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=p, label=y))
    fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss


def _emb(fluid):
    ids = fluid.layers.data(name="x", shape=[1], dtype="int64")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    e = fluid.layers.embedding(ids, size=[30, 8], is_sparse=True)
    h = fluid.layers.fc(input=e, size=16, act="tanh")
    p = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(input=p,
                                                            label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


MODELS = {"mlp": _mlp, "conv": _conv, "embedding": _emb}


def _build(fluid, model):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = MODELS[model](fluid)
    return main, startup, loss


def _feeds(model, steps=STEPS):
    rs = np.random.RandomState(7)
    if model == "embedding":
        return [{"x": rs.randint(0, 30, (12, 1)).astype(np.int64),
                 "y": rs.randn(12, 1).astype(np.float32)}
                for _ in range(steps)]
    shape = (12, 16) if model == "mlp" else (12, 3, 8, 8)
    return [{"x": rs.randn(*shape).astype(np.float32),
             "y": rs.randint(0, 10, (12, 1)).astype(np.int64)}
            for _ in range(steps)]


def _jax_desc(program):
    """The JAX program's desc_str() less the port's one deliberate
    difference (ROADMAP §3 item 4: training-mode batch_norm_grad reads no
    running Mean/Variance)."""
    return _strip_bn_grad_running_stats(program.desc_str())


# The reference's pass picks among a pool's same-shaped vars in set order.
# Where the two programs are the same (no batch norm) the sets are built
# alike and the picks agree; the conv net's batch_norm_grad reads fewer
# vars in the port (ROADMAP §3 item 4), so its sets may order their
# members differently: there the same vars are renamed (into vars of
# their dtype and shape) and the same vars deleted after the same ops.
SAME_PROGRAM = ["embedding", "mlp"]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_memory_optimize_renames_as_the_jax_package(model):
    jmain, _, _ = _build(jfluid, model)
    tmain, _, _ = _build(tfluid, model)
    gb = tmain.global_block()
    shapes = {n: (v.dtype, v.shape) for n, v in gb.vars.items()}
    jr = jfluid.memory_optimize(jmain)
    tr = tfluid.memory_optimize(tmain)
    assert tr and sorted(tr) == sorted(jr)
    assert all(shapes[a] == shapes[b] for a, b in tr.items())
    if model in SAME_PROGRAM:
        assert tr == jr
        assert tmain.desc_str() == _jax_desc(jmain)


def _deletions(program):
    ops = program.global_block().ops
    return [(i, sorted(op.input("X"))) for i, op in enumerate(ops)
            if op.type == "delete_var"]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_release_memory_inserts_as_the_jax_package(model):
    jmain, _, _ = _build(jfluid, model)
    tmain, _, _ = _build(tfluid, model)
    jfluid.release_memory(jmain)
    tfluid.release_memory(tmain)
    assert _deletions(tmain) == _deletions(jmain)
    assert _deletions(tmain)
    if model in SAME_PROGRAM:
        assert tmain.desc_str() == _jax_desc(jmain)


def _jax_start(model):
    main, startup, _ = _build(jfluid, model)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(scope.find_var(n)) for b in main.blocks
            for n, v in b.vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _run(fluid, model, init, feeds, rewrite=None):
    main, startup, loss = _build(fluid, model)
    if rewrite is not None:
        rewrite(fluid)(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    if fluid is jfluid:
        with jfluid.scope_guard(scope):
            exe.run(startup)
            for n, arr in init.items():
                scope.var(n)
                scope.set_var(n, arr)
            losses = [float(np.asarray(exe.run(
                main, feed=f, fetch_list=[loss])[0]).reshape(-1)[0])
                for f in feeds]
        return losses, None, None
    exe.run(startup, scope=scope)
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0]) for f in feeds]
    return losses, convert.numpy_state(scope, main), exe.step_mode(main)


REWRITES = {"memory_optimize": lambda f: f.memory_optimize,
            "release_memory": lambda f: f.release_memory}


@pytest.mark.parametrize("rewrite", sorted(REWRITES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_an_optimized_program_trains_as_the_unoptimized(model, rewrite):
    init = _jax_start(model)
    feeds = _feeds(model)
    want = _run(tfluid, model, init, feeds)
    got = _run(tfluid, model, init, feeds, REWRITES[rewrite])
    assert got[0] == want[0]
    for n in want[1]:
        np.testing.assert_array_equal(got[1][n], want[1][n], err_msg=n)
    if rewrite == "memory_optimize":  # the JAX package runs the other
        # (a program with a host op) op by op, which adds nothing here
        jax_ = _run(jfluid, model, init, feeds, REWRITES[rewrite])
        np.testing.assert_allclose(got[0], jax_[0], rtol=1e-4)


@pytest.mark.parametrize("model", ["mlp", "conv"])
def test_an_optimized_program_is_captured_as_the_interpreter_runs_it(
        recorded_graphs, model):  # noqa: F811
    """memory_optimize keeps no host op: its program takes the graph path,
    whose losses and state are the interpreter's, bitwise."""
    init = _jax_start(model)
    feeds = _feeds(model)
    graph = _run(tfluid, model, init, feeds, REWRITES["memory_optimize"])
    with tflags.flag_guard(cuda_graph=False):
        interp = _run(tfluid, model, init, feeds,
                      REWRITES["memory_optimize"])
    assert (graph[2], interp[2]) == ("graph", "interpreter")
    assert graph[0] == interp[0]
    for n in interp[1]:
        np.testing.assert_array_equal(graph[1][n], interp[1][n], err_msg=n)


def _residual(fluid):
    """A residual junction: out = h + fc(h), h = fc(x), no biases. h has two
    consumers, so h@GRAD is written twice (the add's grad, then a sum with
    the branch's part), and h, dead after the branch's mul_grad, is then
    the pool's one var of h's shape: the JAX pass's pick is forced."""
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=24, bias_attr=False)
    b = fluid.layers.fc(input=h, size=1, bias_attr=False)
    out = fluid.layers.elementwise_add(h, b, axis=0)
    p = fluid.layers.fc(input=out, size=10, act="softmax", bias_attr=False)
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=p, label=y))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return loss


def test_a_residual_net_keeps_its_losses_where_the_jax_package_does_not():
    """ROADMAP §3 item 25: a residual block's input gradient is written
    twice (its first part, then a `sum` in place). The JAX package's pass
    renames it at the sum into the block input, which died just before,
    and so moves the first write into the input while a grad op still
    reads it: its second loss differs from the unoptimized program's (on
    every residual network: the headline's ResNet-50 among them). The
    port leaves a var with two writers out of the pool: bitwise."""
    MODELS["resnet"] = _residual
    try:
        init = _jax_start("resnet")
        feeds = _feeds("mlp", 2)
        jplain = _run(jfluid, "resnet", init, feeds)[0]
        jopt = _run(jfluid, "resnet", init, feeds,
                    REWRITES["memory_optimize"])[0]
        assert jopt[0] == jplain[0] and jopt[1] != jplain[1]
        want = _run(tfluid, "resnet", init, feeds)
        got = _run(tfluid, "resnet", init, feeds,
                   REWRITES["memory_optimize"])
        assert got[0] == want[0]
        for n in want[1]:
            np.testing.assert_array_equal(got[1][n], want[1][n], err_msg=n)
        jmain, _, _ = _build(jfluid, "resnet")
        tmain, _, _ = _build(tfluid, "resnet")
        jr, tr = jfluid.memory_optimize(jmain), tfluid.memory_optimize(tmain)
        twice = {x for x in jr if x.endswith("@GRAD") and sum(
            x in op.output_arg_names() for op in
            _build(tfluid, "resnet")[0].global_block().ops) > 1}
        assert twice and not twice & set(tr)
    finally:
        del MODELS["resnet"]
