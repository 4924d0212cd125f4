"""The port's native training runtime (paddle_tpu_torch/native: its own
copy of runtime.h and train.cc, built into native/build/): a training
program saved by the port's io.save_train_model, initialized and trained
from C++ with no Python in the loop, against the port's Executor step for
step; and bitwise the JAX package's trainer on the same directory. The JAX
package's tests/test_native_train.py, case for case.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu.native import train as jtrain
from paddle_tpu_torch.core.framework import Program, program_guard
from paddle_tpu_torch.native.train import NativeTrainer
from test_torch_native_infer import jax_native_library


@pytest.fixture(scope="module")
def _jax_library(tmp_path_factory):
    return jax_native_library(tmp_path_factory.mktemp("jax_native"),
                              "train.cc")


@pytest.fixture(autouse=True)
def _jax_trainer(monkeypatch, _jax_library):
    monkeypatch.setattr(jtrain, "_lib", None)
    monkeypatch.setattr(jtrain, "train_lib", lambda: _jax_library)


def _build_and_save(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    d = str(tmp_path / "train_model")
    fluid.io.save_train_model(d, ["x", "y"], loss, main, startup)
    return d, main, startup, loss


def _executor_losses(main, startup, loss, init, batches):
    """The port's Executor from the native runtime's initial parameters
    (the two runtimes draw other random numbers)."""
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        for n, v in init.items():
            scope.set_var(n, torch.from_numpy(np.ascontiguousarray(v)))
        losses = [float(np.asarray(exe.run(main, feed=b,
                                           fetch_list=[loss])[0]).item())
                  for b in batches]
    return losses, scope


def test_native_train_converges(tmp_path):
    d, *_ = _build_and_save(tmp_path)
    tr, jtr = NativeTrainer(d), jtrain.NativeTrainer(d)
    rs = np.random.RandomState(0)
    W = rs.randn(4, 1).astype("float32")
    losses = []
    for _ in range(60):
        xv = rs.randn(16, 4).astype("float32")
        b = {"x": xv, "y": xv @ W}
        losses.append(tr.step(b))
        assert jtr.step(b) == losses[-1]  # the same sources, bitwise
    assert all(np.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    w = tr.get_var("fc_0.w_0")
    assert w.shape == (4, 1)
    np.testing.assert_allclose(w, W, atol=0.15)
    np.testing.assert_array_equal(w, jtr.get_var("fc_0.w_0"))


def test_native_train_matches_the_executor(tmp_path):
    """Same program, same data, same updates: the C++ loop tracks the
    port's Executor step for step (fp32, same op order)."""
    d, main, startup, loss = _build_and_save(tmp_path)
    rs = np.random.RandomState(3)
    W = rs.randn(4, 1).astype("float32")
    batches = []
    for _ in range(10):
        xv = rs.randn(8, 4).astype("float32")
        batches.append({"x": xv, "y": (xv @ W).astype("float32")})
    tr = NativeTrainer(d)
    init = {n: tr.get_var(n) for n in ("fc_0.w_0", "fc_0.w_1")}
    native_losses = [tr.step(b) for b in batches]
    py_losses, _ = _executor_losses(main, startup, loss, init, batches)
    np.testing.assert_allclose(native_losses, py_losses, rtol=2e-4,
                               atol=1e-5)


def test_trainer_refuses_nhwc_program(tmp_path):
    """The predictor's NCHW-only guard on the __train__ schema."""
    main, startup = Program(), Program()
    with fluid.unique_name.guard(), program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[8, 8, 2],
                                dtype="float32")
        c = fluid.layers.conv2d(img, num_filters=3, filter_size=3,
                                padding=1, data_format="NHWC")
        loss = fluid.layers.mean(c)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
        fluid.io.save_train_model(str(tmp_path), ["img"], loss, main,
                                  startup)
    with pytest.raises(RuntimeError, match="NHWC"):
        NativeTrainer(str(tmp_path))


def _build_and_save_cnn(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 8, 8],
                                dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                padding=1, act="relu")
        b = fluid.layers.batch_norm(c)
        p = fluid.layers.pool2d(b, pool_size=2, pool_stride=2,
                                pool_type="max")
        pred = fluid.layers.fc(input=p, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Momentum(
            learning_rate=0.01, momentum=0.9).minimize(loss)
    d = str(tmp_path / "cnn_train_model")
    fluid.io.save_train_model(d, ["img", "y"], loss, main, startup)
    return d, main, startup, loss


def test_native_cnn_train_converges(tmp_path):
    """conv2d_grad, pool2d_grad, training-mode batch_norm and momentum
    run in C++."""
    d, *_ = _build_and_save_cnn(tmp_path)
    tr = NativeTrainer(d)
    rs = np.random.RandomState(0)
    xv = rs.randn(8, 1, 8, 8).astype("float32")
    yv = (xv.mean(axis=(1, 2, 3))[:, None] * 2.0).astype("float32")
    losses = [tr.step({"img": xv, "y": yv}) for _ in range(25)]
    assert all(np.isfinite(l) for l in losses), losses
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


def test_native_cnn_matches_the_executor(tmp_path):
    """Step for step on the CNN path from one initial state: the losses,
    and batch norm's running mean folded alike."""
    d, main, startup, loss = _build_and_save_cnn(tmp_path)
    rs = np.random.RandomState(3)
    batches = []
    for _ in range(6):
        xv = rs.randn(4, 1, 8, 8).astype("float32")
        yv = (xv.mean(axis=(1, 2, 3))[:, None] * 2.0).astype("float32")
        batches.append({"img": xv, "y": yv})
    tr = NativeTrainer(d)
    params = ["conv2d_0.w_0", "conv2d_0.w_1", "batch_norm_0.w_0",
              "batch_norm_0.w_1", "batch_norm_0.w_2", "batch_norm_0.w_3",
              "fc_0.w_0", "fc_0.w_1"]
    init = {n: tr.get_var(n) for n in params}
    native_losses = [tr.step(b) for b in batches]
    native_mean = tr.get_var("batch_norm_0.w_2")
    py_losses, scope = _executor_losses(main, startup, loss, init, batches)
    py_mean = np.asarray(scope.find_var("batch_norm_0.w_2"))
    np.testing.assert_allclose(native_losses, py_losses, rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(native_mean, py_mean, rtol=1e-3, atol=1e-5)


def test_native_classifier_matches_the_executor(tmp_path):
    """softmax + cross_entropy (hard labels) backward in C++."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=12, act="relu")
        probs = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        d = str(tmp_path / "cls")
        fluid.io.save_train_model(d, ["x", "label"], loss, main, startup)
    rs = np.random.RandomState(5)
    batches = [{"x": rs.randn(8, 8).astype("float32"),
                "label": rs.randint(0, 4, (8, 1)).astype("int64")}
               for _ in range(8)]
    tr = NativeTrainer(d)
    init = {n: tr.get_var(n)
            for n in ("fc_0.w_0", "fc_0.w_1", "fc_1.w_0", "fc_1.w_1")}
    native_losses = [tr.step(b) for b in batches]
    py_losses, _ = _executor_losses(main, startup, loss, init, batches)
    np.testing.assert_allclose(native_losses, py_losses, rtol=2e-3,
                               atol=2e-4)
    assert native_losses[-1] < native_losses[0], native_losses
