"""The port's native inference predictor (paddle_tpu_torch/native: its own
copy of runtime.h and infer.cc, built into native/build/): a model trained
and saved by the port's Executor and io.py, served from C++ on the host,
against the port's Executor on the saved model; and bitwise the JAX
package's predictor on the same directory (the same sources, compiled the
same way). The JAX package's tests/test_native_infer.py, case for case.
"""

import os
import subprocess

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as fluid
from paddle_tpu.native import infer as jinfer
from paddle_tpu_torch.core.framework import Program, program_guard
from paddle_tpu_torch.native.infer import NativePredictor


def jax_native_library(tmp_dir, source):
    """The JAX package's `source` (paddle_tpu/native) compiled as its
    build.py compiles it, into `tmp_dir`: a private copy, so that no test
    here races the JAX package's own tests building into its directory."""
    src = os.path.join(os.path.dirname(paddle_tpu.__file__), "native",
                       source)
    out = os.path.join(str(tmp_dir), f"lib{source[:-3]}.so")
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o",
                    out, src], check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def _jax_library(tmp_path_factory):
    return jax_native_library(tmp_path_factory.mktemp("jax_native"),
                              "infer.cc")


@pytest.fixture(autouse=True)
def _jax_predictor(monkeypatch, _jax_library):
    monkeypatch.setattr(jinfer, "_lib", None)
    monkeypatch.setattr(jinfer, "infer_lib", lambda: _jax_library)


def _train_and_save(tmpdir, build_fn, feed_maker, steps=3):
    with fluid.unique_name.guard(), program_guard(Program(), Program()):
        feeds, targets, loss = build_fn()
        opt = fluid.optimizer.SGD(learning_rate=0.01)
        opt.minimize(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        for _ in range(steps):
            exe.run(feed=feed_maker(), fetch_list=[loss])
        fluid.io.save_inference_model(
            str(tmpdir), [v.name for v in feeds], targets, exe)
        # the Executor's outputs on the saved model
        with fluid.scope_guard(fluid.Scope()):
            prog, feed_names, fetch_targets = fluid.io.load_inference_model(
                str(tmpdir), exe)
            fd = feed_maker()
            want = exe.run(prog, feed={n: fd[n] for n in feed_names},
                           fetch_list=fetch_targets)
        return fd, [np.asarray(w) for w in want]


def _serve(tmpdir, feed):
    """The port's predictor's outputs, held bitwise to the JAX package's
    predictor on the same directory."""
    pred = NativePredictor(str(tmpdir))
    got = pred.run(feed)
    pred.close()
    jpred = jinfer.NativePredictor(str(tmpdir))
    jgot = jpred.run(feed)
    jpred.close()
    assert len(got) == len(jgot)
    for a, b in zip(got, jgot):
        np.testing.assert_array_equal(a, b)
    return got


def test_mlp_round_trip(tmp_path):
    rng = np.random.RandomState(7)

    def build():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        h = fluid.layers.fc(input=h, size=24, act="tanh")
        probs = fluid.layers.fc(input=h, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        return [x], [probs], loss

    def feed():
        return {"x": rng.randn(8, 16).astype(np.float32),
                "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}

    fd, want = _train_and_save(tmp_path, build, feed)
    pred = NativePredictor(str(tmp_path))
    assert pred.feed_names == ["x"]
    pred.close()
    got = _serve(tmp_path, {"x": fd["x"]})
    assert len(got) == 1 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got[0].sum(axis=1), np.ones(8), rtol=1e-5)


def test_cnn_round_trip(tmp_path):
    rng = np.random.RandomState(3)

    def build():
        img = fluid.layers.data(name="img", shape=[1, 12, 12],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                   padding=1, act="relu")
        bn = fluid.layers.batch_norm(input=conv)
        pool = fluid.layers.pool2d(input=bn, pool_size=2, pool_stride=2,
                                   pool_type="max")
        probs = fluid.layers.fc(input=pool, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        return [img], [probs], loss

    def feed():
        return {"img": rng.randn(4, 1, 12, 12).astype(np.float32),
                "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}

    fd, want = _train_and_save(tmp_path, build, feed)
    got = _serve(tmp_path, {"img": fd["img"]})
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=1e-5)


def test_embedding_round_trip(tmp_path):
    rng = np.random.RandomState(11)

    def build():
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(ids, size=[50, 8])
        y = fluid.layers.fc(input=emb, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=y, label=label))
        return [ids], [y], loss

    def feed():
        return {"ids": rng.randint(0, 50, (6, 1)).astype(np.int64),
                "label": rng.randn(6, 1).astype(np.float32)}

    fd, want = _train_and_save(tmp_path, build, feed)
    got = _serve(tmp_path, {"ids": fd["ids"]})
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=1e-6)


def test_errors_are_surfaced(tmp_path):
    with pytest.raises(RuntimeError, match="load failed"):
        NativePredictor(str(tmp_path / "nonexistent"))

    rng = np.random.RandomState(0)

    def build():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        y = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=y, label=label))
        return [x], [y], loss

    def feed():
        return {"x": rng.randn(3, 4).astype(np.float32),
                "label": rng.randn(3, 1).astype(np.float32)}

    _train_and_save(tmp_path, build, feed)
    pred = NativePredictor(str(tmp_path))
    with pytest.raises(ValueError, match="missing feeds"):
        pred.run({})
    pred.close()


def test_vgg16_round_trip(tmp_path):
    """A whole VGG-16 (batch norm, dropout in test mode) saved by the port
    serves through the native predictor within the JAX test's bound."""
    from paddle_tpu_torch.models.vgg import vgg16_bn_drop

    rng = np.random.RandomState(11)

    def build():
        img = fluid.layers.data(name="data", shape=[3, 32, 32],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        net = vgg16_bn_drop(img)
        probs = fluid.layers.fc(input=net, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        return [img], [probs], loss

    def feed():
        return {"data": rng.randn(2, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}

    fd, want = _train_and_save(tmp_path, build, feed, steps=2)
    got = _serve(tmp_path, {"data": fd["data"]})
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got[0].sum(axis=1), np.ones(2), rtol=1e-4)


def test_se_resnext_round_trip(tmp_path):
    """SE-ResNeXt-50: grouped convolutions (cardinality 32) and the SE
    gate's axis-broadcast elementwise_mul through the native predictor."""
    from paddle_tpu_torch.models.se_resnext import se_resnext

    rng = np.random.RandomState(13)

    def build():
        img = fluid.layers.data(name="data", shape=[3, 32, 32],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        probs = se_resnext(img, 10, depth=50)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        return [img], [probs], loss

    def feed():
        return {"data": rng.randn(2, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}

    fd, want = _train_and_save(tmp_path, build, feed, steps=2)
    got = _serve(tmp_path, {"data": fd["data"]})
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=1e-4)


def test_nhwc_program_refused_with_clear_error(tmp_path):
    """The C++ runtime is NCHW-only: an NHWC save is refused at load with
    a message naming the fix."""
    with fluid.unique_name.guard(), program_guard(Program(), Program()):
        img = fluid.layers.data(name="img", shape=[8, 8, 2],
                                dtype="float32")
        c = fluid.layers.conv2d(img, num_filters=3, filter_size=3,
                                padding=1, data_format="NHWC")
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        fluid.io.save_inference_model(str(tmp_path), ["img"], [c], exe)
    with pytest.raises(RuntimeError, match="NHWC"):
        NativePredictor(str(tmp_path))
