"""The port stands alone, and builds the same IR as the JAX package.

- importing paddle_tpu_torch (in a fresh interpreter) loads no jax module
  and no module of the JAX package; no source file of the port (the
  sequence, data-parallel and serving slices' among them), nor
  chip_smoke.py, nor the worker of the multi-rank tests, imports either;
- the same layer calls under a fresh unique_name.guard() give the same
  Program.desc_str() in both packages (ResNet, SE-ResNeXt-50, VGG-16,
  the MNIST conv net and the MLP) — the string the JAX package's
  compile cache digests — so var names, shapes and attrs map one to one.
  The one deliberate difference: the port's training-mode batch_norm_grad
  op does not read the running Mean/Variance. The inference program of
  each (io.get_inference_program of its prediction, what
  save_inference_model writes as `__model__`) is the same string too.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _foreign(name):
    return name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    # measured as what the import itself adds: an interpreter's site hooks
    # may preload modules before any user code runs
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(new))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "paddle_tpu_torch" in loaded
    assert [m for m in loaded if _foreign(m)] == []


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _foreign(m)]
    assert bad == [], f"{path} imports {bad}"


@pytest.mark.parametrize("module", [
    "core/lod_tensor.py", "ops/sparse_ops.py", "ops/sequence_ops.py",
    "ops/rnn_ops.py", "models/stacked_dynamic_lstm.py",
    "models/machine_translation.py"])
def test_the_sequence_slice_is_among_the_checked_sources(module):
    """The sequence slice's modules are checked by the test above: the walk
    over the package finds each of them."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "parallel_executor.py", "parallel/distributed.py", "parallel/mesh.py",
    "parallel/api.py", "parallel/zero1.py", "ops/collective_ops.py"])
def test_the_data_parallel_slice_is_among_the_checked_sources(module):
    """The data-parallel slice's modules are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "io.py", "ops/io_ops.py", "transpiler/__init__.py",
    "transpiler/inference_transpiler.py", "trainer.py", "inferencer.py",
    "profiler.py", "monitor/__init__.py", "monitor/registry.py",
    "trace/__init__.py", "trace/span.py", "trace/recorder.py",
    "trace/export.py", "serve/__init__.py", "serve/buckets.py",
    "serve/engine.py", "serve/http.py"])
def test_the_serving_slice_is_among_the_checked_sources(module):
    """The serving slice's modules are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


def test_the_multi_rank_worker_imports_only_the_port():
    """The worker the multi-rank tests run as their ranks
    (tests/torch_dp_worker.py) imports neither jax nor the JAX package."""
    path = os.path.join(REPO, "tests", "torch_dp_worker.py")
    bad = [m for m in _imported_modules(path) if _foreign(m)]
    assert bad == [], f"{path} imports {bad}"


def _build(fluid, models, model, train):
    main, startup, _ = _build_net(fluid, models, model, train)
    return main, startup


def _build_net(fluid, models, model, train):
    """(main, startup, the prediction var) of `model`."""
    resnet = models.resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if model == "mlp":
            img = fluid.layers.data(name="img", shape=[784], dtype="float32")
            hidden = fluid.layers.fc(input=img, size=200, act="relu")
            probs = fluid.layers.fc(input=hidden, size=10, act="softmax")
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-3)
        elif model == "resnet50_nhwc":
            img = fluid.layers.data(name="data", shape=[224, 224, 3],
                                    dtype="float32")
            probs = resnet.resnet_imagenet(img, 1000, depth=50, layout="NHWC")
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        elif model == "se_resnext50":
            img = fluid.layers.data(name="data", shape=[3, 224, 224],
                                    dtype="float32")
            probs = models.se_resnext.se_resnext(img, 1000, depth=50)
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        elif model == "vgg16":
            img = fluid.layers.data(name="pixel", shape=[3, 224, 224],
                                    dtype="float32")
            probs = fluid.layers.fc(input=models.vgg.vgg16_bn_drop(img),
                                    size=102, act="softmax")
            opt = fluid.optimizer.Adam(learning_rate=1e-3)
        elif model == "mnist_cnn":
            img = fluid.layers.data(name="pixel", shape=[1, 28, 28],
                                    dtype="float32")
            probs = models.mnist.cnn_model(img)
            opt = fluid.optimizer.AdamOptimizer(learning_rate=0.001,
                                                beta1=0.9, beta2=0.999)
        else:
            img = fluid.layers.data(name="data", shape=[3, 32, 32],
                                    dtype="float32")
            probs = resnet.resnet_cifar10(img, 10, depth=8)
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        if model in ("se_resnext50", "vgg16", "mnist_cnn"):
            fluid.layers.accuracy(input=probs, label=label)
        if train:
            opt.minimize(loss)
    return main, startup, probs


def _strip_bn_grad_running_stats(desc):
    """The JAX desc with Mean/Variance removed from training-mode
    batch_norm_grad inputs — the port's one deliberate difference."""
    d = json.loads(desc)
    for block in d["blocks"]:
        for op in block["ops"]:
            if op["type"] == "batch_norm_grad" \
                    and not op["attrs"].get("is_test", False):
                op["inputs"].pop("Mean", None)
                op["inputs"].pop("Variance", None)
    return json.dumps(d, sort_keys=True)


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
@pytest.mark.parametrize("model", ["resnet_cifar10_8", "resnet50_nhwc", "mlp",
                                   "se_resnext50", "vgg16", "mnist_cnn"])
def test_same_layer_calls_give_the_same_program(model, train):
    jmain, jstart = _build(jfluid, jmodels, model, train)
    tmain, tstart = _build(tfluid, tmodels, model, train)
    assert tstart.desc_str() == jstart.desc_str()
    assert tmain.desc_str() == _strip_bn_grad_running_stats(jmain.desc_str())
    if model in ("mlp", "mnist_cnn") or not train:
        assert tmain.desc_str() == jmain.desc_str()


@pytest.mark.parametrize("model", ["resnet_cifar10_8", "resnet50_nhwc", "mlp",
                                   "se_resnext50", "vgg16", "mnist_cnn"])
def test_same_inference_program(model):
    """A trained program pruned to its prediction (the `__model__` of
    save_inference_model) is the same in both packages."""
    jmain, _, jprobs = _build_net(jfluid, jmodels, model, True)
    tmain, _, tprobs = _build_net(tfluid, tmodels, model, True)
    jinf = jfluid.io.get_inference_program([jprobs], jmain)
    tinf = tfluid.io.get_inference_program([tprobs], tmain)
    assert tinf.desc_str() == jinf.desc_str()
    assert not any(op.type.endswith("_grad") or op.type in (
        "momentum", "adam") for op in tinf.global_block().ops)
