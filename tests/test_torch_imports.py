"""The port stands alone, and builds the same IR as the JAX package.

- importing paddle_tpu_torch (in a fresh interpreter) loads no jax module
  and no module of the JAX package; no source file of the port (the
  sequence, data-parallel, serving and input slices' among them), nor
  chip_smoke.py, nor the worker of the multi-rank tests, imports either;
- the same layer calls under a fresh unique_name.guard() give the same
  Program.desc_str() in both packages (ResNet, SE-ResNeXt-50, VGG-16,
  the MNIST conv net and the MLP) — the string the JAX package's
  compile cache digests — so var names, shapes and attrs map one to one.
  The one deliberate difference: the port's training-mode batch_norm_grad
  op does not read the running Mean/Variance. The inference program of
  each (io.get_inference_program of its prediction, what
  save_inference_model writes as `__model__`) is the same string too.
  Control flow (tests/test_torch_control_flow.py) has the same rule and
  one more difference: the port's IfElse splits the rows between its
  branches as the reference Fluid does (reference fault 10), so its
  program holds reduce_max, reduce_min, a 0.5 fill, two less_than ops,
  a split_lod_tensor in each branch and a merge_lod_tensor where the JAX
  package's holds one logical_not and a multiplex.
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


@pytest.mark.parametrize("module", [
    "monitor/step.py", "monitor/journal.py", "monitor/mfu.py",
    "monitor/skew.py", "health/__init__.py", "health/stats.py",
    "health/ledger.py", "health/detectors.py", "health/compare.py",
    "trace/costs.py", "cli.py", "__main__.py"])
def test_the_instruments_slice_is_among_the_checked_sources(module):
    """The run-time instruments' modules (the step monitor, health, the
    cost table, the CLI) are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "ops/loss_ops.py", "ops/metric_ops.py", "ops/nn_ops.py",
    "ops/math_ops.py", "ops/tensor_ops.py"])
def test_the_loss_and_nn_rest_slice_is_among_the_checked_sources(module):
    """The structured losses, the metrics and the rest of the nn ops are
    checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "recordio.py", "native/__init__.py", "native/build.py",
    "reader/__init__.py", "reader/creator.py", "reader/decorator.py",
    "minibatch.py", "data_feeder.py", "pipeline.py",
    "dataset/__init__.py", "dataset/common.py", "dataset/cifar.py",
    "dataset/conll05.py", "dataset/flowers.py", "dataset/imdb.py",
    "dataset/imikolov.py", "dataset/mnist.py", "dataset/movielens.py",
    "dataset/mq2007.py", "dataset/sentiment.py", "dataset/uci_housing.py",
    "dataset/voc2012.py", "dataset/wmt14.py", "dataset/wmt16.py",
    "datapipe/__init__.py", "datapipe/stats.py", "datapipe/source.py",
    "datapipe/parallel_map.py", "datapipe/batcher.py",
    "datapipe/process_map.py", "datapipe/shm.py", "datapipe/transfer.py",
    "datapipe/feeder.py", "datapipe/pipeline.py", "ops/reader_ops.py",
    "layers/io.py", "executor.py", "models/resnet.py"])
def test_the_input_slice_is_among_the_checked_sources(module):
    """The input path's modules (RecordIO, readers, datasets, the
    DataFeeder, the datapipe stages and the reader ops) are checked by the
    test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "ops/control_flow_ops.py", "ops/beam_search_ops.py",
    "layers/control_flow.py", "layers/learning_rate_scheduler.py",
    "models/machine_translation.py", "analysis/dataflow.py"])
def test_the_control_flow_slice_is_among_the_checked_sources(module):
    """Control flow, beam search and beam_decode are checked by the test
    above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "resilience/__init__.py", "resilience/errors.py", "resilience/retry.py",
    "resilience/nan_guard.py", "resilience/preempt.py",
    "resilience/watchdog.py", "resilience/chaos.py",
    "resilience/checkpoint.py", "resilience/loop.py", "trainer.py",
    "metrics.py", "evaluator.py", "executor.py", "parallel_executor.py",
    "cli.py", "health/__init__.py", "datapipe/process_map.py"])
def test_the_training_services_slice_is_among_the_checked_sources(module):
    """The training services (the Trainer, resilience, metrics and
    evaluators, the Executor's rest) are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "analysis/__init__.py", "analysis/verifier.py", "analysis/safety.py",
    "analysis/hbm.py", "analysis/plans.py", "cache/__init__.py",
    "cache/keys.py", "cache/store.py", "debugger.py", "concurrency.py",
    "ops/concurrency_ops.py", "layers/device.py"])
def test_the_compile_services_slice_is_among_the_checked_sources(module):
    """The compile-time services (FLAGS_verify, the compile cache, the
    debugger, CSP) are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "serve/continuous/__init__.py", "serve/continuous/slots.py",
    "serve/continuous/interop.py", "serve/continuous/scheduler.py",
    "serve/fleet/__init__.py", "serve/fleet/membership.py",
    "serve/fleet/health.py", "serve/fleet/policy.py",
    "serve/fleet/router.py", "serve/fleet/autoscaler.py",
    "parallel/master.py", "serve/http.py", "cli.py"])
def test_the_continuous_and_fleet_slice_is_among_the_checked_sources(
        module):
    """Continuous batching, the fleet and the membership table are
    checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.serve.continuous", "paddle_tpu_torch.serve.fleet",
    "paddle_tpu_torch.parallel.master"])
def test_serving_modules_load_no_jax_in_a_fresh_interpreter(module):
    """Importing each of the continuous/fleet modules alone, in a fresh
    interpreter, loads neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {module}\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert module in loaded
    assert [m for m in loaded if _foreign(m)] == []


def test_serve_exports_every_name_of_the_jax_packages():
    """paddle_tpu_torch.serve's __all__ holds every name of
    paddle_tpu.serve's, each of the same kind; the continuous and fleet
    subpackages hold every name of theirs."""
    import types

    from paddle_tpu import serve as jserve
    from paddle_tpu.serve import continuous as jcont
    from paddle_tpu.serve import fleet as jfleet

    from paddle_tpu_torch import serve as tserve
    from paddle_tpu_torch.serve import continuous as tcont
    from paddle_tpu_torch.serve import fleet as tfleet

    def kind(v):
        if isinstance(v, types.ModuleType):
            return "module"
        return "class" if isinstance(v, type) else "callable" \
            if callable(v) else type(v).__name__

    for jmod, tmod in ((jserve, tserve), (jcont, tcont),
                       (jfleet, tfleet)):
        assert sorted(set(jmod.__all__) - set(tmod.__all__)) == []
        for n in jmod.__all__:
            assert kind(getattr(tmod, n)) == kind(getattr(jmod, n)), n


def _cuda_marked(path):
    """Names of the test functions in `path` marked `cuda`."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and any(
                isinstance(d, ast.Attribute) and d.attr == "cuda"
                for d in node.decorator_list):
            out.append(node.name)
    return out


@pytest.mark.parametrize("module", [
    "core/selected_rows.py", "ops/sparse_ops.py", "ops/rpc_ops.py",
    "parallel/rpc.py", "transpiler/distribute_transpiler.py",
    "transpiler/ps_dispatcher.py",
    "transpiler/memory_optimization_transpiler.py", "layers/io.py",
    "trainer.py", "cli.py"])
def test_the_parameter_server_slice_is_among_the_checked_sources(module):
    """The parameter server (SelectedRows and the sparse table, the RPC
    runtime and its ops, the transpilers) is checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.parallel.rpc", "paddle_tpu_torch.transpiler"])
def test_parameter_server_modules_load_no_jax_in_a_fresh_interpreter(
        module):
    """Importing the RPC runtime or the transpilers alone, in a fresh
    interpreter, loads neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {module}\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert module in loaded
    assert [m for m in loaded if _foreign(m)] == []


@pytest.mark.parametrize("name", ["test_torch_continuous_card.py",
                                  "test_torch_fleet.py",
                                  "test_torch_pserver_card.py",
                                  "test_torch_detection_card.py",
                                  "test_torch_ring_pipeline_card.py"])
def test_the_new_serving_files_cuda_cases_skip_without_a_card(name):
    """Every `cuda`-marked test of the continuous, fleet and pserver
    files skips
    where there is no card (none fails, none passes); the card file
    imports no JAX."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the cases run")
    path = os.path.join(REPO, "tests", name)
    marked = _cuda_marked(path)
    assert marked
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", path, "-q", "-p",
         "no:cacheprovider", "-m", "cuda", "-rs"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert f"{len(marked)} skipped" in proc.stdout, proc.stdout[-2000:]
    if name.endswith("_card.py"):
        assert [m for m in _imported_modules(path) if _foreign(m)] == []
    assert " passed" not in proc.stdout and " failed" not in proc.stdout


@pytest.mark.parametrize("module", [
    "ops/detection_ops.py", "layers/detection.py", "evaluator.py",
    "native/build.py", "native/infer.py", "native/train.py"])
def test_the_detection_and_native_slice_is_among_the_checked_sources(
        module):
    """Detection (its ops, layers and the mAP evaluator) and the native
    CPU runtimes' bindings are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.native.infer", "paddle_tpu_torch.native.train",
    "paddle_tpu_torch.layers.detection"])
def test_detection_and_native_modules_load_no_jax_in_a_fresh_interpreter(
        module):
    """The native bindings and the detection layers, imported alone in a
    fresh interpreter, load neither jax nor the JAX package (the bindings
    keep their own copy of the NHWC guard)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {module}\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert module in loaded
    assert [m for m in loaded if _foreign(m)] == []


@pytest.mark.parametrize("module", [
    "parallel/ring.py", "parallel/mesh.py", "parallel/distributed.py",
    "parallel/pipeline/__init__.py", "parallel/pipeline/partition.py",
    "parallel/pipeline/rewrite.py", "parallel/pipeline/schedule.py",
    "parallel/pipeline/runner.py", "ops/collective_ops.py",
    "analysis/dataflow.py", "backward.py", "resilience/checkpoint.py"])
def test_the_ring_and_pipeline_slice_is_among_the_checked_sources(module):
    """Ring attention, the pipeline package, the permute ops and the
    PTA031 pairing are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.parallel.ring", "paddle_tpu_torch.parallel.pipeline"])
def test_ring_and_pipeline_modules_load_no_jax_in_a_fresh_interpreter(
        module):
    """The ring and the pipeline package, imported alone in a fresh
    interpreter, load neither jax nor the JAX package (the pipeline keeps
    its own copies of the JAX package's pure-Python schedule and
    partition)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {module}\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert module in loaded
    assert [m for m in loaded if _foreign(m)] == []


# the JAX parallel package's names the port leaves out, each with the
# ROADMAP queue 1 item that owns it: autoshard and the sharded embedding
# (item 6)
PARALLEL_EXCEPTIONS = {
    "autoshard": "item 6", "sharded_embedding": "item 6",
    "shard_table": "item 6", "sharded_embedding_lookup": "item 6",
}


def test_the_parallel_package_has_the_jax_packages_names():
    """The port's `parallel` lists every name of the JAX package's
    `parallel.__all__` but the stated exceptions (the ring's four names
    among them), and `parallel.pipeline` the JAX package's names."""
    import paddle_tpu.parallel as jpar
    import paddle_tpu.parallel.pipeline as jpipe
    import paddle_tpu_torch.parallel as tpar
    import paddle_tpu_torch.parallel.pipeline as tpipe

    assert sorted(set(jpar.__all__) - set(tpar.__all__)) == \
        sorted(PARALLEL_EXCEPTIONS)
    assert not set(PARALLEL_EXCEPTIONS) & set(dir(tpar))
    for n in ("ring_attention", "ring_attention_sharded",
              "ring_flash_attention", "ring_flash_attention_sharded",
              "pipeline", "ring", "elastic", "ElasticController",
              "Resized"):
        assert n in tpar.__all__ and hasattr(tpar, n), n
    assert sorted(tpipe.__all__) == sorted(jpipe.__all__)
    for n in tpipe.__all__:
        assert hasattr(tpipe, n), n


@pytest.mark.parametrize("module", [
    "parallel/master.py", "parallel/elastic.py", "cache/service.py",
    "cache/__init__.py", "obs/__init__.py", "obs/client.py",
    "obs/collector.py", "obs/timeline.py", "obs/top.py",
    "resilience/loop.py", "resilience/chaos.py", "cli.py"])
def test_the_control_plane_slice_is_among_the_checked_sources(module):
    """The elastic master and controller, the compile service's client
    and fleet observability are checked by the test above."""
    assert os.path.join(PORT, module) in set(_sources())


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.parallel.master", "paddle_tpu_torch.parallel.elastic",
    "paddle_tpu_torch.cache.service", "paddle_tpu_torch.obs"])
def test_control_plane_modules_load_no_jax_in_a_fresh_interpreter(module):
    """The control plane's modules, imported alone in a fresh
    interpreter, load neither jax nor the JAX package (the master keeps
    its own copy of the JAX package's pure-Python service)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {module}\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert module in loaded
    assert [m for m in loaded if _foreign(m)] == []


def test_the_elastic_worker_imports_only_the_port():
    """The worker the elastic tests run as their ranks
    (tests/torch_elastic_worker.py) imports neither jax nor the JAX
    package."""
    path = os.path.join(REPO, "tests", "torch_elastic_worker.py")
    bad = [m for m in _imported_modules(path) if _foreign(m)]
    assert bad == [], f"{path} imports {bad}"


def test_the_ring_worker_imports_only_the_port():
    """The worker the ring tests run as their ranks
    (tests/torch_ring_worker.py) imports neither jax nor the JAX
    package."""
    path = os.path.join(REPO, "tests", "torch_ring_worker.py")
    bad = [m for m in _imported_modules(path) if _foreign(m)]
    assert bad == [], f"{path} imports {bad}"


# the one name of the JAX package's top level the port leaves out:
# is_compiled_with_tpu, which asks JAX for a TPU
TOP_LEVEL_EXCEPTIONS = {"is_compiled_with_tpu"}


def _public_names(package):
    """dir() of `package` freshly imported in its own interpreter: in this
    one, other tests' imports of submodules (paddle_tpu.obs, ...) add
    names to it."""
    code = (f"import {package}\n"
            f"print(' '.join(n for n in dir({package}) "
            f"if not n.startswith('_')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_the_top_level_has_every_name_of_the_jax_packages():
    """dir() of the port's top level holds every public name of the JAX
    package's but the stated exceptions, and each name the JAX package
    lists in __all__ that the port has is of the same kind (a module, a
    class, a function)."""
    import types

    jnames = _public_names("paddle_tpu")
    tnames = _public_names("paddle_tpu_torch")
    assert sorted(jnames - tnames - TOP_LEVEL_EXCEPTIONS) == []
    assert TOP_LEVEL_EXCEPTIONS <= jnames
    assert not TOP_LEVEL_EXCEPTIONS & tnames

    def kind(v):
        if isinstance(v, types.ModuleType):
            return "module"
        return "class" if isinstance(v, type) else "callable" \
            if callable(v) else type(v).__name__

    for n in sorted(set(jfluid.__all__) & tnames):
        assert kind(getattr(tfluid, n)) == kind(getattr(jfluid, n)), n


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
