"""get_model's readers and the DataFeeder on the port against the JAX
package: for each of the six benchmark models, the first batch of the
train reader equals the JAX one's (Python's `random` seeded the same
before each; DATA_HOME an empty directory, so every dataset is its
synthetic stand-in and nothing reaches the network); the port's DataFeeder
feed equals the JAX DataFeeder's, dense and ragged; the MNIST conv net and
the stacked LSTM trained 2 steps from weights carried across by
convert.py agree within rtol 1e-4 (fp32). The full-depth image models
(ResNet-50, VGG-16, SE-ResNeXt-50 at 224x224) are not trained here: their
readers are compared above, their narrow networks train against the JAX
package in tests/test_torch_image_models.py, and chip_smoke.py's phase
input takes a card step of each from its reader.
"""

import random

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu.dataset import common as jcommon

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.dataset import common as tcommon

MODELS = ["resnet", "se_resnext", "vgg", "mnist", "stacked_dynamic_lstm",
          "machine_translation"]


class _Args:
    batch_size = 4
    data_set = "flowers"
    max_seq_len = 128
    learning_rate = 2e-4


@pytest.fixture(autouse=True)
def empty_data_home(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    monkeypatch.setattr(jcommon, "DATA_HOME", str(tmp_path))
    monkeypatch.setattr(tcommon, "DATA_HOME", str(tmp_path))


def _get_model(package, models, name, args=_Args):
    main, startup = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(main, startup):
        out = getattr(models, name).get_model(args())
        out[2].minimize(out[0])
    return main, startup, out


def _first_batch(package, models, name):
    main, _, out = _get_model(package, models, name)
    random.seed(1234)
    return main, next(out[3]())


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", MODELS)
def test_first_train_batch_equals_the_jax_packages(name):
    jmain, jb = _first_batch(jfluid, jmodels, name)
    tmain, tb = _first_batch(tfluid, tmodels, name)
    assert len(tb) == len(jb) == _Args.batch_size
    _same(tb, jb)


def _feeds(name):
    """The first train batch through each package's DataFeeder over the
    model's data vars: ({name: jax LoDTensor}, {name: port LoDTensor})."""
    out = []
    for package, models in ((jfluid, jmodels), (tfluid, tmodels)):
        main, batch = _first_batch(package, models, name)
        slots = [v for v in main.global_block().vars.values() if v.is_data]
        feeder = package.DataFeeder(feed_list=slots,
                                    place=package.CPUPlace(), program=main)
        out.append(feeder.feed(batch))
    return out


@pytest.mark.parametrize("name", ["mnist", "stacked_dynamic_lstm",
                                  "machine_translation"])
def test_data_feeder_feed_equals_the_jax_packages(name):
    jfeed, tfeed = _feeds(name)
    assert sorted(tfeed) == sorted(jfeed)
    for n in jfeed:
        np.testing.assert_array_equal(tfeed[n].numpy(), jfeed[n].numpy())
        assert tfeed[n].numpy().dtype == jfeed[n].numpy().dtype
        assert tfeed[n].lod() == jfeed[n].lod()
    if name != "mnist":
        assert any(tfeed[n].lod() for n in tfeed)  # a ragged slot


def test_bucket_matches_the_jax_package():
    from paddle_tpu import data_feeder as jdf

    from paddle_tpu_torch import data_feeder as tdf

    for n in list(range(0, 70)) + [100, 1000, 5000]:
        assert tdf._bucket(n) == jdf._bucket(n)


def _train_two_steps(name):
    """(jax losses, port losses) of 2 steps on the first two train batches,
    the port starting from the JAX package's initial weights."""
    out = {}
    init = None
    for key, package, models in (("jax", jfluid, jmodels),
                                 ("port", tfluid, tmodels)):
        main, startup, model = _get_model(package, models, name)
        main.random_seed = startup.random_seed = 7
        random.seed(1234)
        it = model[3]()
        batches = [next(it), next(it)]
        slots = [v for v in main.global_block().vars.values() if v.is_data]
        feeder = package.DataFeeder(feed_list=slots,
                                    place=package.CPUPlace(), program=main)
        exe = package.Executor(package.CPUPlace())
        scope = package.Scope()
        with package.scope_guard(scope):
            exe.run(startup)
            if init is None:
                init = {n: np.asarray(scope.find_var(n))
                        for n, v in main.global_block().vars.items()
                        if v.persistable and scope.find_var(n) is not None}
            else:
                convert.load_numpy_state(scope, main, init,
                                         tfluid.CPUPlace())
            out[key] = [float(np.asarray(exe.run(
                main, feed=feeder.feed(b), fetch_list=[model[0]])[0])
                .reshape(-1)[0]) for b in batches]
    return np.array(out["jax"]), np.array(out["port"])


@pytest.mark.parametrize("name", ["mnist", "stacked_dynamic_lstm"])
def test_two_steps_agree_with_the_jax_package(name):
    jl, tl = _train_two_steps(name)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
