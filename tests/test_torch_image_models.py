"""The image-classification family in the port against the JAX package:
the MNIST conv net, VGG (img_conv_group) and SE-ResNeXt, end to end.

Each model is built by the same layer calls in both packages, the JAX
package's initial state is carried into the port with
convert.load_numpy_state, and the same 3 batches are fed: per-step losses
agree within rtol 1e-4 in fp32 and 2e-2 under bf16 AMP (the bounds of
tests/test_torch_train.py and tests/test_torch_amp.py, reasoned there).
The port runs its fused bucket updates (FLAGS_fuse), the JAX package its
plain optimizer ops: its fusion pass refuses programs with batch norm
(tests/test_torch_train.py says why), and inside each package fused and
unfused updates are bitwise equal.

Dropout: the two packages draw different masks from one seed (the JAX
package from fold_in(PRNGKey(seed), step), the port from its program's
RandomStream), so a loss comparison needs both to drop the same elements.
Here each package's registered `dropout` kernel is replaced, for the
test only, by one that takes its mask from a numpy array named by the
op's Mask output, the same array on both sides; both packages' own
`dropout_grad` then reads that mask. The drawing kernel itself is tested
on the port alone (tests/test_torch_random_ops.py), and one test below
trains with it unpatched.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import amp as jamp
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import vgg as jvgg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import vgg as tvgg

STEPS = 3
LOSS_RTOL = {False: 1e-4, True: 2e-2}
JAX_MODELS = {"mnist": jmnist, "vgg": jvgg, "se_resnext": jse}
PORT_MODELS = {"mnist": tmnist, "vgg": tvgg, "se_resnext": tse}


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


# ---------------------------------------------------------------------------
# the models, narrow and whole
# ---------------------------------------------------------------------------
def _narrow_vgg(fluid, vgg, img):
    """vgg16_bn_drop's layer sequence with 2 img_conv_group blocks of 8
    and 16 filters and a 16-wide head."""
    def conv_block(input, num_filter, groups, dropouts):
        return fluid.nets.img_conv_group(
            input=input, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv = conv_block(conv_block(img, 8, 2, [0.3, 0]), 16, 2, [0.4, 0])
    drop = fluid.layers.dropout(x=conv, dropout_prob=0.5)
    fc1 = fluid.layers.fc(input=drop, size=16, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu")
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
    return fluid.layers.fc(input=drop2, size=16, act=None)


def _narrow_se_resnext(fluid, se, img):
    """The module's own blocks: a 16-filter stem, two SE bottlenecks of
    cardinality 4 and reduction 4 (8 then 16 filters, 16 then 32 out,
    the second with stride 2), global pool, dropout 0.2, classifier."""
    conv = se.conv_bn_layer(img, 16, 3, act="relu")
    conv = se.bottleneck_block(conv, 8, 1, 4, 4)
    conv = se.bottleneck_block(conv, 16, 2, 4, 4)
    pool = fluid.layers.pool2d(input=conv, pool_type="avg",
                               global_pooling=True)
    drop = fluid.layers.dropout(x=pool, dropout_prob=0.2)
    return fluid.layers.fc(input=drop, size=10, act="softmax")


SHAPES = {"mnist": [1, 28, 28], "vgg_narrow": [3, 16, 16],
          "se_narrow": [3, 16, 16], "se_resnext50": [3, 32, 32]}


def _build(fluid, model):
    """(main, startup, loss, accuracy) of `model` with its optimizer: Adam
    for MNIST and VGG, Momentum for SE-ResNeXt (as their get_model)."""
    mods = JAX_MODELS if fluid is jfluid else PORT_MODELS
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=SHAPES[model],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if model == "mnist":
            probs = mods["mnist"].cnn_model(img)
            opt = fluid.optimizer.AdamOptimizer(
                learning_rate=0.001, beta1=0.9, beta2=0.999)
        elif model == "vgg_narrow":
            net = _narrow_vgg(fluid, mods["vgg"], img)
            probs = fluid.layers.fc(input=net, size=10, act="softmax")
            opt = fluid.optimizer.Adam(learning_rate=1e-3)
        else:
            if model == "se_narrow":
                probs = _narrow_se_resnext(fluid, mods["se_resnext"], img)
            else:
                probs = mods["se_resnext"].se_resnext(img, 10, depth=50)
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        acc = fluid.layers.accuracy(input=probs, label=label)
        opt.minimize(loss)
    return main, startup, loss, acc


def _batches(model, n=STEPS, batch=4, seed=3):
    rs = np.random.RandomState(seed)
    return [{"img": rs.rand(batch, *SHAPES[model]).astype(np.float32),
             "label": rs.randint(0, 10, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# one numpy mask per dropout op, the same in both packages
# ---------------------------------------------------------------------------
def _mask(name, shape, p):
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    return (rs.rand(*shape) >= p).astype(np.float32)


def _jax_dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    name = ctx.current_op.output("Mask")[0]
    m = jnp.asarray(_mask(name, x.shape, p)).astype(x.dtype)
    return {"Out": [x * m], "Mask": [m]}


def _port_dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    name = ctx.current_op.output("Mask")[0]
    m = torch.from_numpy(_mask(name, tuple(x.shape), p)).to(x.dtype)
    return {"Out": [x * m], "Mask": [m]}


@pytest.fixture
def same_masks(monkeypatch):
    monkeypatch.setattr(jreg.get_op_def("dropout"), "fn", _jax_dropout)
    monkeypatch.setattr(treg.get_op_def("dropout"), "fn", _port_dropout)


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable)


def _run_jax(model, batches):
    main, startup, loss, _ = _build(jfluid, model)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                  for b in batches]
    return init, np.stack(losses).reshape(-1)


def _run_port(model, init, batches, fuse=True):
    main, _, loss, _ = _build(tfluid, model)
    place = tfluid.CPUPlace()
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    exe = tfluid.Executor(place)
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=fuse):
        losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                  for b in batches]
    plans = [p for _, p, _ in exe._prepared.values() if p is not None]
    return (np.stack(losses).reshape(-1), convert.numpy_state(scope, main),
            [b["opt"] for p in plans for b in p.buckets])


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["mnist", "vgg_narrow", "se_narrow"])
def test_training_tracks_jax(same_masks, model, amp):
    batches = _batches(model)
    with jamp.auto_cast(enabled=amp):
        init, jax_losses = _run_jax(model, batches)
    with tamp.auto_cast(enabled=amp):
        losses, final, buckets = _run_port(model, init, batches)
    assert ("momentum" if model.startswith("se") else "adam") in buckets
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL[amp])
    for n, v in final.items():
        assert v.dtype != np.float16 and v.dtype.kind != "V", n
        if v.dtype.kind == "f":
            assert v.dtype == np.float32, (n, v.dtype)


def test_whole_se_resnext50_one_step_tracks_jax(same_masks):
    """se_resnext(depth=50) at its published widths (cardinality 32,
    reduction 16, 128..1024 filters) on 32x32 input, 10 classes: one fused
    Momentum step, batch 8. At 32x32 the last stage is 1x1, so its batch
    norms normalise over the batch alone; at batch 2 that is two values a
    channel, whose one-pass variance E[x^2] - E[x]^2 cancels to a few f32
    ulps that the normalisation then scales up: there the two packages'
    rounding differences alone put the losses outside rtol 1e-4 (this
    test fails at batch=2), an ill-conditioned input rather than a
    difference of the kernels."""
    batches = _batches("se_resnext50", n=1, batch=8)
    init, jax_losses = _run_jax("se_resnext50", batches)
    losses, _, buckets = _run_port("se_resnext50", init, batches)
    assert "momentum" in buckets
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL[False])


def test_fused_and_unfused_training_are_bitwise_equal(same_masks):
    """Inside the port FLAGS_fuse changes nothing but the op count, with
    Adam (VGG) as with Momentum (tests/test_torch_train.py)."""
    batches = _batches("vgg_narrow")
    init, _ = _run_jax("vgg_narrow", batches)
    fused, fused_state, _ = _run_port("vgg_narrow", init, batches)
    plain, plain_state, buckets = _run_port("vgg_narrow", init, batches,
                                            fuse=False)
    assert buckets == []
    np.testing.assert_array_equal(fused, plain)
    for n in plain_state:
        np.testing.assert_array_equal(fused_state[n], plain_state[n],
                                      err_msg=n)


# ---------------------------------------------------------------------------
# the port alone: real dropout, shapes, get_model
# ---------------------------------------------------------------------------
def _train_unpatched(seed, steps=10):
    main, startup, loss, acc = _build(tfluid, "vgg_narrow")
    main.random_seed = startup.random_seed = seed
    batch = _batches("vgg_narrow", n=1, batch=16)[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()), tflags.flag_guard(fuse=True):
        exe.run(startup)
        out = [exe.run(main, feed=batch, fetch_list=[loss, acc])
               for _ in range(steps)]
    return np.array([o[0].reshape(-1)[0] for o in out]), out[-1][1]


def test_training_with_real_dropout_falls_and_is_reproducible():
    """Narrow VGG with its three dropout ops drawing from the program's
    stream, 10 Adam steps on one batch: the loss falls, and the same
    random_seed gives the same losses bitwise."""
    losses, acc = _train_unpatched(seed=5)
    assert np.all(np.isfinite(losses))
    assert losses[-2:].mean() < losses[:2].mean()
    assert acc.shape == (1,) and 0.0 <= acc[0] <= 1.0
    np.testing.assert_array_equal(_train_unpatched(seed=5)[0], losses)
    assert not np.array_equal(_train_unpatched(seed=6)[0], losses)


def test_declared_shapes_match_the_kernels():
    """The shape contracts (core/shape_inference.py) of this slice's ops
    against what their kernels return: every output of sigmoid,
    elementwise_mul, dropout, top_k and accuracy in a narrow SE-ResNeXt
    training step has its var's declared shape (-1 for the batch)."""
    main, startup, _, _ = _build(tfluid, "se_narrow")
    ops = ("sigmoid", "elementwise_mul", "dropout", "top_k", "accuracy")
    names = sorted({n for op in main.global_block().ops if op.type in ops
                    for n in op.output_arg_names()})
    assert len(names) >= 11
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        outs = exe.run(main, feed=_batches("se_narrow", n=1)[0],
                       fetch_list=names)
    for n, v in zip(names, outs):
        declared = main.global_block().vars[n].shape
        assert len(declared) == v.ndim, (n, declared, v.shape)
        assert all(d in (-1, s) for d, s in zip(declared, v.shape)), \
            (n, declared, v.shape)


@pytest.mark.parametrize("module", [tresnet, tse, tvgg, tmnist],
                         ids=["resnet", "se_resnext", "vgg", "mnist"])
def test_get_model_names_the_missing_input_path(module, tmp_path,
                                                monkeypatch):
    """The input path is ported: get_model returns the benchmark's
    contract, readers included, and its test reader yields batches of
    batch_size (image, label) samples of the data var's size (synthetic
    data: DATA_HOME is an empty directory)."""
    from paddle_tpu_torch.dataset import common

    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))

    class Args:
        batch_size, data_set = 4, "flowers"

    main = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(main, tfluid.Program()):
        out = module.get_model(Args())
    assert len(out) == 6 and callable(out[3]) and callable(out[4])
    image = next(v for v in main.global_block().vars.values() if v.is_data
                 and v.name != "label")
    batch = next(out[4]())
    assert len(batch) == 4
    for img, label in batch:
        assert np.asarray(img).size == int(np.prod(image.shape[1:]))
        assert 0 <= int(label) < (10 if module is tmnist else 102)
