"""The port's training slice against the JAX package, end to end.

Each model is built by the same layer calls in both packages, the JAX
package's initial state is carried into the port with
convert.load_numpy_state, the same 3 batches are fed, and the fused
bucket update runs on both sides: per-step losses agree within rtol 1e-4
and every parameter after 3 steps within rtol 1e-3 / atol 1e-5 (fp32 on
the CPU; the two backends order their convolution and reduction sums
differently, so agreement is to rounding, never bitwise). The rest of the
state — velocities, moments, running statistics — holds sums of raw
gradients, and a batch-norm scale's gradient is a sum of thousands of
terms that cancel to ~1e-2: its rounding error is absolute, so that state
is held to atol 1e-3.

The JAX package's fusion pass refuses training programs with batch norm
(its batch_norm_grad reads the running stats the forward op updated in
place, a PTA031 false positive the port's grad maker removes), so on the
JAX side the ResNets get their fused momentum buckets from the pass's
horizontal rewrite directly (paddle_tpu.fusion._fuse_optimizers).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import fusion as jfusion
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.models import resnet as tresnet

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool from oversubscribing the cores the other workers use
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _narrow_bottleneck(fluid, resnet, img, layout):
    """conv_bn stem + one bottleneck per stage (widths 8/16) + global pool."""
    conv = resnet.conv_bn_layer(img, 8, 3, 1, 1, layout=layout)
    res = resnet.layer_warp(resnet.bottleneck, conv, 8, 1, 1, layout)
    res = resnet.layer_warp(resnet.bottleneck, res, 16, 1, 2, layout)
    pool = fluid.layers.pool2d(input=res, pool_size=7, pool_type="avg",
                               global_pooling=True, data_format=layout)
    return fluid.layers.fc(input=pool, size=10, act="softmax")


def _build(fluid, resnet, model):
    """(main, startup, loss, feed shape) for `model`."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if model == "mlp_adam":
            shape = [784]
            img = fluid.layers.data(name="img", shape=shape, dtype="float32")
            hidden = fluid.layers.fc(input=img, size=200, act="relu")
            probs = fluid.layers.fc(input=hidden, size=10, act="softmax")
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-3)
        else:
            layout = "NHWC" if model.endswith("nhwc") else "NCHW"
            shape = [32, 32, 3] if layout == "NHWC" else [3, 32, 32]
            img = fluid.layers.data(name="img", shape=shape, dtype="float32")
            if model == "resnet_cifar10_8":
                probs = resnet.resnet_cifar10(img, 10, depth=8)
            else:
                probs = _narrow_bottleneck(fluid, resnet, img, layout)
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        opt.minimize(loss)
    return main, startup, loss, shape


def _batches(shape, seed=3):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        x = rs.rand(4, *shape).astype(np.float32)
        y = rs.randint(0, 10, size=(4, 1)).astype(np.int64)
        out.append({"img": x, "label": y})
    return out


def _persistable_names(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable)


def _run_jax(model, batches):
    main, startup, loss, _ = _build(jfluid, jresnet, model)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n in _persistable_names(main)}
        if model == "mlp_adam":
            with jflags.flag_guard(fuse=True):
                losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                          for b in batches]
            plans = [p for _, p in exe._fusion_cache.values()
                     if p is not None]
            buckets = [b["opt"] for p in plans for b in p.buckets]
        else:
            fused = main.clone()
            plan, _ = jfusion._fuse_optimizers(
                fused, jflags.get("fuse_bucket_mb") << 20)
            buckets = [b["opt"] for b in plan]
            losses = [exe.run(fused, feed=b, fetch_list=[loss])[0]
                      for b in batches]
        final = {n: np.asarray(scope.find_var(n))
                 for n in _persistable_names(main)}
    return init, np.stack(losses).reshape(-1), final, buckets


def _run_port(model, init, batches, iters=False):
    main, startup, loss, _ = _build(tfluid, tresnet, model)
    place = tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        if iters:
            stacked = {n: np.stack([b[n] for b in batches[:2]])
                       for n in batches[0]}
            (l2,) = exe.run(main, feed=stacked, fetch_list=[loss], iters=2)
            losses = list(l2) + [exe.run(main, feed=batches[2],
                                         fetch_list=[loss])[0]]
        else:
            losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                      for b in batches]
    plans = [p for _, p, _ in exe._prepared.values() if p is not None]
    buckets = [b["opt"] for p in plans for b in p.buckets]
    return (np.stack(losses).reshape(-1), convert.numpy_state(scope, main),
            buckets)


MODELS = ["bottleneck_nchw", "bottleneck_nhwc", "resnet_cifar10_8",
          "mlp_adam"]


@pytest.mark.parametrize("model", MODELS)
def test_training_tracks_jax(model):
    batches = _batches(_build(tfluid, tresnet, model)[3])
    init, jax_losses, jax_final, jax_buckets = _run_jax(model, batches)
    losses, final, buckets = _run_port(model, init, batches)
    opt = "adam" if model == "mlp_adam" else "momentum"
    assert opt in jax_buckets and opt in buckets
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert set(final) == set(jax_final)
    params = {p.name for p in _build(tfluid, tresnet, model)[0]
              .global_block().all_parameters()}
    for n in sorted(final):
        atol = 1e-5 if n in params else 1e-3
        np.testing.assert_allclose(
            final[n], jax_final[n].astype(final[n].dtype), rtol=1e-3,
            atol=atol, err_msg=n)
    # the port's iters=2 call reproduces two single steps exactly
    losses_k, final_k, _ = _run_port(model, init, batches, iters=True)
    np.testing.assert_array_equal(losses_k, losses)
    for n in final:
        np.testing.assert_array_equal(final_k[n], final[n], err_msg=n)


def test_fused_and_unfused_training_are_bitwise_equal():
    """Inside the port FLAGS_fuse changes nothing but the op count."""
    model = "bottleneck_nhwc"
    batches = _batches(_build(tfluid, tresnet, model)[3])
    init, _, _, _ = _run_jax(model, batches)
    fused, fused_state, _ = _run_port(model, init, batches)
    with tflags.flag_guard(fuse=False):
        main, _, loss, _ = _build(tfluid, tresnet, model)
        scope = tfluid.Scope()
        convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            plain = np.stack([exe.run(main, feed=b, fetch_list=[loss])[0]
                              for b in batches]).reshape(-1)
        plain_state = convert.numpy_state(scope, main)
    np.testing.assert_array_equal(fused, plain)
    for n in plain_state:
        np.testing.assert_array_equal(fused_state[n], plain_state[n],
                                      err_msg=n)


def test_load_numpy_state_checks_shapes():
    main, _, _, _ = _build(tfluid, tresnet, "mlp_adam")
    rs = np.random.RandomState(0)
    arrays = {n: rs.rand(*main.global_block().var(n).shape).astype(
        np.float32) for n in _persistable_names(main)}
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, arrays, tfluid.CPUPlace())
    back = convert.numpy_state(scope, main)
    for n, a in arrays.items():
        np.testing.assert_array_equal(back[n], a)
        assert isinstance(scope.find_var(n), torch.Tensor)
    bad = dict(arrays)
    name = next(n for n in bad if bad[n].ndim == 2)
    bad[name] = bad[name].T.copy()
    with pytest.raises(ValueError, match="shape"):
        convert.load_numpy_state(tfluid.Scope(), main, bad, tfluid.CPUPlace())
    with pytest.raises(KeyError):
        convert.load_numpy_state(tfluid.Scope(), main,
                                 {n: a for n, a in arrays.items()
                                  if n != name}, tfluid.CPUPlace())


def test_default_place_is_the_card_and_never_the_host(monkeypatch):
    """Executor() means CUDAPlace(0); without CUDA it raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor(tfluid.TPUPlace(0))
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"


def test_iters_takes_a_list_of_step_feeds():
    main, startup, loss, shape = _build(tfluid, tresnet, "mlp_adam")
    batches = _batches(shape)
    runs = []
    for feed in (batches, {n: np.stack([b[n] for b in batches])
                           for n in batches[0]}):
        # a fresh Executor: its step count seeds the startup's draws
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            (lk,) = exe.run(main, feed=feed, fetch_list=[loss],
                            iters=STEPS)
        runs.append(lk)
    assert runs[0].shape == (STEPS, 1)
    np.testing.assert_array_equal(runs[0], runs[1])
