"""The port's bf16 mixed-precision policy (paddle_tpu_torch/amp.py) against
the JAX package's (paddle_tpu/amp.py).

Same lists, same dtype flow op by op, fp32 master weights, the amp
fingerprint in the executor's cache key, and training that tracks the JAX
package under `auto_cast()` from the same state.

Tolerances under bf16 (both sides on the CPU). bf16 keeps 8 significant
bits, so one rounding moves a value by up to 2^-9 of it, and the two
backends round their bf16 convolution, matmul and batch-norm outputs at
the same points but sum differently before rounding: a value that lands
near a rounding boundary can come out one bf16 ulp (2^-8 relative) apart.
  * op outputs: 2 ulps, rtol 2^-7 (with atol 2^-7 for values near 0);
  * losses over 3 training steps: rtol 2e-2, five ulps of the f32 loss
    computed from bf16 logits (measured: at most 3e-3);
  * state after 3 steps: parameters within atol 2e-3 (a parameter moves
    by lr x velocity, lr = 0.01 for Momentum, 1e-3 for Adam, and a bf16
    velocity term differs by a few ulps of |g|); velocities, moments and
    running stats sum raw gradients whose bf16 rounding is absolute:
    atol 5e-2 (measured: at most 3e-2 on a batch-norm scale's velocity).
Inside the port the fused and unfused updates stay bitwise equal under
AMP, as in fp32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import amp as jamp
from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk
from paddle_tpu_torch.models import resnet as tresnet

import test_torch_train as train

ULP2 = dict(rtol=2 ** -7, atol=2 ** -7)
LOSS_RTOL = 2e-2
PARAM_ATOL = 2e-3
STATE_ATOL = 5e-2


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


def test_lists_equal_the_jax_package():
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST
    with tamp.auto_cast(), jamp.auto_cast():
        assert tamp.fingerprint() == jamp.fingerprint()
    assert tamp.fingerprint() == jamp.fingerprint() == ("amp-off",)


def test_custom_lists_move_ops_between_lists():
    with tamp.auto_cast(custom_white_list={"softmax"},
                        custom_black_list={"relu"}):
        x = torch.ones(3)
        assert tamp.apply_policy("softmax", {"X": [x]})["X"][0].dtype == \
            torch.bfloat16
        y = torch.ones(3, dtype=torch.bfloat16)
        assert tamp.apply_policy("relu", {"X": [y]})["X"][0].dtype == \
            torch.float32
    assert not tamp.is_enabled()
    with tamp.scale_loss(128.0) as s:
        assert s == 128.0


def test_apply_policy_casts_only_floats():
    """ints and None pass through, SeqTensor data is cast, a grad op
    follows its forward op's list, and an unlisted op is untouched."""
    f32, i64 = torch.ones(2, 3), torch.ones(2, 1, dtype=torch.int64)
    seq = treg.SeqTensor(torch.ones(5, 3), torch.tensor([2, 3]))
    with tamp.auto_cast():
        got = tamp.apply_policy("conv2d_grad", {"X": [f32, i64, None, seq]})
        x, i, none, s = got["X"]
        assert x.dtype == torch.bfloat16 and i is i64 and none is None
        assert s.data.dtype == torch.bfloat16 and s.lengths is seq.lengths
        ins = {"X": [f32]}
        assert tamp.apply_policy("reshape", ins) is ins
        assert tamp.apply_policy("mean", ins) is ins  # already f32


# ---------------------------------------------------------------------------
# dtype flow op by op, against the JAX op under auto_cast()
# ---------------------------------------------------------------------------
def _jax_op(op_type, ins, attrs):
    outs = jreg.run_kernel(jreg.lookup(op_type), jcore.OpContext(),
                           {s: [jnp.asarray(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else (str(v.dtype),
                                        np.asarray(v, np.float32)
                                        if jnp.issubdtype(v.dtype,
                                                          jnp.floating)
                                        else np.asarray(v))
                for v in vs] for s, vs in outs.items()}


def _torch(v):
    """numpy -> torch; a bf16 (ml_dtypes) array goes through f32, exactly."""
    v = np.asarray(v)
    if v.dtype == jnp.bfloat16:
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(v.copy())


def _port_op(op_type, ins, attrs):
    outs = treg.run_kernel(treg.lookup(op_type),
                           tcore.OpContext(tfluid.CPUPlace()),
                           {s: [_torch(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else (
        str(v.dtype).replace("torch.", ""),
        v.float().numpy() if v.dtype.is_floating_point else v.numpy())
        for v in vs] for s, vs in outs.items()}


def _r(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _op_cases():
    rs = np.random.RandomState(5)
    x4 = _r(rs, 2, 6, 6, 3)
    conv = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
            "groups": 1, "data_format": "NHWC"}
    bn = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
          "data_layout": "NHWC"}
    probs = np.abs(_r(rs, 4, 5)) + 0.1
    probs /= probs.sum(1, keepdims=True)
    return {
        "conv2d": ({"Input": [x4], "Filter": [_r(rs, 4, 3, 3, 3)]}, conv),
        "pool2d": ({"X": [x4]}, {"pooling_type": "max", "ksize": [3, 3],
                                 "strides": [2, 2], "paddings": [1, 1],
                                 "data_format": "NHWC"}),
        "pool2d_avg": ({"X": [x4]}, {"pooling_type": "avg", "ksize": [2, 2],
                                     "strides": [1, 1], "paddings": [0, 0],
                                     "global_pooling": True,
                                     "data_format": "NHWC"}),
        "mul": ({"X": [_r(rs, 4, 7)], "Y": [_r(rs, 7, 5)]},
                {"x_num_col_dims": 1, "y_num_col_dims": 1}),
        "elementwise_add": ({"X": [_r(rs, 4, 5)], "Y": [_r(rs, 5)]},
                            {"axis": 1}),
        "relu": ({"X": [_r(rs, 4, 5)]}, {}),
        "batch_norm": ({"X": [x4.astype(jnp.bfloat16)],
                        "Scale": [_r(rs, 3)], "Bias": [_r(rs, 3)],
                        "Mean": [_r(rs, 3)],
                        "Variance": [np.abs(_r(rs, 3)) + 0.5]}, bn),
        "softmax": ({"X": [_r(rs, 4, 5).astype(jnp.bfloat16)]}, {}),
        "cross_entropy": ({"X": [probs.astype(jnp.bfloat16)],
                           "Label": [rs.randint(0, 5, (4, 1))]}, {}),
        "mean": ({"X": [_r(rs, 4, 5).astype(jnp.bfloat16)]}, {}),
        "sum": ({"X": [_r(rs, 4, 5).astype(jnp.bfloat16),
                       _r(rs, 4, 5).astype(jnp.bfloat16)]}, {}),
        "cast": ({"X": [rs.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)]},
                 {"out_dtype": "float32"}),
        "scale": ({"X": [_r(rs, 2, 3)]}, {"scale": 1.0 / 255.0}),
    }


# the output dtype each op gives under auto_cast() for the inputs above
OUT_DTYPE = {"conv2d": "bfloat16", "pool2d": "bfloat16",
             "pool2d_avg": "bfloat16", "mul": "bfloat16",
             "elementwise_add": "bfloat16", "relu": "bfloat16",
             "batch_norm": "bfloat16", "softmax": "float32",
             "cross_entropy": "float32", "mean": "float32",
             "sum": "bfloat16", "cast": "float32", "scale": "float32"}


@pytest.mark.parametrize("case", sorted(OUT_DTYPE))
def test_op_dtype_flow_matches_the_jax_package(case):
    """Under auto_cast(): white ops return bf16 for f32 inputs; batch_norm
    and sum are neutral (bf16 in, bf16 out; running stats and saved
    statistics f32); black ops return f32 for bf16 inputs; cast and scale
    are in neither list. Values agree with the JAX op within 2 bf16 ulps."""
    ins, attrs = _op_cases()[case]
    op_type = case.split("_avg")[0]
    with tamp.auto_cast(), jamp.auto_cast():
        got, want = _port_op(op_type, ins, attrs), _jax_op(op_type, ins, attrs)
    first_slot = {"conv2d": "Output", "batch_norm": "Y",
                  "cross_entropy": "Y"}.get(op_type, "Out")
    assert got[first_slot][0][0] == OUT_DTYPE[case]
    for slot, vals in want.items():
        for w, g in zip(vals, got.get(slot, [])):
            if w is None or g is None:
                continue
            assert g[0] == w[0], (slot, g[0], w[0])
            np.testing.assert_allclose(g[1], w[1], err_msg=slot, **ULP2)
    if op_type == "batch_norm":
        for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
            assert got[slot][0][0] == "float32", slot


# ---------------------------------------------------------------------------
# the executor under the policy
# ---------------------------------------------------------------------------
def _mnist_like(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 12, 12],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                   act="relu")
        pool = fluid.layers.pool2d(input=conv, pool_size=2, pool_stride=2)
        hidden = fluid.layers.fc(input=pool, size=16, act="relu")
        predict = fluid.layers.fc(input=hidden, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=predict, label=label))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def _mnist_batches(n):
    rs = np.random.RandomState(0)
    xs = rs.rand(n, 8, 1, 12, 12).astype(np.float32)
    ys = rs.randint(0, 10, (n, 8, 1)).astype(np.int64)
    return [{"img": x, "label": y} for x, y in zip(xs, ys)]


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_white_ops_see_bf16_and_black_ops_f32(monkeypatch, fuse):
    """The counterpart of tests/test_amp.py::test_white_ops_compute_in_bf16:
    a spy on run_kernel records the dtypes each op's kernel receives after
    the policy. conv2d and mul (and their grads) see bf16; cross_entropy,
    mean and momentum see no bf16; every persistable stays f32."""
    seen = {}
    orig = treg.run_kernel

    def spy(op_def, ctx, ins, attrs):
        for vals in tamp.apply_policy(op_def.type, ins).values():
            for v in vals:
                if isinstance(v, torch.Tensor):
                    seen.setdefault(op_def.type, set()).add(
                        str(v.dtype).replace("torch.", ""))
        return orig(op_def, ctx, ins, attrs)

    monkeypatch.setattr(treg, "run_kernel", spy)
    main, startup, loss = _mnist_like(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=fuse):
        exe.run(startup)
        with tamp.auto_cast():
            losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                      for b in _mnist_batches(2)]
    assert np.isfinite(losses).all()
    for op in ("conv2d", "mul", "conv2d_grad", "mul_grad", "relu", "pool2d"):
        assert "bfloat16" in seen[op], (op, seen[op])
    for op in ("cross_entropy", "mean", "softmax", "softmax_grad"):
        assert "bfloat16" not in seen[op], (op, seen[op])
    update = "fused_momentum_update" if fuse else "momentum"
    assert update in seen
    if not fuse:
        assert "bfloat16" not in seen["momentum"], seen["momentum"]
    for n in scope.local_var_names():
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
            assert v.dtype == torch.float32, (n, v.dtype)


def test_auto_cast_scoping_and_prepare_key():
    """Leaving the context restores fp32; the prepared entry is keyed by
    amp.fingerprint(), so the bf16 step never serves the fp32 run
    (tests/test_amp.py::test_auto_cast_scoping_and_cache)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(input=x, size=4)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        xv = np.ones((2, 4), np.float32)
        with tamp.auto_cast():
            (out_amp,) = exe.run(main, feed={"x": xv}, fetch_list=[y],
                                 return_numpy=False)
        assert not tamp.is_enabled()
        (out_fp32,) = exe.run(main, feed={"x": xv}, fetch_list=[y],
                              return_numpy=False)
    assert out_amp.dtype == torch.bfloat16
    assert out_fp32.dtype == torch.float32
    keys = [k for k in exe._prepared if k[0] == id(main)]
    assert len(keys) == 2
    assert {k[4] for k in keys} == {("amp-off",), _amp_on_fingerprint()}
    np.testing.assert_allclose(out_fp32.numpy(), out_amp.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def _amp_on_fingerprint():
    with tamp.auto_cast():
        return tamp.fingerprint()


AMP_MODELS = ["bottleneck_nhwc", "bottleneck_nchw", "resnet_cifar10_8",
              "mlp_adam"]


@pytest.mark.parametrize("model", AMP_MODELS)
def test_amp_training_tracks_the_jax_package(model):
    """3 fused steps under auto_cast() on both sides from the JAX package's
    initial state: losses within rtol 2e-2, parameters within atol 2e-3,
    the rest of the state within atol 5e-2 (module docstring); all of it
    f32 on the port's side."""
    batches = train._batches(train._build(tfluid, tresnet, model)[3])
    with jamp.auto_cast():
        init, jax_losses, jax_final, _ = train._run_jax(model, batches)
    with tamp.auto_cast():
        losses, final, buckets = train._run_port(model, init, batches)
    assert ("adam" if model == "mlp_adam" else "momentum") in buckets
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    params = {p.name for p in train._build(tfluid, tresnet, model)[0]
              .global_block().all_parameters()}
    for n in sorted(final):
        assert final[n].dtype == np.float32, (n, final[n].dtype)
        np.testing.assert_allclose(
            final[n], jax_final[n].astype(np.float32), rtol=0,
            atol=PARAM_ATOL if n in params else STATE_ATOL, err_msg=n)


def test_fused_and_unfused_amp_training_are_bitwise_equal():
    model = "bottleneck_nhwc"
    batches = train._batches(train._build(tfluid, tresnet, model)[3])
    init, _, _, _ = train._run_jax(model, batches)
    with tamp.auto_cast():
        fused, fused_state, _ = train._run_port(model, init, batches)
        with tflags.flag_guard(fuse=False):
            main, _, loss, _ = train._build(tfluid, tresnet, model)
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


@pytest.mark.parametrize("mix", ["bf16", "bf16_f32"])
def test_bf16_grads_reach_momentum_bucket_as_f32(monkeypatch, mix):
    """A bucket whose grads arrive in bf16 (conv/mul grads) or as a bf16/f32
    mix reaches momentum_bucket with an f32 lane, and its result equals the
    scalar momentum ops (black-listed: their grads cast to f32 first)."""
    rs = np.random.RandomState(11)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    ps = [torch.from_numpy(_r(rs, *s)) for s in shapes]
    vs = [torch.from_numpy(_r(rs, *s)) for s in shapes]
    gs = [torch.from_numpy(_r(rs, *s)).to(torch.bfloat16) for s in shapes]
    if mix == "bf16_f32":
        gs[1] = gs[1].float()
    lr = torch.tensor([0.05])
    seen = []
    orig = fk.momentum_bucket

    def spy(p, g, v, lr, mu, nesterov):
        seen.append((p.dtype, g.dtype, v.dtype))
        return orig(p, g, v, lr, mu, nesterov)

    from paddle_tpu_torch.ops import fused_ops
    monkeypatch.setattr(fused_ops.fk, "momentum_bucket", spy)
    ctx = tcore.OpContext(tfluid.CPUPlace())
    attrs = {"mu": 0.9, "use_nesterov": False}
    with tamp.auto_cast():
        fused = treg.run_kernel(
            treg.lookup("fused_momentum_update"), ctx,
            {"Param": ps, "Grad": gs, "Velocity": vs, "LearningRate": [lr]},
            attrs)
        scalar = [treg.run_kernel(
            treg.lookup("momentum"), ctx,
            {"Param": [p], "Grad": [g], "Velocity": [v],
             "LearningRate": [lr]}, attrs) for p, g, v in zip(ps, gs, vs)]
    assert seen == [(torch.float32,) * 3]
    for i, s in enumerate(scalar):
        for slot in ("ParamOut", "VelocityOut"):
            assert fused[slot][i].dtype == torch.float32
            assert torch.equal(fused[slot][i], s[slot][0]), (slot, i)
