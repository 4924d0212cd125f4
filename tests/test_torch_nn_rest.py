"""The rest of the port's nn ops (ops/nn_ops.py: layer_norm,
conv2d_transpose, depthwise_conv2d, conv3d, lrn, prelu, bilinear_interp,
row_conv, im2sequence, spp, unpool, random_crop; ops/math_ops.py: maxout;
ops/tensor_ops.py: truncated_gaussian_random, multiplex, lod_reset)
against the JAX package's kernels, op by op, through the harness and the
bounds of tests/test_torch_loss_ops.py: fp32 forward and grad within rtol
1e-4, bf16 AMP within 2e-2, the port's grads against float64 central
differences, and a `cuda`-marked twin on the card.

The two random ops draw other numbers than the JAX package's: they are
held by their laws and bounds, and by the same values from the same
generator seed. A few layer programs built from these ops run in both
packages from the JAX package's startup state (convert.load_numpy_state),
so their persistables carry across under the names the JAX startup gives.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor_core as tcore

from test_torch_loss_ops import (  # noqa: F401 (the fixture too)
    Case, Seq, _fresh_port_state, amp_case, card_case, check_case, fd_case,
    r32, run_port, seq)


def _cases():
    rs = np.random.RandomState(17)
    c = {}
    x = r32(rs, 3, 4, 5)
    for begin in (1, 2):
        c[f"layer_norm_begin_{begin}"] = Case(
            "layer_norm", {"X": [x], "Scale": [r32(rs, int(np.prod(
                x.shape[begin:])))], "Bias": [r32(rs, int(np.prod(
                    x.shape[begin:])))]},
            {"epsilon": 1e-5, "begin_norm_axis": begin}, grad=["Y"])
    c["layer_norm_no_affine"] = Case(
        "layer_norm", {"X": [r32(rs, 4, 6)]}, {"begin_norm_axis": 1},
        grad=["Y"])
    c["conv2d_transpose"] = Case(
        "conv2d_transpose", {"Input": [r32(rs, 2, 3, 4, 4)],
                             "Filter": [r32(rs, 3, 2, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]},
        grad=["Output"])
    c["conv2d_transpose_dilated"] = Case(
        "conv2d_transpose", {"Input": [r32(rs, 1, 2, 3, 5)],
                             "Filter": [r32(rs, 2, 3, 2, 3)]},
        {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1]},
        grad=["Output"])
    c["depthwise_conv2d"] = Case(
        "depthwise_conv2d", {"Input": [r32(rs, 2, 3, 5, 5)],
                             "Filter": [r32(rs, 3, 1, 3, 3)]},
        {"strides": [1, 1], "paddings": [1, 1]}, grad=["Output"])
    c["depthwise_conv2d_multiplier"] = Case(
        "depthwise_conv2d", {"Input": [r32(rs, 1, 2, 5, 4)],
                             "Filter": [r32(rs, 4, 1, 2, 2)]},
        {"strides": [2, 1], "paddings": [0, 1]}, grad=["Output"])
    c["conv3d"] = Case(
        "conv3d", {"Input": [r32(rs, 1, 2, 4, 4, 3)],
                   "Filter": [r32(rs, 3, 2, 2, 3, 2)]},
        {"strides": [1, 1, 1], "paddings": [1, 0, 1]}, grad=["Output"])
    c["lrn"] = Case("lrn", {"X": [r32(rs, 2, 6, 3, 3)]},
                    {"n": 5, "k": 2.0, "alpha": 0.05, "beta": 0.75},
                    grad=["Out"])
    c["lrn_n3"] = Case("lrn", {"X": [r32(rs, 1, 4, 2, 3)]},
                       {"n": 3, "k": 1.0, "alpha": 0.1, "beta": 0.5},
                       grad=["Out"])
    px = r32(rs, 2, 3, 2, 2)
    px[np.abs(px) < 1e-3] = 0.5  # no kink within a difference step
    c["prelu_all"] = Case("prelu", {"X": [px], "Alpha": [np.array(
        [0.25], np.float32)]}, {"mode": "all"}, grad=["Out"])
    c["prelu_element"] = Case("prelu", {"X": [px], "Alpha": [r32(
        rs, 3, 2, 2)]}, {"mode": "element"}, grad=["Out"])
    c["bilinear_interp_up"] = Case(
        "bilinear_interp", {"X": [r32(rs, 2, 3, 4, 5)]},
        {"out_h": 7, "out_w": 9}, grad=["Out"])
    c["bilinear_interp_down"] = Case(
        "bilinear_interp", {"X": [r32(rs, 1, 2, 8, 9)]},
        {"out_h": 3, "out_w": 4}, grad=["Out"])
    c["bilinear_interp_one_dim"] = Case(
        "bilinear_interp", {"X": [r32(rs, 1, 2, 4, 6)]},
        {"out_h": 4, "out_w": 11}, grad=["Out"])
    for pad in (0, 2):
        c[f"row_conv_ragged_pad_{pad}"] = Case(
            "row_conv", {"X": [seq(rs, [3, 1, 4], 2, pad=pad)],
                         "Filter": [r32(rs, 3, 2)]}, grad=["Out"])
    c["row_conv_dense"] = Case("row_conv", {"X": [r32(rs, 5, 3)],
                                            "Filter": [r32(rs, 2, 3)]},
                               grad=["Out"])
    c["im2sequence"] = Case(
        "im2sequence", {"X": [r32(rs, 2, 2, 5, 5)]},
        {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 1, 1]},
        grad=["Out"])
    c["im2sequence_plain"] = Case(
        "im2sequence", {"X": [r32(rs, 1, 3, 4, 4)]},
        {"kernels": [2, 2], "strides": [2, 2], "paddings": [0, 0, 0, 0]},
        grad=["Out"])
    # 6 x 7: at 4 x 4 bins no window is all padding, so the gradient
    # checks see finite values (spp_avg_all_padding_windows below)
    sx = rs.permutation(2 * 3 * 6 * 7).astype(np.float32).reshape(
        2, 3, 6, 7) * 0.01
    for ptype in ("max", "avg"):
        c[f"spp_{ptype}"] = Case("spp", {"X": [sx]},
                                 {"pyramid_height": 3, "pooling_type": ptype},
                                 grad=["Out"])
    # height 5 at 4 x 4 bins: the centring padding leaves a row of windows
    # all padding, whose average is 0 / 0 in both packages
    c["spp_avg_all_padding_windows"] = Case(
        "spp", {"X": [r32(rs, 1, 2, 5, 7)]},
        {"pyramid_height": 3, "pooling_type": "avg"})
    idx = np.stack([rs.choice(16, 4, replace=False) for _ in range(6)])
    c["unpool"] = Case(
        "unpool", {"X": [r32(rs, 2, 3, 2, 2)],
                   "Indices": [idx.reshape(2, 3, 2, 2).astype(np.int64)]},
        {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
         "unpooling_type": "max"}, grad=["Out"])
    mx = rs.permutation(2 * 6 * 3 * 3).astype(np.float32).reshape(
        2, 6, 3, 3) * 0.01
    c["maxout"] = Case("maxout", {"X": [mx]}, {"groups": 3}, grad=["Out"])
    c["maxout_pairs"] = Case("maxout", {"X": [mx[:, :4]]}, {"groups": 2},
                             grad=["Out"])
    c["multiplex"] = Case(
        "multiplex", {"X": [r32(rs, 4, 3) for _ in range(3)],
                      "Ids": [np.array([[2], [0], [2], [1]], np.int64)]},
        grad=["Out"])
    lx = seq(rs, [2, 4], 3)
    c["lod_reset_target"] = Case("lod_reset", {"X": [lx]},
                                 {"target_lod": [0, 1, 4, 6]}, grad=["Out"])
    c["lod_reset_by_seq"] = Case(
        "lod_reset", {"X": [lx], "Y": [seq(rs, [3, 3], 1)]}, grad=["Out"])
    c["lod_reset_dense"] = Case(
        "lod_reset", {"X": [r32(rs, 5, 2)],
                      "Y": [np.array([2, 3], np.int32)]}, grad=["Out"])
    return c


CASES = _cases()
GRAD_CASES = sorted(k for k, v in CASES.items() if v.grad)
FLOAT_CASES = sorted(k for k, v in CASES.items() if v.is_float())
TYPES = {"layer_norm", "conv2d_transpose", "depthwise_conv2d", "conv3d",
         "lrn", "prelu", "bilinear_interp", "row_conv", "im2sequence", "spp",
         "unpool", "maxout", "multiplex", "lod_reset"}
RANDOM_TYPES = {"random_crop", "truncated_gaussian_random"}


def test_every_type_of_the_nn_rest_has_a_case():
    assert {v.op_type for v in CASES.values()} == TYPES
    for t in TYPES | RANDOM_TYPES:
        assert tcore.registry.get_op_def(t) is not None, t


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grad_match_the_jax_op(case):
    check_case(CASES[case], len(case))


@pytest.mark.parametrize("case", FLOAT_CASES)
def test_amp_dtype_flow_and_values_match_the_jax_op(case):
    amp_case(CASES[case], len(case))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_grad_matches_central_differences_in_float64(case):
    fd_case(CASES[case], len(case))


def test_spp_averages_an_all_padding_window_to_nan_as_the_jax_package():
    case = CASES["spp_avg_all_padding_windows"]
    got = run_port("spp", case.ins, case.attrs)["Out"][0].data
    # levels 0 and 1 (2 channels x 1 and 4 bins), then level 2, whose
    # first row of 4 x 4 windows lies in the padding
    level2 = got[:, 10:].reshape(1, 2, 4, 4)
    assert np.isfinite(got[:, :10]).all()
    assert np.isnan(level2[:, :, 0]).all()
    assert np.isfinite(level2[:, :, 1:]).all()


def test_layer_norm_statistics_are_f32_under_amp():
    from paddle_tpu_torch import amp as tamp

    x = torch.randn(4, 8, dtype=torch.float32).to(torch.bfloat16)
    with tamp.auto_cast():
        o = tcore.registry.run_kernel(
            tcore.registry.lookup("layer_norm"),
            tcore.OpContext(tfluid.CPUPlace()), {"X": [x]},
            {"begin_norm_axis": 1})
    assert o["Y"][0].dtype == torch.bfloat16
    assert o["Mean"][0].dtype == o["Variance"][0].dtype == torch.float32
    assert o["Mean"][0].shape == (4,)


# ---------------------------------------------------------------------------
# the random ops: laws, bounds, the same numbers from the same seed
# ---------------------------------------------------------------------------
def _stream(seed):
    return tcore.OpContext(tfluid.CPUPlace(), tcore.RandomStream("cpu", seed))


def test_truncated_gaussian_random_law_and_seed():
    attrs = {"shape": [200, 100], "mean": 1.5, "std": 2.0,
             "dtype": "float32"}
    ctx = _stream(3)
    a = run_port("truncated_gaussian_random", {}, attrs, ctx=ctx)
    b = run_port("truncated_gaussian_random", {}, attrs, ctx=ctx)
    z = (a["Out"][0].data - 1.5) / 2.0
    assert a["Out"][0].dtype == "float32" and z.shape == (200, 100)
    assert z.min() >= -2.0 and z.max() <= 2.0 and z.min() < -1.9 \
        and z.max() > 1.9
    # the N(0, 1) law cut at +-2: mean 0, variance 0.7737413
    assert abs(z.mean()) < 0.02 and abs(z.var() - 0.7737413) < 0.02
    assert not np.array_equal(a["Out"][0].data, b["Out"][0].data)
    again = run_port("truncated_gaussian_random", {}, attrs, ctx=_stream(3))
    np.testing.assert_array_equal(again["Out"][0].data, a["Out"][0].data)
    # a seed attr fixes the numbers at every step
    fixed = dict(attrs, seed=11)
    p = run_port("truncated_gaussian_random", {}, fixed, ctx=ctx)
    q = run_port("truncated_gaussian_random", {}, fixed, ctx=ctx)
    np.testing.assert_array_equal(p["Out"][0].data, q["Out"][0].data)


def test_random_crop_law_and_seed():
    """Every crop is a window of its own instance, each offset in range,
    all offsets reached, fresh each step, the same from the same seed."""
    x = np.arange(64 * 5 * 6, dtype=np.float32).reshape(64, 5, 6)
    attrs = {"shape": [3, 4]}
    ctx = _stream(9)
    a = run_port("random_crop", {"X": [x]}, attrs, ctx=ctx)["Out"][0].data
    b = run_port("random_crop", {"X": [x]}, attrs, ctx=ctx)["Out"][0].data
    assert a.shape == (64, 3, 4)
    offsets = set()
    for i in range(64):
        r, c = divmod(int(a[i, 0, 0] - x[i, 0, 0]), 6)
        assert 0 <= r <= 2 and 0 <= c <= 2
        np.testing.assert_array_equal(a[i], x[i, r:r + 3, c:c + 4])
        offsets.add((r, c))
    assert len(offsets) == 9
    assert not np.array_equal(a, b)
    again = run_port("random_crop", {"X": [x]}, attrs, ctx=_stream(9))
    np.testing.assert_array_equal(again["Out"][0].data, a)
    with pytest.raises(ValueError, match="exceeds"):
        run_port("random_crop", {"X": [x]}, {"shape": [6, 2]})


# ---------------------------------------------------------------------------
# layer programs in both packages, from the JAX package's state
# ---------------------------------------------------------------------------
def _net(fluid, case):
    L = fluid.layers
    if case == "seq":
        x = L.data(name="x", shape=[4], dtype="float32", lod_level=1)
        lbl = L.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
        h = L.fc(input=x, size=5)
        crf = L.linear_chain_crf(h, lbl, param_attr=fluid.ParamAttr(
            name="crfw"))
        dec = L.crf_decoding(h, param_attr=fluid.ParamAttr(name="crfw"))
        rc = L.row_conv(L.fc(input=x, size=3), future_context_size=2)
        ln = L.layer_norm(rc, begin_norm_axis=1)
        hs = L.hsigmoid(L.fc(input=x, size=3), lbl, num_classes=5)
        loss = L.mean(crf) + L.mean(ln) + L.mean(hs)
        return loss, [crf, dec, ln, hs]
    img = L.data(name="img", shape=[2, 6, 6], dtype="float32")
    lbl = L.data(name="lbl", shape=[1], dtype="int64")
    up = L.conv2d_transpose(img, num_filters=3, filter_size=3, stride=2,
                            padding=1)
    n = L.lrn(up, n=3, alpha=0.05)
    r = L.upsampling_bilinear2d(n, out_shape=[8, 9])
    feat = L.fc(input=r, size=2, act="softmax")
    auc = L.auc(feat, lbl, num_thresholds=30)
    loss = L.mean(L.cross_entropy(feat, lbl))
    return loss, [up, n, r, auc]


def _build(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, outs = _net(fluid, case)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = startup.random_seed = 5
    return main, startup, [loss] + outs


def _feeds(fluid, case, place):
    rs = np.random.RandomState(6)
    feeds = []
    for _ in range(3):
        if case == "seq":
            lens = [3, 2, 4]
            feeds.append({
                "x": fluid.create_lod_tensor(rs.randn(9, 4).astype(
                    np.float32), [lens], place),
                "lbl": fluid.create_lod_tensor(rs.randint(0, 5, (9, 1)),
                                               [lens], place)})
        else:
            feeds.append({"img": rs.randn(4, 2, 6, 6).astype(np.float32),
                          "lbl": rs.randint(0, 2, (4, 1)).astype(np.int64)})
    return feeds


@pytest.mark.parametrize("case", ["seq", "image"])
def test_layer_programs_run_as_in_the_jax_package(case):
    """3 SGD steps: every fetched value within rtol 1e-4 of the JAX
    package's (decoded tags equal); the crfw, layer_norm, hsigmoid, lrn and
    auc state crosses from the JAX startup by name and is read back."""
    main, startup, fetch = _build(jfluid, case)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        want = [exe.run(main, feed=f, fetch_list=fetch, return_numpy=False)
                for f in _feeds(jfluid, case, jfluid.CPUPlace())]
        want_state = {n: np.asarray(scope.find_var(n)) for n in init}
    main, _, fetch = _build(tfluid, case)
    tsc = tfluid.Scope()
    convert.load_numpy_state(tsc, main, init, tfluid.CPUPlace())
    assert convert.numpy_state(tsc, main).keys() == init.keys()
    with tfluid.scope_guard(tsc):
        exe = tfluid.Executor(tfluid.CPUPlace())
        got = [exe.run(main, feed=f, fetch_list=fetch)
               for f in _feeds(tfluid, case, tfluid.CPUPlace())]
    for g_step, w_step in zip(got, want):
        for g, w in zip(g_step, w_step):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    got_state = convert.numpy_state(tsc, main)
    for n, w in want_state.items():
        np.testing.assert_allclose(got_state[n], w, rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    if case == "seq":
        assert "crfw" in got_state
    else:
        assert any(n.endswith("_stat_pos") for n in got_state)


def test_nce_state_carries_across_and_trains():
    """An nce layer's weight and bias cross from the JAX startup by name;
    the port's steps (negatives drawn from its own stream, so no value
    parity) give finite costs, move the weights, and numpy_state reads
    back the loaded state before any step."""
    progs = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
            cost = fluid.layers.nce(fluid.layers.fc(input=x, size=4), lbl,
                                    num_total_classes=50, num_neg_samples=5)
            loss = fluid.layers.mean(cost)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        main.random_seed = startup.random_seed = 3
        progs[name] = (main, startup, loss)
    main, startup, _ = progs["jax"]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    init = {n: np.asarray(scope.find_var(n))
            for n, v in main.global_block().vars.items() if v.persistable}
    nce_state = sorted(n for n in init if n.startswith("nce"))
    assert len(nce_state) == 2, nce_state
    main, _, loss = progs["port"]
    assert main.desc_str() == progs["jax"][0].desc_str()
    tsc = tfluid.Scope()
    convert.load_numpy_state(tsc, main, init, tfluid.CPUPlace())
    back = convert.numpy_state(tsc, main)
    for n in init:
        np.testing.assert_array_equal(back[n], init[n], err_msg=n)
    rs = np.random.RandomState(2)
    with tfluid.scope_guard(tsc):
        exe = tfluid.Executor(tfluid.CPUPlace())
        costs = [float(exe.run(main, feed={
            "x": rs.randn(8, 6).astype(np.float32),
            "lbl": rs.randint(0, 50, (8, 1))}, fetch_list=[loss])[0][0])
            for _ in range(3)]
    assert np.all(np.isfinite(costs))
    moved = convert.numpy_state(tsc, main)
    assert all(not np.array_equal(moved[n], init[n]) for n in nce_state)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_op_on_the_card_matches_the_cpu(case):
    card_case(CASES[case], len(case))


@pytest.mark.cuda
def test_random_ops_on_the_card_keep_their_laws():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx = tcore.OpContext(tfluid.CUDAPlace(0),
                          tcore.RandomStream("cuda", 3))
    z = run_port("truncated_gaussian_random", {},
                 {"shape": [1000, 100]}, device="cuda", ctx=ctx)["Out"][0]
    assert z.data.min() >= -2.0 and z.data.max() <= 2.0
    assert abs(z.data.var() - 0.7737413) < 0.01
    x = np.arange(32 * 5 * 6, dtype=np.float32).reshape(32, 5, 6)
    a = run_port("random_crop", {"X": [x]}, {"shape": [3, 4]},
                 device="cuda", ctx=ctx)["Out"][0].data
    for i in range(32):
        r, c = divmod(int(a[i, 0, 0] - x[i, 0, 0]), 6)
        np.testing.assert_array_equal(a[i], x[i, r:r + 3, c:c + 4])
