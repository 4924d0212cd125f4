"""Detection in the port (paddle_tpu_torch/ops/detection_ops.py,
layers/detection.py, evaluator.DetectionMAP) against the JAX package, on
the CPU, from the same seeded numpy inputs.

- The device ops (iou_similarity, box_coder, prior_box) within rtol 1e-6
  (1e-5 for box_coder's decode, whose exp may differ by an ulp); roi_pool's
  forward exactly and its gradient within rtol 1e-6 (atol 1e-7): the edge,
  a bin wholly outside the map (finfo.min), round-half-to-even, and ties
  on a ReLU'd map, where the cotangent splits among the tied maxima.
- The host ops (bipartite_match, target_assign, mine_hard_examples,
  multiclass_nms, detection_map) bitwise: the JAX tests' fixtures, tied
  IoUs, tied losses, nms_eta < 1, an image with no detection.
- Each layer builds the JAX package's desc_str; multi_box_head over the
  JAX test's 3 maps gives its outputs; the small ssd_loss net trains 5
  steps from the JAX package's weights with losses within rtol 1e-4 in
  fp32 and 2e-2 under bf16 AMP; detection_output, detection_map (integral
  and 11point) and the DetectionMAP evaluator give the JAX package's
  values, and a chained detection_map the one-shot mAP where the JAX
  package's does not (ROADMAP §3 item 26).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.ops  # noqa: F401  (fills the JAX registry)
from paddle_tpu import amp as jamp
from paddle_tpu.core import executor_core as jexec
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor_core as texec
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope

HOST_OPS = ("bipartite_match", "target_assign", "mine_hard_examples",
            "multiclass_nms", "detection_map")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


# ---------------------------------------------------------------------------
# the two packages' kernels on the same numpy inputs
# ---------------------------------------------------------------------------
def _seq(lib, data, lengths):
    """A SeqTensor of `lib` ("jax" or "torch") from numpy."""
    if lib == "jax":
        return jreg.SeqTensor(jnp.asarray(data),
                              jnp.asarray(lengths, jnp.int32))
    lens = np.asarray(lengths, np.int32)
    return treg.SeqTensor(torch.from_numpy(np.asarray(data)),
                          torch.from_numpy(lens), host_lengths=lens)


def _value(lib, v):
    if isinstance(v, tuple):  # (data, lengths): a ragged input
        return _seq(lib, *v)
    return jnp.asarray(v) if lib == "jax" else torch.from_numpy(np.asarray(v))


def _np(v):
    """(data, lengths or None) of a kernel's output, as numpy."""
    if isinstance(v, (jreg.SeqTensor, treg.SeqTensor)):
        return _np(v.data)[0], np.asarray(
            v.lengths.cpu() if isinstance(v.lengths, torch.Tensor)
            else v.lengths)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy(), None
    return np.asarray(v), None


def _both(op_type, ins, attrs):
    """{slot: [(jax data, jax lengths), (port data, port lengths)]}."""
    jins = {s: [_value("jax", v) for v in vs] for s, vs in ins.items()}
    tins = {s: [_value("torch", v) for v in vs] for s, vs in ins.items()}
    j = jreg.run_kernel(jreg.lookup(op_type), jexec.OpContext(eager=True),
                        jins, attrs)
    t = treg.run_kernel(treg.lookup(op_type),
                        texec.OpContext(tfluid.CPUPlace()), tins, attrs)
    assert set(j) == set(t), (sorted(j), sorted(t))
    return {s: (_np(j[s][0]), _np(t[s][0])) for s in j}


def _bitwise(outs):
    for slot, ((jd, jl), (td, tl)) in outs.items():
        assert td.shape == jd.shape, slot
        np.testing.assert_array_equal(td, jd, err_msg=slot)
        if jl is not None or tl is not None:
            np.testing.assert_array_equal(tl, jl, err_msg=slot)


def _close(outs, rtol):
    for slot, ((jd, jl), (td, tl)) in outs.items():
        np.testing.assert_allclose(td, jd, rtol=rtol, atol=0, err_msg=slot)
        if jl is not None or tl is not None:
            np.testing.assert_array_equal(tl, jl, err_msg=slot)


def _boxes(rs, n, lo=0.0, hi=1.0, min_side=0.02):
    x0 = rs.uniform(lo, hi - min_side, n)
    y0 = rs.uniform(lo, hi - min_side, n)
    w = rs.uniform(min_side, 0.6, n)
    h = rs.uniform(min_side, 0.6, n)
    return np.stack([x0, y0, np.minimum(x0 + w, hi), np.minimum(y0 + h, hi)],
                    1).astype(np.float32)


def _grid_priors(k=4, size=0.3):
    """k x k square priors of side `size` on a regular grid: symmetric, so
    a box at the grid's center ties across several of them."""
    c = (np.arange(k) + 0.5) / k
    cx, cy = np.meshgrid(c, c)
    cx, cy = cx.reshape(-1), cy.reshape(-1)
    h = size / 2
    return np.stack([cx - h, cy - h, cx + h, cy + h], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------
def test_iou_similarity_matches_jax_and_keeps_the_ground_truths_lod():
    rs = np.random.RandomState(0)
    gt, priors = _boxes(rs, 7), _boxes(rs, 30)
    outs = _both("iou_similarity", {"X": [(gt, [3, 0, 4])], "Y": [priors]},
                 {})
    _close(outs, 1e-6)
    (_, jl), (_, tl) = outs["Out"]
    np.testing.assert_array_equal(tl, [3, 0, 4])  # bipartite_match reads it
    np.testing.assert_array_equal(jl, [3, 0, 4])


@pytest.mark.parametrize("case", ["encode", "encode_no_var", "elementwise",
                                  "decode"])
def test_box_coder_matches_jax(case):
    rs = np.random.RandomState(1)
    prior = _boxes(rs, 12)
    pvar = rs.uniform(0.1, 0.3, (12, 4)).astype(np.float32)
    attrs = {"code_type": "encode_center_size"}
    ins = {"PriorBox": [prior], "PriorBoxVar": [pvar]}
    if case == "encode":
        ins["TargetBox"] = [_boxes(rs, 5)]
    elif case == "encode_no_var":
        ins = {"PriorBox": [prior], "TargetBox": [_boxes(rs, 5)]}
    elif case == "elementwise":
        ins["TargetBox"] = [np.stack([_boxes(rs, 12) for _ in range(3)])]
        attrs["elementwise"] = True
    else:
        ins["TargetBox"] = [rs.randn(3, 12, 4).astype(np.float32)]
        attrs = {"code_type": "decode_center_size"}
    _close(_both("box_coder", ins, attrs), 1e-5 if case == "decode" else 1e-6)


@pytest.mark.parametrize("case", ["jax_fixture", "ssd300_conv4_3", "no_max",
                                  "two_min_sizes_steps"])
def test_prior_box_matches_jax(case):
    attrs = {"min_sizes": [10.0], "max_sizes": [20.0],
             "aspect_ratios": [2.0], "flip": True, "clip": True,
             "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 0.0,
             "step_h": 0.0, "offset": 0.5}
    feat, image = np.zeros((1, 8, 2, 3), np.float32), \
        np.zeros((1, 3, 40, 60), np.float32)
    if case == "ssd300_conv4_3":
        attrs = {"min_sizes": [30.0], "max_sizes": [60.0],
                 "aspect_ratios": [2.0], "flip": True, "clip": False,
                 "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 8.0,
                 "step_h": 8.0, "offset": 0.5}
        feat, image = np.zeros((1, 1, 38, 38), np.float32), \
            np.zeros((1, 3, 300, 300), np.float32)
    elif case == "no_max":
        attrs = {"min_sizes": [16.0], "aspect_ratios": [3.0, 2.0],
                 "flip": False}
    elif case == "two_min_sizes_steps":
        attrs = {"min_sizes": [8.0, 24.0], "max_sizes": [16.0, 32.0],
                 "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
                 "step_w": 12.0, "step_h": 9.0, "offset": 0.25}
    _close(_both("prior_box", {"Input": [feat], "Image": [image]}, attrs),
           1e-6)


# ---------------------------------------------------------------------------
# roi_pool
# ---------------------------------------------------------------------------
ROI_ATTRS = {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5}


def _roi_case(case):
    rs = np.random.RandomState(2)
    if case == "jax_fixture":
        x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
        return x, np.asarray([[0, 0, 0, 1, 1]], np.float32), {
            "pooled_height": 1, "pooled_width": 1, "spatial_scale": 1.0}
    x = rs.randn(2, 3, 9, 11).astype(np.float32)
    if case == "relu_ties":
        x = np.maximum(x, 0)  # a ReLU'd map: bins of exact zeros tie
        x[0, 1, 2:6, 3:7] = 0.0
    rois = [[0, 2, 3, 12, 15], [1, -6, -4, 7, 5], [0, 14, 8, 27, 21],
            [1, 0, 0, 1, 1], [0, 30, 30, 40, 40], [1, 5, 1, 9, 18]]
    if case == "round_half_even":
        # x1 * 0.5 = 2.5 -> 2, y1 * 0.5 = 3.5 -> 4, x2 * 0.5 = 6.5 -> 6
        rois = [[0, 5, 7, 13, 9], [1, 1, 3, 5, 11]]
    return x, np.asarray(rois, np.float32), ROI_ATTRS


def _jax_roi(x, rois, g, attrs):
    def fwd(xv):
        return jreg.run_kernel(jreg.lookup("roi_pool"),
                               jexec.OpContext(eager=True),
                               {"X": [xv], "ROIs": [jnp.asarray(rois)]},
                               attrs)
    outs, vjp = jax.vjp(lambda xv: fwd(xv)["Out"][0], jnp.asarray(x))
    return (np.asarray(outs), np.asarray(vjp(jnp.asarray(g))[0]),
            np.asarray(fwd(jnp.asarray(x))["Argmax"][0]))


def _port_roi(x, rois, g, attrs):
    ctx = texec.OpContext(tfluid.CPUPlace())
    ins = {"X": [torch.from_numpy(x)], "ROIs": [torch.from_numpy(rois)]}
    outs = treg.run_kernel(treg.lookup("roi_pool"), ctx, ins, attrs)
    grad = treg.run_kernel(treg.lookup("roi_pool_grad"), ctx,
                           dict(ins, **{"Out@GRAD": [torch.from_numpy(g)]}),
                           attrs)
    return (outs["Out"][0].numpy(), grad["X@GRAD"][0].numpy(),
            outs["Argmax"][0])


@pytest.mark.parametrize("case", ["jax_fixture", "edges", "relu_ties",
                                  "round_half_even"])
def test_roi_pool_matches_jax_forward_and_grad(case):
    x, rois, attrs = _roi_case(case)
    rs = np.random.RandomState(3)
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    g = rs.randn(rois.shape[0], x.shape[1], ph, pw).astype(np.float32)
    jo, jg, _ = _jax_roi(x, rois, g, attrs)
    to, tg, targmax = _port_roi(x, rois, g, attrs)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)
    assert targmax.dtype == torch.int64 and not targmax.any()
    assert targmax.shape == to.shape
    if case == "edges":
        # roi 4 lies wholly outside the 9 x 11 map: every bin is empty
        assert (to[4] == np.finfo(np.float32).min).all()


def test_torch_round_is_half_to_even_like_jnp_round():
    v = np.asarray([0.5, 1.5, 2.5, 3.5, -0.5, -1.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v))))
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  [0, 2, 2, 4, -0, -2])


def test_roi_pool_ties_split_the_cotangent_as_jax_does():
    """On a ReLU'd map a bin of zeros ties: the JAX package's max gives
    each tied element g / count. One winner taking all (what
    adaptive_max_pool2d's backward does) differs, and the port does not."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 3, 3] = 1.0
    rois = np.asarray([[0, 0, 0, 3, 3]], np.float32)
    attrs = {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}
    g = np.ones((1, 1, 2, 2), np.float32)
    _, jg, _ = _jax_roi(x, rois, g, attrs)
    _, tg, _ = _port_roi(x, rois, g, attrs)
    np.testing.assert_allclose(tg, jg, rtol=1e-6)
    np.testing.assert_allclose(jg[0, 0, :2, :2], 0.25)  # 4 tied zeros
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.nn.functional.adaptive_max_pool2d(xt, 2).sum().backward()
    assert not np.allclose(xt.grad.numpy(), jg)


def test_a_roi_pool_program_runs_and_gives_the_jax_outputs():
    """The layer's program (its type was the port's last unregistered
    one) trains its input's grad like the JAX package's."""
    x, rois, attrs = _roi_case("relu_ties")
    res = {}
    for lib in (jfluid, tfluid):
        main, startup = lib.Program(), lib.Program()
        with lib.unique_name.guard(), lib.program_guard(main, startup):
            xv = lib.layers.data(name="x", shape=list(x.shape[1:]),
                                 dtype="float32")
            xv.stop_gradient = False
            rv = lib.layers.data(name="rois", shape=[5], dtype="float32")
            o = lib.layers.roi_pool(xv, rv, attrs["pooled_height"],
                                    attrs["pooled_width"],
                                    attrs["spatial_scale"])
            loss = lib.layers.mean(lib.layers.scale(o, 3.0))
            grads = lib.backward.append_backward(loss)
        exe = lib.Executor(lib.CPUPlace())
        with lib.scope_guard(lib.Scope()):
            exe.run(startup)
            res[lib.__name__] = [np.asarray(v) for v in exe.run(
                main, feed={"x": x, "rois": rois},
                fetch_list=[o, "x@GRAD"])]
        assert main.desc_str() is not None and grads is not None
    np.testing.assert_array_equal(res["paddle_tpu_torch"][0],
                                  res["paddle_tpu"][0])
    np.testing.assert_allclose(res["paddle_tpu_torch"][1],
                               res["paddle_tpu"][1], rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# host ops: bitwise
# ---------------------------------------------------------------------------
def _dist(rs, lengths, P):
    d = rs.rand(sum(lengths), P).astype(np.float32)
    d[d < 0.3] = 0.0
    return d


@pytest.mark.parametrize("case", ["jax_fixture_bipartite",
                                  "jax_fixture_per_prediction", "random",
                                  "iou_ties", "empty_image"])
def test_bipartite_match_is_bitwise_the_jax_packages(case):
    rs = np.random.RandomState(4)
    attrs = {"match_type": "per_prediction", "dist_threshold": 0.5}
    if case.startswith("jax_fixture"):
        dist = np.asarray([[0.8, 0.3, 0.2], [0.9, 0.6, 0.1]], np.float32)
        attrs = {"match_type": "bipartite"} if case.endswith("bipartite") \
            else {"match_type": "per_prediction", "dist_threshold": 0.15}
        ins = {"DistMat": [dist]}
    elif case == "iou_ties":
        # two ground truths at the grid's center: symmetric priors tie
        priors = _grid_priors()
        gt = np.asarray([[0.35, 0.35, 0.65, 0.65], [0.3, 0.3, 0.7, 0.7],
                         [0.1, 0.6, 0.4, 0.9]], np.float32)
        iou = _both("iou_similarity", {"X": [gt], "Y": [priors]},
                    {})["Out"][0][0]
        assert len(set(np.round(iou[0], 7).tolist())) < iou.shape[1]
        ins = {"DistMat": [(iou, [2, 1])]}
    elif case == "empty_image":
        ins = {"DistMat": [(_dist(rs, [3, 0, 2], 20), [3, 0, 2])]}
    else:
        lengths = [4, 1, 7, 2]
        ins = {"DistMat": [(_dist(rs, lengths, 50), lengths)]}
    _bitwise(_both("bipartite_match", ins, attrs))


def test_target_assign_is_bitwise_the_jax_packages():
    rs = np.random.RandomState(5)
    # the JAX test's fixture
    _bitwise(_both("target_assign", {
        "X": [(np.asarray([[1.0], [2.0], [5.0]], np.float32), [2, 1])],
        "MatchIndices": [np.asarray([[0, -1, 1], [-1, 0, -1]], np.int64)],
        "NegIndices": [(np.asarray([[1]], np.int64), [1, 0])]},
        {"mismatch_value": 9}))
    lengths = [3, 2, 4]
    boxes = _boxes(rs, sum(lengths))
    labels = rs.randint(1, 21, (sum(lengths), 1)).astype(np.int64)
    match = np.stack([rs.randint(-1, n, 40) for n in lengths]).astype(
        np.int64)
    neg_rows = [np.sort(rs.choice(np.where(match[b] < 0)[0], 3,
                                  replace=False)) for b in range(3)]
    neg = (np.concatenate(neg_rows).reshape(-1, 1).astype(np.int64),
           [3, 3, 3])
    for x, extra in ((labels, {"NegIndices": [neg]}), (boxes, {})):
        _bitwise(_both("target_assign", dict(
            {"X": [(x, lengths)], "MatchIndices": [match]}, **extra),
            {"mismatch_value": 0}))


@pytest.mark.parametrize("case", ["jax_fixture", "random", "loss_ties",
                                  "sample_size"])
def test_mine_hard_examples_is_bitwise_the_jax_packages(case):
    rs = np.random.RandomState(6)
    attrs = {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5}
    if case == "jax_fixture":
        loss = np.asarray([[0.1, 0.9, 0.5, 0.7]], np.float32)
        match = np.asarray([[0, -1, -1, -1]], np.int64)
        mdist = np.asarray([[0.8, 0.1, 0.2, 0.6]], np.float32)
        attrs["neg_pos_ratio"] = 2.0
    else:
        B, P = 3, 60
        match = np.where(rs.rand(B, P) < 0.1, rs.randint(0, 4, (B, P)),
                         -1).astype(np.int64)
        mdist = rs.rand(B, P).astype(np.float32)
        loss = rs.rand(B * P, 1).astype(np.float32)
        if case == "loss_ties":  # a stable sort keeps the lower prior first
            loss = np.round(loss * 4) / 4
        if case == "sample_size":
            attrs["sample_size"] = 5
    _bitwise(_both("mine_hard_examples", {"ClsLoss": [loss],
                                          "MatchIndices": [match],
                                          "MatchDist": [mdist]}, attrs))


def _nms_inputs(rs, N=3, C=4, M=60):
    boxes = np.stack([_boxes(rs, M) for _ in range(N)])
    # clusters of near-duplicates, so suppression happens
    boxes[:, M // 2:] = boxes[:, :M // 2] + rs.uniform(
        -0.02, 0.02, (N, M // 2, 4)).astype(np.float32)
    scores = rs.rand(N, C, M).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("case", ["jax_fixture", "random", "top_k_keep_top_k",
                                  "eta", "eta_below_half", "score_ties",
                                  "no_detection", "ssd_like"])
def test_multiclass_nms_is_bitwise_the_jax_packages(case):
    rs = np.random.RandomState(7)
    attrs = {"background_label": 0, "score_threshold": 0.1,
             "nms_threshold": 0.5, "nms_top_k": -1, "keep_top_k": -1}
    if case == "jax_fixture":
        boxes = np.asarray([[[0, 0, 1, 1], [0, 0, 1.05, 1.05],
                             [2, 2, 3, 3]]], np.float32)
        scores = np.zeros((1, 2, 3), np.float32)
        scores[0, 1] = [0.9, 0.8, 0.7]
    else:
        boxes, scores = _nms_inputs(rs)
    if case == "top_k_keep_top_k":
        attrs.update(nms_top_k=20, keep_top_k=25, nms_threshold=0.3)
    elif case == "eta":
        attrs.update(nms_threshold=0.8, nms_eta=0.9)
    elif case == "eta_below_half":  # the threshold stops once <= 0.5
        attrs.update(nms_threshold=0.6, nms_eta=0.7)
    elif case == "ssd_like":  # SSD's test settings at a few hundred boxes
        boxes, scores = _nms_inputs(rs, N=2, C=6, M=400)
        scores = np.exp(scores * 4)
        scores /= scores.sum(1, keepdims=True)
        attrs.update(score_threshold=0.01, nms_threshold=0.45, nms_top_k=100,
                     keep_top_k=80)
    elif case == "score_ties":
        scores = np.round(scores * 5) / 5
    elif case == "no_detection":
        scores[1] = 0.05  # image 1: nothing passes the threshold
    outs = _both("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
                 attrs)
    _bitwise(outs)
    if case == "no_detection":
        (data, lengths), _ = outs["Out"]
        assert lengths[1] == 1
        row = data[lengths[0]]
        np.testing.assert_array_equal(row, [-1, 0, 0, 0, 0, 0])


def _dmap_fixture_arrays():
    label = np.array([[1, 0, 0.1, 0.1, 0.3, 0.3], [1, 1, 0.6, 0.6, 0.8, 0.8],
                      [2, 0, 0.3, 0.3, 0.6, 0.5], [1, 0, 0.7, 0.1, 0.9, 0.3]],
                     np.float32)
    detect = np.array([[1, 0.3, 0.1, 0.0, 0.4, 0.3],
                       [1, 0.7, 0.0, 0.1, 0.2, 0.3],
                       [1, 0.9, 0.7, 0.6, 0.8, 0.8],
                       [2, 0.8, 0.2, 0.1, 0.4, 0.4],
                       [2, 0.1, 0.4, 0.3, 0.7, 0.5],
                       [1, 0.2, 0.8, 0.1, 1.0, 0.3],
                       [3, 0.2, 0.8, 0.1, 1.0, 0.3]], np.float32)
    return (label, [2, 2]), (detect, [3, 4])


@pytest.mark.parametrize("ap", ["integral", "11point"])
@pytest.mark.parametrize("difficult", [True, False])
def test_detection_map_is_bitwise_the_jax_packages_with_state(ap, difficult):
    label, detect = _dmap_fixture_arrays()
    attrs = {"class_num": 4, "overlap_threshold": 0.3,
             "evaluate_difficult": difficult, "ap_type": ap}
    first = _both("detection_map", {"DetectRes": [detect],
                                    "Label": [label]}, attrs)
    _bitwise(first)
    # chained: the first call's accumulators as the state of a second
    state = {slot: [first["Accum" + slot][0]] for slot in
             ("PosCount", "TruePos", "FalsePos")}
    state = {s: [(d, l) if l is not None else d for (d, l) in v]
             for s, v in state.items()}
    _bitwise(_both("detection_map", dict(
        {"DetectRes": [detect], "Label": [label],
         "HasState": [np.asarray([1], np.int32)]}, **state), attrs))


def test_the_accumulated_map_is_the_one_shot_map_where_jax_counts_zero():
    """Chained over two batches, the port's mAP is the mAP of both batches
    at once, as the reference's state (one list a class that holds a
    pair) makes it. The JAX package seeds every class a list, so class 2,
    with a positive and no detection, counts as AP 0 once chained
    (ROADMAP §3 item 26)."""
    label1 = np.asarray([[1, 0, 0.1, 0.1, 0.4, 0.4],
                         [2, 0, 0.5, 0.5, 0.9, 0.9]], np.float32)
    det1 = np.asarray([[1, 0.9, 0.1, 0.1, 0.4, 0.4]], np.float32)
    label2 = np.asarray([[1, 0, 0.2, 0.2, 0.6, 0.6]], np.float32)
    det2 = np.asarray([[1, 0.8, 0.2, 0.2, 0.6, 0.6],
                       [1, 0.3, 0.7, 0.7, 0.9, 0.9]], np.float32)
    attrs = {"class_num": 3, "overlap_threshold": 0.5, "ap_type": "11point"}
    first = _both("detection_map", {"DetectRes": [(det1, [1])],
                                    "Label": [(label1, [2])]}, attrs)
    _bitwise(first)
    maps = []
    for lib, k in (("jax", 0), ("torch", 1)):
        state = {slot: [first["Accum" + slot][k]]
                 for slot in ("PosCount", "TruePos", "FalsePos")}
        ins = {"DetectRes": [_value(lib, (det2, [2]))],
               "Label": [_value(lib, (label2, [1]))],
               "HasState": [_value(lib, np.asarray([1], np.int32))],
               **{s: [_value(lib, (d, l) if l is not None else d)
                      for d, l in v] for s, v in state.items()}}
        if lib == "jax":
            o = jreg.run_kernel(jreg.lookup("detection_map"),
                                jexec.OpContext(eager=True), ins, attrs)
        else:
            o = treg.run_kernel(treg.lookup("detection_map"),
                                texec.OpContext(tfluid.CPUPlace()), ins,
                                attrs)
        maps.append(float(_np(o["MAP"][0])[0][0]))
    once = _both("detection_map", {
        "DetectRes": [(np.concatenate([det1, det2]), [1, 2])],
        "Label": [(np.concatenate([label1, label2]), [2, 1])]}, attrs)
    _bitwise(once)
    jax_map, port_map = maps
    assert port_map == float(once["MAP"][1][0][0])
    assert jax_map == port_map / 2  # class 2 counted as AP 0 beside class 1


def test_the_five_host_ops_are_host_sync_and_keep_a_program_off_the_graph():
    for t in HOST_OPS:
        assert t in texec.HOST_SYNC_OPS, t
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _ssd_program(tfluid)
    blocker = texec.capture_blocker(main.global_block().ops)
    assert blocker is not None and blocker.type == "bipartite_match"


# ---------------------------------------------------------------------------
# layers: the programs they build, and what those programs compute
# ---------------------------------------------------------------------------
def _ssd_program(fluid, P=8, C=3):
    """The JAX package's test net (tests/test_detection_ssd.py)."""
    img_feat = fluid.layers.data(name="feat", shape=[P * 4],
                                 dtype="float32")
    loc = fluid.layers.reshape(
        fluid.layers.fc(input=img_feat, size=P * 4,
                        param_attr=fluid.ParamAttr(name="loc_w")),
        shape=[-1, P, 4], inplace=False)
    conf = fluid.layers.reshape(
        fluid.layers.fc(input=img_feat, size=P * C,
                        param_attr=fluid.ParamAttr(name="conf_w")),
        shape=[-1, P, C], inplace=False)
    gt_box = fluid.layers.data(name="gt_box", shape=[4], dtype="float32",
                               lod_level=1)
    gt_label = fluid.layers.data(name="gt_label", shape=[1], dtype="int64",
                                 lod_level=1)
    prior = fluid.layers.data(name="prior", shape=[P, 4],
                              append_batch_size=False, dtype="float32")
    pvar = fluid.layers.data(name="pvar", shape=[P, 4],
                             append_batch_size=False, dtype="float32")
    loss = fluid.layers.ssd_loss(loc, conf, gt_box, gt_label, prior, pvar)
    return fluid.layers.mean(loss)


def _layer_program(fluid, name):
    L = fluid.layers
    if name == "ssd_loss":
        return [_ssd_program(fluid)]
    if name == "multi_box_head":
        image = L.data(name="image", shape=[3, 64, 64], dtype="float32")
        maps = [L.data(name=f"f{i}", shape=[8, s, s], dtype="float32")
                for i, s in enumerate((8, 4, 2))]
        return list(L.multi_box_head(
            inputs=maps, image=image, base_size=64, num_classes=3,
            min_ratio=20, max_ratio=90,
            aspect_ratios=[[2.0], [2.0, 3.0], [2.0]], flip=True, clip=True))
    boxes = L.data(name="boxes", shape=[4], dtype="float32", lod_level=1)
    prior = L.data(name="prior", shape=[6, 4], append_batch_size=False,
                   dtype="float32")
    if name == "box_coder":
        return [L.box_coder(prior, prior, boxes)]
    if name == "iou_similarity":
        return [L.iou_similarity(boxes, prior)]
    if name == "prior_box":
        feat = L.data(name="feat", shape=[8, 4, 4], dtype="float32")
        image = L.data(name="image", shape=[3, 32, 32], dtype="float32")
        return list(L.prior_box(feat, image, [8.0], [16.0], [2.0],
                                flip=True, clip=True))
    match, dist = L.bipartite_match(L.iou_similarity(boxes, prior),
                                    "per_prediction", 0.5)
    if name == "bipartite_match":
        return [match, dist]
    if name == "target_assign":
        return list(L.target_assign(boxes, match, mismatch_value=0))
    if name == "mine_hard_examples":
        loss = L.data(name="loss", shape=[6], dtype="float32")
        return list(L.mine_hard_examples(loss, match, dist))
    bboxes = L.data(name="bboxes", shape=[6, 4], dtype="float32")
    scores = L.data(name="scores", shape=[3, 6], dtype="float32")
    if name == "multiclass_nms":
        return [L.multiclass_nms(bboxes, scores, score_threshold=0.1,
                                 nms_top_k=4, keep_top_k=3)]
    if name == "detection_output":
        loc = L.data(name="loc", shape=[6, 4], dtype="float32")
        conf = L.data(name="conf", shape=[6, 3], dtype="float32")
        return [L.detection_output(loc, conf, prior, prior)]
    assert name == "detection_map"
    det = L.data(name="det", shape=[6], dtype="float32", lod_level=1)
    lab = L.data(name="lab", shape=[6], dtype="float32", lod_level=1)
    return [L.detection_map(det, lab, class_num=4, ap_version="11point")]


LAYERS = ["box_coder", "iou_similarity", "prior_box", "bipartite_match",
          "target_assign", "mine_hard_examples", "ssd_loss",
          "multiclass_nms", "detection_output", "multi_box_head",
          "detection_map"]


@pytest.mark.parametrize("name", LAYERS)
def test_each_detection_layer_builds_the_jax_packages_program(name):
    import paddle_tpu.layers.detection as jdet
    import paddle_tpu_torch.layers.detection as tdet

    assert sorted(tdet.__all__) == sorted(jdet.__all__) == sorted(LAYERS)
    assert name in tfluid.layers.__all__
    descs = []
    for lib in (jfluid, tfluid):
        main, startup = lib.Program(), lib.Program()
        with lib.unique_name.guard(), lib.program_guard(main, startup):
            _layer_program(lib, name)
        descs.append((main.desc_str(), startup.desc_str()))
    assert descs[1] == descs[0]


def _jax_state(scope, program):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in program.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def test_multi_box_head_over_the_jax_tests_3_maps_gives_its_outputs():
    rs = np.random.RandomState(0)
    feed = {"image": rs.rand(2, 3, 64, 64).astype(np.float32),
            "f0": rs.rand(2, 8, 8, 8).astype(np.float32),
            "f1": rs.rand(2, 8, 4, 4).astype(np.float32),
            "f2": rs.rand(2, 8, 2, 2).astype(np.float32)}
    res, init = {}, None
    for lib in (jfluid, tfluid):
        main, startup = lib.Program(), lib.Program()
        with lib.unique_name.guard(), lib.program_guard(main, startup):
            outs = _layer_program(lib, "multi_box_head")
        P_total = 8 * 8 * 4 + 4 * 4 * 6 + 2 * 2 * 4
        assert outs[2].shape == (P_total, 4)
        exe = lib.Executor(lib.CPUPlace())
        scope = lib.Scope()
        with lib.scope_guard(scope):
            if init is None:
                exe.run(startup)
                init = _jax_state(scope, startup)
            else:
                convert.load_numpy_state(scope, main, init, lib.CPUPlace())
            res[lib.__name__] = [np.asarray(v) for v in
                                 exe.run(main, feed=feed, fetch_list=outs)]
    for t, j in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def _ssd_priors(P=8):
    prior = np.zeros((P, 4), np.float32)
    for i in range(P):
        x0, y0 = (i % 4) * 0.25, (i // 4) * 0.5
        prior[i] = [x0, y0, x0 + 0.25, y0 + 0.5]
    return prior


def _ssd_feeds(lib, steps=5, P=8):
    rs = np.random.RandomState(0)
    feat = rs.randn(2, P * 4).astype(np.float32)
    place = lib.CPUPlace()
    gtb = np.asarray([[0.05, 0.1, 0.2, 0.45], [0.55, 0.55, 0.72, 0.95],
                      [0.3, 0.0, 0.6, 0.4]], np.float32)
    gtl = np.asarray([[1], [2], [1]], np.int64)
    return [{"feat": feat + 0.01 * s,
             "gt_box": lib.create_lod_tensor(gtb, [[1, 2]], place),
             "gt_label": lib.create_lod_tensor(gtl, [[1, 2]], place),
             "prior": _ssd_priors(P),
             "pvar": np.full((P, 4), 0.1, np.float32)}
            for s in range(steps)]


@pytest.mark.parametrize("amp", [False, True])
def test_the_small_ssd_net_trains_like_the_jax_package(amp):
    """5 SGD steps of the JAX test's ssd_loss net from the JAX package's
    weights: losses within rtol 1e-4 in fp32, 2e-2 under bf16 AMP."""
    losses, init = {}, None
    for lib, ampmod in ((jfluid, jamp), (tfluid, tamp)):
        main, startup = lib.Program(), lib.Program()
        with lib.unique_name.guard(), lib.program_guard(main, startup):
            avg = _ssd_program(lib)
            lib.optimizer.SGD(learning_rate=0.05).minimize(avg)
        exe = lib.Executor(lib.CPUPlace())
        scope = lib.Scope()
        with lib.scope_guard(scope):
            if init is None:
                exe.run(startup)
                init = _jax_state(scope, main)
            else:
                convert.load_numpy_state(scope, main, init, lib.CPUPlace())
            with ampmod.auto_cast() if amp else contextlib.nullcontext():
                losses[lib.__name__] = [
                    float(np.asarray(exe.run(main, feed=f,
                                             fetch_list=[avg])[0]).reshape(()))
                    for f in _ssd_feeds(lib)]
    np.testing.assert_allclose(losses["paddle_tpu_torch"],
                               losses["paddle_tpu"],
                               rtol=2e-2 if amp else 1e-4)
    assert losses["paddle_tpu_torch"][-1] < losses["paddle_tpu_torch"][0]


def test_detection_output_matches_the_jax_package():
    rs = np.random.RandomState(8)
    P, C = 24, 4
    prior = _boxes(rs, P)
    pvar = np.full((P, 4), 0.2, np.float32)
    loc = (rs.randn(2, P, 4) * 0.3).astype(np.float32)
    logits = rs.randn(2, P, C).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    res = {}
    for lib in (jfluid, tfluid):
        main, startup = lib.Program(), lib.Program()
        with lib.unique_name.guard(), lib.program_guard(main, startup):
            L = lib.layers
            lv = L.data(name="loc", shape=[2, P, 4], append_batch_size=False,
                        dtype="float32")
            sv = L.data(name="scores", shape=[2, P, C],
                        append_batch_size=False, dtype="float32")
            pv = L.data(name="prior", shape=[P, 4], append_batch_size=False,
                        dtype="float32")
            vv = L.data(name="pvar", shape=[P, 4], append_batch_size=False,
                        dtype="float32")
            det = L.detection_output(lv, sv, pv, vv, nms_threshold=0.45,
                                     nms_top_k=10, keep_top_k=12,
                                     score_threshold=0.1)
        exe = lib.Executor(lib.CPUPlace())
        out, = exe.run(main, feed={"loc": loc, "scores": scores,
                                   "prior": prior, "pvar": pvar},
                       fetch_list=[det], return_numpy=True)
        res[lib.__name__] = (np.asarray(out),
                             out.lod() if hasattr(out, "lod") else None)
    (td, tlod), (jd, jlod) = res["paddle_tpu_torch"], res["paddle_tpu"]
    assert td.shape == jd.shape and td.shape[0] > 2
    np.testing.assert_array_equal(td[:, :2], jd[:, :2])
    np.testing.assert_allclose(td[:, 2:], jd[:, 2:], rtol=1e-5, atol=1e-6)
    if jlod is not None:
        assert tlod == jlod


# class 1: (desc) (.9,1)(.7,1)(.3,0)(.2,1), 3 positives -> AP 11/12;
# class 2: (.8,0)(.1,1), 1 positive -> AP 1/2 (the JAX package's test)
_EXPECTED_MAP = (11.0 / 12.0 + 0.5) / 2.0


def _dmap_feed(lib):
    (label, llen), (detect, dlen) = _dmap_fixture_arrays()
    place = lib.CPUPlace()
    return {"det": lib.create_lod_tensor(detect, [dlen], place),
            "lab": lib.create_lod_tensor(label, [llen], place),
            "gtl": lib.create_lod_tensor(label[:, :1].copy(), [llen], place),
            "gtd": lib.create_lod_tensor(label[:, 1:2].copy(), [llen], place),
            "gtb": lib.create_lod_tensor(label[:, 2:].copy(), [llen], place)}


@pytest.mark.parametrize("ap", ["integral", "11point"])
def test_the_detection_map_layer_gives_the_jax_packages_map(ap):
    got = {}
    for lib in (jfluid, tfluid):
        with lib.program_guard(lib.Program(), lib.Program()):
            L = lib.layers
            det = L.data(name="det", shape=[6], dtype="float32", lod_level=1)
            lab = L.data(name="lab", shape=[6], dtype="float32", lod_level=1)
            m = L.detection_map(det, lab, class_num=4, overlap_threshold=0.3,
                                evaluate_difficult=True, ap_version=ap)
            main = lib.default_main_program()
        feed = {k: v for k, v in _dmap_feed(lib).items()
                if k in ("det", "lab")}
        got[lib.__name__] = np.asarray(lib.Executor(lib.CPUPlace()).run(
            main, feed=feed, fetch_list=[m])[0])
    np.testing.assert_array_equal(got["paddle_tpu_torch"], got["paddle_tpu"])
    if ap == "integral":
        np.testing.assert_allclose(got["paddle_tpu_torch"], [_EXPECTED_MAP],
                                   atol=1e-5)


def test_the_detection_map_evaluator_accumulates_and_resets_as_jax_does():
    got = {}
    for lib in (jfluid, tfluid):
        with lib.program_guard(lib.Program(), lib.Program()):
            L = lib.layers
            det = L.data(name="det", shape=[6], dtype="float32", lod_level=1)
            gtl = L.data(name="gtl", shape=[1], dtype="float32", lod_level=1)
            gtd = L.data(name="gtd", shape=[1], dtype="float32", lod_level=1)
            gtb = L.data(name="gtb", shape=[4], dtype="float32", lod_level=1)
            ev = lib.evaluator.DetectionMAP(
                det, gtl, gtb, gtd, class_num=4, overlap_threshold=0.3,
                evaluate_difficult=True, ap_version="integral")
            cur, accum = ev.get_map_var()
            main = lib.default_main_program()
            startup = lib.default_startup_program()
        feed = {k: v for k, v in _dmap_feed(lib).items() if k != "lab"}
        exe = lib.Executor(lib.CPUPlace())
        with lib.scope_guard(lib.Scope()):
            exe.run(startup)
            ev.reset(exe)
            vals = [exe.run(main, feed=feed, fetch_list=[cur, accum])
                    for _ in range(2)]
            ev.reset(exe)
            vals.append(exe.run(main, feed=feed, fetch_list=[cur, accum]))
        got[lib.__name__] = np.asarray(vals, np.float64).reshape(3, 2)
    np.testing.assert_array_equal(got["paddle_tpu_torch"], got["paddle_tpu"])
    t = got["paddle_tpu_torch"]
    np.testing.assert_allclose(t[:, 0], _EXPECTED_MAP, atol=1e-5)
    # two identical batches accumulated (the JAX test's hand count), then
    # the reset's first batch alone
    np.testing.assert_allclose(t[1, 1], (0.91071428 + 0.41666667) / 2,
                               atol=1e-5)
    np.testing.assert_allclose(t[2, 1], _EXPECTED_MAP, atol=1e-5)
