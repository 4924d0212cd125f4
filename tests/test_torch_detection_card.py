"""Detection on the card (marked `cuda`, skipped without one; this file
imports no JAX: run it on the card with
`python -m pytest tests/test_torch_detection_card.py -m cuda`).

- the five host ops give the same bits fed the same arrays on the card
  and on the host; the box ops agree within rtol 1e-6;
- roi_pool's forward and its tie-splitting gradient are bitwise the
  host's on a ReLU'd map, as a kernel and as a layer's captured program;
- a program holding ssd_loss runs on the card through the interpreter,
  its losses within rtol 1e-4 of the host's from one state.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor_core, registry
from paddle_tpu_torch.core.registry import SeqTensor


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _both(op_type, ins, attrs):
    """The kernel's outputs on the card and on the host, as host tensors."""
    res = []
    for place, dev in ((fluid.CUDAPlace(0), "cuda"),
                       (fluid.CPUPlace(), "cpu")):
        moved = {s: [SeqTensor(v.data.to(dev), v.lengths.to(dev),
                               v.host_lengths)
                     if isinstance(v, SeqTensor) else v.to(dev) for v in vs]
                 for s, vs in ins.items()}
        outs = registry.run_kernel(registry.lookup(op_type),
                                   executor_core.OpContext(place), moved,
                                   attrs)
        res.append({s: (v[0].data.cpu(), v[0].lengths.cpu())
                    if isinstance(v[0], SeqTensor) else (v[0].cpu(), None)
                    for s, v in outs.items()})
    return res


def _seq(a, lengths):
    lens = np.asarray(lengths, np.int32)
    return SeqTensor(torch.from_numpy(a), torch.from_numpy(lens), lens)


def _boxes(rs, n):
    xy = rs.uniform(0, 0.7, (n, 2))
    wh = rs.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.cuda
def test_the_host_ops_give_the_same_bits_on_the_card_and_the_host():
    _need_card()
    rs = np.random.RandomState(0)
    lengths = [3, 1, 4]
    gt = _seq(_boxes(rs, 8), lengths)
    labels = _seq(rs.randint(1, 5, (8, 1)).astype(np.int64), lengths)
    priors = torch.from_numpy(_boxes(rs, 300))
    iou = _both("iou_similarity", {"X": [gt], "Y": [priors]}, {})[1]["Out"]
    dist = SeqTensor(iou[0], iou[1], np.asarray(lengths, np.int32))
    cases = [("bipartite_match", {"DistMat": [dist]},
              {"match_type": "per_prediction", "dist_threshold": 0.3})]
    card, host = _both(*cases[0])
    match = host["ColToRowMatchIndices"][0]
    loss = torch.from_numpy(rs.rand(3 * 300, 1).astype(np.float32))
    cases += [
        ("mine_hard_examples", {"ClsLoss": [loss], "MatchIndices": [match],
                                "MatchDist": [host["ColToRowMatchDist"][0]]},
         {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5}),
        ("target_assign", {"X": [labels], "MatchIndices": [match]},
         {"mismatch_value": 0}),
        ("multiclass_nms", {
            "BBoxes": [torch.from_numpy(np.stack([_boxes(rs, 300)] * 3))],
            "Scores": [torch.softmax(torch.from_numpy(
                rs.randn(3, 5, 300).astype(np.float32)), 1)]},
         {"score_threshold": 0.05, "nms_threshold": 0.45, "nms_top_k": 50,
          "keep_top_k": 40, "nms_eta": 0.95}),
    ]
    for op_type, ins, attrs in cases:
        card, host = _both(op_type, ins, attrs)
        for slot in host:
            for c, h in zip(card[slot], host[slot]):
                if h is not None:
                    assert torch.equal(c, h), (op_type, slot)
    det = _both(*cases[-1])[1]["Out"]
    label = _seq(np.concatenate([labels.data.numpy().astype(np.float32),
                                 np.zeros((8, 1), np.float32),
                                 gt.data.numpy()], 1), lengths)
    card, host = _both("detection_map", {
        "DetectRes": [SeqTensor(det[0], det[1])], "Label": [label]},
        {"class_num": 5, "ap_type": "11point", "overlap_threshold": 0.5})
    for slot in host:
        assert torch.equal(card[slot][0], host[slot][0]), slot


@pytest.mark.cuda
def test_the_box_ops_agree_within_1e6():
    _need_card()
    rs = np.random.RandomState(1)
    prior = torch.from_numpy(_boxes(rs, 64))
    pvar = torch.full((64, 4), 0.2)
    cases = [
        ("prior_box", {"Input": [torch.zeros(1, 1, 19, 19)],
                       "Image": [torch.zeros(1, 3, 300, 300)]},
         {"min_sizes": [60.0], "max_sizes": [111.0],
          "aspect_ratios": [2.0, 3.0], "flip": True, "step_w": 16.0,
          "step_h": 16.0}),
        ("iou_similarity", {"X": [torch.from_numpy(_boxes(rs, 9))],
                            "Y": [prior]}, {}),
        ("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                       "TargetBox": [torch.from_numpy(_boxes(rs, 7))]},
         {"code_type": "encode_center_size"}),
        ("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                       "TargetBox": [torch.randn(2, 64, 4)]},
         {"code_type": "decode_center_size"}),
    ]
    for op_type, ins, attrs in cases:
        card, host = _both(op_type, ins, attrs)
        for slot in host:
            torch.testing.assert_close(card[slot][0], host[slot][0],
                                       rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_roi_pool_forward_and_grad_are_the_hosts_bits():
    _need_card()
    rs = np.random.RandomState(2)
    x = torch.relu(torch.from_numpy(rs.randn(2, 16, 19, 31).astype(
        np.float32)))
    rois = []
    for b in range(2):
        for _ in range(12):
            x0, y0 = rs.uniform(-40, 460, 2)
            rois.append([b, x0, y0, x0 + rs.uniform(8, 300),
                         y0 + rs.uniform(8, 200)])
    rois = torch.from_numpy(np.asarray(rois, np.float32))
    g = torch.from_numpy(rs.randn(24, 16, 7, 7).astype(np.float32))
    attrs = {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1 / 16}
    fwd = _both("roi_pool", {"X": [x], "ROIs": [rois]}, attrs)
    bwd = _both("roi_pool_grad", {"X": [x], "ROIs": [rois],
                                  "Out@GRAD": [g]}, attrs)
    assert torch.equal(fwd[0]["Out"][0], fwd[1]["Out"][0])
    assert torch.equal(bwd[0]["X@GRAD"][0], bwd[1]["X@GRAD"][0])
    assert (fwd[1]["Out"][0] == 0).any()  # tied zeros were split


@pytest.mark.cuda
def test_a_roi_pool_program_runs_on_the_card_as_a_captured_graph():
    """layers.roi_pool's program (the type the port lacked) trains x's
    gradient on the card, eager and then replayed, bitwise the host's."""
    _need_card()
    rs = np.random.RandomState(4)
    x = torch.relu(torch.from_numpy(rs.randn(2, 8, 12, 20).astype(
        np.float32)))
    rois = torch.from_numpy(np.asarray(
        [[b % 2, *rs.uniform(-30, 150, 2), *rs.uniform(150, 330, 2)]
         for b in range(10)], np.float32))
    g = torch.from_numpy(rs.randn(10, 8, 7, 7).astype(np.float32))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        xv = L.data(name="x", shape=[8, 12, 20], dtype="float32")
        xv.stop_gradient = False
        rv = L.data(name="rois", shape=[5], dtype="float32")
        gv = L.data(name="g", shape=[8, 7, 7], dtype="float32")
        o = L.roi_pool(xv, rv, 7, 7, 1 / 16)
        fluid.backward.append_backward(L.reduce_sum(L.elementwise_mul(o, gv)))
    res = {}
    for place, dev in ((fluid.CPUPlace(), "cpu"),
                       (fluid.CUDAPlace(0), "cuda")):
        exe = fluid.Executor(place)
        feed = {"x": x.to(dev), "rois": rois.to(dev), "g": g.to(dev)}
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            res[dev] = [[v.cpu() for v in exe.run(
                main, feed=feed, fetch_list=[o, "x@GRAD"],
                return_numpy=False)] for _ in range(2)]
            mode = exe.step_mode(main)
    assert mode == "graph"
    for step in range(2):
        for c, h in zip(res["cuda"][step], res["cpu"][0]):
            assert torch.equal(c, h), step


@pytest.mark.cuda
def test_an_ssd_loss_program_runs_on_the_card_through_the_interpreter():
    _need_card()
    P, C = 8, 3
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feat = fluid.layers.data(name="feat", shape=[P * 4], dtype="float32")
        loc = fluid.layers.reshape(fluid.layers.fc(feat, P * 4),
                                   shape=[-1, P, 4], inplace=False)
        conf = fluid.layers.reshape(fluid.layers.fc(feat, P * C),
                                    shape=[-1, P, C], inplace=False)
        gt_box = fluid.layers.data(name="gt_box", shape=[4], dtype="float32",
                                   lod_level=1)
        gt_label = fluid.layers.data(name="gt_label", shape=[1],
                                     dtype="int64", lod_level=1)
        prior = fluid.layers.data(name="prior", shape=[P, 4],
                                  append_batch_size=False, dtype="float32")
        loss = fluid.layers.mean(fluid.layers.ssd_loss(
            loc, conf, gt_box, gt_label, prior))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    rs = np.random.RandomState(3)
    prior_np = np.asarray([[(i % 4) * 0.25, (i // 4) * 0.5,
                            (i % 4) * 0.25 + 0.25, (i // 4) * 0.5 + 0.5]
                           for i in range(P)], np.float32)
    gtb = np.asarray([[0.05, 0.1, 0.2, 0.45], [0.55, 0.55, 0.72, 0.95],
                      [0.3, 0.0, 0.6, 0.4]], np.float32)
    feat_np = rs.randn(2, P * 4).astype(np.float32)
    losses, init = {}, None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            if init is None:
                exe.run(startup)
                init = convert.numpy_state(scope, main)
            else:
                convert.load_numpy_state(scope, main, init, place)
            feed = {"feat": feat_np, "prior": prior_np,
                    "gt_box": fluid.create_lod_tensor(gtb, [[1, 2]], place),
                    "gt_label": fluid.create_lod_tensor(
                        np.asarray([[1], [2], [1]], np.int64), [[1, 2]],
                        place)}
            losses[str(place)] = [float(exe.run(main, feed=feed,
                                                fetch_list=[loss])[0])
                                  for _ in range(5)]
            mode = exe.step_mode(main)
    assert mode == "interpreter"
    host, card = losses.values()
    np.testing.assert_allclose(card, host, rtol=1e-4)
    assert card[-1] < card[0]
