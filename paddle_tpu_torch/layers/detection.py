"""Detection layers (reference python/paddle/fluid/layers/detection.py;
the JAX package's paddle_tpu/layers/detection.py, whose programs these
build op for op): prior_box, bipartite_match, target_assign, ssd_loss,
multiclass_nms / detection_output, plus the box utilities.

ssd_loss mirrors the reference composite (detection.py:350): matching /
mining / target assignment run as host ops producing STOP-GRADIENT targets
(executor_core.HOST_SYNC_OPS: such a program runs on the interpreter),
while the differentiable loss terms (softmax cross-entropy + smooth-L1)
run on the device, so gradients flow to the location/confidence heads.
"""

from ..layer_helper import LayerHelper

__all__ = ["box_coder", "iou_similarity", "prior_box", "bipartite_match",
           "target_assign", "mine_hard_examples", "ssd_loss",
           "multiclass_nms", "detection_output", "multi_box_head",
           "detection_map"]


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None):
    """reference detection.py:679 — the SSD prediction head: per feature
    map, a prior_box grid plus 1x1 conv loc/conf branches, flattened and
    concatenated across maps.

    Returns (mbox_locs [N, P_total, 4], mbox_confs [N, P_total, C],
    boxes [P_total, 4], variances [P_total, 4])."""
    import math

    from . import nn
    from . import tensor as tensor_layers

    num_layer = len(inputs)
    if min_sizes is None:
        # reference ratio schedule: evenly spaced [min_ratio, max_ratio]
        # over layers 1.., with a half-scale prior for layer 0
        assert num_layer >= 3, \
            "min_sizes must be given explicitly for < 3 feature maps"
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) / (num_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes
    if steps:
        step_w = step_h = steps

    mbox_locs, mbox_confs, box_results, var_results = [], [], [], []
    for i, inp in enumerate(inputs):
        min_size = min_sizes[i]
        max_size = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if aspect_ratios is not None else [1.0]
        if not isinstance(ar, (list, tuple)):
            ar = [ar]
        step = [step_w[i] if step_w else 0.0,
                step_h[i] if step_h else 0.0]
        box, var = prior_box(inp, image, min_size, max_size, list(ar),
                             variance, flip, clip, step, offset)
        H, W, P = box.shape[0], box.shape[1], box.shape[2]
        box_results.append(nn.reshape(box, shape=[H * W * P, 4],
                                      inplace=False))
        var_results.append(nn.reshape(var, shape=[H * W * P, 4],
                                      inplace=False))

        loc = nn.conv2d(input=inp, num_filters=P * 4,
                        filter_size=kernel_size, padding=pad, stride=stride)
        loc = nn.transpose(loc, perm=[0, 2, 3, 1])       # NHWC
        mbox_locs.append(nn.reshape(loc, shape=[0, H * W * P, 4],
                                    inplace=False))

        conf = nn.conv2d(input=inp, num_filters=P * num_classes,
                         filter_size=kernel_size, padding=pad,
                         stride=stride)
        conf = nn.transpose(conf, perm=[0, 2, 3, 1])
        mbox_confs.append(nn.reshape(
            conf, shape=[0, H * W * P, num_classes], inplace=False))

    if num_layer == 1:
        return mbox_locs[0], mbox_confs[0], box_results[0], var_results[0]
    return (tensor_layers.concat(mbox_locs, axis=1),
            tensor_layers.concat(mbox_confs, axis=1),
            tensor_layers.concat(box_results, axis=0),
            tensor_layers.concat(var_results, axis=0))


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              elementwise=False):
    helper = LayerHelper("box_coder")
    output_box = helper.create_tmp_variable(dtype=prior_box.dtype)
    helper.append_op(
        "box_coder",
        {
            "PriorBox": [prior_box],
            "PriorBoxVar": [prior_box_var] if prior_box_var is not None else [],
            "TargetBox": [target_box],
        },
        {"OutputBox": [output_box]},
        {"code_type": code_type, "box_normalized": box_normalized,
         "elementwise": elementwise},
    )
    return output_box


def iou_similarity(x, y, box_normalized=True):
    helper = LayerHelper("iou_similarity")
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=x.lod_level)
    helper.append_op("iou_similarity", {"X": [x], "Y": [y]}, {"Out": [out]})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.0],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None):
    """reference detection.py:568 — SSD anchor grid for one feature map.
    Returns (boxes, variances), each [H, W, num_priors, 4]."""
    helper = LayerHelper("prior_box", **locals())
    if not isinstance(min_sizes, (list, tuple)):
        min_sizes = [min_sizes]
    if not isinstance(aspect_ratios, (list, tuple)):
        aspect_ratios = [aspect_ratios]
    attrs = {
        "min_sizes": [float(s) for s in min_sizes],
        "aspect_ratios": [float(a) for a in aspect_ratios],
        "variances": list(variance),
        "flip": flip,
        "clip": clip,
        "step_w": float(steps[0]),
        "step_h": float(steps[1]),
        "offset": offset,
    }
    if max_sizes:
        attrs["max_sizes"] = [float(s) for s in (
            max_sizes if isinstance(max_sizes, (list, tuple)) else [max_sizes])]
        assert len(attrs["max_sizes"]) == len(attrs["min_sizes"]), (
            "max_sizes must pair 1:1 with min_sizes (one sqrt(min*max) "
            "square prior per min_size)")
    # static [H, W, P, 4] shape so heads (multi_box_head) can size their
    # conv branches; P mirrors the kernel's prior-count rule: per min_size,
    # every aspect ratio plus (when max_sizes given) one square prior
    from ..ops.detection_ops import _expand_aspect_ratios

    shape = None
    if input.shape is not None and len(input.shape) == 4:
        n_ar = len(_expand_aspect_ratios(attrs["aspect_ratios"], flip))
        P = len(attrs["min_sizes"]) * (n_ar + (1 if max_sizes else 0))
        shape = (input.shape[2], input.shape[3], P, 4)
    box = helper.create_tmp_variable(dtype=input.dtype, shape=shape)
    var = helper.create_tmp_variable(dtype=input.dtype, shape=shape)
    helper.append_op("prior_box", {"Input": [input], "Image": [image]},
                     {"Boxes": [box], "Variances": [var]}, attrs)
    box.stop_gradient = True
    var.stop_gradient = True
    return box, var


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """reference detection.py:208 -> (match_indices, matched_distance),
    each [B, num_priors]; indices are per-image gt rows, -1 = unmatched."""
    helper = LayerHelper("bipartite_match", **locals())
    match_indices = helper.create_tmp_variable(dtype="int64")
    match_distance = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        "bipartite_match", {"DistMat": [dist_matrix]},
        {"ColToRowMatchIndices": [match_indices],
         "ColToRowMatchDist": [match_distance]},
        {"match_type": match_type, "dist_threshold": dist_threshold},
    )
    match_indices.stop_gradient = True
    match_distance.stop_gradient = True
    return match_indices, match_distance


def target_assign(input, match_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    """reference detection.py:285 -> (out [B, P, D], out_weight [B, P, 1])."""
    helper = LayerHelper("target_assign", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    out_weight = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        "target_assign",
        {"X": [input], "MatchIndices": [match_indices],
         "NegIndices": [negative_indices] if negative_indices is not None
         else []},
        {"Out": [out], "OutWeight": [out_weight]},
        {"mismatch_value": mismatch_value},
    )
    out.stop_gradient = True
    out_weight.stop_gradient = True
    return out, out_weight


def mine_hard_examples(cls_loss, match_indices, match_dist,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       mining_type="max_negative", sample_size=None):
    """Hard-negative mining (reference mine_hard_examples_op.cc).

    Divergence from the reference: under mining_type="max_negative" the
    reference IGNORES sample_size (it only budgets hard_example mining);
    here a given sample_size additionally CAPS the mined negatives per
    prior set. Porting reference code that sets both mining_type=
    "max_negative" and sample_size will mine fewer negatives here — leave
    sample_size=None for strict reference numerics."""
    helper = LayerHelper("mine_hard_examples", **locals())
    neg_indices = helper.create_tmp_variable(dtype="int64", lod_level=1)
    updated = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        "mine_hard_examples",
        {"ClsLoss": [cls_loss], "MatchIndices": [match_indices],
         "MatchDist": [match_dist]},
        {"NegIndices": [neg_indices], "UpdatedMatchIndices": [updated]},
        {"neg_pos_ratio": neg_pos_ratio,
         "neg_dist_threshold": neg_dist_threshold,
         "mining_type": mining_type,
         "sample_size": sample_size},
    )
    neg_indices.stop_gradient = True
    updated.stop_gradient = True
    return neg_indices, updated


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """reference detection.py:350 — SSD multibox loss.

    location [N, P, 4], confidence [N, P, C], gt_box LoD [sum_gt, 4],
    gt_label LoD [sum_gt, 1], prior_box [P, 4]. Returns loss [N*P, 1]
    (normalize=True divides by the matched-prior count)."""
    from . import nn

    num_classes = int(confidence.shape[-1])

    # 1-2. match gt to priors on IoU
    iou = iou_similarity(x=gt_box, y=prior_box)
    matched_indices, matched_dist = bipartite_match(
        iou, match_type, overlap_threshold)

    # 3. confidence loss on provisional targets (for mining)
    tgt_label, _ = target_assign(gt_label, matched_indices,
                                 mismatch_value=background_label)
    conf2d = nn.reshape(confidence, shape=[-1, num_classes], inplace=False)
    lbl2d = nn.reshape(tgt_label, shape=[-1, 1], inplace=False)
    lbl2d.stop_gradient = True
    mining_loss = nn.softmax_with_cross_entropy(conf2d, lbl2d)

    # 4. hard-negative mining
    neg_indices, updated_indices = mine_hard_examples(
        mining_loss, matched_indices, matched_dist,
        neg_pos_ratio=neg_pos_ratio, neg_dist_threshold=neg_overlap,
        mining_type=mining_type, sample_size=sample_size)

    # 5. final classification targets (positives + mined negatives)
    final_label, conf_w = target_assign(
        gt_label, updated_indices, negative_indices=neg_indices,
        mismatch_value=background_label)
    flbl2d = nn.reshape(final_label, shape=[-1, 1], inplace=False)
    flbl2d.stop_gradient = True
    conf_loss = nn.softmax_with_cross_entropy(conf2d, flbl2d)
    conf_loss = conf_loss * nn.reshape(conf_w, shape=[-1, 1], inplace=False)

    # 6. localization targets: matched gt box per prior, encoded vs priors
    tgt_box, loc_w = target_assign(gt_box, updated_indices)
    loc_target = box_coder(prior_box, prior_box_var, tgt_box,
                           elementwise=True)
    loc_target.stop_gradient = True
    loc2d = nn.reshape(location, shape=[-1, 4], inplace=False)
    loct2d = nn.reshape(loc_target, shape=[-1, 4], inplace=False)
    loc_loss = nn.smooth_l1(loc2d, loct2d)
    loc_loss = loc_loss * nn.reshape(loc_w, shape=[-1, 1], inplace=False)

    # 7-8. weighted sum; optional normalization by matched count
    loss = conf_loss_weight * conf_loss + loc_loss_weight * loc_loss
    if normalize:
        denom = nn.reduce_sum(loc_w) + 1e-6
        loss = loss / denom
    return loss


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.0,
                   nms_top_k=-1, nms_threshold=0.3, keep_top_k=-1,
                   nms_eta=1.0, normalized=True):
    """bboxes [N, M, 4], scores [N, C, M] -> LoD [total_det, 6] rows
    (label, score, x1, y1, x2, y2)."""
    helper = LayerHelper("multiclass_nms")
    out = helper.create_tmp_variable(dtype=bboxes.dtype, lod_level=1)
    helper.append_op(
        "multiclass_nms", {"BBoxes": [bboxes], "Scores": [scores]},
        {"Out": [out]},
        {"background_label": background_label,
         "score_threshold": score_threshold, "nms_top_k": nms_top_k,
         "nms_threshold": nms_threshold, "keep_top_k": keep_top_k,
         "nms_eta": nms_eta},
    )
    out.stop_gradient = True
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """reference detection.py:46 — decode predicted offsets against the
    priors, then per-class NMS. loc [N, P, 4], scores [N, P, C] (already
    softmaxed) -> LoD detections [total, 6]."""
    from . import nn

    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    scores_t = nn.transpose(scores, perm=[0, 2, 1])  # [N, C, P]
    return multiclass_nms(
        decoded, scores_t, background_label=background_label,
        score_threshold=score_threshold, nms_top_k=nms_top_k,
        nms_threshold=nms_threshold, keep_top_k=keep_top_k, nms_eta=nms_eta)


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """VOC mAP of a detection batch (reference layers/detection.py:157).

    detect_res: LoD [M,6] rows [label, score, xmin, ymin, xmax, ymax]
    label: LoD [N,6] rows [label, difficult, box] or [N,5] [label, box]
    With has_state/input_states/out_states the op chains its
    (pos_count, true_pos, false_pos) accumulators across batches —
    the DetectionMAP evaluator wires that loop up.
    """
    helper = LayerHelper("detection_map", **locals())

    def _var(dtype):
        return helper.create_tmp_variable(dtype=dtype, stop_gradient=True)

    map_out = _var("float32")
    accum_pos_count_out = out_states[0] if out_states else _var("int32")
    accum_true_pos_out = out_states[1] if out_states else _var("float32")
    accum_false_pos_out = out_states[2] if out_states else _var("float32")

    inputs = {"Label": [label], "DetectRes": [detect_res]}
    if has_state is not None:
        inputs["HasState"] = [has_state]
    if input_states:
        inputs["PosCount"] = [input_states[0]]
        inputs["TruePos"] = [input_states[1]]
        inputs["FalsePos"] = [input_states[2]]
    helper.append_op(
        "detection_map",
        inputs,
        {
            "MAP": [map_out],
            "AccumPosCount": [accum_pos_count_out],
            "AccumTruePos": [accum_true_pos_out],
            "AccumFalsePos": [accum_false_pos_out],
        },
        {
            "overlap_threshold": overlap_threshold,
            "evaluate_difficult": evaluate_difficult,
            "ap_type": ap_version,
            "class_num": class_num,
            "background_label": background_label,
        },
    )
    return map_out
