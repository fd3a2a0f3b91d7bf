"""model_builder — pipeline proto -> detector (port of
mtlx/builders/model_builder.py), Faster R-CNN with the
mask_rcnn_box_predictor only. At is_training=True the MTL heads are on
as the proto asks; the hard example miner raises."""

from __future__ import annotations

import torch

from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig, MTLConfig
from mtlx_torch.device import DeviceLike

FEATURE_EXTRACTORS = {
    "faster_rcnn_resnet50": "resnet50",
    "faster_rcnn_resnet101": "resnet101",
    "faster_rcnn_resnet152": "resnet152",
    "faster_rcnn_inception_resnet_v2": "inception_resnet_v2",
    "faster_rcnn_inception_v2": "inception_v2",
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def canvas_from_resizer(image_resizer, stride: int = 16):
    """Static canvas from the image_resizer proto:
    keep_aspect_ratio_resizer(min, max) -> (max, max); fixed_shape_resizer
    -> (h, w); rounded up to a multiple of 2 * stride."""
    mult = 2 * stride
    kind = image_resizer.WhichOneof("image_resizer_oneof")
    if kind == "fixed_shape_resizer":
        r = image_resizer.fixed_shape_resizer
        return (_round_up(r.height, mult), _round_up(r.width, mult))
    r = image_resizer.keep_aspect_ratio_resizer
    side = _round_up(r.max_dimension, mult)
    return (side, side)


def resizer_params(image_resizer):
    """(kind, params) for the host-side resize."""
    kind = image_resizer.WhichOneof("image_resizer_oneof") or "keep_aspect_ratio_resizer"
    if kind == "fixed_shape_resizer":
        r = image_resizer.fixed_shape_resizer
        return "fixed", {"height": r.height, "width": r.width}
    r = image_resizer.keep_aspect_ratio_resizer
    return "keep_aspect", {
        "min_dimension": r.min_dimension,
        "max_dimension": r.max_dimension,
    }


def _initializer_spec(hyperparams):
    """The Hyperparams proto's initializer as a FasterRCNNConfig spec."""
    init = hyperparams.initializer
    kind = init.WhichOneof("initializer_oneof")
    if kind == "truncated_normal_initializer":
        return ("truncated_normal", init.truncated_normal_initializer.stddev)
    if kind == "variance_scaling_initializer":
        vs = init.variance_scaling_initializer
        mode = {0: "fan_in", 1: "fan_out", 2: "fan_avg"}[vs.mode]
        dist = "uniform" if vs.uniform else "truncated_normal"
        return ("variance_scaling", vs.factor, mode, dist)
    return None  # lecun_normal


def build_config(model_proto, is_training: bool, max_gt_boxes: int = 100,
                 dtype: torch.dtype = torch.bfloat16) -> FasterRCNNConfig:
    """The FasterRCNNConfig of a DetectionModel proto."""
    which = model_proto.WhichOneof("model")
    if which == "ssd":
        raise NotImplementedError("SSD is not ported: ROADMAP.md queue 1, SSD")
    if which != "faster_rcnn":
        raise ValueError(f"unknown model type {which!r}")
    fr = model_proto.faster_rcnn
    extractor_type = fr.feature_extractor.type or "faster_rcnn_resnet50"
    if extractor_type not in FEATURE_EXTRACTORS:
        raise ValueError(f"unknown feature extractor {extractor_type!r}")
    stride = fr.feature_extractor.first_stage_features_stride or 16
    bn_params = None
    if fr.feature_extractor.HasField("batch_norm"):
        b = fr.feature_extractor.batch_norm
        bn_params = (b.decay, b.epsilon, b.center, b.scale)

    ag = fr.first_stage_anchor_generator
    if ag.WhichOneof("anchor_generator_oneof") != "grid_anchor_generator":
        raise ValueError("faster_rcnn requires grid_anchor_generator")
    g = ag.grid_anchor_generator
    scales = tuple(g.scales) or (0.25, 0.5, 1.0, 2.0)
    aspects = tuple(g.aspect_ratios) or (0.5, 1.0, 2.0)

    rpn_init = None
    if fr.HasField("first_stage_box_predictor_conv_hyperparams"):
        rpn_init = _initializer_spec(fr.first_stage_box_predictor_conv_hyperparams)

    sp = fr.second_stage_box_predictor
    predictor_kind = sp.WhichOneof("box_predictor_oneof")
    if predictor_kind == "rfcn_box_predictor":
        raise NotImplementedError("R-FCN is not ported: ROADMAP.md queue 1, R-FCN")
    if is_training and fr.HasField("hard_example_miner"):
        raise NotImplementedError(
            "the hard example miner is not ported: ROADMAP.md queue 1, slice 2 "
            "(hard_example_mining_mask)"
        )
    use_dropout, keep_prob, fc_init = False, 1.0, None
    predict_masks, mask_depth = False, 256
    if predictor_kind == "mask_rcnn_box_predictor":
        m = sp.mask_rcnn_box_predictor
        if m.predict_keypoints:
            raise ValueError(
                "predict_keypoints is unimplemented for MaskRCNNBoxPredictor "
                "(as in the reference)"
            )
        use_dropout = m.use_dropout
        keep_prob = m.dropout_keep_probability
        predict_masks = m.predict_instance_masks
        mask_depth = m.mask_prediction_conv_depth
        if m.HasField("fc_hyperparams"):
            fc_init = _initializer_spec(m.fc_hyperparams)

    pp = fr.second_stage_post_processing
    nms = pp.batch_non_max_suppression
    score_converter = {0: "identity", 1: "sigmoid", 2: "softmax"}[pp.score_converter]
    mtl = MTLConfig(
        multiobject=fr.mtl.window,
        closeness=fr.mtl.closeness,
        foreground=fr.mtl.edgemask,
        multiobject_weight=fr.mtl.window_loss_weight,
        closeness_weight=fr.mtl.closeness_loss_weight,
        foreground_weight=fr.mtl.edgemask_loss_weight,
        window_enlarge_factor=fr.mtl.window_enlarge_factor,
        closeness_sigma=fr.mtl.closeness_sigma,
        window_sampling=fr.mtl.window_sampling,
        refine=fr.mtl.refine,
    )
    return FasterRCNNConfig(
        num_classes=fr.num_classes,
        canvas_size=canvas_from_resizer(fr.image_resizer, stride),
        backbone=FEATURE_EXTRACTORS[extractor_type],
        feature_stride=stride,
        anchor_scales=scales,
        anchor_aspect_ratios=aspects,
        anchor_base_size=(float(g.height or 256), float(g.width or 256)),
        rpn_depth=fr.first_stage_box_predictor_depth,
        rpn_kernel_size=fr.first_stage_box_predictor_kernel_size or 3,
        rpn_atrous_rate=fr.first_stage_atrous_rate or 1,
        rpn_conv_initializer=rpn_init,
        first_stage_nms_score_threshold=fr.first_stage_nms_score_threshold,
        first_stage_nms_iou_threshold=fr.first_stage_nms_iou_threshold,
        first_stage_max_proposals=fr.first_stage_max_proposals,
        first_stage_minibatch_size=fr.first_stage_minibatch_size,
        first_stage_positive_balance_fraction=fr.first_stage_positive_balance_fraction,
        first_stage_localization_loss_weight=fr.first_stage_localization_loss_weight,
        first_stage_objectness_loss_weight=fr.first_stage_objectness_loss_weight,
        initial_crop_size=fr.initial_crop_size or 14,
        maxpool_kernel_size=fr.maxpool_kernel_size or 2,
        maxpool_stride=fr.maxpool_stride or 2,
        second_stage_batch_size=fr.second_stage_batch_size,
        second_stage_balance_fraction=fr.second_stage_balance_fraction,
        second_stage_nms_score_threshold=nms.score_threshold,
        second_stage_nms_iou_threshold=nms.iou_threshold,
        second_stage_max_detections_per_class=nms.max_detections_per_class,
        second_stage_max_total_detections=nms.max_total_detections,
        second_stage_localization_loss_weight=fr.second_stage_localization_loss_weight,
        second_stage_classification_loss_weight=fr.second_stage_classification_loss_weight,
        second_stage_dropout=use_dropout and is_training,
        second_stage_dropout_keep_prob=keep_prob,
        second_stage_fc_initializer=fc_init,
        score_converter=score_converter,
        predict_instance_masks=predict_masks,
        mask_prediction_conv_depth=mask_depth,
        second_stage_mask_prediction_loss_weight=fr.second_stage_mask_prediction_loss_weight,
        batch_norm_trainable=fr.feature_extractor.batch_norm_trainable,
        batch_norm_params=bn_params,
        slim_stride_order=fr.feature_extractor.slim_stride_order,
        number_of_stages=fr.number_of_stages,
        max_gt_boxes=max_gt_boxes,
        dtype=dtype,
        # eval drops the training-only aux heads unless the refine path
        # fuses them into inference features
        mtl=mtl if (is_training or mtl.refine) else MTLConfig(),
    )


def build(model_proto, is_training: bool, max_gt_boxes: int = 100,
          dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None) -> FasterRCNN:
    """Dispatch on the model oneof, mirroring the reference's build()."""
    return FasterRCNN(build_config(model_proto, is_training, max_gt_boxes, dtype), device)
