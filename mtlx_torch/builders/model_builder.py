"""model_builder — pipeline proto -> detector (port of
mtlx/builders/model_builder.py): Faster R-CNN with the
mask_rcnn_box_predictor, R-FCN with the rfcn_box_predictor, or SSD
(builders/ssd_builder.py). At is_training=True the MTL heads are on as
the proto asks, and at eval too when mtl.refine fuses them into the
second stage. Faster R-CNN's hard example miner takes the second stage's
loss weights; R-FCN refuses one in training (mtlx's R-FCN ignores it)."""

from __future__ import annotations

import torch

from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig, MTLConfig
from mtlx_torch.detector.rfcn import RFCN, RFCNConfig
from mtlx_torch.detector.ssd import SSD, SSDConfig
from mtlx_torch.device import DeviceLike
from mtlx_torch.losses.losses import HardExampleMinerConfig

FEATURE_EXTRACTORS = {
    "faster_rcnn_resnet50": "resnet50",
    "faster_rcnn_resnet101": "resnet101",
    "faster_rcnn_resnet152": "resnet152",
    "faster_rcnn_inception_resnet_v2": "inception_resnet_v2",
    "faster_rcnn_inception_v2": "inception_v2",
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def canvas_from_resizer(image_resizer, stride: int = 16, exact_fixed_shape: bool = False):
    """Static canvas from the image_resizer proto:
    keep_aspect_ratio_resizer(min, max) -> (max, max); fixed_shape_resizer
    -> (h, w); rounded up to a multiple of 2 * stride, except a fixed
    shape with `exact_fixed_shape` (SSD): its SAME-padded extractors
    ceil-divide any size, and SSD300 (conv11 at 19x19, 1917 anchors)
    computes at exactly 300x300, not at 320."""
    mult = 2 * stride
    kind = image_resizer.WhichOneof("image_resizer_oneof")
    if kind == "fixed_shape_resizer":
        r = image_resizer.fixed_shape_resizer
        if exact_fixed_shape:
            return (r.height, r.width)
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
                 dtype: torch.dtype = torch.bfloat16):
    """The FasterRCNNConfig (RFCNConfig for an rfcn_box_predictor, SSDConfig
    for an ssd model) of a DetectionModel proto."""
    which = model_proto.WhichOneof("model")
    if which == "ssd":
        from mtlx_torch.builders import ssd_builder

        return ssd_builder.build_config(model_proto.ssd, is_training, max_gt_boxes, dtype)
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
    miner = None
    if fr.HasField("hard_example_miner"):
        if predictor_kind == "rfcn_box_predictor" and is_training:
            raise ValueError("hard_example_miner is not applied by the R-FCN meta-arch "
                             "(mtlx's R-FCN ignores it); remove it or use faster_rcnn")
        # the miner ranks ROIs by the weighted loss training minimizes
        # (the reference passes the second stage's loss weights)
        m = fr.hard_example_miner
        miner = HardExampleMinerConfig(
            num_hard_examples=m.num_hard_examples,
            iou_threshold=m.iou_threshold,
            loss_type={0: "both", 1: "cls", 2: "loc"}[m.loss_type],
            cls_loss_weight=fr.second_stage_classification_loss_weight,
            loc_loss_weight=fr.second_stage_localization_loss_weight,
            max_negatives_per_positive=float(m.max_negatives_per_positive),
            min_negatives_per_image=m.min_negatives_per_image,
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
    # the fields both meta-architectures take (mtlx's RFCNConfig leaves
    # the ROI crop, dropout, masks, miner and number_of_stages at their
    # defaults)
    common = dict(
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
        second_stage_batch_size=fr.second_stage_batch_size,
        second_stage_balance_fraction=fr.second_stage_balance_fraction,
        second_stage_nms_score_threshold=nms.score_threshold,
        second_stage_nms_iou_threshold=nms.iou_threshold,
        second_stage_max_detections_per_class=nms.max_detections_per_class,
        second_stage_max_total_detections=nms.max_total_detections,
        second_stage_localization_loss_weight=fr.second_stage_localization_loss_weight,
        second_stage_classification_loss_weight=fr.second_stage_classification_loss_weight,
        score_converter=score_converter,
        batch_norm_trainable=fr.feature_extractor.batch_norm_trainable,
        batch_norm_params=bn_params,
        slim_stride_order=fr.feature_extractor.slim_stride_order,
        max_gt_boxes=max_gt_boxes,
        dtype=dtype,
    )
    if predictor_kind == "rfcn_box_predictor":
        r = sp.rfcn_box_predictor
        return RFCNConfig(
            **common,
            num_spatial_bins=(r.num_spatial_bins_height, r.num_spatial_bins_width),
            rfcn_depth=r.depth,
            rfcn_crop_size=(r.crop_height, r.crop_width),
            mtl=mtl if is_training else MTLConfig(),
        )
    return FasterRCNNConfig(
        **common,
        initial_crop_size=fr.initial_crop_size or 14,
        maxpool_kernel_size=fr.maxpool_kernel_size or 2,
        maxpool_stride=fr.maxpool_stride or 2,
        second_stage_dropout=use_dropout and is_training,
        second_stage_dropout_keep_prob=keep_prob,
        second_stage_fc_initializer=fc_init,
        predict_instance_masks=predict_masks,
        mask_prediction_conv_depth=mask_depth,
        second_stage_mask_prediction_loss_weight=fr.second_stage_mask_prediction_loss_weight,
        hard_example_miner=miner,
        number_of_stages=fr.number_of_stages,
        # eval drops the training-only aux heads unless the refine path
        # fuses them into inference features
        mtl=mtl if (is_training or mtl.refine) else MTLConfig(),
    )


def build(model_proto, is_training: bool, max_gt_boxes: int = 100,
          dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """Dispatch on the model oneof and the box predictor, mirroring the
    reference's build(): an SSD for an ssd model, an RFCN for an
    rfcn_box_predictor, else a FasterRCNN."""
    cfg = build_config(model_proto, is_training, max_gt_boxes, dtype)
    if isinstance(cfg, SSDConfig):
        return SSD(cfg, device)
    return (RFCN if isinstance(cfg, RFCNConfig) else FasterRCNN)(cfg, device)


def _regularizer(hyperparams):
    """(regularizer kind, weight) of a Hyperparams proto."""
    reg = hyperparams.regularizer
    kind = reg.WhichOneof("regularizer_oneof")
    if kind == "l2_regularizer":
        return kind, reg.l2_regularizer.weight
    if kind == "l1_regularizer":
        return kind, reg.l1_regularizer.weight
    return kind, 0.0


def regularization_scopes(model_proto):
    """Weight regularization of a model proto's Hyperparams: [(top-level
    module prefix, kind, weight)], what train_step.make_regularization_fn
    takes (mtlx's regularization_scopes)."""
    scopes = []
    if model_proto.WhichOneof("model") == "ssd":
        ssd = model_proto.ssd
        bp = ssd.box_predictor
        if (bp.WhichOneof("box_predictor_oneof") == "convolutional_box_predictor"
                and bp.convolutional_box_predictor.HasField("conv_hyperparams")):
            kind, w = _regularizer(bp.convolutional_box_predictor.conv_hyperparams)
            if kind and w:
                scopes.append(("box_predictor", kind, w))
                scopes.append(("extra", kind, w))
        if ssd.feature_extractor.HasField("conv_hyperparams"):
            kind, w = _regularizer(ssd.feature_extractor.conv_hyperparams)
            if kind and w:
                scopes.append(("backbone", kind, w))
        return scopes
    fr = model_proto.faster_rcnn
    if fr.HasField("first_stage_box_predictor_conv_hyperparams"):
        kind, w = _regularizer(fr.first_stage_box_predictor_conv_hyperparams)
        if kind and w:
            scopes.append(("rpn", kind, w))
    sp = fr.second_stage_box_predictor
    kind_of = sp.WhichOneof("box_predictor_oneof")
    if kind_of == "mask_rcnn_box_predictor":
        m = sp.mask_rcnn_box_predictor
        for field, scope in (("fc_hyperparams", "box_predictor"),
                             ("conv_hyperparams", "mask_head")):
            if m.HasField(field):
                kind, w = _regularizer(getattr(m, field))
                if kind and w:
                    scopes.append((scope, kind, w))
    elif kind_of == "rfcn_box_predictor" and sp.rfcn_box_predictor.HasField("conv_hyperparams"):
        kind, w = _regularizer(sp.rfcn_box_predictor.conv_hyperparams)
        if kind and w:
            scopes.append(("rfcn_predictor", kind, w))
    return scopes


def image_resizer(model_proto):
    """The image_resizer proto of the model oneof."""
    return getattr(model_proto, model_proto.WhichOneof("model")).image_resizer
