"""SSD model builder: an Ssd proto -> SSDConfig (port of
mtlx/builders/ssd_builder.py), the `ssd` branch of model_builder."""

from __future__ import annotations

import torch

from mtlx_torch.detector.ssd import SSDConfig

SSD_FEATURE_EXTRACTORS = {"ssd_mobilenet_v1", "ssd_inception_v2"}


def build_config(ssd_proto, is_training: bool, max_gt_boxes: int = 100,
                 dtype: torch.dtype = torch.bfloat16) -> SSDConfig:
    from mtlx_torch.builders.model_builder import canvas_from_resizer

    fe = ssd_proto.feature_extractor
    if fe.type and fe.type not in SSD_FEATURE_EXTRACTORS:
        raise ValueError(f"unknown ssd feature extractor {fe.type!r}")

    ag = ssd_proto.anchor_generator
    if ag.WhichOneof("anchor_generator_oneof") == "ssd_anchor_generator":
        g = ag.ssd_anchor_generator
        num_layers = g.num_layers
        min_scale, max_scale = g.min_scale, g.max_scale
        aspects = tuple(g.aspect_ratios) or (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
        reduce_lowest = g.reduce_boxes_in_lowest_layer
    else:
        num_layers, min_scale, max_scale = 6, 0.2, 0.95
        aspects = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
        reduce_lowest = True

    m = ssd_proto.matcher.argmax_matcher

    coder_scales = (10.0, 10.0, 5.0, 5.0)
    if ssd_proto.box_coder.WhichOneof("box_coder_oneof") == "faster_rcnn_box_coder":
        bc = ssd_proto.box_coder.faster_rcnn_box_coder
        coder_scales = (bc.y_scale or 10.0, bc.x_scale or 10.0,
                        bc.height_scale or 5.0, bc.width_scale or 5.0)

    similarity = "iou"
    sim_kind = ssd_proto.similarity_calculator.WhichOneof("region_similarity")
    if sim_kind == "ioa_similarity":
        similarity = "ioa"
    elif sim_kind == "neg_sq_dist_similarity":
        similarity = "neg_sq_dist"

    pp = ssd_proto.post_processing
    nms = pp.batch_non_max_suppression
    score_converter = {0: "identity", 1: "sigmoid", 2: "softmax"}[pp.score_converter]

    loss = ssd_proto.loss
    cls_kind = loss.classification_loss.WhichOneof("classification_loss")
    cls_loss = "weighted_softmax" if cls_kind == "weighted_softmax" else "weighted_sigmoid"
    # no hard_example_miner block trains on every negative; an explicit
    # max_negatives_per_positive of 0 means no cap
    if loss.HasField("hard_example_miner"):
        miner = loss.hard_example_miner
        neg_per_pos = float(miner.max_negatives_per_positive)
        min_neg = int(miner.min_negatives_per_image)
    else:
        neg_per_pos, min_neg = 0.0, 0

    kernel_size = 3
    predictor_min_depth = predictor_max_depth = layers_before = 0
    use_dropout, dropout_keep, apply_sigmoid = False, 0.8, False
    bp = ssd_proto.box_predictor
    if bp.WhichOneof("box_predictor_oneof") == "convolutional_box_predictor":
        cbp = bp.convolutional_box_predictor
        kernel_size = cbp.kernel_size or 3
        predictor_min_depth = cbp.min_depth
        predictor_max_depth = cbp.max_depth
        layers_before = cbp.num_layers_before_predictor
        use_dropout = cbp.use_dropout
        dropout_keep = cbp.dropout_keep_probability
        apply_sigmoid = cbp.apply_sigmoid_to_scores

    has_bn = fe.conv_hyperparams.HasField("batch_norm")
    bn = fe.conv_hyperparams.batch_norm
    return SSDConfig(
        num_classes=ssd_proto.num_classes,
        feature_extractor=fe.type or "ssd_mobilenet_v1",
        canvas_size=canvas_from_resizer(ssd_proto.image_resizer, stride=16,
                                        exact_fixed_shape=True),
        depth_multiplier=fe.depth_multiplier or 1.0,
        min_depth=fe.min_depth or 8,
        bn_epsilon=bn.epsilon if has_bn else 1e-3,
        bn_center=bn.center if has_bn else True,
        bn_scale=bn.scale if has_bn else True,
        # slim.batch_norm's is_training = batch_norm.train and is_training
        batch_norm_trainable=(is_training and bn.train) if has_bn else False,
        bn_momentum=bn.decay if has_bn else 0.999,
        num_layers=num_layers,
        min_scale=min_scale,
        max_scale=max_scale,
        aspect_ratios=aspects,
        reduce_boxes_in_lowest_layer=reduce_lowest,
        matched_threshold=m.matched_threshold if ssd_proto.HasField("matcher") else 0.5,
        unmatched_threshold=m.unmatched_threshold if ssd_proto.HasField("matcher") else 0.5,
        similarity=similarity,
        box_coder_scales=coder_scales,
        classification_loss=cls_loss,
        localization_weight=loss.localization_weight,
        classification_weight=loss.classification_weight,
        negatives_per_positive=neg_per_pos,
        min_negatives_per_image=min_neg,
        normalize_loss_by_num_matches=ssd_proto.normalize_loss_by_num_matches,
        score_converter=score_converter,
        nms_score_threshold=nms.score_threshold,
        nms_iou_threshold=nms.iou_threshold,
        max_detections_per_class=nms.max_detections_per_class,
        max_total_detections=nms.max_total_detections,
        kernel_size=kernel_size,
        predictor_min_depth=predictor_min_depth,
        predictor_max_depth=predictor_max_depth,
        num_layers_before_predictor=layers_before,
        use_dropout=use_dropout and is_training,
        dropout_keep_prob=dropout_keep,
        apply_sigmoid_to_scores=apply_sigmoid,
        max_gt_boxes=max_gt_boxes,
        dtype=dtype,
    )
