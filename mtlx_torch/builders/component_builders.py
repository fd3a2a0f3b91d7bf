"""Per-proto component builders (port of mtlx/builders/component_builders.py,
the reference's builders/*_builder.py): an anchor generator, box coder,
matcher, similarity, image resizer, post-processing, losses,
hyperparameters and input reader, each from its config message of the
port's own reader (config/text_format.py). The model builders do this
work themselves; these are the public config-to-component API for a user
assembling a model of their own.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from mtlx_torch.anchors.grid import GridAnchorGenerator
from mtlx_torch.anchors.multi_grid import create_ssd_anchors
from mtlx_torch.assign import matcher as matcher_lib
from mtlx_torch.assign import similarity as sim_lib
from mtlx_torch.coders import box_coders
from mtlx_torch.losses import losses as loss_lib


def build_anchor_generator(proto):
    """AnchorGenerator message -> a grid or SSD anchor generator."""
    kind = proto.WhichOneof("anchor_generator_oneof")
    if kind == "grid_anchor_generator":
        g = proto.grid_anchor_generator
        return GridAnchorGenerator(
            scales=tuple(g.scales) or (0.25, 0.5, 1.0, 2.0),
            aspect_ratios=tuple(g.aspect_ratios) or (0.5, 1.0, 2.0),
            base_anchor_size=(float(g.height or 256), float(g.width or 256)),
            anchor_stride=(float(g.height_stride), float(g.width_stride)),
            anchor_offset=(float(g.height_offset), float(g.width_offset)),
        )
    if kind == "ssd_anchor_generator":
        g = proto.ssd_anchor_generator
        return create_ssd_anchors(
            num_layers=g.num_layers,
            min_scale=g.min_scale,
            max_scale=g.max_scale,
            scales=tuple(g.scales),
            aspect_ratios=tuple(g.aspect_ratios) or (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
            interpolated_scale_aspect_ratio=g.interpolated_scale_aspect_ratio,
            base_anchor_size=(g.base_anchor_height, g.base_anchor_width),
            reduce_boxes_in_lowest_layer=g.reduce_boxes_in_lowest_layer,
        )
    raise ValueError(f"unknown anchor generator {kind!r}")


def build_box_coder(proto) -> box_coders.BoxCoder:
    kind = proto.WhichOneof("box_coder_oneof")
    if kind == "faster_rcnn_box_coder":
        c = proto.faster_rcnn_box_coder
        return box_coders.make_faster_rcnn_coder(
            (c.y_scale, c.x_scale, c.height_scale, c.width_scale))
    if kind == "mean_stddev_box_coder":
        return box_coders.make_mean_stddev_coder(proto.mean_stddev_box_coder.stddev)
    if kind == "square_box_coder":
        return box_coders.make_square_coder((proto.square_box_coder.scale_factor,) * 3)
    if kind == "keypoint_box_coder":
        c = proto.keypoint_box_coder
        scale = (c.y_scale, c.x_scale, c.height_scale, c.width_scale)
        return box_coders.BoxCoder(
            encode=functools.partial(box_coders.keypoint_encode, scale_factors=scale),
            decode=functools.partial(box_coders.keypoint_decode,
                                     num_keypoints=c.num_keypoints, scale_factors=scale),
            code_size=4 + 2 * c.num_keypoints,
        )
    raise ValueError(f"unknown box coder {kind!r}")


def build_matcher(proto) -> Callable:
    kind = proto.WhichOneof("matcher_oneof")
    if kind == "argmax_matcher":
        m = proto.argmax_matcher
        # ignore_thresholds drops both thresholds: every column matches its
        # argmax row, with no negatives and no ignores
        low = float("-inf") if m.ignore_thresholds else m.unmatched_threshold
        high = float("-inf") if m.ignore_thresholds else m.matched_threshold
        return matcher_lib.make_argmax_matcher(
            high, low, force_match_for_each_row=m.force_match_for_each_row,
            negatives_lower_than_unmatched=m.negatives_lower_than_unmatched)
    if kind == "bipartite_matcher":
        return matcher_lib.greedy_bipartite_match
    raise ValueError(f"unknown matcher {kind!r}")


def build_region_similarity_calculator(proto) -> Callable:
    return {
        "iou_similarity": sim_lib.iou_similarity,
        "ioa_similarity": sim_lib.ioa_similarity,
        "neg_sq_dist_similarity": sim_lib.neg_sq_dist_similarity,
    }[proto.WhichOneof("region_similarity")]


def build_image_resizer(proto) -> Tuple[str, dict]:
    from mtlx_torch.builders.model_builder import resizer_params

    return resizer_params(proto)


def build_post_processing(proto):
    """PostProcessing message -> (the NMS keyword arguments, the score
    converter's name)."""
    nms = proto.batch_non_max_suppression
    kwargs = dict(
        score_threshold=nms.score_threshold,
        iou_threshold=nms.iou_threshold,
        max_size_per_class=nms.max_detections_per_class,
        max_total_size=nms.max_total_detections,
    )
    return kwargs, {0: "identity", 1: "sigmoid", 2: "softmax"}[proto.score_converter]


def build_classification_loss(proto) -> Callable:
    kind = proto.WhichOneof("classification_loss")
    if kind == "weighted_sigmoid" or kind is None:
        return loss_lib.weighted_sigmoid_classification_loss
    if kind == "weighted_softmax":
        return functools.partial(loss_lib.weighted_softmax_classification_loss,
                                 logit_scale=proto.weighted_softmax.logit_scale)
    if kind == "bootstrapped_sigmoid":
        b = proto.bootstrapped_sigmoid
        return functools.partial(loss_lib.bootstrapped_sigmoid_classification_loss,
                                 alpha=b.alpha,
                                 bootstrap_type="hard" if b.hard_bootstrap else "soft")
    raise ValueError(f"unknown classification loss {kind!r}")


def build_localization_loss(proto) -> Callable:
    kind = proto.WhichOneof("localization_loss")
    if kind == "weighted_l2":
        return loss_lib.weighted_l2_loss
    if kind == "weighted_smooth_l1" or kind is None:
        return loss_lib.weighted_smooth_l1_loss
    if kind == "weighted_iou":
        return loss_lib.weighted_iou_loss
    raise ValueError(f"unknown localization loss {kind!r}")


def build_hard_example_miner(m, cls_loss_weight: float = 0.05,
                             loc_loss_weight: float = 0.06):
    """HardExampleMiner message -> HardExampleMinerConfig; the callers pass
    their configured loss weights, so the miner ranks by the loss that
    trains."""
    return loss_lib.HardExampleMinerConfig(
        num_hard_examples=m.num_hard_examples,
        iou_threshold=m.iou_threshold,
        loss_type={0: "both", 1: "cls", 2: "loc"}[m.loss_type],
        cls_loss_weight=cls_loss_weight,
        loc_loss_weight=loc_loss_weight,
        max_negatives_per_positive=float(m.max_negatives_per_positive),
        min_negatives_per_image=m.min_negatives_per_image,
    )


def build_losses(loss_proto):
    """Loss message -> (classification loss, localization loss, their
    weights, the miner's config or None). `anchorwise_output` changes
    nothing: every loss is per anchor here."""
    miner = None
    if loss_proto.HasField("hard_example_miner"):
        miner = build_hard_example_miner(loss_proto.hard_example_miner,
                                         cls_loss_weight=loss_proto.classification_weight,
                                         loc_loss_weight=loss_proto.localization_weight)
    return (build_classification_loss(loss_proto.classification_loss),
            build_localization_loss(loss_proto.localization_loss),
            loss_proto.classification_weight, loss_proto.localization_weight, miner)


def make_initializer(spec) -> Callable[..., Tensor]:
    """An initializer of a spec (None: lecun_normal; ("truncated_normal",
    stddev); ("variance_scaling", scale, mode, distribution)): init(t,
    generator=None) fills a weight in PyTorch's layout ([out, in, kh, kw]
    or [out, in]) in place as flax's initializer draws its kernel (the
    same distribution, not the same numbers), and returns it."""
    from mtlx_torch.detector.faster_rcnn import _init_

    def init(t: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        receptive = t[0, 0].numel() if t.dim() > 2 else 1
        with torch.no_grad():
            _init_(t, spec, t.shape[1] * receptive, t.shape[0] * receptive,
                   generator or torch.default_generator)
        return t

    return init


def build_hyperparams(proto) -> dict:
    """Hyperparams message -> the settings it gives a layer: op, an
    initializer (make_initializer), the regularizer and its weight, the
    activation and the batch norm switches."""
    from mtlx_torch.builders.model_builder import _initializer_spec

    reg_kind = proto.regularizer.WhichOneof("regularizer_oneof")
    reg_weight = 0.0
    if reg_kind == "l2_regularizer":
        reg_weight = proto.regularizer.l2_regularizer.weight
    elif reg_kind == "l1_regularizer":
        reg_weight = proto.regularizer.l1_regularizer.weight
    return {
        "op": "fc" if proto.op == 2 else "conv",
        "initializer": make_initializer(_initializer_spec(proto)),
        "regularizer": reg_kind,
        "regularizer_weight": reg_weight,
        "activation": {0: None, 1: "relu", 2: "relu6"}[proto.activation],
        "batch_norm": proto.HasField("batch_norm"),
        "batch_norm_train": proto.batch_norm.train,
    }


def build_input_reader(proto, canvas_size, resizer, max_boxes: int = 100,
                       process_index: int = 0, process_count: int = 1):
    """InputReader message -> the port's DetectionDataset."""
    from mtlx_torch.data.loader import DetectionDataset

    if proto.WhichOneof("input_reader") != "tf_record_input_reader":
        raise ValueError("only tf_record_input_reader is supported")
    return DetectionDataset(
        list(proto.tf_record_input_reader.input_path),
        canvas_size=canvas_size,
        resizer=resizer,
        max_boxes=max_boxes,
        process_index=process_index,
        process_count=process_count,
        load_instance_masks=proto.load_instance_masks,
        num_keypoints=proto.num_keypoints,
    )
