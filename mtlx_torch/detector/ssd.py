"""SSD, the single-shot multi-feature-map detector (port of
mtlx/detector/ssd.py), with the DetectionModel interface of FasterRCNN:
`preprocess`, `predict` (serving), `predict_train`, `loss` and
`postprocess`, so the train, eval and export CLIs drive either.

The canvas is the fixed resizer's exact shape (300x300: conv11 at 19x19,
1917 anchors); a batch is padded to the whole canvas, never to a bucket
(`supports_bucketed_compute` is false). Ground truth arrives in absolute
canvas pixels and anchors are canvas-normalized, so the loss normalizes
the ground truth by the canvas; `postprocess` clips each image's
detections to its true region and re-expresses them normalized to it.

On the card a training step launches the IoU kernel once (the whole
batch's ground truth against the shared anchors) and serving launches
NMS once (every class problem of every image). Hard negatives are mined
as in mtlx: the negatives' losses sorted in descending order, a second
sort for the ranks, both stable so ties rank as `jnp.argsort` ranks them,
and the first max(3 x matches, 3) (at most all negatives) kept.

Batch norm trains live when the config says so (`batch_norm { train:
true }`): `predict_train` runs the modules in training mode, and the
train step folds the batch statistics into the moving ones after the
update (backbones/resnet.py LiveBatchNorm). The only random draws are
the box predictors' dropout uniforms, in training with use_dropout
(`dropout_shapes`, train_step.make_draws).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.anchors.multi_grid import create_ssd_anchors
from mtlx_torch.assign import matcher as matcher_lib
from mtlx_torch.assign import similarity as sim_lib
from mtlx_torch.assign.target_assigner import TargetAssigner
from mtlx_torch.backbones import resnet
from mtlx_torch.backbones.feature_maps import MultiResolutionFeatureMaps, ssd_layer_depths
from mtlx_torch.backbones.inception_resnet_v2 import BNKnobs
from mtlx_torch.backbones.inception_v2 import InceptionV2
from mtlx_torch.backbones.mobilenet import MobileNetV1
from mtlx_torch.coders import box_coders
from mtlx_torch.detector.faster_rcnn import _flush_subnormal, _init_, softmax
from mtlx_torch.device import DeviceLike, resolve_device
from mtlx_torch.heads import box_predictors
from mtlx_torch.losses import losses as loss_lib
from mtlx_torch.ops import nms as nms_lib


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    num_classes: int = 20
    canvas_size: Tuple[int, int] = (320, 320)
    feature_extractor: str = "ssd_mobilenet_v1"  # or ssd_inception_v2
    depth_multiplier: float = 1.0
    min_depth: int = 8
    # feature_extractor.conv_hyperparams.batch_norm.{epsilon,center,scale}
    bn_epsilon: float = 1e-3
    bn_center: bool = True
    bn_scale: bool = True
    # batch_norm.{train,decay}: live batch norm in training
    batch_norm_trainable: bool = False
    bn_momentum: float = 0.999
    insert_1x1_conv: bool = True
    # anchors
    num_layers: int = 6
    min_scale: float = 0.2
    max_scale: float = 0.95
    aspect_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
    reduce_boxes_in_lowest_layer: bool = True
    # matcher / target assignment
    matched_threshold: float = 0.5
    unmatched_threshold: float = 0.5
    similarity: str = "iou"  # iou | ioa | neg_sq_dist
    box_coder_scales: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    # losses
    classification_loss: str = "weighted_sigmoid"  # or weighted_softmax
    localization_weight: float = 1.0
    classification_weight: float = 1.0
    negatives_per_positive: float = 3.0
    min_negatives_per_image: int = 3
    normalize_loss_by_num_matches: bool = True
    # box predictor (ConvolutionalBoxPredictor proto)
    predictor_min_depth: int = 0
    predictor_max_depth: int = 0
    num_layers_before_predictor: int = 0
    use_dropout: bool = False
    dropout_keep_prob: float = 0.8
    apply_sigmoid_to_scores: bool = False
    # post-processing
    score_converter: str = "sigmoid"
    nms_score_threshold: float = 1e-8
    nms_iou_threshold: float = 0.6
    max_detections_per_class: int = 100
    max_total_detections: int = 100
    box_code_size: int = 4
    kernel_size: int = 3
    max_gt_boxes: int = 100
    dtype: Any = torch.bfloat16


class SSDModules(nn.Module):
    """All parameters of the detector, named as mtlx's flax modules:
    backbone, extra (the pyramid's extra maps) and box_predictor_{i}."""

    def __init__(self, cfg: SSDConfig, anchors_per_location: Tuple[int, ...]):
        super().__init__()
        bn = BNKnobs(cfg.batch_norm_trainable,
                     resnet.BNSpec(cfg.bn_momentum, cfg.bn_epsilon, cfg.bn_center, cfg.bn_scale))
        if cfg.feature_extractor == "ssd_inception_v2":
            self.backbone = InceptionV2(cfg.dtype, bn, cfg.depth_multiplier, cfg.min_depth)
            endpoints = [self.backbone.channels_16, self.backbone.channels_32]
        else:
            self.backbone = MobileNetV1(cfg.depth_multiplier, cfg.min_depth, cfg.dtype, bn)
            endpoints = self.backbone.out_channels
        self.extra = MultiResolutionFeatureMaps(
            endpoints, ssd_layer_depths(cfg.num_layers), cfg.depth_multiplier, cfg.min_depth,
            cfg.insert_1x1_conv, dtype=cfg.dtype)
        self.num_layers = cfg.num_layers
        for i, width in enumerate(self.extra.out_channels):
            self.add_module(f"box_predictor_{i}", box_predictors.ConvolutionalBoxPredictor(
                width, cfg.num_classes, anchors_per_location[i], cfg.box_code_size,
                cfg.kernel_size, cfg.predictor_min_depth, cfg.predictor_max_depth,
                cfg.num_layers_before_predictor, cfg.use_dropout, cfg.dropout_keep_prob,
                cfg.apply_sigmoid_to_scores, cfg.dtype))

    def forward(self, images: Tensor, dropout: Optional[List[Tensor]] = None):
        """[B, H, W, 3] -> (class logits [B, A, K+1], box encodings [B, A,
        4], float32, and the feature maps' (h, w)). `dropout`: each
        predictor's dropout draws, in training with use_dropout."""
        feats = self.extra(self.backbone(images))
        cls_list, box_list = [], []
        for i, fmap in enumerate(feats):
            cls, box = getattr(self, f"box_predictor_{i}")(
                fmap, None if dropout is None else dropout[i])
            cls_list.append(cls)
            box_list.append(box)
        return (torch.cat(cls_list, dim=1), torch.cat(box_list, dim=1),
                [tuple(f.shape[1:3]) for f in feats])


def mine_hard_negatives(per_anchor_cls: Tensor, neg_mask: Tensor, num_matches: Tensor,
                        negatives_per_positive: float, min_negatives_per_image: int) -> Tensor:
    """Classic 3:1 hard negative mining (mtlx's SSD.loss): per image, the
    max(negatives_per_positive x matches, min_negatives_per_image)
    negatives of the largest loss, at most all of them;
    negatives_per_positive <= 0 keeps every negative. The losses sort in
    descending order and a second sort gives each anchor its rank, both
    stable, so ties rank by anchor index as jnp.argsort ranks them.
    [B, A] losses and negatives, [B] matches -> [B, A] bool."""
    neg_count = neg_mask.float().sum(-1)
    if negatives_per_positive > 0:
        num_neg = torch.minimum(
            torch.clamp_min(negatives_per_positive * num_matches, float(min_negatives_per_image)),
            neg_count)
    else:
        num_neg = neg_count
    neg_losses = torch.where(neg_mask, per_anchor_cls, float("-inf"))
    order = torch.argsort(-neg_losses, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return neg_mask & (ranks < num_neg[:, None])


_SIMILARITIES = {
    "iou": sim_lib.iou_similarity,
    "ioa": sim_lib.ioa_similarity,
    "neg_sq_dist": sim_lib.neg_sq_dist_similarity,
}


class SSD:
    """Single-shot detector around SSDModules, on one device. `device=None`
    means the CUDA device (raises without one)."""

    # the anchors are fixed to the canvas: batches are padded to all of it
    supports_bucketed_compute = False

    def __init__(self, cfg: SSDConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = create_ssd_anchors(
            num_layers=cfg.num_layers, min_scale=cfg.min_scale, max_scale=cfg.max_scale,
            aspect_ratios=cfg.aspect_ratios,
            reduce_boxes_in_lowest_layer=cfg.reduce_boxes_in_lowest_layer)
        self.modules = SSDModules(cfg, tuple(gen.num_anchors_per_location)).to(self.device).eval()
        if self.device.type == "cuda":
            self.modules.to(memory_format=torch.channels_last)
        self.box_coder = box_coders.make_faster_rcnn_coder(cfg.box_coder_scales)
        self._assigner = TargetAssigner(
            similarity_fn=_SIMILARITIES[cfg.similarity],
            matcher_fn=matcher_lib.make_argmax_matcher(
                cfg.matched_threshold, cfg.unmatched_threshold, force_match_for_each_row=True),
            box_coder=self.box_coder,
        )
        self.feature_map_shapes = self._feature_shapes(cfg.canvas_size, cfg.num_layers)
        self._anchors_cpu = gen.generate(self.feature_map_shapes)
        self.anchors = self._anchors_cpu.to(self.device)

    @staticmethod
    def _feature_shapes(canvas, num_layers: int) -> List[Tuple[int, int]]:
        """The maps' (h, w): /16 at the first endpoint, then halved (SAME
        padding: ceil division, at least 1)."""
        halve = lambda x: max(1, -(-x // 2))
        h, w = canvas
        for _ in range(4):
            h, w = halve(h), halve(w)
        shapes = [(h, w)]
        for _ in range(num_layers - 1):
            h, w = halve(h), halve(w)
            shapes.append((h, w))
        return shapes

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a CPU generator), drawn as
        mtlx's flax init draws them: every conv lecun_normal, biases 0,
        batch norm at scale 1, offset 0, mean 0, variance 1."""
        state = {}
        for name, t in self.modules.state_dict().items():
            w = torch.empty(t.shape, dtype=torch.float32)
            if name.endswith("weight"):
                receptive = w[0, 0].numel()
                _init_(w, None, w.shape[1] * receptive, w.shape[0] * receptive, generator)
            elif name.endswith((".scale", ".var")):
                w.fill_(1.0)
            else:
                w.zero_()
            state[name] = w
        self.modules.load_state_dict(state)

    def to(self, device: DeviceLike) -> "SSD":
        self.device = resolve_device(device)
        self.modules.to(self.device)
        if self.device.type == "cuda":
            self.modules.to(memory_format=torch.channels_last)
        self.anchors = self._anchors_cpu.to(self.device)
        return self

    # ---- DetectionModel API ----

    @staticmethod
    def preprocess(images: Tensor) -> Tensor:
        """Scale 0-255 pixels to [-1, 1]: (2 / 255) x - 1."""
        return images * (2.0 / 255.0) - 1.0

    def dropout_shapes(self, batch_size: int) -> List[Tuple[int, ...]]:
        """The shape of each predictor's dropout draws ([B, h, w, depth])
        when the config trains with dropout, else none."""
        if not self.cfg.use_dropout:
            return []
        return [(batch_size, h, w, getattr(self.modules, f"box_predictor_{i}").depth)
                for i, (h, w) in enumerate(self.feature_map_shapes)]

    def _run(self, images: Tensor, dropout: Optional[List[Tensor]] = None) -> Dict[str, Tensor]:
        if tuple(images.shape[1:3]) != tuple(self.cfg.canvas_size):
            raise ValueError(f"SSD computes on its whole canvas {self.cfg.canvas_size}, got "
                             f"images of {tuple(images.shape[1:3])} (pad_for_model pads)")
        cls_logits, box_encodings, shapes = self.modules(images, dropout)
        if box_encodings.shape[1] != self.anchors.shape[0]:
            raise ValueError(
                f"anchor count {self.anchors.shape[0]} != predictor outputs "
                f"{box_encodings.shape[1]} (feature shapes {shapes} vs precomputed "
                f"{self.feature_map_shapes})")
        return {"class_predictions_with_background": cls_logits,
                "box_encodings": box_encodings, "anchors": self.anchors}

    @torch.inference_mode()
    def predict(self, images: Tensor, true_shapes: Optional[Tensor] = None,
                training: bool = False) -> Dict[str, Tensor]:
        """Serve: images [B, H, W, 3] preprocessed on the canvas. Batch norm
        reads its moving statistics."""
        if training:
            raise NotImplementedError(
                "predict is the serving entry; training predicts with "
                "predict_train(images, true_shapes, groundtruth, draws)")
        self.modules.eval()
        return self._run(images)

    def predict_train(self, images: Tensor, true_shapes: Tensor,
                      groundtruth: Dict[str, Tensor],
                      draws: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
        """The training forward (mtlx predict(training=True)): live batch
        norm normalizes by the batch and keeps its statistics for the
        train step to commit; with use_dropout, draws["dropout_{i}"] drop
        each predictor's class input."""
        self.modules.train()
        dropout = None
        if self.cfg.use_dropout:
            dropout = [draws[f"dropout_{i}"] for i in range(self.cfg.num_layers)]
        return self._run(images, dropout)

    def _normalize_gt(self, gt_boxes: Tensor) -> Tensor:
        """Absolute canvas pixels -> canvas-normalized (the anchors' frame)."""
        ch, cw = self.cfg.canvas_size
        return gt_boxes / torch.tensor([ch, cw, ch, cw], dtype=gt_boxes.dtype,
                                       device=gt_boxes.device)

    def loss(self, pred: Dict[str, Tensor], gt: Dict[str, Tensor],
             draws: Optional[Dict[str, Tensor]] = None, replicas=None) -> Dict[str, Tensor]:
        """Classification (mined 3:1) and localization losses, each the
        mean over the images of the image's sum over its anchors divided
        by its matches. With `replicas` the batch is this rank's rows: the
        terms are per image and means, so their mean over the ranks is
        mtlx's on the global batch."""
        c = self.cfg
        k = c.num_classes
        cls_logits = pred["class_predictions_with_background"]
        dev = cls_logits.device
        labels = torch.clamp(gt["classes"].long() + 1, 0, k)
        onehot = F.one_hot(labels, k + 1).float()
        unmatched = F.one_hot(torch.tensor(0, device=dev), k + 1).float()
        res = self._assigner.assign(pred["anchors"], self._normalize_gt(gt["boxes"]),
                                    gt_labels=onehot, gt_mask=gt["mask"],
                                    unmatched_cls_target=unmatched)
        matched = res.match >= 0
        num_matches = matched.float().sum(-1)  # [B]
        if c.classification_loss == "weighted_sigmoid":
            per_anchor_cls = loss_lib.weighted_sigmoid_classification_loss(
                cls_logits, res.cls_targets, res.cls_weights).sum(-1)
        else:
            per_anchor_cls = loss_lib.weighted_softmax_classification_loss(
                cls_logits, res.cls_targets, res.cls_weights)
        neg_mask = (res.match == matcher_lib.UNMATCHED) & (res.cls_weights > 0)
        keep_neg = mine_hard_negatives(per_anchor_cls.detach(), neg_mask, num_matches,
                                       c.negatives_per_positive, c.min_negatives_per_image)
        cls_loss = torch.where(matched | keep_neg, per_anchor_cls, 0.0).sum(-1)
        loc_loss = loss_lib.weighted_smooth_l1_loss(
            pred["box_encodings"], res.reg_targets, res.reg_weights).sum(-1)
        normalizer = (torch.clamp_min(num_matches, 1.0) if c.normalize_loss_by_num_matches
                      else torch.ones_like(num_matches))
        out = {
            "Loss/classification_loss": (cls_loss / normalizer).mean() * c.classification_weight,
            "Loss/localization_loss": (loc_loss / normalizer).mean() * c.localization_weight,
        }
        out["total_loss"] = out["Loss/classification_loss"] + out["Loss/localization_loss"]
        return out

    def _convert_scores(self, cls_logits: Tensor) -> Tensor:
        kind = self.cfg.score_converter
        if kind == "sigmoid":
            return _flush_subnormal(torch.sigmoid(cls_logits))
        if kind == "softmax":
            return softmax(cls_logits)
        if kind == "identity":
            return cls_logits
        raise ValueError(f"unknown score_converter {kind!r}")

    @torch.inference_mode()
    def postprocess(self, pred: Dict[str, Tensor],
                    true_shapes: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Decode, then per-class NMS of every class of every image in one
        launch, clipped to each image's true region -> detection_boxes
        (normalized to the true image), detection_scores,
        detection_classes (0-based), num_detections."""
        c = self.cfg
        ch, cw = c.canvas_size
        box_enc = pred["box_encodings"]
        b = box_enc.shape[0]
        dev = box_enc.device
        if true_shapes is None:
            true_shapes = torch.tensor([[ch, cw]], dtype=torch.int32, device=dev).expand(b, 2)
        boxes = self.box_coder.decode(box_enc, pred["anchors"])  # [B, A, 4]
        scores = self._convert_scores(pred["class_predictions_with_background"])[..., 1:]
        canvas = torch.tensor([ch, cw], dtype=torch.float32, device=dev)
        rel = true_shapes.to(dev).float() / canvas  # [B, 2]: th, tw
        th, tw = rel[:, 0], rel[:, 1]
        zero = torch.zeros_like(th)
        res = nms_lib.batch_multiclass_non_max_suppression(
            boxes[:, :, None, :], scores,
            score_threshold=c.nms_score_threshold,
            iou_threshold=c.nms_iou_threshold,
            max_size_per_class=c.max_detections_per_class,
            max_total_size=c.max_total_detections,
            clip_window=torch.stack([zero, zero, th, tw], dim=1),
        )
        # canvas-normalized -> true-image-normalized
        scale = torch.stack([1.0 / th, 1.0 / tw, 1.0 / th, 1.0 / tw], dim=1)
        return {
            "detection_boxes": torch.clamp(res.boxes * scale[:, None, :], 0.0, 1.0),
            "detection_scores": res.scores,
            "detection_classes": res.classes,
            "num_detections": res.num_valid,
        }
