"""MTL Faster R-CNN with a ResNet trunk and frozen batch norm, in plain
PyTorch: the benchmark's reference for the train cells. The layer
equations, the proposal selection, the target assignment, the recycled
labels and the losses are frozen copies of mtlx_torch/detector/
faster_rcnn.py's training path (`predict_train`, `loss`), on the plain
kernels of `kernels_plain`. The parameter names are the port's, so one
state dict loads into both.

The second stage takes its proposals from outside (`losses` gets the
sampled proposals of the run under test): the top-k / NMS / sampling
stage is discontinuous in the RPN's scores, so it is checked on its own
(`sampled_proposals`, from the RPN outputs that the run under test
computed) and not followed through a lower-precision rounding."""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from . import box_coders, box_ops, losses as loss_lib, matcher as matcher_lib, nms as nms_lib
from . import recycle, roi as roi_lib, samplers, target_assigner
from .grid import GridAnchorGenerator
from .heads import ForegroundHead, MaskRCNNBoxPredictor, PooledHead, RPNHead
from .resnet import ResNetBoxClassifierFeatures, ResNetProposalFeatures, preprocess_images


def f32(x: float) -> float:
    """x as a float proto field holds it (rounded to float32)."""
    return struct.unpack("f", struct.pack("f", x))[0]


@dataclasses.dataclass(frozen=True)
class Config:
    """The sizes a configuration file's `model` block states."""

    num_classes: int
    resnet_depth: int
    feature_stride: int
    anchor_scales: Tuple[float, ...]
    anchor_aspect_ratios: Tuple[float, ...]
    anchor_base_size: Tuple[float, float]
    rpn_depth: int
    rpn_kernel_size: int
    first_stage_nms_score_threshold: float
    first_stage_nms_iou_threshold: float
    first_stage_pre_nms_top_k: int
    first_stage_max_proposals: int
    first_stage_minibatch_size: int
    first_stage_positive_balance_fraction: float
    first_stage_localization_loss_weight: float
    first_stage_objectness_loss_weight: float
    initial_crop_size: int
    maxpool_kernel_size: int
    maxpool_stride: int
    second_stage_batch_size: int
    second_stage_balance_fraction: float
    second_stage_localization_loss_weight: float
    second_stage_classification_loss_weight: float
    multiobject_weight: float
    closeness_weight: float
    foreground_weight: float
    window_enlarge_factor: float
    closeness_sigma: float
    second_stage_nms_score_threshold: float
    second_stage_nms_iou_threshold: float
    second_stage_max_detections_per_class: int
    second_stage_max_total_detections: int

    @classmethod
    def from_dict(cls, d: Dict) -> "Config":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)}
        for k in ("anchor_scales", "anchor_aspect_ratios", "anchor_base_size"):
            kw[k] = tuple(float(v) for v in kw[k])
        for k in ("first_stage_nms_iou_threshold", "second_stage_nms_iou_threshold",
                  "multiobject_weight", "closeness_weight"):
            kw[k] = f32(kw[k])  # as the builder reads them from the proto
        return cls(**kw)


def softmax(logits: Tensor) -> Tensor:
    """exp(x - max) / sum over the last axis, subnormal results flushed."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.where(p < torch.finfo(torch.float32).tiny, 0.0, p)


def random_horizontal_flip(images: Tensor, boxes: Tensor, true_shape: Tensor,
                           uniforms: Tensor) -> Tuple[Tensor, Tensor]:
    """Mirror the true-image region of each image whose draw is below 0.5,
    and its boxes (float images [B, H, W, 3], boxes [B, G, 4] px)."""
    do = uniforms < 0.5
    b, height, width, ch = images.shape
    w = true_shape[:, 1].to(torch.int64)[:, None]
    cols = torch.arange(width, device=images.device)
    src = torch.where(cols < w, w - 1 - cols, cols)
    flipped = torch.gather(images, 2, src[:, None, :, None].expand(b, height, width, ch))
    wf = w.to(boxes.dtype)
    fboxes = torch.stack(
        [boxes[..., 0], wf - boxes[..., 3], boxes[..., 2], wf - boxes[..., 1]], dim=-1)
    return (torch.where(do[:, None, None, None], flipped, images),
            torch.where(do[:, None, None], fboxes, boxes))


class Detector(nn.Module):
    """The parameters under the port's names, and the training path."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32, mtl: bool = True):
        super().__init__()
        self.cfg = cfg
        k = cfg.num_classes
        self.backbone = ResNetProposalFeatures(cfg.resnet_depth, dtype)
        self.classifier_backbone = ResNetBoxClassifierFeatures(cfg.resnet_depth, dtype)
        a = len(cfg.anchor_scales) * len(cfg.anchor_aspect_ratios)
        self.rpn = RPNHead(1024, a, cfg.rpn_depth, cfg.rpn_kernel_size, 1, dtype)
        self.box_predictor = MaskRCNNBoxPredictor(2048, k, dtype)
        if mtl:  # the auxiliary heads train; serving builds without them
            self.fg_head = ForegroundHead(1024, dtype=dtype)
            self.mo_head = PooledHead(1024, k, dtype=dtype)
            self.cl_head = PooledHead(1024, k, dtype=dtype)
        self.anchor_gen = GridAnchorGenerator(cfg.anchor_scales, cfg.anchor_aspect_ratios,
                                              cfg.anchor_base_size,
                                              (float(cfg.feature_stride),) * 2)
        self.coder = box_coders.make_faster_rcnn_coder()
        self.proposal_assigner = target_assigner.create_target_assigner("FasterRCNN", "proposal")
        self.detection_assigner = target_assigner.create_target_assigner("FasterRCNN",
                                                                         "detection")

    def anchors_for(self, hw: Tuple[int, int], device) -> Tensor:
        s = self.cfg.feature_stride
        raw = self.anchor_gen.generate((-(-hw[0] // s), -(-hw[1] // s)))
        window = torch.tensor([0.0, 0.0, float(hw[0]), float(hw[1])])
        return box_ops.clip_to_window(raw, window).to(device)

    def rpn_outputs(self, images: Tensor):
        """Float 0-255 images [B, H, W, 3] -> (stride-16 map, objectness
        logits [B, A, 2], box encodings [B, A, 4])."""
        feats = self.backbone(preprocess_images(images))
        obj, enc = self.rpn(feats)
        return feats, obj, enc

    # ---- the stage that is checked on its own ----

    @torch.no_grad()
    def proposals(self, obj: Tensor, enc: Tensor, true_shapes: Tensor, hw: Tuple[int, int]):
        """Decode -> clip to the true image -> top-k -> NMS: the proposals
        [B, first_stage_max_proposals, 4] px, their scores and mask."""
        c = self.cfg
        anchors = self.anchors_for(hw, obj.device)
        b = obj.shape[0]
        scores = softmax(obj)[..., 1]
        boxes = self.coder.decode(enc, anchors[None])
        window = torch.cat([torch.zeros(b, 2, device=boxes.device), true_shapes.float()], dim=1)
        boxes = box_ops.clip_to_window(boxes, window)
        scores = torch.where(box_ops.area(boxes) > 0, scores, float("-inf"))
        k = min(c.first_stage_pre_nms_top_k, boxes.shape[1])
        top_scores, top_idx = nms_lib.top_k(scores, k)
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))
        area_ok = box_ops.area(top_boxes) > 0
        top_scores = torch.where(area_ok, top_scores, 0.0)
        idx, keep = nms_lib.batched_non_max_suppression(
            top_boxes, top_scores, max_output_size=c.first_stage_max_proposals,
            iou_threshold=c.first_stage_nms_iou_threshold,
            score_threshold=c.first_stage_nms_score_threshold, valid_mask=area_ok)
        idx = idx.long()
        proposals = torch.gather(top_boxes, 1, idx[..., None].expand(*idx.shape, 4))
        return proposals, torch.where(keep, torch.gather(top_scores, 1, idx), 0.0), keep

    @torch.no_grad()
    def sampled_proposals(self, obj: Tensor, enc: Tensor, true_shapes: Tensor, gt_boxes: Tensor,
                          gt_mask: Tensor, hw: Tuple[int, int], pos: Tensor, neg: Tensor):
        """The proposals, balanced-sampled to second_stage_batch_size and
        compacted to the front: [B, P, 4] and their mask [B, P]."""
        c = self.cfg
        proposals, _, keep = self.proposals(obj, enc, true_shapes, hw)
        res = self.detection_assigner.assign(proposals, gt_boxes, gt_mask=gt_mask)
        positive = (res.match >= 0) & keep
        indicator = keep & (res.match != matcher_lib.IGNORED)
        sampled = samplers.balanced_subsample(indicator, positive, c.second_stage_batch_size,
                                              c.second_stage_balance_fraction, (pos, neg))
        order = torch.argsort((~sampled).to(torch.uint8), dim=-1, stable=True)
        idx = order[:, : c.second_stage_batch_size]
        return matcher_lib.take_rows(proposals, idx), torch.gather(sampled, 1, idx)

    # ---- the loss of a block of images ----

    def losses(self, feats: Tensor, obj: Tensor, enc: Tensor, gt: Dict[str, Tensor],
               anchor_draws: Tuple[Tensor, Tensor], proposals: Tensor, proposal_mask: Tensor,
               batch_size: int, counts: Tuple[Tensor, Tensor]) -> Dict[str, Tensor]:
        """The `Loss/*` terms of these rows as their share of the terms of
        the whole batch of `batch_size` images: the per-image means divide
        by batch_size, the multi-object and closeness terms by `counts`,
        their valid windows and objects over the whole batch. Summed over
        the blocks of a batch, each term is the port's term on the batch."""
        c = self.cfg
        s = c.feature_stride
        hw = (feats.shape[1] * s, feats.shape[2] * s)
        anchors = self.anchors_for(hw, feats.device)
        out = {}
        # first stage
        res = self.proposal_assigner.assign(anchors, gt["boxes"], gt_mask=gt["mask"])
        sampled = samplers.balanced_subsample(
            res.cls_weights > 0, res.match >= 0, c.first_stage_minibatch_size,
            c.first_stage_positive_balance_fraction, anchor_draws)
        weights = sampled.float()
        normalizer = torch.clamp_min(weights.sum(-1), 1.0)
        t = res.cls_targets[..., 0]
        obj_loss = loss_lib.weighted_softmax_classification_loss(
            obj, torch.stack([1.0 - t, t], dim=-1), weights)
        loc_loss = loss_lib.weighted_smooth_l1_loss(enc, res.reg_targets,
                                                    res.reg_weights * sampled)
        out["Loss/RPNLoss/objectness_loss"] = (
            (obj_loss.sum(-1) / normalizer).sum() / batch_size
            * c.first_stage_objectness_loss_weight)
        out["Loss/RPNLoss/localization_loss"] = (
            (loc_loss.sum(-1) / normalizer).sum() / batch_size
            * c.first_stage_localization_loss_weight)
        # second stage, on the given proposals
        canvas = torch.tensor([hw[0], hw[1], hw[0], hw[1]], dtype=torch.float32,
                              device=feats.device)
        cls, box = self.second_stage(feats, proposals)
        k = c.num_classes
        onehot = recycle.one_hot(gt["classes"] + 1, k + 1)
        background = recycle.one_hot(torch.zeros((), dtype=torch.int64, device=feats.device),
                                     k + 1)
        res = self.detection_assigner.assign(proposals, gt["boxes"], gt_labels=onehot,
                                             gt_mask=gt["mask"], unmatched_cls_target=background)
        w = proposal_mask.float()
        cls_loss = loss_lib.weighted_softmax_classification_loss(cls, res.cls_targets,
                                                                 res.cls_weights * w)
        row = torch.clamp(torch.argmax(res.cls_targets[..., 1:], dim=-1), 0, box.shape[2] - 1)
        enc2 = torch.take_along_dim(box, row[..., None, None].expand(*row.shape, 1, 4),
                                    dim=2)[..., 0, :]
        loc2 = loss_lib.weighted_smooth_l1_loss(enc2, res.reg_targets, res.reg_weights * w)
        normalizer = torch.clamp_min(w.sum(-1), 1.0)
        out["Loss/BoxClassifierLoss/classification_loss"] = (
            (cls_loss.sum(-1) / normalizer).sum() / batch_size
            * c.second_stage_classification_loss_weight)
        out["Loss/BoxClassifierLoss/localization_loss"] = (
            (loc2.sum(-1) / normalizer).sum() / batch_size
            * c.second_stage_localization_loss_weight)
        # the auxiliary tasks on the recycled labels
        mask = gt["mask"]
        fg = self.fg_head(feats)
        target = recycle.foreground_mask(gt["boxes"] / canvas, mask, tuple(fg.shape[1:]))
        out["Loss/MTL/foreground_loss"] = (
            loss_lib.sigmoid_cross_entropy(fg, target).sum()
            / (batch_size * fg.shape[1] * fg.shape[2]) * c.foreground_weight)

        def pool(boxes_norm):
            return roi_lib.mean_pooled_crop(feats, boxes_norm, (7, 7)).float()

        windows = recycle.enlarged_windows(gt["boxes"], c.window_enlarge_factor)
        mo_labels, cl_labels = self.recycled_labels(gt)
        for name, logits, labels, weight, count in (
                ("multiobject", self.mo_head(pool(windows / canvas)), mo_labels,
                 c.multiobject_weight, counts[0]),
                ("closeness", self.cl_head(pool(gt["boxes"] / canvas)), cl_labels,
                 c.closeness_weight, counts[1])):
            valid = mask & (labels.sum(-1) > 0)
            ce = loss_lib.softmax_cross_entropy(logits, labels)
            out[f"Loss/MTL/{name}_loss"] = (ce * valid).sum() / torch.clamp_min(count, 1.0) * weight
        return out

    def second_stage(self, feats: Tensor, proposals: Tensor):
        """ROI crop -> max pool -> block4 -> mean -> box predictor:
        (class logits [B, P, K + 1], box refinements [B, P, K, 4])."""
        c = self.cfg
        s = c.feature_stride
        h, w = feats.shape[1] * s, feats.shape[2] * s
        b, p = proposals.shape[:2]
        canvas = torch.tensor([h, w, h, w], dtype=torch.float32, device=feats.device)
        crops = roi_lib.batch_crop_and_resize(
            feats.contiguous(), (proposals / canvas).contiguous(),
            (c.initial_crop_size, c.initial_crop_size))
        crops = crops.reshape((b * p,) + crops.shape[2:])
        crops = F.max_pool2d(crops.permute(0, 3, 1, 2), c.maxpool_kernel_size,
                             c.maxpool_stride).permute(0, 2, 3, 1)
        x = self.classifier_backbone(crops)
        cls, box = self.box_predictor(x.float().mean(dim=(1, 2)))
        return cls.reshape(b, p, -1), box.reshape(b, p, -1, 4)

    def recycled_labels(self, gt: Dict[str, Tensor]):
        """The multi-object labels of each box's enlarged window and the
        closeness labels of each box."""
        c = self.cfg
        windows = recycle.enlarged_windows(gt["boxes"], c.window_enlarge_factor)
        return (recycle.multiobject_labels(windows, gt["boxes"], gt["classes"], gt["mask"],
                                           c.num_classes),
                recycle.closeness_labels(gt["boxes"], gt["classes"], gt["mask"], c.num_classes,
                                         c.closeness_sigma))

    def label_counts(self, gt: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        """The whole batch's counts of valid multi-object windows and
        closeness objects, which divide those two terms."""
        mo, cl = self.recycled_labels(gt)
        return tuple((gt["mask"] & (lab.sum(-1) > 0)).float().sum() for lab in (mo, cl))
