"""Detection losses (port of mtlx/losses/losses.py), in mtlx's formulas:
each takes predictions, targets and per-anchor weights and returns the
per-anchor loss; callers normalize. The L2, IoU and bootstrapped sigmoid
losses are what a Loss proto reaches through
builders/component_builders.py.

`hard_example_mining_mask` is Faster R-CNN's NMS-based hard example
miner (SSD mines in its loss, detector/ssd.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from mtlx_torch.geometry import box_ops
from mtlx_torch.ops import nms as nms_lib

_F32_TINY = torch.finfo(torch.float32).tiny


def weighted_l2_loss(pred: Tensor, target: Tensor, weights: Tensor) -> Tensor:
    """0.5 * ||pred - target||^2 summed over the code, weighted. -> [..., A]."""
    diff = pred - target
    return (0.5 * (diff * diff)).sum(-1) * weights


def weighted_iou_loss(pred_boxes: Tensor, target_boxes: Tensor, weights: Tensor) -> Tensor:
    """-log(matched IoU) per anchor, the IoU floored at 1e-8, weighted."""
    iou = box_ops.matched_iou(pred_boxes, target_boxes)
    return -torch.log(torch.clamp_min(iou, 1e-8)) * weights


def weighted_smooth_l1_loss(pred: Tensor, target: Tensor, weights: Tensor) -> Tensor:
    """Huber / smooth-L1 (delta 1) summed over the code, weighted. -> [..., A]."""
    diff = pred - target
    abs_diff = diff.abs()
    loss = torch.where(abs_diff < 1.0, 0.5 * (diff * diff), abs_diff - 0.5)
    return loss.sum(-1) * weights


def sigmoid_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Elementwise stable sigmoid CE (tf.nn.sigmoid_cross_entropy_with_logits)."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def weighted_sigmoid_classification_loss(logits: Tensor, targets: Tensor, weights: Tensor,
                                         class_indices=None) -> Tensor:
    """Per-anchor-per-class sigmoid CE, weighted per anchor; with
    class_indices only those classes count. -> [..., A, K]."""
    loss = sigmoid_cross_entropy(logits, targets)
    if class_indices is not None:
        keep = torch.zeros(logits.shape[-1], dtype=loss.dtype, device=loss.device)
        keep[torch.as_tensor(class_indices, device=loss.device)] = 1.0
        loss = loss * keep
    return loss * weights[..., None]


def softmax_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Rowwise softmax CE against a (possibly soft) distribution. -> [...]."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)


def weighted_softmax_classification_loss(logits: Tensor, targets: Tensor,
                                         weights: Tensor, logit_scale: float = 1.0) -> Tensor:
    """Per-anchor softmax CE of logits / logit_scale, weighted. -> [..., A]."""
    if logit_scale != 1.0:
        logits = logits / logit_scale
    return softmax_cross_entropy(logits, targets) * weights


def bootstrapped_sigmoid_classification_loss(logits: Tensor, targets: Tensor, weights: Tensor,
                                             alpha: float = 0.5,
                                             bootstrap_type: str = "soft") -> Tensor:
    """Sigmoid CE against alpha * targets + (1 - alpha) * the prediction
    (its sigmoid, "soft", or the sigmoid thresholded at 0.5, "hard"),
    weighted per anchor; the gradient flows through the soft target, as
    in mtlx. -> [..., A, K]."""
    p = torch.sigmoid(logits)
    if bootstrap_type == "soft":
        boot = alpha * targets + (1.0 - alpha) * p
    elif bootstrap_type == "hard":
        boot = alpha * targets + (1.0 - alpha) * (p > 0.5).to(logits.dtype)
    else:
        raise ValueError(f"unknown bootstrap_type {bootstrap_type}")
    return sigmoid_cross_entropy(logits, boot) * weights[..., None]


class HardExampleMinerConfig(NamedTuple):
    """mtlx's HardExampleMinerConfig (the HardExampleMiner proto; the
    builder sets the loss weights to the second stage's)."""

    num_hard_examples: int = 64
    iou_threshold: float = 0.7
    loss_type: str = "both"  # 'cls' | 'loc' | 'both'
    cls_loss_weight: float = 0.05
    loc_loss_weight: float = 0.06
    max_negatives_per_positive: float = 0.0  # 0 = unlimited
    min_negatives_per_image: int = 0


def hard_example_mining_mask(cls_losses: Tensor, loc_losses: Tensor, boxes: Tensor,
                             match: Tensor, config: HardExampleMinerConfig) -> Tensor:
    """The hardest examples of each of B images (mtlx's
    hard_example_mining_mask over a leading batch axis): cls_losses and
    loc_losses [B, A], boxes [B, A, 4], match [B, A] (>= 0: positive) ->
    keep [B, A] bool, at most num_hard_examples True a row.

    The examples are ranked by the weighted loss (`loss_type`), hardest
    first, ties to the lower index (mtlx's stable argsort; the loss's
    subnormals are flushed to zero, as XLA compares them, which also makes
    -0 and +0 one value). Walking them in that order, an example is kept
    unless its IoU with a kept one is greater than iou_threshold, the
    negatives allowed, max(min_negatives_per_image, ratio * positives
    kept), are used up, or num_hard_examples are kept.

    Without a negatives cap (max_negatives_per_positive 0, the proto's
    default) that walk is greedy NMS with the rank as the score, and runs
    as one launch of the NMS kernel for the B images on the card (the same
    IoU, `>` test, lower-index tie order and zero-area handling as the
    walk, no score threshold). With a cap the walk runs step by step over
    one IoU matrix an image, one launch of the IoU kernel for the B
    images."""
    if config.loss_type == "cls":
        image_loss = cls_losses * config.cls_loss_weight
    elif config.loss_type == "loc":
        image_loss = loc_losses * config.loc_loss_weight
    else:
        image_loss = cls_losses * config.cls_loss_weight + loc_losses * config.loc_loss_weight
    image_loss = torch.where(image_loss.abs() < _F32_TINY, 0.0, image_loss)
    b, a = image_loss.shape
    dev = image_loss.device
    order = torch.argsort(-image_loss, dim=-1, stable=True)  # hardest first
    boxes = boxes.float()
    if config.max_negatives_per_positive <= 0:
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(a, device=dev).expand(b, a))
        idx, kept = nms_lib.batched_non_max_suppression(
            boxes, (a - rank).float(), min(config.num_hard_examples, a),
            iou_threshold=config.iou_threshold)
        hits = torch.zeros((b, a), dtype=torch.int32, device=dev)
        return hits.scatter_add_(1, idx.long(), kept.int()) > 0
    boxes_sorted = torch.gather(boxes, 1, order[..., None].expand(b, a, 4))
    is_pos = torch.gather(match >= 0, 1, order)
    overlap = box_ops.iou(boxes_sorted, boxes_sorted) > config.iou_threshold  # [B, A, A]
    keep = torch.zeros((b, a), dtype=torch.bool, device=dev)
    num_kept = torch.zeros(b, dtype=torch.int32, device=dev)
    num_pos = torch.zeros_like(num_kept)
    num_neg = torch.zeros_like(num_kept)
    ratio = config.max_negatives_per_positive
    for i in range(a):
        overlaps = (keep & overlap[:, i]).any(-1)
        # mtlx's bound max(min_negatives_per_image, ratio * positives), in float32
        allowed = torch.clamp_min(num_pos.float() * ratio, float(config.min_negatives_per_image))
        neg_ok = is_pos[:, i] | (num_neg.float() < allowed)
        take = (num_kept < config.num_hard_examples) & ~overlaps & neg_ok
        keep[:, i] = take
        num_kept += take.int()
        num_pos += (take & is_pos[:, i]).int()
        num_neg += (take & ~is_pos[:, i]).int()
    return torch.zeros_like(keep).scatter_(1, order, keep)
