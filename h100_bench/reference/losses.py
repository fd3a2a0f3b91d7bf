"""The per-anchor losses of Faster R-CNN's train step, a frozen copy of
mtlx_torch/losses/losses.py's formulas; callers normalize."""

from __future__ import annotations
import torch
from torch import Tensor


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


def softmax_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Rowwise softmax CE against a (possibly soft) distribution. -> [...]."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)


def weighted_softmax_classification_loss(logits: Tensor, targets: Tensor,
                                         weights: Tensor, logit_scale: float = 1.0) -> Tensor:
    """Per-anchor softmax CE of logits / logit_scale, weighted. -> [..., A]."""
    if logit_scale != 1.0:
        logits = logits / logit_scale
    return softmax_cross_entropy(logits, targets) * weights

