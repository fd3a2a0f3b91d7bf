"""Detection losses (port of mtlx/losses/losses.py), in mtlx's formulas:
each takes predictions, targets and per-anchor weights and returns the
per-anchor loss; callers normalize.

`hard_example_mining_mask` is not ported yet (the flagship has no
miner): ROADMAP.md queue 1, slice 2 (the hard example miner).
"""

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
                                         weights: Tensor) -> Tensor:
    """Per-anchor softmax CE, weighted. -> [..., A]."""
    return softmax_cross_entropy(logits, targets) * weights
