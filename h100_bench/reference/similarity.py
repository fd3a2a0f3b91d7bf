"""Region similarity calculators (a frozen copy of mtlx_torch/assign/similarity.py)."""

from __future__ import annotations

from torch import Tensor

from . import box_ops


def iou_similarity(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU [..., N, M]; on CUDA tensors one launch of the IoU
    kernel (box_ops.iou)."""
    return box_ops.iou(boxes1, boxes2)


