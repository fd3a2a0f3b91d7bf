"""Region similarity calculators (port of mtlx/assign/similarity.py)."""

from __future__ import annotations

from torch import Tensor

from mtlx_torch.geometry import box_ops


def iou_similarity(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU [..., N, M]; on CUDA tensors one launch of the IoU
    kernel (box_ops.iou)."""
    return box_ops.iou(boxes1, boxes2)


def ioa_similarity(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise intersection over the area of boxes2 [..., N, M]."""
    return box_ops.ioa(boxes1, boxes2)


def neg_sq_dist_similarity(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Negative squared L2 distance between box corner vectors [..., N, M]."""
    diff = boxes1[..., :, None, :] - boxes2[..., None, :, :]
    return -(diff * diff).sum(-1)
