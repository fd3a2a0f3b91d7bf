"""Top-k and batched greedy NMS, a frozen copy of mtlx_torch/ops/nms.py's
entries that the RPN's proposal selection takes, on the plain NMS."""

from __future__ import annotations
from typing import Optional
import torch
from torch import Tensor
from . import kernels_plain as nms_cuda


_NEG = -1e10


def top_k(values: Tensor, k: int):
    """`jax.lax.top_k` over the last axis: the k largest values, ties to
    the lower index. Returns (values, indices)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def batched_non_max_suppression(
    boxes: Tensor,
    scores: Tensor,
    max_output_size: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
    valid_mask: Optional[Tensor] = None,
):
    """Greedy single-class NMS over a leading problem axis, one launch.
    boxes [P, N, 4], scores [P, N], valid_mask [P, N] bool ->
    (indices [P, max_output_size] int32 0-padded, keep [P, max_output_size] bool)."""
    if valid_mask is None:
        valid_mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    return nms_cuda.non_max_suppression(
        boxes.contiguous(), scores.contiguous(), valid_mask.contiguous(),
        max_output_size, iou_threshold, score_threshold,
    )

