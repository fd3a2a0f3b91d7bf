"""ROI feature cropping with TF `crop_and_resize` semantics (port of
mtlx/ops/roi.py).

Normalized box corners map to pixel centres of the source
(`y1 * (H - 1) .. y2 * (H - 1)`), the bilinear sample grid includes both
corners, and out-of-range samples read 0. On the card every crop is one
launch of the gather-bilinear kernel (mtlx_torch/kernels/roi_cuda.py);
on the CPU its plain version runs.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from mtlx_torch.kernels import roi_cuda


def _sample_coords(c0: Tensor, c1: Tensor, size: int, limit: int) -> Tensor:
    """Per-box 1-D sample coordinates, TF crop_and_resize convention.
    [..., N] corners -> [..., N, size]."""
    if size > 1:
        # divide by a tensor on the data's device: PyTorch's CUDA division
        # by a Python scalar multiplies by its reciprocal, which rounds
        # differently from the true division of mtlx and of the kernel
        size_m1 = torch.tensor(float(size - 1), dtype=c0.dtype, device=c0.device)
        step = (c1 - c0) * (limit - 1) / size_m1
        return c0[..., None] * (limit - 1) + step[..., None] * torch.arange(
            size, dtype=c0.dtype, device=c0.device
        )
    return (0.5 * (c0 + c1))[..., None] * (limit - 1)


def crop_and_resize(
    image: Tensor,
    boxes: Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> Tensor:
    """Crop + bilinearly resize regions from one image.
    image [H, W, C], boxes [N, 4] normalized (may exceed [0, 1]) ->
    [N, crop_h, crop_w, C]."""
    return roi_cuda.crop_and_resize(
        image[None], boxes[None], crop_size, extrapolation_value
    )[0]


def batch_crop_and_resize(
    images: Tensor, boxes: Tensor, crop_size: Tuple[int, int], **kw
) -> Tensor:
    """[B, H, W, C] x [B, N, 4] -> [B, N, ch, cw, C] (per-image boxes),
    one kernel launch for the whole batch."""
    return roi_cuda.crop_and_resize(images, boxes, crop_size, **kw)
