"""ROI crops with TF `crop_and_resize` semantics, a frozen copy of
mtlx_torch/ops/roi.py's entries that Faster R-CNN takes, on the plain
gather crop (autograd differentiates it)."""

from __future__ import annotations
from typing import Tuple
import torch
import torch.nn.functional as F
from torch import Tensor
from . import kernels_plain as roi_cuda


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


def batch_crop_and_resize(
    images: Tensor, boxes: Tensor, crop_size: Tuple[int, int], **kw
) -> Tensor:
    """[B, H, W, C] x [B, N, 4] -> [B, N, ch, cw, C] (per-image boxes),
    one kernel launch for the whole batch."""
    return roi_cuda.crop_and_resize(images, boxes, crop_size, **kw)


def _interp_matrix(c0: Tensor, c1: Tensor, size: int, limit: int) -> Tensor:
    """Per-box 1-D bilinear interpolation matrix [..., N, size, limit]:
    row i holds the two taps of output coordinate i (TF crop_and_resize
    convention, zeros when the sample falls outside)."""
    coords = _sample_coords(c0, c1, size, limit)  # [..., N, size]
    lo = torch.floor(coords)
    frac = coords - lo
    lo_i = torch.clamp(lo.to(torch.int64), 0, limit - 1)
    hi_i = torch.clamp(lo_i + 1, 0, limit - 1)
    in_range = ((coords >= 0.0) & (coords <= limit - 1)).to(coords.dtype)
    w_lo = F.one_hot(lo_i, limit).to(coords.dtype) * ((1.0 - frac) * in_range)[..., None]
    w_hi = F.one_hot(hi_i, limit).to(coords.dtype) * (frac * in_range)[..., None]
    return w_lo + w_hi


def mean_pooled_crop(image: Tensor, boxes: Tensor, crop_size: Tuple[int, int] = (7, 7)) -> Tensor:
    """`crop_and_resize(image, boxes, crop_size).mean((-3, -2))` without
    the crop: average-pooling a bilinear resample is a linear functional
    of the source, so it is two contractions with the per-box mean
    interpolation weights, in the image's type (mtlx.ops.roi
    .mean_pooled_crop). image [..., H, W, C], boxes [..., N, 4] ->
    [..., N, C]."""
    h, w = image.shape[-3], image.shape[-2]
    ch, cw = crop_size
    dt = image.dtype
    b = boxes.float()
    ry = _interp_matrix(b[..., 0], b[..., 2], ch, h).mean(dim=-2).to(dt)  # [..., N, H]
    rx = _interp_matrix(b[..., 1], b[..., 3], cw, w).mean(dim=-2).to(dt)  # [..., N, W]
    tmp = torch.einsum("...nh,...hwc->...nwc", ry, image)
    return torch.einsum("...nw,...nwc->...nc", rx, tmp)

