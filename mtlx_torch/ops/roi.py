"""ROI feature cropping with TF `crop_and_resize` semantics (port of
mtlx/ops/roi.py).

Normalized box corners map to pixel centres of the source
(`y1 * (H - 1) .. y2 * (H - 1)`), the bilinear sample grid includes both
corners, and out-of-range samples read 0. On the card every crop is one
launch of the gather-bilinear kernel (mtlx_torch/kernels/roi_cuda.py),
and its d(features) one launch of the backward kernel; on the CPU their
plain versions run.

`mean_pooled_crop` (the aux heads' pooling) stays two plain contractions
with the per-box mean interpolation weights, as in mtlx, and autograd
differentiates it.

`position_sensitive_crop_regions` (R-FCN's second stage) is an XLA op in
mtlx, not a Pallas kernel; the port runs it on the same crop kernels,
one launch for all the spatial bins of a score map.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
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


def _bin_boxes(boxes: Tensor, num_spatial_bins: Tuple[int, int]) -> Tensor:
    """Each box's sub-box of every spatial bin, bin by = i // bins_x, bx =
    i % bins_x: [..., N, 4] -> [..., bins, N, 4], with mtlx's arithmetic
    (y1 + by * step_y .. y1 + (by + 1) * step_y, step_y = (y2 - y1) /
    bins_y), the division by a tensor on the boxes' device (as
    `_sample_coords`)."""
    bins_y, bins_x = num_spatial_bins
    y1, x1, y2, x2 = boxes.unbind(-1)
    div = lambda n: torch.tensor(float(n), dtype=boxes.dtype, device=boxes.device)
    step_y = (y2 - y1) / div(bins_y)
    step_x = (x2 - x1) / div(bins_x)
    subs = [torch.stack([y1 + by * step_y, x1 + bx * step_x,
                         y1 + (by + 1) * step_y, x1 + (bx + 1) * step_x], dim=-1)
            for by in range(bins_y) for bx in range(bins_x)]
    return torch.stack(subs, dim=-3)


def position_sensitive_crop_regions(
    image: Tensor,
    boxes: Tensor,
    crop_size: Tuple[int, int],
    num_spatial_bins: Tuple[int, int],
    global_pool: bool = True,
) -> Tensor:
    """R-FCN's position-sensitive crop (mtlx.ops.roi
    .position_sensitive_crop_regions): the C = bins_y * bins_x * depth
    channels are one depth-wide group per spatial bin, and each bin crops
    only its group over its own sub-window of the box, at crop_size /
    bins. The bins are then averaged (global_pool) or tiled back.

    image [B, H, W, C] with boxes [B, N, 4] (or mtlx's unbatched [H, W, C]
    with [N, 4]) -> [B, N, depth] with global_pool, else [B, N, crop_h,
    crop_w, depth].

    mtlx crops bin by bin. Here the map is laid out once as [B * bins, H,
    W, depth] (bin-major, contiguous) with the sub-boxes as [B * bins, N,
    4], so one crop launch covers every bin of every image; each sample is
    computed as in the per-bin crop, so the crops are the same. The means
    are taken in mtlx's order: over the crop, then over the bins.
    """
    if image.dim() == 3:
        return position_sensitive_crop_regions(
            image[None], boxes[None], crop_size, num_spatial_bins, global_pool)[0]
    bins_y, bins_x = num_spatial_bins
    bins = bins_y * bins_x
    b, h, w, c = image.shape
    if c % bins:
        raise ValueError(f"channel count {c} is not divisible by num_spatial_bins "
                         f"{bins_y}x{bins_x}={bins}")
    depth = c // bins
    ch, cw = crop_size
    if ch % bins_y or cw % bins_x:
        raise ValueError("crop_size must be divisible by num_spatial_bins")
    bin_ch, bin_cw = ch // bins_y, cw // bins_x
    n = boxes.shape[-2]
    # bin-major and contiguous (a copy), as the kernel takes it
    groups = image.reshape(b, h, w, bins, depth).permute(0, 3, 1, 2, 4).contiguous()
    groups = groups.reshape(b * bins, h, w, depth)
    sub_boxes = _bin_boxes(boxes, num_spatial_bins).reshape(b * bins, n, 4).contiguous()
    crops = roi_cuda.crop_and_resize(groups, sub_boxes, (bin_ch, bin_cw))
    if global_pool:
        pooled = crops.mean(dim=(2, 3)).reshape(b, bins, n, depth)
        return pooled.mean(dim=1)
    crops = crops.reshape(b, bins_y, bins_x, n, bin_ch, bin_cw, depth)
    return crops.permute(0, 3, 1, 4, 2, 5, 6).reshape(b, n, ch, cw, depth)
