"""Annotation recycling: the self-supervised pseudo-labels derived from
ground-truth boxes (port of mtlx/labels/recycle.py; its formulas are
mtlx's reconstructions of the paper, and the port matches mtlx).

Everything is static-shape and batched over leading dims: ground truth
is padded to [G] with a mask. `sampled_windows` takes its uniform draws
as tensors (mtlx draws them from a key).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from mtlx_torch.geometry import box_ops

EPS = 1e-8


def one_hot(index: Tensor, num_classes: int, dtype: torch.dtype = torch.float32) -> Tensor:
    """jax.nn.one_hot: [..., num_classes], an all-zero row for an index
    outside [0, num_classes) (F.one_hot raises on those)."""
    classes = torch.arange(num_classes, device=index.device)
    return (index[..., None] == classes).to(dtype)


def multiobject_labels(windows: Tensor, gt_boxes: Tensor, gt_classes: Tensor,
                       gt_mask: Tensor, num_classes: int) -> Tensor:
    """Soft class distribution per window, p(c | w) proportional to the
    summed fraction of each class-c object inside the window; all-zero
    rows where no object is covered. [..., W, K]."""
    coverage = box_ops.ioa(windows, gt_boxes) * gt_mask[..., None, :]  # [..., W, G]
    mass = coverage @ one_hot(gt_classes, num_classes)  # [..., W, K]
    total = mass.sum(-1, keepdim=True)
    return torch.where(total > EPS, mass / torch.clamp_min(total, EPS), 0.0)


def closeness_labels(gt_boxes: Tensor, gt_classes: Tensor, gt_mask: Tensor,
                     num_classes: int, sigma: float = 0.5) -> Tensor:
    """Per object, a distribution over the classes of the other objects,
    weighted by exp(-d^2 / (2 sigma^2)) of their centre distance over
    the mean box diagonal. [..., G, K]."""
    g = gt_boxes.shape[-2]
    yc, xc, h, w = box_ops.center_coordinates_and_sizes(gt_boxes)
    centers = torch.stack([yc, xc], dim=-1)  # [..., G, 2]
    diag = torch.sqrt(h * h + w * w)
    scale = 0.5 * (diag[..., :, None] + diag[..., None, :]) + EPS
    diff = centers[..., :, None, :] - centers[..., None, :, :]
    d = torch.sqrt((diff * diff).sum(-1)) / scale
    wgt = torch.exp(-(d * d) / (2.0 * sigma * sigma))
    eye = torch.eye(g, dtype=torch.bool, device=gt_boxes.device)
    valid_pair = gt_mask[..., :, None] & gt_mask[..., None, :] & ~eye
    wgt = torch.where(valid_pair, wgt, 0.0)
    mass = wgt @ one_hot(gt_classes, num_classes)
    total = mass.sum(-1, keepdim=True)
    return torch.where(total > EPS, mass / torch.clamp_min(total, EPS), 0.0)


def foreground_mask(gt_boxes: Tensor, gt_mask: Tensor, shape: Tuple[int, int]) -> Tensor:
    """The union of the valid boxes (normalized to the map) rasterized at
    `shape`: a pixel is foreground iff its centre lies in a box.
    [..., G, 4] -> [..., H, W] float32 in {0, 1}."""
    h, w = shape
    dev = gt_boxes.device
    # divide by a tensor: a CUDA division by a Python scalar multiplies by
    # the reciprocal and can move a pixel centre across a box edge
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / torch.tensor(
        float(h), device=dev)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / torch.tensor(
        float(w), device=dev)
    inside_y = (ys >= gt_boxes[..., 0:1]) & (ys < gt_boxes[..., 2:3])  # [..., G, H]
    inside_x = (xs >= gt_boxes[..., 1:2]) & (xs < gt_boxes[..., 3:4])  # [..., G, W]
    inside = inside_y[..., :, None] & inside_x[..., None, :] & gt_mask[..., None, None]
    return inside.any(dim=-3).float()


def enlarged_windows(gt_boxes: Tensor, factor: float = 2.0) -> Tensor:
    """Each box enlarged about its centre by `factor`."""
    yc, xc, h, w = box_ops.center_coordinates_and_sizes(gt_boxes)
    return box_ops.from_center_coordinates(yc, xc, h * factor, w * factor)


def sampled_windows(gt_boxes: Tensor, factor: float, uniforms: Tuple[Tensor, Tensor]) -> Tensor:
    """Random windows around each box: per axis a scale s ~ U[1, factor]
    and a centre offset U[-1, 1] * (s - 1) / 2 * size, so the window
    contains the box. uniforms = (u_scale, u_offset), each [..., G, 2] in
    [0, 1): the unit draws of mtlx's (scale, offset) keys, mapped to the
    ranges as jax.random.uniform maps them."""
    u_scale, u_off = uniforms
    yc, xc, h, w = box_ops.center_coordinates_and_sizes(gt_boxes)
    scale = torch.clamp_min(u_scale * (factor - 1.0) + 1.0, 1.0)
    off = torch.clamp_min(u_off * 2.0 + -1.0, -1.0)
    sy, sx = scale[..., 0], scale[..., 1]
    dy = off[..., 0] * (sy - 1.0) * 0.5 * h
    dx = off[..., 1] * (sx - 1.0) * 0.5 * w
    return box_ops.from_center_coordinates(yc + dy, xc + dx, h * sy, w * sx)
