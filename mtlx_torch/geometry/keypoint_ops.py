"""Keypoint geometry (port of mtlx/geometry/keypoint_ops.py): the flip,
scale, clip and coordinate-frame parallels of box_ops for [..., N, K, 2]
keypoints in (y, x) order, in the keypoints' float type."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import Tensor


def _scalar(v, like: Tensor) -> Tensor:
    """A scalar (or tensor) parameter as a tensor of `like`'s type and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def scale(keypoints: Tensor, y_scale, x_scale) -> Tensor:
    s = torch.stack([_scalar(y_scale, keypoints), _scalar(x_scale, keypoints)])
    return keypoints * s


def clip_to_window(keypoints: Tensor, window: Tensor) -> Tensor:
    """Clip to `window` [..., 4], which broadcasts over the keypoint axis
    (keypoints [B, K, 2] with windows [B, 4] clip per batch row)."""
    y = torch.minimum(torch.maximum(keypoints[..., 0], window[..., 0:1]), window[..., 2:3])
    x = torch.minimum(torch.maximum(keypoints[..., 1], window[..., 1:2]), window[..., 3:4])
    return torch.stack([y, x], dim=-1)


def prune_outside_window(keypoints: Tensor, window: Tensor) -> Tensor:
    """Keypoints outside the window become NaN (the reference's 'absent')."""
    y, x = keypoints[..., 0], keypoints[..., 1]
    inside = ((y >= window[..., 0:1]) & (y <= window[..., 2:3])
              & (x >= window[..., 1:2]) & (x <= window[..., 3:4]))
    return torch.where(inside[..., None], keypoints, torch.nan)


def change_coordinate_frame(keypoints: Tensor, window: Tensor) -> Tensor:
    win_h = window[..., 2:3] - window[..., 0:1]
    win_w = window[..., 3:4] - window[..., 1:2]
    y = (keypoints[..., 0] - window[..., 0:1]) / win_h
    x = (keypoints[..., 1] - window[..., 1:2]) / win_w
    return torch.stack([y, x], dim=-1)


def to_normalized_coordinates(keypoints: Tensor, height, width) -> Tensor:
    return scale(keypoints, 1.0 / _scalar(height, keypoints), 1.0 / _scalar(width, keypoints))


def to_absolute_coordinates(keypoints: Tensor, height, width) -> Tensor:
    return scale(keypoints, height, width)


def _permuted(keypoints: Tensor, flip_permutation: Optional[Sequence[int]]) -> Tensor:
    if flip_permutation is None:
        return keypoints
    idx = torch.as_tensor(list(flip_permutation), dtype=torch.int64, device=keypoints.device)
    return keypoints.index_select(-2, idx)


def flip_horizontal(keypoints: Tensor, flip_point, flip_permutation=None) -> Tensor:
    """Mirror x about flip_point; flip_permutation renames the keypoints
    (left eye <-> right eye)."""
    keypoints = _permuted(keypoints, flip_permutation)
    y, x = keypoints[..., 0], keypoints[..., 1]
    return torch.stack([y, 2.0 * _scalar(flip_point, keypoints) - x], dim=-1)


def flip_vertical(keypoints: Tensor, flip_point, flip_permutation=None) -> Tensor:
    keypoints = _permuted(keypoints, flip_permutation)
    y, x = keypoints[..., 0], keypoints[..., 1]
    return torch.stack([2.0 * _scalar(flip_point, keypoints) - y, x], dim=-1)


def rot90(keypoints: Tensor) -> Tensor:
    """Rotate normalized keypoints 90 degrees counter-clockwise."""
    y, x = keypoints[..., 0], keypoints[..., 1]
    return torch.stack([1.0 - x, y], dim=-1)
