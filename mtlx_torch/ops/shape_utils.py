"""Static-shape helpers (port of mtlx/ops/shape_utils.py, the reference's
utils/shape_utils.py and utils/ops.py picks): every variable-length set
is padded to a static size with a validity mask."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor


def pad_or_clip_along_axis(x, size: int, axis: int = 0, pad_value=0):
    """x (a numpy array or a tensor) padded with pad_value or clipped to
    `size` along `axis`."""
    n = x.shape[axis]
    if n == size:
        return x
    if n > size:
        slicer = [slice(None)] * x.ndim
        slicer[axis] = slice(0, size)
        return x[tuple(slicer)]
    if isinstance(x, np.ndarray):
        pads = [(0, 0)] * x.ndim
        pads[axis] = (0, size - n)
        return np.pad(x, pads, constant_values=pad_value)
    pads = [0, 0] * x.dim()  # F.pad lists the last axis first
    pads[2 * (x.dim() - 1 - axis % x.dim()) + 1] = size - n
    return F.pad(x, pads, value=pad_value)


def indices_to_dense_vector(indices: Tensor, size: int, indices_value: float = 1.0,
                            default_value: float = 0.0) -> Tensor:
    """A [size] float32 vector of default_value with indices_value at
    `indices`."""
    indices = torch.as_tensor(indices)
    out = torch.full((size,), default_value, dtype=torch.float32, device=indices.device)
    out[indices.long()] = indices_value
    return out


def padded_one_hot_encoding(indices: Tensor, depth: int, left_pad: int = 1) -> Tensor:
    """Float32 one-hot rows of `depth` with `left_pad` zero columns in front
    (the background column)."""
    oh = F.one_hot(torch.as_tensor(indices).long(), depth).float()
    return F.pad(oh, (left_pad, 0))


def mask_count(mask: Tensor) -> Tensor:
    """The True entries of a mask along its last axis, int32."""
    return mask.to(torch.int32).sum(-1, dtype=torch.int32)


def nearest_neighbor_upsampling(x: Tensor, scale: int) -> Tensor:
    """[..., H, W, C] -> [..., H * scale, W * scale, C], each pixel
    repeated."""
    return x.repeat_interleave(scale, dim=-3).repeat_interleave(scale, dim=-2)
