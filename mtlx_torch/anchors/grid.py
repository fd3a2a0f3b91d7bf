"""Grid anchor generation (port of mtlx/anchors/grid.py).

Anchor ordering contract (must match the RPN head's channel order):
flattened as [grid_y, grid_x, anchor] with the anchor index fastest,
where the per-cell anchor list enumerates aspect_ratios as the outer
loop and scales as the inner loop. The layout is computed in numpy, as
in mtlx, so both packages produce the same float32 values.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import Tensor


def tile_anchors(
    grid_height: int,
    grid_width: int,
    scales: Sequence[float],
    aspect_ratios: Sequence[float],
    base_anchor_size: Tuple[float, float] = (256.0, 256.0),
    anchor_stride: Tuple[float, float] = (16.0, 16.0),
    anchor_offset: Tuple[float, float] = (0.0, 0.0),
) -> Tensor:
    """Generate [grid_h * grid_w * A, 4] absolute-coordinate anchors
    (float32, on the CPU)."""
    scales = np.asarray(scales, np.float32)
    aspects = np.asarray(aspect_ratios, np.float32)
    # aspect outer, scale inner (see module docstring)
    scales_grid = np.tile(scales, len(aspects))
    aspects_grid = np.repeat(aspects, len(scales))
    ratio_sqrt = np.sqrt(aspects_grid)
    heights = scales_grid / ratio_sqrt * base_anchor_size[0]
    widths = scales_grid * ratio_sqrt * base_anchor_size[1]

    y_centers = np.arange(grid_height, dtype=np.float32) * anchor_stride[0] + anchor_offset[0]
    x_centers = np.arange(grid_width, dtype=np.float32) * anchor_stride[1] + anchor_offset[1]

    # [grid_h, grid_w, A]
    yc = y_centers[:, None, None]
    xc = x_centers[None, :, None]
    h = heights[None, None, :]
    w = widths[None, None, :]
    shape = (grid_height, grid_width, len(scales_grid))
    boxes = np.stack(
        [
            np.broadcast_to(yc - 0.5 * h, shape),
            np.broadcast_to(xc - 0.5 * w, shape),
            np.broadcast_to(yc + 0.5 * h, shape),
            np.broadcast_to(xc + 0.5 * w, shape),
        ],
        axis=-1,
    ).reshape(-1, 4)
    return torch.from_numpy(np.ascontiguousarray(boxes, np.float32))


class GridAnchorGenerator:
    """Anchors on a regular grid; the RPN default is 4 scales x 3 aspects
    at stride 16 with a 256x256 base anchor."""

    def __init__(
        self,
        scales: Sequence[float] = (0.5, 1.0, 2.0),
        aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        base_anchor_size: Tuple[float, float] = (256.0, 256.0),
        anchor_stride: Tuple[float, float] = (16.0, 16.0),
        anchor_offset: Tuple[float, float] = (0.0, 0.0),
    ):
        self.scales = tuple(scales)
        self.aspect_ratios = tuple(aspect_ratios)
        self.base_anchor_size = tuple(base_anchor_size)
        self.anchor_stride = tuple(anchor_stride)
        self.anchor_offset = tuple(anchor_offset)

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.scales) * len(self.aspect_ratios)

    def generate(self, feature_map_shape: Tuple[int, int]) -> Tensor:
        """[H*W*A, 4] anchors in absolute image coordinates."""
        h, w = feature_map_shape
        return tile_anchors(
            h,
            w,
            self.scales,
            self.aspect_ratios,
            self.base_anchor_size,
            self.anchor_stride,
            self.anchor_offset,
        )
