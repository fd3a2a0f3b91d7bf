"""Multi-layer (SSD) anchor generation (port of mtlx/anchors/multi_grid.py):
one anchor grid per feature map, per-layer scales interpolated between
min_scale and max_scale, the extra interpolated-scale anchor
(sqrt(s_k * s_{k+1}) at aspect 1) and the reduced boxes of the lowest
layer. Anchors are in NORMALIZED coordinates, ordered per layer as
[grid_y, grid_x, anchor]; the layout is computed in numpy, as in mtlx, so
both packages produce the same float32 values.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor


def ssd_scales(num_layers: int, min_scale: float, max_scale: float) -> List[float]:
    """Linearly interpolated per-layer scales, plus a terminal 1.0."""
    return [
        min_scale + (max_scale - min_scale) * i / max(num_layers - 1, 1)
        for i in range(num_layers)
    ] + [1.0]


class MultipleGridAnchorGenerator:
    """SSD anchors over multiple feature maps (normalized coordinates)."""

    def __init__(self, box_specs_list: Sequence[Sequence[Tuple[float, float]]],
                 base_anchor_size: Tuple[float, float] = (1.0, 1.0)):
        # box_specs_list[k]: the (scale, aspect_ratio) of each anchor of a
        # location of layer k
        self.box_specs_list = [list(s) for s in box_specs_list]
        self.base_anchor_size = tuple(base_anchor_size)

    @property
    def num_anchors_per_location(self) -> List[int]:
        return [len(s) for s in self.box_specs_list]

    def generate(self, feature_map_shape_list: Sequence[Tuple[int, int]]) -> Tensor:
        """The concatenated [sum_k H_k * W_k * A_k, 4] anchors (float32,
        on the CPU)."""
        if len(feature_map_shape_list) != len(self.box_specs_list):
            raise ValueError(
                "need one box spec per feature map: "
                f"{len(feature_map_shape_list)} vs {len(self.box_specs_list)}"
            )
        all_anchors = []
        for (h, w), specs in zip(feature_map_shape_list, self.box_specs_list):
            stride_y, stride_x = 1.0 / h, 1.0 / w
            offset_y, offset_x = 0.5 * stride_y, 0.5 * stride_x
            heights = np.array(
                [s / math.sqrt(a) * self.base_anchor_size[0] for s, a in specs], np.float32)
            widths = np.array(
                [s * math.sqrt(a) * self.base_anchor_size[1] for s, a in specs], np.float32)
            yc = (np.arange(h, dtype=np.float32) * stride_y + offset_y)[:, None, None]
            xc = (np.arange(w, dtype=np.float32) * stride_x + offset_x)[None, :, None]
            hh = heights[None, None, :]
            ww = widths[None, None, :]
            a = len(specs)
            boxes = np.stack([
                np.broadcast_to(yc - 0.5 * hh, (h, w, a)),
                np.broadcast_to(xc - 0.5 * ww, (h, w, a)),
                np.broadcast_to(yc + 0.5 * hh, (h, w, a)),
                np.broadcast_to(xc + 0.5 * ww, (h, w, a)),
            ], axis=-1).reshape(-1, 4)
            all_anchors.append(boxes)
        return torch.from_numpy(np.concatenate(all_anchors, axis=0))


def create_ssd_anchors(
    num_layers: int = 6,
    min_scale: float = 0.2,
    max_scale: float = 0.95,
    scales: Optional[Sequence[float]] = None,
    aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    interpolated_scale_aspect_ratio: float = 1.0,
    base_anchor_size: Tuple[float, float] = (1.0, 1.0),
    reduce_boxes_in_lowest_layer: bool = True,
) -> MultipleGridAnchorGenerator:
    """The standard SSD anchor stack (mtlx's create_ssd_anchors)."""
    if scales is None or not list(scales):
        scales = ssd_scales(num_layers, min_scale, max_scale)
    else:
        scales = list(scales) + [1.0]
    box_specs_list = []
    for layer, (s, s_next) in enumerate(zip(scales[:-1], scales[1:])):
        if layer == 0 and reduce_boxes_in_lowest_layer:
            specs = [(0.1, 1.0), (s, 2.0), (s, 0.5)]
        else:
            specs = [(s, a) for a in aspect_ratios]
            if interpolated_scale_aspect_ratio > 0.0:
                specs.append((math.sqrt(s * s_next), interpolated_scale_aspect_ratio))
        box_specs_list.append(specs)
    return MultipleGridAnchorGenerator(box_specs_list, base_anchor_size)
