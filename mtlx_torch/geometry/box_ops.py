"""Core box geometry on `[..., N, 4]` tensors in `[ymin, xmin, ymax, xmax]`
order (port of mtlx/geometry/box_ops.py).

Every function repeats the reference's operations in the same order, so
float32 results agree bit for bit wherever both sides round alike.
"""

from __future__ import annotations

import torch
from torch import Tensor

from mtlx_torch.kernels import iou_cuda

# divisor guard for IoU ratios; must match mtlx's 1e-30 (a larger floor
# gives tiny-but-real unions an arbitrary partial IoU)
EPSILON = 1e-30


def area(boxes: Tensor) -> Tensor:
    """Areas of boxes. [..., N, 4] -> [..., N]."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def height_width(boxes: Tensor):
    """[..., N, 4] -> (heights, widths), each [..., N]."""
    return boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]


def center_coordinates_and_sizes(boxes: Tensor):
    """[..., N, 4] -> (ycenter, xcenter, h, w), each [..., N]."""
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    h = ymax - ymin
    w = xmax - xmin
    return ymin + 0.5 * h, xmin + 0.5 * w, h, w


def from_center_coordinates(ycenter, xcenter, h, w) -> Tensor:
    """Inverse of center_coordinates_and_sizes; stacks on a new last axis."""
    return torch.stack(
        [ycenter - 0.5 * h, xcenter - 0.5 * w, ycenter + 0.5 * h, xcenter + 0.5 * w],
        dim=-1,
    )


def matched_intersection(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Elementwise intersection of aligned boxes. [..., N, 4] x2 -> [..., N]."""
    ih = torch.clamp_min(torch.minimum(boxes1[..., 2], boxes2[..., 2])
                         - torch.maximum(boxes1[..., 0], boxes2[..., 0]), 0.0)
    iw = torch.clamp_min(torch.minimum(boxes1[..., 3], boxes2[..., 3])
                         - torch.maximum(boxes1[..., 1], boxes2[..., 1]), 0.0)
    return ih * iw


def matched_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Elementwise IoU of aligned boxes. [..., N]; 0 where the union is not
    positive."""
    inter = matched_intersection(boxes1, boxes2)
    union = area(boxes1) + area(boxes2) - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, EPSILON), 0.0)


def scale(boxes: Tensor, y_scale, x_scale) -> Tensor:
    """Boxes with their y coordinates times y_scale and x times x_scale."""
    return torch.stack([boxes[..., 0] * y_scale, boxes[..., 1] * x_scale,
                        boxes[..., 2] * y_scale, boxes[..., 3] * x_scale], dim=-1)


def intersection(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise intersection areas. [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    ih = torch.clamp_min(
        torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0]),
        0.0,
    )
    iw = torch.clamp_min(
        torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1]),
        0.0,
    )
    return ih * iw


def iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU. [..., N, 4] x [..., M, 4] -> [..., N, M] (leading
    dims broadcast). Pairs whose union is not positive (zero-area padding
    rows) get 0.

    The leading dims fold into the problems of one call of the IoU op (a
    side whose leading dims are all 1 is shared by every problem): on CUDA
    tensors one launch of the IoU kernel, which takes float32, on CPU
    tensors its plain version in the boxes' own type."""
    lead = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
    on_card = boxes1.device.type != "cpu"

    def fold(b: Tensor) -> Tensor:
        b = b.float() if on_card else b
        if b.shape[:-2].numel() == 1:
            return b.reshape(1, *b.shape[-2:]).contiguous()
        return b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:]).contiguous()

    out = iou_cuda.iou_matrix(fold(boxes1), fold(boxes2))
    return out.reshape(*lead, boxes1.shape[-2], boxes2.shape[-2])


def ioa(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise intersection over the area of boxes2. [..., N, M]."""
    inter = intersection(boxes1, boxes2)
    a2 = area(boxes2)[..., None, :]
    return torch.where(a2 > 0, inter / torch.clamp_min(a2, EPSILON), 0.0)


def clip_to_window(boxes: Tensor, window: Tensor) -> Tensor:
    """Clip boxes to window [..., 4] = [ymin, xmin, ymax, xmax]
    (broadcast against the boxes' leading dims)."""
    wy0, wx0, wy1, wx1 = (window[..., i : i + 1] for i in range(4))

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    return torch.stack(
        [
            clip(boxes[..., 0], wy0, wy1),
            clip(boxes[..., 1], wx0, wx1),
            clip(boxes[..., 2], wy0, wy1),
            clip(boxes[..., 3], wx0, wx1),
        ],
        dim=-1,
    )


def outside_window_mask(boxes: Tensor, window: Tensor) -> Tensor:
    """True where a box falls at least partly outside `window` [..., 4]
    (mtlx's static-shape form of the reference's prune_outside_window:
    callers AND its negation into their validity mask). [..., N]."""
    wy0, wx0, wy1, wx1 = (window[..., i, None] for i in range(4))
    return ((boxes[..., 0] < wy0) | (boxes[..., 1] < wx0) | (boxes[..., 2] > wy1)
            | (boxes[..., 3] > wx1))


def completely_outside_window_mask(boxes: Tensor, window: Tensor) -> Tensor:
    """True where a box lies entirely outside `window` (the static-shape
    form of prune_completely_outside_window). [..., N]."""
    wy0, wx0, wy1, wx1 = (window[..., i, None] for i in range(4))
    return ((boxes[..., 0] >= wy1) | (boxes[..., 2] <= wy0) | (boxes[..., 1] >= wx1)
            | (boxes[..., 3] <= wx0))


def change_coordinate_frame(boxes: Tensor, window: Tensor) -> Tensor:
    """Express boxes relative to window, normalized by the window size."""
    wy0 = window[..., 0:1]
    wx0 = window[..., 1:2]
    h = window[..., 2:3] - wy0
    w = window[..., 3:4] - wx0
    return torch.stack(
        [
            (boxes[..., 0] - wy0) / h,
            (boxes[..., 1] - wx0) / w,
            (boxes[..., 2] - wy0) / h,
            (boxes[..., 3] - wx0) / w,
        ],
        dim=-1,
    )


def _as_tensor(value, like: Tensor) -> Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def to_normalized_coordinates(boxes: Tensor, height, width) -> Tensor:
    """Absolute pixel coordinates -> normalized [0, 1] coordinates."""
    return scale(boxes, 1.0 / _as_tensor(height, boxes), 1.0 / _as_tensor(width, boxes))


def to_absolute_coordinates(boxes: Tensor, height, width) -> Tensor:
    """Normalized [0, 1] coordinates -> absolute pixel coordinates."""
    return scale(boxes, _as_tensor(height, boxes), _as_tensor(width, boxes))


def normalized_to_image_coordinates(boxes: Tensor, image_shape) -> Tensor:
    """`to_absolute_coordinates` by an image shape's (height, width) (the
    reference utils/ops.py helper's name)."""
    return to_absolute_coordinates(boxes, image_shape[0], image_shape[1])
