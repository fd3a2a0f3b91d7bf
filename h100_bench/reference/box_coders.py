"""Faster R-CNN's box coder, a frozen copy of mtlx_torch/coders/box_coders.py."""

from __future__ import annotations
from typing import Callable, NamedTuple, Sequence
import torch
from torch import Tensor
from . import box_ops

EPSILON = 1e-8


class BoxCoder(NamedTuple):
    """A coder as an (encode, decode, code_size) triple."""

    encode: Callable
    decode: Callable
    code_size: int


def faster_rcnn_encode(
    boxes: Tensor, anchors: Tensor, scale_factors: Sequence[float] = (10.0, 10.0, 5.0, 5.0)
) -> Tensor:
    """Encode boxes w.r.t. anchors as [ty, tx, th, tw] (EPSILON added to
    every height and width before the ratio and the log)."""
    ycenter_a, xcenter_a, ha, wa = box_ops.center_coordinates_and_sizes(anchors)
    ycenter, xcenter, h, w = box_ops.center_coordinates_and_sizes(boxes)
    ha = ha + EPSILON
    wa = wa + EPSILON
    h = h + EPSILON
    w = w + EPSILON
    ty = (ycenter - ycenter_a) / ha * scale_factors[0]
    tx = (xcenter - xcenter_a) / wa * scale_factors[1]
    th = torch.log(h / ha) * scale_factors[2]
    tw = torch.log(w / wa) * scale_factors[3]
    return torch.stack([ty, tx, th, tw], dim=-1)


def faster_rcnn_decode(
    codes: Tensor, anchors: Tensor, scale_factors: Sequence[float] = (10.0, 10.0, 5.0, 5.0)
) -> Tensor:
    """Decode [ty, tx, th, tw] codes against anchors back to corner boxes."""
    ycenter_a, xcenter_a, ha, wa = box_ops.center_coordinates_and_sizes(anchors)
    ty = codes[..., 0] / scale_factors[0]
    tx = codes[..., 1] / scale_factors[1]
    th = codes[..., 2] / scale_factors[2]
    tw = codes[..., 3] / scale_factors[3]
    w = torch.exp(tw) * wa
    h = torch.exp(th) * ha
    ycenter = ty * ha + ycenter_a
    xcenter = tx * wa + xcenter_a
    return box_ops.from_center_coordinates(ycenter, xcenter, h, w)


def make_faster_rcnn_coder(scale_factors=(10.0, 10.0, 5.0, 5.0)) -> BoxCoder:
    return BoxCoder(
        encode=lambda b, a: faster_rcnn_encode(b, a, scale_factors),
        decode=lambda c, a: faster_rcnn_decode(c, a, scale_factors),
        code_size=4,
    )

