"""Box coders (port of mtlx/coders/box_coders.py): Faster R-CNN's
anchor-relative `[ty, tx, th, tw]` codes with scale factors `[10, 10, 5,
5]`, the keypoint coder that extends them with each keypoint's
anchor-relative offset, the mean-stddev coder (corner offsets over a
stddev, the Multibox preset's) and the square coder (`[ty, tx, tl]` on
the side of the square of equal area)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
from torch import Tensor

from mtlx_torch.geometry import box_ops

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


def mean_stddev_encode(boxes: Tensor, anchors: Tensor, stddev: float = 0.01) -> Tensor:
    """(box - anchor) / stddev, per corner coordinate."""
    return (boxes - anchors) / stddev


def mean_stddev_decode(codes: Tensor, anchors: Tensor, stddev: float = 0.01) -> Tensor:
    return codes * stddev + anchors


def make_mean_stddev_coder(stddev: float = 0.01) -> BoxCoder:
    return BoxCoder(
        encode=lambda b, a: mean_stddev_encode(b, a, stddev),
        decode=lambda c, a: mean_stddev_decode(c, a, stddev),
        code_size=4,
    )


def square_encode(boxes: Tensor, anchors: Tensor,
                  scale_factors: Sequence[float] = (1.0, 1.0, 1.0)) -> Tensor:
    """[ty, tx, tl] with l = sqrt(h * w), relative to the anchor's l."""
    ycenter_a, xcenter_a, ha, wa = box_ops.center_coordinates_and_sizes(anchors)
    la = torch.sqrt((ha + EPSILON) * (wa + EPSILON))
    ycenter, xcenter, h, w = box_ops.center_coordinates_and_sizes(boxes)
    side = torch.sqrt((h + EPSILON) * (w + EPSILON))
    ty = (ycenter - ycenter_a) / la * scale_factors[0]
    tx = (xcenter - xcenter_a) / la * scale_factors[1]
    tl = torch.log(side / la) * scale_factors[2]
    return torch.stack([ty, tx, tl], dim=-1)


def square_decode(codes: Tensor, anchors: Tensor,
                  scale_factors: Sequence[float] = (1.0, 1.0, 1.0)) -> Tensor:
    ycenter_a, xcenter_a, ha, wa = box_ops.center_coordinates_and_sizes(anchors)
    la = torch.sqrt((ha + EPSILON) * (wa + EPSILON))
    side = torch.exp(codes[..., 2] / scale_factors[2]) * la
    ycenter = codes[..., 0] / scale_factors[0] * la + ycenter_a
    xcenter = codes[..., 1] / scale_factors[1] * la + xcenter_a
    return box_ops.from_center_coordinates(ycenter, xcenter, side, side)


def make_square_coder(scale_factors=(1.0, 1.0, 1.0)) -> BoxCoder:
    return BoxCoder(
        encode=lambda b, a: square_encode(b, a, scale_factors),
        decode=lambda c, a: square_decode(c, a, scale_factors),
        code_size=3,
    )


def keypoint_encode(boxes: Tensor, keypoints: Tensor, anchors: Tensor,
                    scale_factors: Sequence[float] = (10.0, 10.0, 5.0, 5.0)) -> Tensor:
    """Boxes and their K keypoints as [ty, tx, th, tw, tky0, tkx0, ...]:
    each keypoint relative to the anchor's center, over the anchor's size
    (plus EPSILON), times the y / x scale factors (the reference's
    keypoint_box_coder)."""
    ycenter_a, xcenter_a, ha, wa = box_ops.center_coordinates_and_sizes(anchors)
    box_codes = faster_rcnn_encode(boxes, anchors, scale_factors)
    ha_e = (ha + EPSILON)[..., None]
    wa_e = (wa + EPSILON)[..., None]
    tky = (keypoints[..., 0] - ycenter_a[..., None]) / ha_e * scale_factors[0]
    tkx = (keypoints[..., 1] - xcenter_a[..., None]) / wa_e * scale_factors[1]
    kp_codes = torch.stack([tky, tkx], dim=-1).reshape(*boxes.shape[:-1], -1)
    return torch.cat([box_codes, kp_codes], dim=-1)


def keypoint_decode(codes: Tensor, anchors: Tensor, num_keypoints: int,
                    scale_factors: Sequence[float] = (10.0, 10.0, 5.0, 5.0)):
    """Box and keypoint codes back to (boxes, keypoints [..., K, 2])."""
    ycenter_a, xcenter_a, ha, wa = box_ops.center_coordinates_and_sizes(anchors)
    boxes = faster_rcnn_decode(codes[..., :4], anchors, scale_factors)
    kp = codes[..., 4:].reshape(*codes.shape[:-1], num_keypoints, 2)
    ky = kp[..., 0] / scale_factors[0] * (ha + EPSILON)[..., None] + ycenter_a[..., None]
    kx = kp[..., 1] / scale_factors[1] * (wa + EPSILON)[..., None] + xcenter_a[..., None]
    return boxes, torch.stack([ky, kx], dim=-1)


def batch_decode(decode_fn, batch_codes: Tensor, anchors: Tensor) -> Tensor:
    """Decode [B, N, code_size] against shared [N, 4] anchors."""
    return decode_fn(batch_codes, anchors.expand(*batch_codes.shape[:-1], 4))
