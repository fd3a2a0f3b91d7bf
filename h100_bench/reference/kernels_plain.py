"""The plain versions of the port's three detection kernels, frozen copies
of `iou_matrix_plain`, `non_max_suppression_plain` and
`crop_and_resize_plain` (mtlx_torch/kernels/*_cuda.py), under the names
the copied callers use. The crop is the gather form, which autograd
differentiates in the features."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

EPSILON = 1e-30
_NEG = -1e10  # the score of a dead row


def iou_matrix(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] in box_ops.iou's operation
    order; pairs whose union is not positive get 0."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    ih = torch.clamp_min(
        torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0]), 0.0
    )
    iw = torch.clamp_min(
        torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1]), 0.0
    )
    inter = ih * iw
    a1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    a2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, EPSILON), 0.0)


def non_max_suppression(boxes: Tensor, scores: Tensor, valid: Tensor, max_out: int,
                        iou_threshold: float = 0.5, score_threshold: float = float("-inf")):
    """Greedy NMS over P problems at once: boxes [P, N, 4], scores and
    valid [P, N] -> (indices [P, max_out] int32 0-padded, keep [P, max_out]
    bool). The first maximum wins a tie (the lower index)."""
    p, n = scores.shape
    dev = scores.device
    live = torch.where(valid, scores, _NEG)
    live = torch.where(live > score_threshold, live, _NEG)
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    area = (ymax - ymin) * (xmax - xmin)
    col = torch.arange(n, device=dev)
    rows = torch.arange(p, device=dev)
    idx = torch.zeros((p, max_out), dtype=torch.int32, device=dev)
    keep = torch.zeros((p, max_out), dtype=torch.bool, device=dev)
    for k in range(max_out):
        best = torch.argmax(live, dim=1)
        ok = live[rows, best] > _NEG / 2
        if not bool(ok.any()):
            break  # every later slot stays empty
        by0 = ymin[rows, best][:, None]
        bx0 = xmin[rows, best][:, None]
        by1 = ymax[rows, best][:, None]
        bx1 = xmax[rows, best][:, None]
        barea = (by1 - by0) * (bx1 - bx0)
        ih = torch.clamp_min(torch.minimum(ymax, by1) - torch.maximum(ymin, by0), 0.0)
        iw = torch.clamp_min(torch.minimum(xmax, bx1) - torch.maximum(xmin, bx0), 0.0)
        inter = ih * iw
        union = area + barea - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-30), 0.0)
        suppress = (iou > iou_threshold) | (col[None, :] == best[:, None])
        live = torch.where(ok[:, None] & suppress, _NEG, live)
        idx[:, k] = torch.where(ok, best, 0).to(torch.int32)
        keep[:, k] = ok
    return idx, keep


def _sample_points(boxes: Tensor, crop_size: Tuple[int, int], h: int, w: int):
    """Per axis (lo, hi, frac, in_range) of every sample point: [B, N, 4]
    -> y parts [B, N, ch], x parts [B, N, cw]."""
    from .roi import _sample_coords

    def sample_axis(coords, limit):
        lo = torch.floor(coords)
        frac = coords - lo
        lo_i = torch.clamp(lo.to(torch.int64), 0, limit - 1)
        hi_i = torch.clamp(lo_i + 1, 0, limit - 1)
        in_range = (coords >= 0.0) & (coords <= limit - 1)
        return lo_i, hi_i, frac, in_range

    y1, x1, y2, x2 = boxes.unbind(-1)
    ys = _sample_coords(y1, y2, crop_size[0], h)
    xs = _sample_coords(x1, x2, crop_size[1], w)
    return sample_axis(ys, h), sample_axis(xs, w)


def crop_and_resize(features: Tensor, boxes: Tensor, crop_size: Tuple[int, int]) -> Tensor:
    """[B, H, W, C] x [B, N, 4] normalized boxes -> [B, N, ch, cw, C]: four
    gathered taps a sample, two lerps across and one down, 0 outside."""
    b, h, w, _ = features.shape
    boxes = boxes.detach()
    (y_lo, y_hi, y_frac, y_in), (x_lo, x_hi, x_frac, x_in) = _sample_points(
        boxes, crop_size, h, w
    )
    bi = torch.arange(b, device=features.device)[:, None, None, None]

    def gather2d(yi, xi):  # [B, N, ch] x [B, N, cw] -> [B, N, ch, cw, C]
        return features[bi, yi[..., :, None], xi[..., None, :]].float()

    tl = gather2d(y_lo, x_lo)
    tr = gather2d(y_lo, x_hi)
    bl = gather2d(y_hi, x_lo)
    br = gather2d(y_hi, x_hi)
    yf = y_frac[..., :, None, None]
    xf = x_frac[..., None, :, None]
    top = tl + (tr - tl) * xf
    bottom = bl + (br - bl) * xf
    out = top + (bottom - top) * yf
    valid = (y_in[..., :, None] & x_in[..., None, :])[..., None]
    return torch.where(valid, out, 0.0).to(features.dtype)
