"""The yardstick's arithmetic: the card's published peaks, the model
operations of a train step and of a served batch (for `mfu.*`), and the least time of each call
of the port's detection kernels (for the `*_roofline` metrics), all from
shapes and inputs, none from the program. The kernel bounds are
chip_smoke.py's (`bound_ms`, `crop_pixels_read`, the NMS and IoU counts),
copied here so that an edit there does not move the benchmark."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# one H100 SXM, NVIDIA's data sheet, dense, at 700 W
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# the NMS kernel's operations per box and greedy step: the argmax key
# compare and the IoU test (2 min, 2 max, 3 sub, 2 clamp, 1 mul, 2 add /
# sub, 1 div, 3 compares)
NMS_OPS_PER_BOX_STEP = 17
# a crop output element: three lerps (sub, mul, add)
ROI_OPS_PER_ELEMENT = 9
# a crop backward input element: four weights and four adds
ROI_BWD_OPS_PER_ELEMENT = 8
# an IoU output: 2 min, 2 max, 2 sub, 2 clamp, 1 mul, area (3), union (2),
# compare, max, div
IOU_OPS_PER_OUTPUT = 16

RESNET_UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    float32 operations at the CUDA cores' peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


# ---- model operations ----

def _conv(n: int, h: int, w: int, cin: int, cout: int, k: int) -> int:
    """Multiply-adds of a k x k convolution producing n x h x w x cout."""
    return n * h * w * cout * cin * k * k


def _stage(n: int, h: int, w: int, units: int, cin: int, depth: int, stride: int) -> Tuple[int, int, int]:
    """(multiply-adds, out h, out w) of a bottleneck stage, the stride on
    its first unit."""
    mid = depth // 4
    oh, ow = -(-h // stride), -(-w // stride)
    macs = 0
    for u in range(units):
        i = cin if u == 0 else depth
        ih, iw = (h, w) if u == 0 else (oh, ow)
        macs += _conv(n, ih, iw, i, mid, 1)          # conv1 at the unit's input
        macs += _conv(n, oh, ow, mid, mid, 3)        # conv2, strided
        macs += _conv(n, oh, ow, mid, depth, 1)      # conv3
        if u == 0 and i != depth:
            macs += _conv(n, oh, ow, i, depth, 1)    # the projection shortcut
    return macs, oh, ow


def _trunk_and_rpn(model: Dict, batch: int, hw: Tuple[int, int]) -> Tuple[int, int, int]:
    """(multiply-adds, map h, map w) of the trunk to conv4 and the RPN."""
    units = RESNET_UNITS[model["resnet_depth"]]
    h, w = hw
    macs = _conv(batch, -(-h // 2), -(-w // 2), 3, 64, 7)
    h, w = -(-h // 4), -(-w // 4)  # conv1 /2, maxpool /2
    for units_, cin, depth, stride in ((units[0], 64, 256, 1), (units[1], 256, 512, 2),
                                       (units[2], 512, 1024, 2)):
        m, h, w = _stage(batch, h, w, units_, cin, depth, stride)
        macs += m
    anchors = len(model["anchor_scales"]) * len(model["anchor_aspect_ratios"])
    macs += _conv(batch, h, w, 1024, model["rpn_depth"], model["rpn_kernel_size"])
    macs += _conv(batch, h, w, model["rpn_depth"], 6 * anchors, 1)
    return macs, h, w


def _second_stage(model: Dict, rois: int) -> int:
    """Multiply-adds of conv5 on `rois` pooled crops and the box predictor."""
    k = model["num_classes"]
    side = model["initial_crop_size"] // model["maxpool_stride"]
    units = RESNET_UNITS[model["resnet_depth"]]
    return _stage(rois, side, side, units[3], 1024, 2048, 1)[0] + rois * 2048 * (k + 1 + 4 * k)


def train_step_flops(model: Dict, batch: int, hw: Tuple[int, int], max_boxes: int) -> float:
    """Model operations of one MTL Faster R-CNN train step on a batch of
    `batch` images on an h x w canvas: convolutions and matrix products
    only (the trunk, the RPN, the foreground head, conv5 on the sampled
    proposals, the box predictor, the two pooled heads and their window
    pooling), the forward counted three times for forward and backward."""
    k = model["num_classes"]
    macs, h, w = _trunk_and_rpn(model, batch, hw)
    macs += _conv(batch, h, w, 1024, 256, 3) + _conv(batch, h, w, 256, 1, 1)  # foreground
    macs += _second_stage(model, batch * model["second_stage_batch_size"])
    windows = batch * max_boxes
    macs += 2 * windows * (1024 * 1024 + 1024 * k)           # the two pooled heads
    macs += 2 * windows * (h * w * 1024 + w * 1024)          # their windows' pooling
    return 3 * 2 * float(macs)


def serve_flops(model: Dict, batch: int, hw: Tuple[int, int]) -> float:
    """Model operations of one served batch: the trunk, the RPN, conv5 and
    the box predictor on first_stage_max_proposals proposals an image."""
    macs = _trunk_and_rpn(model, batch, hw)[0]
    macs += _second_stage(model, batch * model["first_stage_max_proposals"])
    return 2 * float(macs)


# ---- kernel bounds ----

def crop_pixels_read(boxes: torch.Tensor, crop_size, h: int, w: int) -> int:
    """Distinct pixels a crop must read: per image, the union over its
    boxes of (rows under an in-range sample row) x (columns under an
    in-range sample column)."""
    from h100_bench.reference.kernels_plain import _sample_points

    (y_lo, y_hi, _, y_in), (x_lo, x_hi, _, x_in) = _sample_points(boxes.float(), crop_size, h, w)

    def used(lo, hi, in_range, n):
        u = torch.zeros(*boxes.shape[:2], n + 1, device=boxes.device)
        for idx in (lo, hi):  # out-of-range samples go to the spare index n
            u.scatter_(2, torch.where(in_range, idx, n), 1.0)
        return u[..., :n]

    rows, cols = used(y_lo, y_hi, y_in, h), used(x_lo, x_hi, x_in, w)
    return int((torch.bmm(rows.transpose(1, 2), cols) > 0).sum())


def nms_seconds(scores_shape, keep: torch.Tensor, max_out: int) -> float:
    """Every pick made plus the empty pick that ends a problem early, each
    a pass over the N boxes; boxes, scores and valid read once, the picks
    written."""
    p, n = scores_shape
    steps = int(torch.clamp(keep.sum(1) + 1, max=max_out).sum())
    return least_seconds(p * n * (16 + 4 + 1) + p * max_out * (4 + 1),
                         steps * n * NMS_OPS_PER_BOX_STEP)


def crop_seconds(features_shape, itemsize: int, boxes: torch.Tensor, crop_size) -> float:
    """The pixels under the sample points read once, the boxes read, the
    crops written."""
    b, h, w, c = features_shape
    n = boxes.shape[1]
    outputs = b * n * crop_size[0] * crop_size[1] * c
    pixels = crop_pixels_read(boxes, crop_size, h, w)
    return least_seconds(pixels * c * itemsize + b * n * 16 + outputs * itemsize,
                         outputs * ROI_OPS_PER_ELEMENT)


def crop_backward_seconds(dout_shape, itemsize: int, image_hw) -> float:
    """The crops' gradient and the boxes read, the map's gradient written."""
    b, n, ch, cw, c = dout_shape
    inputs = b * n * ch * cw * c
    return least_seconds(inputs * itemsize + b * n * 16 + b * image_hw[0] * image_hw[1] * c * itemsize,
                         inputs * ROI_BWD_OPS_PER_ELEMENT)


def iou_seconds(shape1, shape2) -> float:
    """Both box sets read, the [P, N, M] matrix written."""
    p, n, m = max(shape1[0], shape2[0]), shape1[1], shape2[1]
    return least_seconds((shape1[0] * n + shape2[0] * m) * 16 + p * n * m * 4,
                         p * n * m * IOU_OPS_PER_OUTPUT)
