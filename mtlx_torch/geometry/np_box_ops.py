"""Numpy box geometry for the evaluator and the host geometry (port of
mtlx/geometry/np_box_ops.py, its Faster R-CNN box coder oracle too).

Boxes are float arrays of shape [N, 4] in [ymin, xmin, ymax, xmax] order.
"""

from __future__ import annotations

import numpy as np


def area(boxes: np.ndarray) -> np.ndarray:
    """Areas of boxes. [N, 4] -> [N]."""
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def intersection(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise intersection areas. [N, 4] x [M, 4] -> [N, M]."""
    ymin1, xmin1, ymax1, xmax1 = np.split(boxes1, 4, axis=1)
    ymin2, xmin2, ymax2, xmax2 = np.split(boxes2, 4, axis=1)
    ih = np.maximum(0.0, np.minimum(ymax1, ymax2.T) - np.maximum(ymin1, ymin2.T))
    iw = np.maximum(0.0, np.minimum(xmax1, xmax2.T) - np.maximum(xmin1, xmin2.T))
    return ih * iw


def iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise intersection-over-union. [N, 4] x [M, 4] -> [N, M]."""
    inter = intersection(boxes1, boxes2)
    union = area(boxes1)[:, None] + area(boxes2)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-30), 0.0)


def ioa(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise intersection over the area of boxes2. [N, 4] x [M, 4] -> [N, M]."""
    inter = intersection(boxes1, boxes2)
    a2 = area(boxes2)
    return np.where(a2[None, :] > 0, inter / np.maximum(a2[None, :], 1e-30), 0.0)


def clip_to_window(boxes: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Clip boxes to a window [ymin, xmin, ymax, xmax]."""
    wy0, wx0, wy1, wx1 = window
    return np.stack([np.clip(boxes[:, 0], wy0, wy1), np.clip(boxes[:, 1], wx0, wx1),
                     np.clip(boxes[:, 2], wy0, wy1), np.clip(boxes[:, 3], wx0, wx1)], axis=1)


def change_coordinate_frame(boxes: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Re-express boxes relative to `window` (normalized by its size)."""
    wy0, wx0, wy1, wx1 = window
    h = wy1 - wy0
    w = wx1 - wx0
    return np.stack([(boxes[:, 0] - wy0) / h, (boxes[:, 1] - wx0) / w,
                     (boxes[:, 2] - wy0) / h, (boxes[:, 3] - wx0) / w], axis=1)


def center_coordinates_and_sizes(boxes: np.ndarray):
    """[N, 4] -> (ycenter, xcenter, h, w), each [N]."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    return boxes[:, 0] + 0.5 * h, boxes[:, 1] + 0.5 * w, h, w


def faster_rcnn_encode(boxes: np.ndarray, anchors: np.ndarray,
                       scale_factors=(10.0, 10.0, 5.0, 5.0)) -> np.ndarray:
    """The Faster R-CNN box coder's encode in numpy: [ty, tx, th, tw], with
    the reference's 1e-8 added to every height and width."""
    eps = 1e-8
    ycenter_a, xcenter_a, ha, wa = center_coordinates_and_sizes(anchors)
    ycenter, xcenter, h, w = center_coordinates_and_sizes(boxes)
    ha, wa, h, w = ha + eps, wa + eps, h + eps, w + eps
    ty = (ycenter - ycenter_a) / ha * scale_factors[0]
    tx = (xcenter - xcenter_a) / wa * scale_factors[1]
    th = np.log(h / ha) * scale_factors[2]
    tw = np.log(w / wa) * scale_factors[3]
    return np.stack([ty, tx, th, tw], axis=1)


def faster_rcnn_decode(codes: np.ndarray, anchors: np.ndarray,
                       scale_factors=(10.0, 10.0, 5.0, 5.0)) -> np.ndarray:
    """The Faster R-CNN box coder's decode in numpy."""
    ycenter_a, xcenter_a, ha, wa = center_coordinates_and_sizes(anchors)
    ty = codes[:, 0] / scale_factors[0]
    tx = codes[:, 1] / scale_factors[1]
    th = codes[:, 2] / scale_factors[2]
    tw = codes[:, 3] / scale_factors[3]
    w = np.exp(tw) * wa
    h = np.exp(th) * ha
    ycenter = ty * ha + ycenter_a
    xcenter = tx * wa + xcenter_a
    return np.stack([ycenter - 0.5 * h, xcenter - 0.5 * w, ycenter + 0.5 * h,
                     xcenter + 0.5 * w], axis=1)
