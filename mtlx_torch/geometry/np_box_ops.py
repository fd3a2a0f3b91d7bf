"""Numpy box geometry for the evaluator and the host geometry (port of
area, intersection, iou, ioa and clip_to_window of
mtlx/geometry/np_box_ops.py).

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
