"""Numpy operations on [N, H, W] binary instance masks (port of
mtlx/geometry/np_mask_ops.py): the matching geometry of the
instance-segmentation evaluators, as np_box_ops is of the box ones.

Masks are uint8 / bool arrays (any nonzero value counts); the pairwise
ops return float64. The intersection is a float32 product of the
flattened masks, exact below 2^24 pixels a mask.
"""

from __future__ import annotations

import numpy as np

EPSILON = 1e-7


def area(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] -> [N] pixel counts."""
    if masks.ndim != 3:
        raise ValueError("masks must be [N, H, W]")
    return masks.astype(bool).sum(axis=(1, 2)).astype(np.float64)


def intersection(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Pairwise intersection areas: [N, H, W] x [M, H, W] -> [N, M]."""
    n, m = len(masks1), len(masks2)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float64)
    a = masks1.astype(bool).reshape(n, -1).astype(np.float32)
    b = masks2.astype(bool).reshape(m, -1).astype(np.float32)
    return (a @ b.T).astype(np.float64)


def iou(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Pairwise mask IoU: [N, M]."""
    inter = intersection(masks1, masks2)
    union = area(masks1)[:, None] + area(masks2)[None, :] - inter
    return inter / np.maximum(union, EPSILON)


def ioa(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Pairwise intersection over the area of masks2: ioa[i, j] =
    |m1_i & m2_j| / |m2_j|."""
    inter = intersection(masks1, masks2)
    return inter / np.maximum(area(masks2)[None, :], EPSILON)
