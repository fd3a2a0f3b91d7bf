"""Detection metrics (port of mtlx/eval/metrics.py): Pascal every-point AP
(the monotonic precision envelope integrated over recall steps),
precision and recall from score-ranked detections, and CorLoc. Numpy,
on the host."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_precision_recall(
    scores: np.ndarray, labels: np.ndarray, num_gt: int
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Precision/recall curves from per-detection scores and tp(1)/fp(0)
    labels, against num_gt groundtruth instances."""
    if num_gt == 0:
        return None, None
    if len(scores) == 0:
        # groundtruth exists but nothing was detected: empty curves -> AP 0
        return np.zeros(0), np.zeros(0)
    order = np.argsort(-scores, kind="stable")
    labels = labels[order].astype(np.float64)
    tp = np.cumsum(labels)
    fp = np.cumsum(1.0 - labels)
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / num_gt
    return precision, recall


def compute_average_precision(
    precision: Optional[np.ndarray], recall: Optional[np.ndarray]
) -> float:
    """Pascal every-point-interpolated AP (not the 11-point VOC07 one)."""
    if precision is None or recall is None:
        return float("nan")
    p = np.concatenate([[0.0], precision, [0.0]])
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]  # the envelope from the right
    idx = np.where(r[1:] != r[:-1])[0] + 1
    return float(np.sum((r[idx] - r[idx - 1]) * p[idx]))


def compute_cor_loc(
    num_gt_imgs_per_class: np.ndarray, num_correctly_detected_per_class: np.ndarray
) -> np.ndarray:
    """CorLoc per class: the share of images holding the class whose
    top-scoring detection of that class is correct."""
    return np.where(
        num_gt_imgs_per_class > 0,
        num_correctly_detected_per_class / np.maximum(num_gt_imgs_per_class, 1),
        np.nan,
    )
