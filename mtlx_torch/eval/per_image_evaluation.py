"""Per-image detection/groundtruth matching (port of
mtlx/eval/per_image_evaluation.py).

Greedy matching of score-ranked detections to groundtruth at IoU >= 0.5,
per class, with the Pascal difficult-box protocol: a detection whose
best match is a difficult groundtruth box is removed from scoring
(neither tp nor fp); each other groundtruth box can be claimed once.
Group-of groundtruth (the OpenImages protocol) leaves the match pool,
and an unmatched detection inside one (IoA >= threshold) is unscored.
Given both detection and groundtruth instance masks, the match
similarity is mask IoU (np_mask_ops) instead of box IoU: what the Pascal
instance-segmentation evaluators match on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mtlx_torch.geometry import np_box_ops, np_mask_ops


class PerImageEvaluation:
    def __init__(self, num_classes: int, matching_iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou_threshold = matching_iou_threshold

    def compute_object_detection_metrics(
        self,
        detected_boxes: np.ndarray,
        detected_scores: np.ndarray,
        detected_class_labels: np.ndarray,
        groundtruth_boxes: np.ndarray,
        groundtruth_class_labels: np.ndarray,
        groundtruth_is_difficult: np.ndarray,
        groundtruth_is_group_of: Optional[np.ndarray] = None,
        detected_masks: Optional[np.ndarray] = None,
        groundtruth_masks: Optional[np.ndarray] = None,
    ):
        """(scores, tp_fp_labels, is_class_correctly_detected), each per
        class."""
        if groundtruth_is_group_of is None or len(groundtruth_is_group_of) != len(
            groundtruth_class_labels
        ):
            groundtruth_is_group_of = np.zeros(len(groundtruth_class_labels), bool)
        scores, tp_fp = self._label_tp_fp(
            detected_boxes, detected_scores, detected_class_labels, groundtruth_boxes,
            groundtruth_class_labels, groundtruth_is_difficult,
            groundtruth_is_group_of.astype(bool), detected_masks, groundtruth_masks,
        )
        correctly_detected = self._corloc_flags(
            detected_boxes, detected_scores, detected_class_labels, groundtruth_boxes,
            groundtruth_class_labels,
        )
        return scores, tp_fp, correctly_detected

    def _per_class(self, boxes, scores, labels, cls, masks=None
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        sel = labels == cls
        b, s = boxes[sel], scores[sel]
        order = np.argsort(-s, kind="stable")
        return b[order], s[order], (masks[sel][order] if masks is not None else None)

    def _label_tp_fp(self, det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
                     gt_difficult, gt_group_of, det_masks=None, gt_masks=None):
        use_masks = det_masks is not None and gt_masks is not None
        all_scores, all_tp_fp = [], []
        for cls in range(self.num_classes):
            b, s, m = self._per_class(det_boxes, det_scores, det_labels, cls, det_masks)
            gsel = gt_labels == cls
            gdiff = (
                gt_difficult[gsel]
                if len(gt_difficult) == len(gt_labels)
                else np.zeros(gsel.sum(), bool)
            ).astype(bool)
            ggroup = gt_group_of[gsel]
            gboxes = gt_boxes[gsel][~ggroup]
            gdiff_n = gdiff[~ggroup]
            group_boxes = gt_boxes[gsel][ggroup]
            gmasks_n = gt_masks[gsel][~ggroup] if use_masks else None
            if len(b) == 0:
                all_scores.append(np.zeros(0, np.float32))
                all_tp_fp.append(np.zeros(0, bool))
                continue
            tp_fp = np.zeros(len(b), bool)
            drop = np.zeros(len(b), bool)
            matched = np.zeros(len(b), bool)
            if len(gboxes) > 0:
                sim = np_mask_ops.iou(m, gmasks_n) if use_masks else np_box_ops.iou(b, gboxes)
                claimed = np.zeros(len(gboxes), bool)
                for i in range(len(b)):
                    j = int(np.argmax(sim[i]))
                    if sim[i, j] >= self.iou_threshold:
                        if gdiff_n[j]:
                            drop[i] = True  # matched a difficult box: unscored
                        elif not claimed[j]:
                            claimed[j] = True
                            tp_fp[i] = True
                            matched[i] = True
            if len(group_boxes) > 0:
                ioa = np_box_ops.ioa(group_boxes, b)  # [G, D]
                hits = ioa.max(axis=0) >= self.iou_threshold
                drop |= hits & ~matched & ~drop
            keep = ~drop
            all_scores.append(s[keep])
            all_tp_fp.append(tp_fp[keep])
        return all_scores, all_tp_fp

    def _corloc_flags(self, det_boxes, det_scores, det_labels, gt_boxes, gt_labels):
        flags = np.zeros(self.num_classes, np.int32)
        for cls in range(self.num_classes):
            gsel = gt_labels == cls
            if not gsel.any():
                continue
            b, _, _ = self._per_class(det_boxes, det_scores, det_labels, cls)
            if len(b) == 0:
                continue
            if np_box_ops.iou(b[:1], gt_boxes[gsel]).max() >= self.iou_threshold:
                flags[cls] = 1
        return flags
