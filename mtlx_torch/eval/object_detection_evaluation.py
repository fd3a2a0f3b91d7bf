"""Corpus-level detection evaluation (port of
mtlx/eval/object_detection_evaluation.py: ObjectDetectionEvaluation and
the Pascal, OpenImages and weighted Pascal evaluators, with the
reference's metric names, 'Precision/mAP@0.5IOU' and
'PerformanceByCategory/AP@0.5IOU/<name>', and the Pascal and weighted
Pascal instance-segmentation evaluators, which match on mask IoU and
prefix their names 'PascalMasks_' / 'WeightedPascalMasks_')."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mtlx_torch.eval import metrics as metrics_lib
from mtlx_torch.eval.per_image_evaluation import PerImageEvaluation


class ObjectDetectionEvaluation:
    def __init__(self, num_classes: int, matching_iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.per_image = PerImageEvaluation(num_classes, matching_iou_threshold)
        self.scores_per_class: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
        self.tp_fp_per_class: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
        self.num_gt_per_class = np.zeros(num_classes, np.int64)
        self.num_gt_imgs_per_class = np.zeros(num_classes, np.int64)
        self.num_correct_imgs_per_class = np.zeros(num_classes, np.int64)
        self.gt: Dict[str, dict] = {}

    def add_single_ground_truth_image_info(
        self,
        image_key: str,
        groundtruth_boxes: np.ndarray,
        groundtruth_class_labels: np.ndarray,
        groundtruth_is_difficult: Optional[np.ndarray] = None,
        groundtruth_is_group_of: Optional[np.ndarray] = None,
        groundtruth_masks: Optional[np.ndarray] = None,
    ):
        n = len(groundtruth_class_labels)
        if groundtruth_is_difficult is None or len(groundtruth_is_difficult) != n:
            groundtruth_is_difficult = np.zeros(n, bool)
        groundtruth_is_difficult = groundtruth_is_difficult.astype(bool)
        if groundtruth_is_group_of is None or len(groundtruth_is_group_of) != n:
            groundtruth_is_group_of = np.zeros(n, bool)
        groundtruth_is_group_of = groundtruth_is_group_of.astype(bool)
        self.gt[image_key] = {
            "boxes": groundtruth_boxes,
            "labels": groundtruth_class_labels,
            "difficult": groundtruth_is_difficult,
            "group_of": groundtruth_is_group_of,
            "masks": groundtruth_masks,
        }
        for cls in range(self.num_classes):
            # neither difficult nor group-of boxes enter the recall denominator
            sel = ((groundtruth_class_labels == cls) & ~groundtruth_is_difficult
                   & ~groundtruth_is_group_of)
            self.num_gt_per_class[cls] += int(sel.sum())
            if (groundtruth_class_labels == cls).any():
                self.num_gt_imgs_per_class[cls] += 1

    def add_single_detected_image_info(
        self,
        image_key: str,
        detected_boxes: np.ndarray,
        detected_scores: np.ndarray,
        detected_class_labels: np.ndarray,
        detected_masks: Optional[np.ndarray] = None,
    ):
        gt = self.gt.get(image_key, {
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros(0, np.int64),
            "difficult": np.zeros(0, bool),
            "group_of": np.zeros(0, bool),
            "masks": None,
        })
        scores, tp_fp, correct = self.per_image.compute_object_detection_metrics(
            detected_boxes, detected_scores, detected_class_labels, gt["boxes"],
            gt["labels"], gt["difficult"], groundtruth_is_group_of=gt["group_of"],
            detected_masks=detected_masks, groundtruth_masks=gt["masks"],
        )
        for cls in range(self.num_classes):
            self.scores_per_class[cls].append(scores[cls])
            self.tp_fp_per_class[cls].append(tp_fp[cls])
        self.num_correct_imgs_per_class += correct

    def evaluate(self):
        aps = np.full(self.num_classes, np.nan)
        precisions, recalls = {}, {}
        for cls in range(self.num_classes):
            scores = (np.concatenate(self.scores_per_class[cls])
                      if self.scores_per_class[cls] else np.zeros(0))
            tp_fp = (np.concatenate(self.tp_fp_per_class[cls])
                     if self.tp_fp_per_class[cls] else np.zeros(0, bool))
            p, r = metrics_lib.compute_precision_recall(
                scores, tp_fp.astype(np.float32), int(self.num_gt_per_class[cls])
            )
            precisions[cls], recalls[cls] = p, r
            aps[cls] = metrics_lib.compute_average_precision(p, r)
        mean_ap = float(np.nanmean(aps)) if np.isfinite(aps).any() else float("nan")
        corloc = metrics_lib.compute_cor_loc(
            self.num_gt_imgs_per_class, self.num_correct_imgs_per_class
        )
        mean_corloc = float(np.nanmean(corloc)) if np.isfinite(corloc).any() else float("nan")
        return aps, mean_ap, precisions, recalls, corloc, mean_corloc


class PascalDetectionEvaluator:
    """Categories are [{'id', 'name'}] with 1-based ids; detections and
    groundtruth carry 1-based class labels."""

    def __init__(self, categories: List[dict], matching_iou_threshold: float = 0.5):
        self.categories = categories
        self._label_offset = 1
        max_id = max(c["id"] for c in categories)
        self.evaluation = ObjectDetectionEvaluation(
            num_classes=max_id, matching_iou_threshold=matching_iou_threshold
        )
        self._name = {c["id"]: c["name"] for c in categories}

    def add_single_ground_truth_image_info(self, image_id: str, groundtruth_dict: dict):
        self.evaluation.add_single_ground_truth_image_info(
            image_id,
            groundtruth_dict["groundtruth_boxes"],
            groundtruth_dict["groundtruth_classes"] - self._label_offset,
            groundtruth_dict.get("groundtruth_difficult"),
        )

    def add_single_detected_image_info(self, image_id: str, detections_dict: dict):
        self.evaluation.add_single_detected_image_info(
            image_id,
            detections_dict["detection_boxes"],
            detections_dict["detection_scores"],
            detections_dict["detection_classes"] - self._label_offset,
        )

    def evaluate(self) -> Dict[str, float]:
        aps, mean_ap, _, _, _, mean_corloc = self.evaluation.evaluate()
        out = {"Precision/mAP@0.5IOU": mean_ap, "CorLoc/CorLoc@0.5IOU": mean_corloc}
        for cls_id, name in self._name.items():
            out[f"PerformanceByCategory/AP@0.5IOU/{name}"] = float(
                aps[cls_id - self._label_offset])
        return out

    def clear(self):
        self.__init__(self.categories, self.evaluation.per_image.iou_threshold)


class PascalInstanceSegmentationEvaluator(PascalDetectionEvaluator):
    """pascal_voc_instance_segmentation_metrics: the Pascal protocol matched
    on instance-mask IoU instead of box IoU, its metric names prefixed
    'PascalMasks_'. The groundtruth and detection dicts carry
    'groundtruth_instance_masks' / 'detection_masks', [N, H, W] binary in
    the image's frame."""

    _PREFIX = "PascalMasks_"

    def add_single_ground_truth_image_info(self, image_id: str, groundtruth_dict: dict):
        self.evaluation.add_single_ground_truth_image_info(
            image_id,
            groundtruth_dict["groundtruth_boxes"],
            groundtruth_dict["groundtruth_classes"] - self._label_offset,
            groundtruth_dict.get("groundtruth_difficult"),
            groundtruth_masks=np.asarray(groundtruth_dict["groundtruth_instance_masks"], bool),
        )

    def add_single_detected_image_info(self, image_id: str, detections_dict: dict):
        self.evaluation.add_single_detected_image_info(
            image_id,
            detections_dict["detection_boxes"],
            detections_dict["detection_scores"],
            detections_dict["detection_classes"] - self._label_offset,
            detected_masks=np.asarray(detections_dict["detection_masks"], bool),
        )

    def evaluate(self) -> Dict[str, float]:
        out = super().evaluate()
        return {f"{self._PREFIX}{k}": v for k, v in out.items()}


class OpenImagesDetectionEvaluator(PascalDetectionEvaluator):
    """open_images_V2_detection_metrics: Pascal-style AP@0.5 with the
    OpenImages group-of protocol. Group-of groundtruth boxes stay out of
    the recall denominator, and an unmatched detection inside one (IoA >=
    threshold) is unscored instead of a false positive. Groundtruth dicts
    may carry 'groundtruth_group_of'."""

    def add_single_ground_truth_image_info(self, image_id: str, groundtruth_dict: dict):
        self.evaluation.add_single_ground_truth_image_info(
            image_id,
            groundtruth_dict["groundtruth_boxes"],
            groundtruth_dict["groundtruth_classes"] - self._label_offset,
            groundtruth_dict.get("groundtruth_difficult"),
            groundtruth_is_group_of=groundtruth_dict.get("groundtruth_group_of"),
        )

    def evaluate(self) -> Dict[str, float]:
        aps, mean_ap, _, _, _, _ = self.evaluation.evaluate()
        out = {"OpenImagesV2_Precision/mAP@0.5IOU": mean_ap}
        for cls_id, name in self._name.items():
            out[f"OpenImagesV2_PerformanceByCategory/AP@0.5IOU/{name}"] = float(
                aps[cls_id - self._label_offset])
        return out


class WeightedPascalDetectionEvaluator(PascalDetectionEvaluator):
    """All classes' detections pooled into one precision/recall curve over
    the total groundtruth count (use_weighted_mean_ap)."""

    def evaluate(self) -> Dict[str, float]:
        ev = self.evaluation
        aps, _, _, _, _, _ = ev.evaluate()
        all_scores, all_tp_fp = [], []
        for cls in range(ev.num_classes):
            if ev.scores_per_class[cls]:
                all_scores.append(np.concatenate(ev.scores_per_class[cls]))
                all_tp_fp.append(np.concatenate(ev.tp_fp_per_class[cls]))
        total_gt = int(ev.num_gt_per_class.sum())
        if all_scores and total_gt > 0:
            p, r = metrics_lib.compute_precision_recall(
                np.concatenate(all_scores), np.concatenate(all_tp_fp).astype(np.float32),
                total_gt)
            weighted_ap = float(metrics_lib.compute_average_precision(p, r))
        else:
            weighted_ap = float("nan")
        out = {"WeightedPascalBoxes_Precision/mAP@0.5IOU": weighted_ap}
        for cls_id, name in self._name.items():
            out[f"WeightedPascalBoxes_PerformanceByCategory/AP@0.5IOU/{name}"] = float(
                aps[cls_id - self._label_offset])
        return out


class WeightedPascalInstanceSegmentationEvaluator(PascalInstanceSegmentationEvaluator):
    """weighted_pascal_voc_instance_segmentation_metrics: the weighted
    (box-count pooled) AP of WeightedPascalDetectionEvaluator over
    mask-IoU matches, its names prefixed 'WeightedPascalMasks_'."""

    def evaluate(self) -> Dict[str, float]:
        pooled = WeightedPascalDetectionEvaluator.evaluate(self)
        return {k.replace("WeightedPascalBoxes_", "WeightedPascalMasks_"): v
                for k, v in pooled.items()}
