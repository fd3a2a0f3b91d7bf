"""COCO-style detection evaluation (port of mtlx/eval/coco_evaluation.py,
metrics_set 'coco_detection_metrics'): a numpy implementation of
COCOeval's bbox protocol, with no pycocotools.

  * 10 IoU thresholds 0.50:0.05:0.95, greedy score-descending matching per
    (image, class); a detection may match an already-matched crowd box;
    ignored groundtruth (crowd, or out of the area range) neither rewards
    nor penalizes
  * 101-point interpolated AP, averaged over the classes present in the
    groundtruth and over the thresholds
  * area ranges all / small / medium / large ([0, 32^2], [32^2, 96^2],
    [96^2, inf])
  * AR@{1, 10, 100}: the mean over thresholds and classes of the recall
    with at most k detections an image

The metric names are the reference's coco_tools names
('DetectionBoxes_Precision/mAP', ...). iou_type 'segm' (metrics_set
'coco_mask_metrics', `CocoMaskEvaluator`) matches on binary-mask IoU
instead, a crowd's IoU being the intersection over the detection's area
(pycocotools' maskUtils.iou), with mask-pixel areas for the area ranges,
under the names 'DetectionMasks_...'.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mtlx_torch.geometry import np_box_ops

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).round(2)  # 0.5 ... 0.95 (10)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETECTIONS = 100
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros((0,), np.float64)
    return np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)


def _mask_iou(dt_masks: np.ndarray, gt_masks: np.ndarray,
              gt_iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] binary-mask IoU; a crowd's is the intersection over the
    detection's area (pycocotools maskUtils.iou with iscrowd)."""
    d, g = len(dt_masks), len(gt_masks)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    dt = dt_masks.reshape(d, -1).astype(bool)
    gt = gt_masks.reshape(g, -1).astype(bool)
    inter = dt.astype(np.float64) @ gt.T.astype(np.float64)  # [D, G]
    da = dt.sum(1).astype(np.float64)[:, None]
    ga = gt.sum(1).astype(np.float64)[None, :]
    union = np.where(gt_iscrowd[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_image(
    iou: np.ndarray,  # [D, G], detections sorted by score, descending
    gt_iscrowd: np.ndarray,  # [G] bool
    gt_ignore: np.ndarray,  # [G] bool (crowd or out of the area range)
    dt_out_of_range: np.ndarray,  # [D] bool
):
    """One (image, class, area range) match at every IoU threshold.
    Returns (tp [T, D], dt_ignore [T, D], the count of groundtruth not
    ignored)."""
    d, g = iou.shape
    t = len(IOU_THRESHOLDS)
    tp = np.zeros((t, d), bool)
    dt_ig = np.zeros((t, d), bool)
    npig = int((~gt_ignore).sum())
    if d == 0:
        return tp, dt_ig, npig
    if g == 0:
        # unmatched detections out of the area range are ignored
        dt_ig[:] = dt_out_of_range[None, :]
        return tp, dt_ig, npig
    # groundtruth not ignored first (COCOeval's order)
    gt_order = np.argsort(gt_ignore, kind="stable")
    gt_iscrowd = gt_iscrowd[gt_order]
    gt_ignore = gt_ignore[gt_order]
    iou = iou[:, gt_order]
    for ti, thr in enumerate(IOU_THRESHOLDS):
        matched = np.full(g, -1)
        for di in range(d):
            best = -1
            best_iou = min(thr, 1.0 - 1e-10)
            for gi in range(g):
                # taken already (a crowd box can take several detections)
                if matched[gi] >= 0 and not gt_iscrowd[gi]:
                    continue
                # with a real match in hand, stop at the first ignored box:
                # it cannot be better
                if best >= 0 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if iou[di, gi] < best_iou:
                    continue
                best_iou = iou[di, gi]
                best = gi
            if best >= 0:
                matched[best] = di
                if gt_ignore[best]:
                    dt_ig[ti, di] = True
                else:
                    tp[ti, di] = True
            else:
                dt_ig[ti, di] = dt_out_of_range[di]
    return tp, dt_ig, npig


class CocoDetectionEvaluation:
    """Accumulates per-image results; classes are 0-based here. iou_type
    'bbox' matches on box IoU, 'segm' on binary-mask IoU with mask-pixel
    areas (masks [N, H, W] in the same image frame for groundtruth and
    detections)."""

    def __init__(self, num_classes: int, iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"unknown iou_type {iou_type!r}")
        self.num_classes = num_classes
        self.iou_type = iou_type
        self.gt: Dict[str, dict] = {}
        # per area range: a list over images of {class: (scores, tp, ig)}
        self._results: Dict[str, List] = {k: [] for k in AREA_RANGES}
        self._npig = {k: np.zeros(num_classes, np.int64) for k in AREA_RANGES}

    def add_single_ground_truth_image_info(
        self,
        image_key: str,
        boxes: np.ndarray,
        classes: np.ndarray,
        is_crowd: Optional[np.ndarray] = None,
        masks: Optional[np.ndarray] = None,
    ):
        if is_crowd is None or len(is_crowd) != len(classes):
            is_crowd = np.zeros(len(classes), bool)
        if self.iou_type == "segm" and masks is None:
            raise ValueError("segm evaluation needs groundtruth masks")
        self.gt[image_key] = {
            "boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "classes": np.asarray(classes, np.int64),
            "is_crowd": np.asarray(is_crowd, bool),
            "masks": np.asarray(masks, bool) if masks is not None else None,
        }

    def add_single_detected_image_info(
        self,
        image_key: str,
        boxes: np.ndarray,
        scores: np.ndarray,
        classes: np.ndarray,
        masks: Optional[np.ndarray] = None,
    ):
        gt = self.gt.get(image_key, {
            "boxes": np.zeros((0, 4)),
            "classes": np.zeros(0, np.int64),
            "is_crowd": np.zeros(0, bool),
            "masks": None,
        })
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64)
        classes = np.asarray(classes, np.int64)
        order = np.argsort(-scores, kind="stable")[:MAX_DETECTIONS]
        boxes, scores, classes = boxes[order], scores[order], classes[order]
        segm = self.iou_type == "segm"
        if segm:
            if masks is None:
                raise ValueError("segm evaluation needs detection masks")
            masks = np.asarray(masks, bool)[order]
            gt_masks = gt["masks"]
            if gt_masks is None:
                gt_masks = np.zeros((0,) + masks.shape[1:], bool)
            dt_areas = masks.sum(axis=(1, 2)).astype(np.float64)
            gt_areas = gt_masks.sum(axis=(1, 2)).astype(np.float64)
        else:
            dt_areas = _box_areas(boxes)
            gt_areas = _box_areas(gt["boxes"])
        for rng_name, (lo, hi) in AREA_RANGES.items():
            per_class = {}
            for c in range(self.num_classes):
                dsel = classes == c
                gsel = gt["classes"] == c
                if not dsel.any() and not gsel.any():
                    continue
                g_ignore = gt["is_crowd"][gsel] | ((gt_areas[gsel] < lo) | (gt_areas[gsel] >= hi))
                d_out = (dt_areas[dsel] < lo) | (dt_areas[dsel] >= hi)
                if segm:
                    iou = _mask_iou(masks[dsel], gt_masks[gsel], gt["is_crowd"][gsel])
                else:
                    iou = np_box_ops.iou(boxes[dsel], gt["boxes"][gsel])
                tp, ig, npig = _match_image(iou, gt["is_crowd"][gsel], g_ignore, d_out)
                per_class[c] = (scores[dsel], tp, ig)
                self._npig[rng_name][c] += npig
            self._results[rng_name].append(per_class)

    # ---- aggregation ----

    def _precision_recall(self, rng_name: str, max_dets: int):
        """(ap [T, C], recall [T, C]), NaN where a class has no groundtruth."""
        t = len(IOU_THRESHOLDS)
        ap = np.full((t, self.num_classes), np.nan)
        rec = np.full((t, self.num_classes), np.nan)
        for c in range(self.num_classes):
            npig = int(self._npig[rng_name][c])
            if npig == 0:
                continue
            scores, tps, igs = [], [], []
            for per_class in self._results[rng_name]:
                if c not in per_class:
                    continue
                s, tp, ig = per_class[c]
                scores.append(s[:max_dets])
                tps.append(tp[:, :max_dets])
                igs.append(ig[:, :max_dets])
            if not scores:
                ap[:, c] = 0.0
                rec[:, c] = 0.0
                continue
            scores = np.concatenate(scores)
            tps = np.concatenate(tps, axis=1)
            igs = np.concatenate(igs, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            tps, igs = tps[:, order], igs[:, order]
            for ti in range(t):
                keep = ~igs[ti]
                tp = tps[ti][keep].astype(np.float64)
                fp = (~tps[ti][keep]).astype(np.float64)
                tp_cum = np.cumsum(tp)
                fp_cum = np.cumsum(fp)
                recall = tp_cum / npig
                precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
                rec[ti, c] = recall[-1] if len(recall) else 0.0
                # precision envelope, then the 101-point interpolation
                for i in range(len(precision) - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                idx = np.searchsorted(recall, RECALL_POINTS, side="left")
                q = np.zeros(len(RECALL_POINTS))
                valid = idx < len(precision)
                q[valid] = precision[idx[valid]]
                ap[ti, c] = q.mean()
        return ap, rec

    def evaluate(self) -> Dict[str, float]:
        def mean(x):
            return float(np.nanmean(x)) if np.isfinite(x).any() else -1.0

        prefix = "DetectionMasks" if self.iou_type == "segm" else "DetectionBoxes"
        ap_all, _ = self._precision_recall("all", MAX_DETECTIONS)
        out = {
            f"{prefix}_Precision/mAP": mean(ap_all),
            f"{prefix}_Precision/mAP@.50IOU": mean(ap_all[0]),
            f"{prefix}_Precision/mAP@.75IOU": mean(ap_all[5]),
        }
        for rng_name in ("small", "medium", "large"):
            ap_r, rec_r = self._precision_recall(rng_name, MAX_DETECTIONS)
            out[f"{prefix}_Precision/mAP ({rng_name})"] = mean(ap_r)
            out[f"{prefix}_Recall/AR@100 ({rng_name})"] = mean(rec_r)
        for k in (1, 10, 100):
            _, rec_k = self._precision_recall("all", k)
            out[f"{prefix}_Recall/AR@{k}"] = mean(rec_k)
        return out

    def per_category_ap(self) -> Dict[int, float]:
        ap_all, _ = self._precision_recall("all", MAX_DETECTIONS)
        return {
            c: (float(np.nanmean(ap_all[:, c])) if np.isfinite(ap_all[:, c]).any()
                else float("nan"))
            for c in range(self.num_classes)
        }


class CocoDetectionEvaluator:
    """Categories are [{'id', 'name'}] with 1-based ids (COCO's run 1..90
    with gaps; the evaluator sizes itself by the largest); the add_* dict
    keys are the Pascal evaluator's, so the eval loop feeds any metrics_set
    alike. Crowd boxes come in as `groundtruth_is_crowd`, or else as
    `groundtruth_difficult` (the loader's field for COCO's iscrowd)."""

    def __init__(self, categories: List[dict], include_metrics_per_category: bool = False):
        self.categories = categories
        self._include_per_category = include_metrics_per_category
        self._label_offset = 1
        max_id = max(c["id"] for c in categories)
        self.evaluation = CocoDetectionEvaluation(num_classes=max_id)
        self._name = {c["id"]: c["name"] for c in categories}

    def add_single_ground_truth_image_info(self, image_id: str, groundtruth_dict):
        self.evaluation.add_single_ground_truth_image_info(
            image_id,
            groundtruth_dict["groundtruth_boxes"],
            np.asarray(groundtruth_dict["groundtruth_classes"]) - self._label_offset,
            groundtruth_dict.get("groundtruth_is_crowd",
                                 groundtruth_dict.get("groundtruth_difficult")),
        )

    def add_single_detected_image_info(self, image_id: str, detections_dict):
        self.evaluation.add_single_detected_image_info(
            image_id,
            detections_dict["detection_boxes"],
            detections_dict["detection_scores"],
            np.asarray(detections_dict["detection_classes"]) - self._label_offset,
        )

    def evaluate(self) -> Dict[str, float]:
        out = self.evaluation.evaluate()
        if self._include_per_category:
            per_cat = self.evaluation.per_category_ap()
            for cls_id, name in self._name.items():
                ap = per_cat.get(cls_id - self._label_offset, float("nan"))
                out[f"DetectionBoxes_PerformanceByCategory/mAP/{name}"] = ap
        return out

    def clear(self):
        self.__init__(self.categories, self._include_per_category)


class CocoMaskEvaluator:
    """metrics_set 'coco_mask_metrics': the COCOeval matching of the box
    evaluator on binary-mask IoU with mask-pixel areas. The dicts carry
    'groundtruth_instance_masks' / 'detection_masks', [N, H, W] binary in
    the true image's frame; an image without them contributes nothing."""

    def __init__(self, categories: List[dict], include_metrics_per_category: bool = False):
        self.categories = categories
        self._include_per_category = include_metrics_per_category
        self._label_offset = 1
        max_id = max(c["id"] for c in categories)
        self.evaluation = CocoDetectionEvaluation(num_classes=max_id, iou_type="segm")
        self._name = {c["id"]: c["name"] for c in categories}

    def add_single_ground_truth_image_info(self, image_id: str, groundtruth_dict):
        masks = groundtruth_dict.get("groundtruth_instance_masks")
        if masks is None:
            return
        self.evaluation.add_single_ground_truth_image_info(
            image_id,
            groundtruth_dict["groundtruth_boxes"],
            np.asarray(groundtruth_dict["groundtruth_classes"]) - self._label_offset,
            groundtruth_dict.get("groundtruth_is_crowd",
                                 groundtruth_dict.get("groundtruth_difficult")),
            masks=masks,
        )

    def add_single_detected_image_info(self, image_id: str, detections_dict):
        masks = detections_dict.get("detection_masks")
        if masks is None or image_id not in self.evaluation.gt:
            return
        self.evaluation.add_single_detected_image_info(
            image_id,
            detections_dict["detection_boxes"],
            detections_dict["detection_scores"],
            np.asarray(detections_dict["detection_classes"]) - self._label_offset,
            masks=masks,
        )

    def evaluate(self) -> Dict[str, float]:
        out = self.evaluation.evaluate()
        if self._include_per_category:
            per_cat = self.evaluation.per_category_ap()
            for cls_id, name in self._name.items():
                ap = per_cat.get(cls_id - self._label_offset, float("nan"))
                out[f"DetectionMasks_PerformanceByCategory/mAP/{name}"] = ap
        return out

    def clear(self):
        self.__init__(self.categories, self._include_per_category)
