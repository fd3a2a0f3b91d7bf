"""mtlx_torch's numpy evaluator against mtlx's: box geometry, AP / CorLoc,
per-image matching and the Pascal evaluators on seeded detections with
difficult and group-of groundtruth.

Tolerance: none. The port runs the same numpy operations in the same
order (the AP envelope as a reverse running maximum, which is exact), so
every metric must be equal, NaN where mtlx gives NaN.
"""

import numpy as np
import pytest

from mtlx.eval import metrics as jmetrics
from mtlx.eval import object_detection_evaluation as jode
from mtlx.geometry import np_box_ops as jbox
from mtlx_torch.eval import metrics as tmetrics
from mtlx_torch.eval import object_detection_evaluation as tode
from mtlx_torch.geometry import np_box_ops as tbox

NUM_CLASSES = 4
CATEGORIES = [{"id": i + 1, "name": f"c{i + 1}"} for i in range(NUM_CLASSES)]


def _boxes(rs, n, scale=100.0):
    y0, x0 = rs.uniform(0, 0.7, n), rs.uniform(0, 0.7, n)
    return (np.stack([y0, x0, y0 + rs.uniform(0.02, 0.3, n), x0 + rs.uniform(0.02, 0.3, n)], 1)
            * scale).astype(np.float32)


def _images(seed: int, n: int = 12):
    """Per image: groundtruth (some difficult, some group-of) and
    detections, a share of them jittered copies of the groundtruth."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = rs.randint(0, 6)
        gt_boxes = _boxes(rs, g)
        gt_classes = rs.randint(1, NUM_CLASSES + 1, g)
        difficult = rs.uniform(size=g) < 0.25
        group_of = rs.uniform(size=g) < 0.2
        near = gt_boxes[rs.uniform(size=g) < 0.7]
        near = near + rs.normal(0, 2.0, near.shape).astype(np.float32)
        det_boxes = np.concatenate([near, _boxes(rs, rs.randint(0, 5))]).astype(np.float32)
        d = len(det_boxes)
        det_classes = np.concatenate([gt_classes[:len(near)],
                                      rs.randint(1, NUM_CLASSES + 1, d - len(near))])
        scores = rs.uniform(size=d).astype(np.float32)
        if d > 1:
            scores[1] = scores[0]  # a tie
        out.append((f"im{i}", gt_boxes, gt_classes, difficult, group_of, det_boxes, scores,
                    det_classes))
    return out


def test_np_box_ops_equal_mtlx():
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 7), _boxes(rs, 5)
    b[0] = [3, 3, 3, 9]  # zero area
    for fn in ("intersection", "iou", "ioa"):
        assert np.array_equal(getattr(tbox, fn)(a, b), getattr(jbox, fn)(a, b)), fn
    assert np.array_equal(tbox.area(a), jbox.area(a))


def test_metrics_equal_mtlx():
    rs = np.random.RandomState(1)
    for n, num_gt in ((0, 0), (0, 3), (9, 5), (40, 17)):
        scores = rs.uniform(size=n).astype(np.float32)
        labels = (rs.uniform(size=n) < 0.5).astype(np.float32)
        p, r = tmetrics.compute_precision_recall(scores, labels, num_gt)
        jp, jr = jmetrics.compute_precision_recall(scores, labels, num_gt)
        if jp is None:
            assert p is None and r is None
        else:
            assert np.array_equal(p, jp) and np.array_equal(r, jr)
        ap, jap = tmetrics.compute_average_precision(p, r), jmetrics.compute_average_precision(jp, jr)
        assert ap == jap or (np.isnan(ap) and np.isnan(jap))
    gt_imgs, correct = np.array([0, 3, 5]), np.array([0, 1, 5])
    np.testing.assert_array_equal(tmetrics.compute_cor_loc(gt_imgs, correct),
                                  jmetrics.compute_cor_loc(gt_imgs, correct))


def _equal_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k] == w or (np.isnan(got[k]) and np.isnan(w)), k


@pytest.mark.parametrize("name", ["PascalDetectionEvaluator", "WeightedPascalDetectionEvaluator"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pascal_evaluators_equal_mtlx(name, seed):
    port, ref = getattr(tode, name)(CATEGORIES), getattr(jode, name)(CATEGORIES)
    for key, gb, gc, diff, _, db, ds, dc in _images(seed):
        for ev in (port, ref):
            ev.add_single_ground_truth_image_info(key, {
                "groundtruth_boxes": gb, "groundtruth_classes": gc,
                "groundtruth_difficult": diff})
            ev.add_single_detected_image_info(key, {
                "detection_boxes": db, "detection_scores": ds, "detection_classes": dc})
    got, want = port.evaluate(), ref.evaluate()
    _equal_metrics(got, want)
    assert np.isfinite(want[next(k for k in want if "mAP" in k)])


def test_object_detection_evaluation_group_of_equals_mtlx():
    port, ref = (tode.ObjectDetectionEvaluation(NUM_CLASSES),
                 jode.ObjectDetectionEvaluation(NUM_CLASSES))
    for key, gb, gc, diff, group, db, ds, dc in _images(3):
        for ev in (port, ref):
            ev.add_single_ground_truth_image_info(key, gb, gc - 1, diff, group)
            ev.add_single_detected_image_info(key, db, ds, dc - 1)
    got, want = port.evaluate(), ref.evaluate()
    for g, w in zip(got, want):
        if isinstance(w, dict):
            for cls in w:
                assert (g[cls] is None and w[cls] is None) or np.array_equal(g[cls], w[cls])
        else:
            np.testing.assert_array_equal(g, w)


def test_build_evaluators():
    from mtlx_torch.config import config_util
    from mtlx_torch.eval.eval import build_evaluators

    def config(sets):
        text = "eval_config { " + " ".join(f'metrics_set: "{s}"' for s in sets) + " }"
        return config_util.parse_pipeline_text(text).eval_config

    evs = build_evaluators(config(["pascal_voc_metrics", "weighted_pascal_voc_metrics"]),
                           CATEGORIES)
    assert [type(e).__name__ for e in evs] == ["PascalDetectionEvaluator",
                                               "WeightedPascalDetectionEvaluator"]
    assert type(build_evaluators(config([]), CATEGORIES)[0]).__name__ == \
        "PascalDetectionEvaluator"
    evs = build_evaluators(config(["coco_detection_metrics",
                                   "open_images_V2_detection_metrics"]), CATEGORIES)
    assert [type(e).__name__ for e in evs] == ["CocoDetectionEvaluator",
                                               "OpenImagesDetectionEvaluator"]
    evs = build_evaluators(config(["pascal_voc_instance_segmentation_metrics",
                                   "weighted_pascal_voc_instance_segmentation_metrics",
                                   "coco_mask_metrics"]), CATEGORIES)
    assert [type(e).__name__ for e in evs] == ["PascalInstanceSegmentationEvaluator",
                                               "WeightedPascalInstanceSegmentationEvaluator",
                                               "CocoMaskEvaluator"]
    with pytest.raises(ValueError, match="unknown"):
        build_evaluators(config(["no_such_metrics"]), CATEGORIES)
