"""The port's COCO and OpenImages evaluators against mtlx's, the COCO label
map the port keeps, the metrics sets of the eval CLI, and the R101 COCO
pipeline (BASELINE config 5) through the port's builders.

Tolerance: 1e-12 absolute on every metric (the port runs the same numpy
operations in the same order; -1 and NaN where mtlx gives them). The
cases are tests/test_coco_metrics.py's hand-computed ones and seeded
images over COCO's 90 ids with gaps: boxes of every area range, crowd
boxes given as `groundtruth_difficult` (as the loader gives COCO's
iscrowd), classes without groundtruth.
"""

import os

import numpy as np
import pytest

from mtlx.eval import coco_evaluation as jcoco
from mtlx.eval import object_detection_evaluation as jode
from mtlx.utils import label_map_util as jlabel
from mtlx_torch.eval import coco_evaluation as tcoco
from mtlx_torch.eval import object_detection_evaluation as tode
from mtlx_torch.utils import label_map_util as tlabel

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCO_LABEL_MAP = os.path.join(_REPO, "mtlx_torch", "data", "label_maps",
                              "mscoco_label_map.pbtxt")
CATS = [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}]
SQUARE = [0.0, 0.0, 10.0, 10.0]


def _gt(boxes, classes, **extra):
    return {"groundtruth_boxes": np.asarray(boxes, np.float64),
            "groundtruth_classes": np.asarray(classes), **extra}


def _det(boxes, scores, classes):
    return {"detection_boxes": np.asarray(boxes, np.float64),
            "detection_scores": np.asarray(scores), "detection_classes": np.asarray(classes)}


# tests/test_coco_metrics.py's cases: [(groundtruth, detections)] a image
HAND_CASES = {
    "perfect": [(_gt([SQUARE], [1]), _det([SQUARE], [0.9], [1]))],
    "partial_iou": [(_gt([SQUARE], [1]), _det([[0.0, 0.0, 10.0, 8.0]], [0.9], [1]))],
    "lower_rank_false_positive": [(_gt([SQUARE], [1]),
                                   _det([[50.0, 50.0, 60.0, 60.0], SQUARE], [0.95, 0.9], [1, 1]))],
    "crowd": [(_gt([SQUARE, [20.0, 20.0, 40.0, 40.0]], [1, 1],
                   groundtruth_is_crowd=np.asarray([False, True])),
               _det([SQUARE, [20.0, 20.0, 40.0, 40.0]], [0.9, 0.8], [1, 1]))],
    "ar_at_1": [(_gt([SQUARE, [20.0, 20.0, 30.0, 30.0]], [1, 1]),
                 _det([SQUARE, [20.0, 20.0, 30.0, 30.0]], [0.9, 0.8], [1, 1]))],
    "class_without_groundtruth": [(_gt([SQUARE], [1]),
                                   _det([SQUARE, SQUARE], [0.9, 0.9], [1, 2]))],
}


def _assert_metrics_equal(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if np.isnan(w):
            assert np.isnan(g), key
        else:
            assert abs(g - w) <= 1e-12, (key, g, w)


def _evaluate(module, cls, categories, images, **kw):
    ev = getattr(module, cls)(categories, **kw)
    for i, (gt, det) in enumerate(images):
        ev.add_single_ground_truth_image_info(f"im{i}", gt)
        ev.add_single_detected_image_info(f"im{i}", det)
    return ev.evaluate()


@pytest.mark.parametrize("per_category", [False, True], ids=["summary", "per_category"])
@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_coco_hand_cases_equal_mtlx(case, per_category):
    images = HAND_CASES[case]
    kw = {"include_metrics_per_category": per_category}
    got = _evaluate(tcoco, "CocoDetectionEvaluator", CATS, images, **kw)
    _assert_metrics_equal(got, _evaluate(jcoco, "CocoDetectionEvaluator", CATS, images, **kw))
    assert any("PerformanceByCategory" in k for k in got) == per_category


def _coco_categories():
    return list(tlabel.create_category_index_from_labelmap(COCO_LABEL_MAP).values())


def _seeded_images(seed: int, ids, n: int = 24, group_of: bool = False):
    """Per image 0-8 groundtruth boxes of every area range (absolute
    pixels of a 480x640 image), some crowd (as groundtruth_difficult) and,
    with group_of, some group-of; detections are jittered copies plus
    strays, some of classes with no groundtruth anywhere."""
    rs = np.random.RandomState(seed)
    ids = np.asarray(ids)
    gt_ids = ids[: len(ids) // 2]  # the other half never has groundtruth
    images = []
    for _ in range(n):
        g = rs.randint(0, 9)
        side = rs.choice([12.0, 60.0, 200.0], g)[:, None] * rs.uniform(0.7, 1.3, (g, 2))
        y0, x0 = rs.uniform(0, 400, g), rs.uniform(0, 500, g)
        boxes = np.stack([y0, x0, y0 + side[:, 0], x0 + side[:, 1]], 1)
        classes = rs.choice(gt_ids, g)
        gt = _gt(boxes, classes, groundtruth_difficult=rs.uniform(size=g) < 0.15)
        if group_of:
            gt["groundtruth_group_of"] = rs.uniform(size=g) < 0.2
        keep = rs.uniform(size=g) < 0.8
        jitter = boxes[keep] + rs.normal(0, 3, (int(keep.sum()), 4))
        k = rs.randint(0, 4)
        stray = np.concatenate([rs.uniform(0, 400, (k, 2)), rs.uniform(400, 600, (k, 2))], 1)
        det_boxes = np.concatenate([jitter, np.sort(stray.reshape(k, 2, 2), 1).reshape(k, 4)])
        det_classes = np.concatenate([classes[keep], rs.choice(ids, k)])
        det = _det(det_boxes, rs.uniform(0.05, 1.0, len(det_classes)), det_classes)
        images.append((gt, det))
    return images


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_seeded_coco_ids_equal_mtlx(seed):
    cats = _coco_categories()
    images = _seeded_images(seed, [c["id"] for c in cats])
    kw = {"include_metrics_per_category": True}
    got = _evaluate(tcoco, "CocoDetectionEvaluator", cats, images, **kw)
    want = _evaluate(jcoco, "CocoDetectionEvaluator", cats, images, **kw)
    _assert_metrics_equal(got, want)
    assert len(got) == 12 + 80
    # classes with no groundtruth drop out of the mean (their AP is NaN)
    assert np.isnan(got["DetectionBoxes_PerformanceByCategory/mAP/toothbrush"])
    assert 0 < got["DetectionBoxes_Precision/mAP"] < 1


@pytest.mark.parametrize("seed", [0, 1])
def test_open_images_seeded_equal_mtlx(seed):
    cats = _coco_categories()
    images = _seeded_images(seed, [c["id"] for c in cats], group_of=True)
    got = _evaluate(tode, "OpenImagesDetectionEvaluator", cats, images)
    want = _evaluate(jode, "OpenImagesDetectionEvaluator", cats, images)
    _assert_metrics_equal(got, want)
    assert np.isfinite(got["OpenImagesV2_Precision/mAP@0.5IOU"])
    # the group-of protocol changes the result on these images
    pascal = _evaluate(tode, "PascalDetectionEvaluator", cats, images)
    assert pascal["Precision/mAP@0.5IOU"] != got["OpenImagesV2_Precision/mAP@0.5IOU"]


def test_mask_evaluation_raises():
    # the mask evaluator is ported (tests/test_torch_masks.py holds it to
    # mtlx's); what raises now is what mtlx's raises: segm matching fed a
    # side without masks
    rs = np.random.RandomState(3)
    gt_masks = rs.uniform(size=(2, 16, 16)) < 0.4
    gt = {"groundtruth_boxes": np.asarray([[0, 0, 16, 16]] * 2, np.float32),
          "groundtruth_classes": np.asarray([1, 2]), "groundtruth_instance_masks": gt_masks}
    det = {"detection_boxes": np.asarray([[0, 0, 16, 16]] * 2, np.float32),
           "detection_scores": np.asarray([0.9, 0.4], np.float32),
           "detection_classes": np.asarray([1, 2]), "detection_masks": gt_masks[::-1]}
    theirs, ours = jcoco.CocoMaskEvaluator(CATS), tcoco.CocoMaskEvaluator(CATS)
    for ev in (theirs, ours):
        ev.add_single_ground_truth_image_info("a", gt)
        ev.add_single_detected_image_info("a", det)
    assert ours.evaluate() == theirs.evaluate()
    for evaluation in (jcoco.CocoDetectionEvaluation(2, iou_type="segm"),
                       tcoco.CocoDetectionEvaluation(2, iou_type="segm")):
        with pytest.raises(ValueError, match="segm evaluation needs groundtruth masks"):
            evaluation.add_single_ground_truth_image_info("a", gt["groundtruth_boxes"],
                                                          np.asarray([0, 1]))
    with pytest.raises(ValueError, match="unknown iou_type"):
        tcoco.CocoDetectionEvaluation(2, iou_type="keypoints")


def test_coco_label_map_equals_mtlx():
    ref = os.path.join(_REPO, "mtlx", "data", "label_maps", "mscoco_label_map.pbtxt")
    with open(COCO_LABEL_MAP) as a, open(ref) as b:
        assert a.read() == b.read()
    index = tlabel.create_category_index_from_labelmap(COCO_LABEL_MAP)
    assert index == jlabel.create_category_index_from_labelmap(ref)
    assert len(index) == 80 and max(index) == 90 and 12 not in index  # ids with gaps
    for display in (False, True):
        assert tlabel.get_label_map_dict(COCO_LABEL_MAP, display) == \
            jlabel.get_label_map_dict(ref, display)


def test_r101_coco_pipeline_builds_every_entry_point():
    from mtlx_torch.builders import model_builder, optimizer_builder, preprocessor_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.eval.eval import build_evaluators

    configs = config_util.get_configs_from_pipeline_file(
        os.path.join(_REPO, "configs", "faster_rcnn_resnet101_mtl_coco.config"))
    for training in (False, True):
        model = model_builder.build(configs["model"], is_training=training, device="cpu")
        assert (model.cfg.backbone, model.cfg.num_classes) == ("resnet101", 90)
        assert len(model.modules.backbone.block3) == 23
    tc = configs["train_config"]
    tx, _, _ = optimizer_builder.build(tc.optimizer, tc)
    assert [float(tx.lr(s)) for s in (0, 60000, 80000)] == pytest.approx([3e-3, 3e-4, 3e-5])
    assert [n for n, _ in preprocessor_builder.build(tc.data_augmentation_options)] == \
        ["random_horizontal_flip"]
    (ev,) = build_evaluators(configs["eval_config"], _coco_categories())
    assert type(ev).__name__ == "CocoDetectionEvaluator"
    assert ev.evaluation.num_classes == 90


def test_eval_loop_feeds_group_of(tmp_path, monkeypatch):
    """evaluate_checkpoint hands the records' group-of flags to the
    evaluators: its OpenImages metrics equal the evaluator fed directly."""
    from mtlx_torch.config import config_util
    from mtlx_torch.data import imgcodec, tfrecord
    from mtlx_torch.data.example_decoder import build_example
    from mtlx_torch.data.loader import DetectionDataset
    from mtlx_torch.eval import eval as eval_cli

    boxes = np.asarray([[0.1, 0.1, 0.9, 0.9], [0.2, 0.2, 0.4, 0.4], [0.5, 0.5, 0.7, 0.8]],
                       np.float32)
    record = str(tmp_path / "eval.record")
    with tfrecord.TFRecordWriter(record) as w:
        for i in range(2):
            w.write(build_example(imgcodec.encode_png(np.zeros((32, 32, 3), np.uint8)), b"png",
                                  32, 32, f"im{i}", boxes, [1, 2, 2], ["cat", "dog", "dog"],
                                  group_of=[1, 0, 0]))
    dataset = DetectionDataset([record], canvas_size=(32, 32),
                               resizer=("fixed", {"height": 32, "width": 32}), max_boxes=4)
    # detections in the normalized frame: one inside the group-of box
    det_norm = np.asarray([[0.3, 0.3, 0.5, 0.5], [0.2, 0.2, 0.4, 0.4]], np.float32)

    def fake_detect(model, images, true_shapes, bucket_multiple=0):
        b = len(images)
        return {"detection_boxes": np.repeat(det_norm[None], b, 0),
                "detection_scores": np.tile(np.float32([0.9, 0.8]), (b, 1)),
                "detection_classes": np.tile(np.int32([0, 1]), (b, 1)),
                "num_detections": np.full(b, 2, np.int32)}

    monkeypatch.setattr(eval_cli, "detect", fake_detect)
    eval_config = config_util.parse_pipeline_text(
        'eval_config { metrics_set: "open_images_V2_detection_metrics" '
        'metrics_set: "coco_detection_metrics" }').eval_config
    got = eval_cli.evaluate_checkpoint(None, dataset, eval_config, CATS, batch_size=2)
    ref = tode.OpenImagesDetectionEvaluator(CATS)
    for i in range(2):
        ref.add_single_ground_truth_image_info(f"im{i}", {
            "groundtruth_boxes": boxes * 32, "groundtruth_classes": np.asarray([1, 2, 2]),
            "groundtruth_group_of": np.asarray([True, False, False])})
        ref.add_single_detected_image_info(f"im{i}", {
            "detection_boxes": det_norm * 32, "detection_scores": np.float32([0.9, 0.8]),
            "detection_classes": np.asarray([1, 2])})
    want = ref.evaluate()
    for key, value in want.items():
        assert got[key] == value or (np.isnan(got[key]) and np.isnan(value)), key
    assert "DetectionBoxes_Precision/mAP" in got
    dataset.close()
