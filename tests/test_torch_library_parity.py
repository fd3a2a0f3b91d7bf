"""The small public library functions of mtlx that the port gained last,
each held to its mtlx counterpart on the CPU on the same seeded inputs
(one parametrised case each):

  * geometry/box_ops.py: height_width, outside_window_mask,
    completely_outside_window_mask, to_normalized_coordinates,
    to_absolute_coordinates, normalized_to_image_coordinates (equal);
  * geometry/np_box_ops.py: center_coordinates_and_sizes,
    change_coordinate_frame, faster_rcnn_encode, faster_rcnn_decode
    (equal; the log and exp within 1e-6 relative);
  * assign/matcher.py: the matched, unmatched and ignored column masks;
  * assign/target_assigner.py: batch_assign (targets within 1e-6, matches
    equal), also with a per-image unmatched class target;
  * coders/box_coders.py: batch_decode (1e-6);
  * config/config_util.py: merge_external_params_with_configs on the
    flagship's and SSD MobileNet's pipelines, every override and a
    skipped None, the port's text parsed by protobuf equal to mtlx's
    message, and an unknown override refused by both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf import text_format as pb_text_format

from mtlx.assign import matcher as jmatcher
from mtlx.assign import target_assigner as jassigner
from mtlx.coders import box_coders as jcoders
from mtlx.config import config_util as jconfig
from mtlx.config.protos import pipeline_pb2
from mtlx.geometry import box_ops as jbox_ops
from mtlx.geometry import np_box_ops as jnp_box_ops
from mtlx_torch.assign import matcher as tmatcher
from mtlx_torch.assign import target_assigner as tassigner
from mtlx_torch.coders import box_coders as tcoders
from mtlx_torch.config import config_util as tconfig
from mtlx_torch.config import text_format as ttext
from mtlx_torch.geometry import box_ops as tbox_ops
from mtlx_torch.geometry import np_box_ops as tnp_box_ops


def _boxes(rs, *lead, scale=1.0):
    corners = np.sort(rs.uniform(-0.2, 1.2, (*lead, 2, 2)), axis=-1) * scale
    return corners.reshape(*lead, 4)[..., [0, 2, 1, 3]].astype(np.float32)


def _windows(rs, *lead):
    return _boxes(rs, *lead) * 0.5 + 0.25


def _box_ops_cases():
    rs = np.random.RandomState(0)
    boxes, window = _boxes(rs, 3, 40), _windows(rs, 3)
    pixels = _boxes(rs, 2, 30, scale=480.0)
    hw = (np.float32(480.0), np.float32(640.0))
    return {
        "height_width": (lambda m, b: m.height_width(b), (boxes,)),
        "outside_window_mask": (lambda m, b, w: m.outside_window_mask(b, w), (boxes, window)),
        "completely_outside_window_mask": (
            lambda m, b, w: m.completely_outside_window_mask(b, w), (boxes, window)),
        "to_normalized_coordinates": (
            lambda m, b: m.to_normalized_coordinates(b, *hw), (pixels,)),
        "to_absolute_coordinates": (lambda m, b: m.to_absolute_coordinates(b, *hw), (boxes,)),
        "normalized_to_image_coordinates": (
            lambda m, b: m.normalized_to_image_coordinates(b, (480, 640)), (boxes,)),
    }


@pytest.mark.parametrize("name", list(_box_ops_cases()))
def test_box_ops_equal_mtlx(name):
    fn, args = _box_ops_cases()[name]
    want = fn(jbox_ops, *(jnp.asarray(a) for a in args))
    got = fn(tbox_ops, *(torch.from_numpy(a) for a in args))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _np_box_ops_cases():
    rs = np.random.RandomState(1)
    boxes, anchors, window = _boxes(rs, 50), _boxes(rs, 50), _windows(rs)
    codes = rs.normal(0, 1, (50, 4)).astype(np.float32)
    return {
        "center_coordinates_and_sizes": (lambda m: m.center_coordinates_and_sizes(boxes), 0),
        "change_coordinate_frame": (lambda m: m.change_coordinate_frame(boxes, window), 0),
        "faster_rcnn_encode": (lambda m: m.faster_rcnn_encode(boxes, anchors), 1e-6),
        "faster_rcnn_encode_scales": (
            lambda m: m.faster_rcnn_encode(boxes, anchors, (5.0, 5.0, 2.0, 2.0)), 1e-6),
        "faster_rcnn_decode": (lambda m: m.faster_rcnn_decode(codes, anchors), 1e-6),
    }


@pytest.mark.parametrize("name", list(_np_box_ops_cases()))
def test_np_box_ops_equal_mtlx(name):
    fn, rtol = _np_box_ops_cases()[name]
    want, got = fn(jnp_box_ops), fn(tnp_box_ops)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


@pytest.mark.parametrize("mask", ["matched_column_mask", "unmatched_column_mask",
                                  "ignored_column_mask"])
def test_column_masks_equal_mtlx(mask):
    match = np.random.RandomState(2).randint(-2, 6, (3, 40)).astype(np.int32)
    want = getattr(jmatcher, mask)(jnp.asarray(match))
    got = getattr(tmatcher, mask)(torch.from_numpy(match))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assign_inputs(seed):
    rs = np.random.RandomState(seed)
    anchors = _boxes(rs, 64)
    gt = _boxes(rs, 3, 6)
    # some ground truth near anchors, so that rows match
    gt[:, :3] = anchors[rs.randint(0, 64, (3, 3))] + rs.normal(0, 0.01, (3, 3, 4)).astype(
        np.float32)
    mask = np.arange(6)[None] < np.asarray([[6], [3], [0]])
    labels = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (3, 6))]
    unmatched = np.tile(np.asarray([[1.0, 0, 0, 0]], np.float32), (3, 1))
    unmatched[1] = [0.5, 0.5, 0, 0]
    return anchors, gt, mask, labels, unmatched


@pytest.mark.parametrize("case", ["proposal", "detection", "labels_and_unmatched_target"])
def test_batch_assign_equals_mtlx(case):
    anchors, gt, mask, labels, unmatched = _assign_inputs(3)
    kw = dict(gt_boxes=gt, gt_mask=mask)
    if case == "labels_and_unmatched_target":
        kw.update(gt_labels=labels, unmatched_cls_target=unmatched)
    stage = "proposal" if case == "proposal" else "detection"
    want = jassigner.batch_assign(jassigner.create_target_assigner("FasterRCNN", stage),
                                  jnp.asarray(anchors),
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tassigner.batch_assign(tassigner.create_target_assigner("FasterRCNN", stage),
                                 torch.from_numpy(anchors),
                                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.match.numpy(), np.asarray(want.match))
    assert (got.match.numpy() >= 0).any()
    for field in ("cls_targets", "cls_weights", "reg_targets", "reg_weights"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("coder", ["faster_rcnn", "mean_stddev"])
def test_batch_decode_equals_mtlx(coder):
    rs = np.random.RandomState(4)
    codes = rs.normal(0, 1, (3, 50, 4)).astype(np.float32)
    anchors = _boxes(rs, 50)
    make = f"make_{coder}_coder"
    want = jcoders.batch_decode(getattr(jcoders, make)().decode, jnp.asarray(codes),
                                jnp.asarray(anchors))
    got = tcoders.batch_decode(getattr(tcoders, make)().decode, torch.from_numpy(codes),
                               torch.from_numpy(anchors))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


_OVERRIDES = {
    "batch_size": dict(batch_size=3),
    "train_steps": dict(train_steps=1234),
    "learning_rate": dict(learning_rate=0.0125),
    "input_paths": dict(train_input_path="/data/train-*.record",
                        eval_input_path="/data/val.record"),
    "label_map_path": dict(label_map_path="/data/label_map.pbtxt"),
    "none_skipped": dict(batch_size=None, learning_rate=0.5),
}


@pytest.mark.parametrize("config", ["faster_rcnn_resnet50_mtl_voc0712", "ssd_mobilenet_v1_voc"])
@pytest.mark.parametrize("override", list(_OVERRIDES))
def test_merge_external_params_equals_mtlx(config, override):
    path = f"configs/{config}.config"
    want = jconfig.merge_external_params_with_configs(
        jconfig.get_configs_from_pipeline_file(path), **_OVERRIDES[override])
    got = tconfig.merge_external_params_with_configs(
        tconfig.get_configs_from_pipeline_file(path), **_OVERRIDES[override])
    text = ttext.to_text(tconfig.create_pipeline_proto_from_configs(got))
    parsed = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
    assert parsed == jconfig.create_pipeline_proto_from_configs(want)
    with pytest.raises(ValueError, match="unknown override"):
        tconfig.merge_external_params_with_configs(got, num_workers=2)
