"""The slice as a whole: the tiny flagship model of __graft_entry__
(resnet10, 64x64, float32) with the same weights in mtlx and in the port,
compared stage by stage and end to end on the CPU.

Stages are fed the same inputs on both sides, so each comparison sees
only that stage's arithmetic ("allclose" below is rtol 1e-4 with an atol
of 1e-4 times the tensor's largest magnitude):
  * features and RPN logits: allclose (convolution sums in another order)
  * _postprocess_rpn on mtlx's logits: the same proposals selected in the
    same order (keep exactly equal; boxes within 1e-5, which only the
    one-ulp differences of exp in the decode can explain)
  * _predict_second_stage on mtlx's proposals: allclose (1e-4)
  * postprocess on mtlx's class logits and refinements: classes and
    num_detections exactly equal, boxes and scores within 1e-5
End to end (each side on its own intermediate results) the observed max
differences were 3.9e-5 in detection boxes (normalized coordinates) and
8.3e-7 in detection scores, with classes and counts equal (features up to
650 differed by at most 3.8e-4); the test holds them to allclose.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.builders import model_builder as tbuilder
from mtlx_torch.config import config_util as tconfig
from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig
from mtlx_torch.export.exporter import InferenceModel


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


BOX_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, rtol=1e-4):
    """allclose at rtol, with an atol of rtol times the tensor's largest
    magnitude: convolution sums in another order err relative to the
    scale of the sums, not of each output."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _randomize(variables, seed):
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rs.normal(0, 0.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def tiny():
    """One mtlx model + its predictions, and the port's model with the
    same weights (shared by every test of this file)."""
    jmodel = graft._flagship(canvas=(64, 64), dtype=jnp.float32, **graft._TINY_KW)
    variables = _randomize(jmodel.init_variables(jax.random.PRNGKey(0)), 7)
    rs = np.random.RandomState(0)
    images = rs.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    true_shapes = np.asarray([[64, 64], [48, 56]], np.int32)
    pre = jmodel.preprocess(jnp.asarray(images))
    jpred = jmodel.predict(variables, pre, jnp.asarray(true_shapes), training=False)
    jdet = jmodel.postprocess(jpred, jnp.asarray(true_shapes))

    kw = {k: v for k, v in graft._TINY_KW.items()}
    cfg = FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=torch.float32, **kw)
    port = FasterRCNN(cfg, device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables), strict=True)
    to_np = lambda tree: {k: np.asarray(v) for k, v in tree.items() if v is not None}
    return dict(jmodel=jmodel, variables=variables, images=images, true_shapes=true_shapes,
                jpred=to_np(jpred), jdet=to_np(jdet), port=port)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_features_and_rpn_logits(tiny):
    port = tiny["port"]
    with torch.inference_mode():
        feats = port.modules.backbone(port.preprocess(_t(tiny["images"])))
        obj, enc = port.modules.rpn(feats)
    _close(feats, tiny["jpred"]["rpn_features"])
    _close(obj, tiny["jpred"]["rpn_objectness_logits"])
    _close(enc, tiny["jpred"]["rpn_box_encodings"])


def test_postprocess_rpn_selects_the_same_proposals(tiny):
    jp, port = tiny["jpred"], tiny["port"]
    props, scores, keep = port._postprocess_rpn(
        _t(jp["rpn_objectness_logits"]), _t(jp["rpn_box_encodings"]),
        _t(tiny["true_shapes"]), _t(jp["anchors"]),
    )
    np.testing.assert_array_equal(keep.numpy(), jp["proposal_mask"])
    np.testing.assert_allclose(props.numpy(), jp["proposal_boxes"], **BOX_TOL)
    np.testing.assert_allclose(scores.numpy(), jp["proposal_scores"], **BOX_TOL)
    assert keep.sum() > 0


def test_second_stage_on_the_same_proposals(tiny):
    jp, port = tiny["jpred"], tiny["port"]
    cls, box, _ = port._predict_second_stage(_t(jp["rpn_features"]),
                                             _t(jp["proposal_boxes"]), (64, 64))
    _close(cls, jp["class_predictions"])
    _close(box, jp["refined_box_encodings"])


def test_postprocess_on_the_same_stage_two_outputs(tiny):
    jp, jd, port = tiny["jpred"], tiny["jdet"], tiny["port"]
    det = port.postprocess({k: _t(v) for k, v in jp.items()}, _t(tiny["true_shapes"]))
    np.testing.assert_array_equal(det["detection_classes"].numpy(), jd["detection_classes"])
    np.testing.assert_array_equal(det["num_detections"].numpy(), jd["num_detections"])
    np.testing.assert_allclose(det["detection_boxes"].numpy(), jd["detection_boxes"], **BOX_TOL)
    np.testing.assert_allclose(det["detection_scores"].numpy(), jd["detection_scores"], **BOX_TOL)
    assert (det["num_detections"] > 0).all()


def test_end_to_end(tiny):
    port, jd = tiny["port"], tiny["jdet"]
    ts = _t(tiny["true_shapes"])
    pred = port.predict(port.preprocess(_t(tiny["images"])), ts)
    det = port.postprocess(pred, ts)
    np.testing.assert_array_equal(det["detection_classes"].numpy(), jd["detection_classes"])
    np.testing.assert_array_equal(det["num_detections"].numpy(), jd["num_detections"])
    _close(det["detection_boxes"], jd["detection_boxes"])
    _close(det["detection_scores"], jd["detection_scores"])


def test_training_predict_raises(tiny):
    port = tiny["port"]
    with pytest.raises(NotImplementedError):
        port.predict(_t(tiny["images"]), _t(tiny["true_shapes"]), training=True)


# a flagship-shaped pipeline cut to a 64x64 canvas and 8 proposals, so the
# full-width R50 serves on the CPU in seconds
_SMALL_PIPELINE = """
model { faster_rcnn {
  num_classes: 20
  image_resizer { keep_aspect_ratio_resizer { min_dimension: 48 max_dimension: 64 } }
  feature_extractor { type: 'faster_rcnn_resnet50' first_stage_features_stride: 16 }
  first_stage_anchor_generator { grid_anchor_generator {
    scales: [0.25, 0.5, 1.0, 2.0] aspect_ratios: [0.5, 1.0, 2.0] } }
  first_stage_nms_iou_threshold: 0.7
  first_stage_max_proposals: 8
  initial_crop_size: 14 maxpool_kernel_size: 2 maxpool_stride: 2
  second_stage_box_predictor { mask_rcnn_box_predictor {} }
  second_stage_post_processing {
    batch_non_max_suppression { score_threshold: 0.0 iou_threshold: 0.6
      max_detections_per_class: 100 max_total_detections: 300 }
    score_converter: SOFTMAX }
} }
bucketing { bucket_multiple: 32 }
"""


def test_inference_model_save_load_round_trip(tmp_path):
    pipeline = tconfig.parse_pipeline_text(_SMALL_PIPELINE)
    model = tbuilder.build(pipeline.model, is_training=False, dtype=torch.float32, device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    resizer = tbuilder.resizer_params(pipeline.model.faster_rcnn.image_resizer)
    served = InferenceModel(model, resizer, bucket_multiple=32, device="cpu",
                            pipeline_text=_SMALL_PIPELINE)
    images = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    before = served.predict_image_tensor(images)

    export_dir = served.save(os.path.join(tmp_path, "export"))
    loaded = InferenceModel.load(export_dir, device="cpu", dtype=torch.float32)
    after = loaded.predict_image_tensor(images)
    assert loaded.bucket_multiple == 32 and loaded.resizer == resizer
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    assert before["detection_boxes"].shape == (2, 300, 4)
    assert before["num_detections"].shape == (2,)
    assert (before["detection_classes"][before["detection_scores"] > 0] >= 1).all()  # 1-based

    # a 48x60 image is at its resizer target already and serves on the
    # 64x64 bucket: the same result as predict_image_tensor on that canvas
    small = images[0, :48, :60]
    canvas = np.zeros((1, 64, 64, 3), np.uint8)
    canvas[0, :48, :60] = small
    via_images = loaded.predict_images([small])
    with torch.inference_mode():
        ts = torch.tensor([[48, 60]], dtype=torch.int32)
        m = loaded.model
        direct = m.postprocess(m.predict(m.preprocess(_t(canvas).float()), ts), ts)
    np.testing.assert_array_equal(via_images["detection_classes"],
                                  direct["detection_classes"].numpy() + 1)
    np.testing.assert_array_equal(via_images["detection_boxes"], direct["detection_boxes"].numpy())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=torch.float32,
                           **graft._TINY_KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FasterRCNN(cfg)
    model = FasterRCNN(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceModel(model, ("fixed", {"height": 64, "width": 64}))
