"""The eval CLI's visualizations against mtlx's on the CPU.

  * `visualize_boxes_and_labels_on_image_array` (and the mask pasting it
    uses) of mtlx_torch/utils/visualization_utils.py: pixel-equal to
    mtlx's on the same inputs, with scores above and below the threshold,
    groundtruth without scores, instance masks and keypoints, in
    normalized and absolute coordinates. Tolerance: none.
  * The eval loop (`evaluate_checkpoint`, what both eval CLIs call) on the
    tiny resnet10 of `__graft_entry__` with the same weights on both sides
    (the box predictor set to score one class 0.99 on every proposal, so
    the left half has detections over its 0.3 to draw), the same PNG records of two true shapes and the same
    eval_config, two images a batch: the same
    `Detections_Left_Groundtruth_Right/<i>` image summaries in the event
    file and the same `export-<step>-<i>.png` files, their decoded pixels
    equal. mtlx encodes with PIL and the port with its own PNG encoder, so
    the bytes differ and the pixels are compared. Tolerance: none (the
    drawn boxes round to pixels; the detections agree to 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mtlx.utils import visualization_utils as jviz
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.data import imgcodec
from mtlx_torch.utils import visualization_utils as tviz
from mtlx_torch.utils.summary_writer import read_events
from test_torch_rfcn import seeded_variables

CATEGORIES = [{"id": i + 1, "name": f"c{i + 1}"} for i in range(20)]
INDEX = {c["id"]: c for c in CATEGORIES}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _case(seed, n=6, h=48, w=64):
    rs = np.random.RandomState(seed)
    image = rs.randint(0, 255, (h, w, 3), dtype=np.uint8)
    y0, x0 = rs.uniform(0, 0.6, n), rs.uniform(0, 0.6, n)
    boxes = np.stack([y0, x0, y0 + rs.uniform(0.1, 0.4, n), x0 + rs.uniform(0.1, 0.4, n)],
                     1).astype(np.float32)
    classes = rs.randint(1, 25, n)  # some without a name in the index
    scores = rs.uniform(0, 1, n).astype(np.float32)
    masks = rs.uniform(0, 1, (n, 14, 14)).astype(np.float32)
    keypoints = rs.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    return image, boxes, classes, scores, masks, keypoints


@pytest.mark.parametrize("variant", ["detections", "groundtruth", "masks_keypoints", "absolute"])
def test_visualize_boxes_and_labels_equals_mtlx(variant):
    image, boxes, classes, scores, masks, keypoints = _case(3)
    kw = dict(min_score_thresh=0.3)
    if variant == "groundtruth":
        scores, kw = None, dict(min_score_thresh=0.0)
    elif variant == "masks_keypoints":
        h, w = image.shape[:2]
        pasted = tviz.paste_instance_masks(masks, boxes, h, w)
        np.testing.assert_array_equal(pasted, jviz.paste_instance_masks(masks, boxes, h, w))
        kw.update(instance_masks=pasted, keypoints=keypoints)
    elif variant == "absolute":
        boxes = boxes * np.asarray([48, 64, 48, 64], np.float32)
        kw.update(use_normalized_coordinates=False, line_thickness=3, max_boxes_to_draw=4)
    got, want = image.copy(), image.copy()
    out = tviz.visualize_boxes_and_labels_on_image_array(got, boxes, classes, scores, INDEX, **kw)
    jviz.visualize_boxes_and_labels_on_image_array(want, boxes, classes, scores, INDEX, **kw)
    assert out is got
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)  # something was drawn


_EVAL_CONFIG = """eval_config {{ num_examples: 4 num_visualizations: 3
  metrics_set: "pascal_voc_detection_metrics" visualization_export_dir: "{viz}" }}"""


def _records(path):
    """Four PNG records, two 48x64 and two 64x48 (no resize under a 48 /
    64 keep-aspect resizer), each with two boxes."""
    from mtlx_torch.data import tfrecord
    from mtlx_torch.data.example_decoder import build_example

    rs = np.random.RandomState(0)
    arrays = []
    with tfrecord.TFRecordWriter(path) as w:
        for i, (h, wd) in enumerate([(48, 64), (64, 48), (48, 64), (64, 48)]):
            arr = rs.randint(0, 255, (h, wd, 3), dtype=np.uint8)
            boxes = np.asarray([[0.1, 0.1, 0.6, 0.5], [0.3, 0.4, 0.9, 0.95]], np.float32)
            w.write(build_example(imgcodec.encode_png(arr), b"png", h, wd, f"im{i}.png",
                                  boxes, [1, 3], ["c1", "c3"]))
            arrays.append(arr)
    return arrays


def _images(eval_dir):
    events = [e for name in sorted(os.listdir(eval_dir)) if name.startswith("events.")
              for e in read_events(os.path.join(eval_dir, name))]
    return {tag: (e["step"], imgcodec.decode_png(v[2])) for e in events
            for tag, v in e.get("values", []) if isinstance(v, tuple)}


def test_eval_loop_visualizations_equal_mtlx(tmp_path):
    from google.protobuf import text_format as pb_text_format
    from mtlx.config.protos import pipeline_pb2
    from mtlx.data.loader import DetectionDataset as JDataset
    from mtlx.eval import eval as jeval
    from mtlx.train.train_step import TrainState
    from mtlx.utils.summary_writer import SummaryWriter as JWriter
    from mtlx_torch.config import config_util as tconfig
    from mtlx_torch.data.loader import DetectionDataset
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig
    from mtlx_torch.eval import eval as teval
    from mtlx_torch.utils.summary_writer import SummaryWriter

    jmodel = graft._flagship(canvas=(64, 64), dtype=jnp.float32, **graft._TINY_KW)
    variables = seeded_variables(jmodel.modules.init, 11, jnp.zeros((1, 64, 64, 3)))
    # class 1 scores 0.99 on every proposal, its box the proposal's: the
    # left half has detections to draw
    head = variables["params"]["box_predictor"]
    for layer in ("class_logits", "box_refinement"):
        head[layer]["kernel"][:] = 0.0
        head[layer]["bias"][:] = 0.0
    head["class_logits"]["bias"][1] = 8.0
    record = str(tmp_path / "eval.record")
    raw = _records(record)
    resizer = ("keep_aspect", {"min_dimension": 48, "max_dimension": 64})
    step = 7

    # mtlx: its eval loop on its dataset, writer and eval_config
    jdir, jviz_dir = tmp_path / "jeval", tmp_path / "jviz"
    jconfig = pb_text_format.Parse(_EVAL_CONFIG.format(viz=jviz_dir),
                                   pipeline_pb2.TrainEvalPipelineConfig()).eval_config
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None, tx=None)
    writer = JWriter(str(jdir))
    jmetrics = jeval.evaluate_checkpoint(jmodel, state, JDataset([record], (64, 64), resizer),
                                         jconfig, CATEGORIES, batch_size=2, writer=writer,
                                         step=step)
    writer.close()

    # the port: the same weights through the bridge
    tdir, tviz_dir = tmp_path / "teval", tmp_path / "tviz"
    tconf = tconfig.parse_pipeline_text(_EVAL_CONFIG.format(viz=tviz_dir)).eval_config
    port = FasterRCNN(FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=torch.float32,
                                       **graft._TINY_KW), device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables), strict=True)
    dataset = DetectionDataset([record], (64, 64), resizer)
    writer = SummaryWriter(str(tdir))
    try:
        metrics = teval.evaluate_checkpoint(port, dataset, tconf, CATEGORIES, batch_size=2,
                                            writer=writer, step=step)
    finally:
        writer.close()
        dataset.close()
    np.testing.assert_allclose(metrics["Precision/mAP@0.5IOU"],
                               jmetrics["Precision/mAP@0.5IOU"], rtol=1e-6)

    got, want = _images(tdir), _images(jdir)
    assert sorted(got) == sorted(want) == [
        f"Detections_Left_Groundtruth_Right/{i}" for i in range(3)]
    for tag, (s, pixels) in want.items():
        assert got[tag][0] == s == step
        np.testing.assert_array_equal(got[tag][1], pixels, err_msg=tag)
    names = sorted(os.listdir(tviz_dir))
    assert names == sorted(os.listdir(jviz_dir)) == [f"export-{step}-{i}.png" for i in range(3)]
    for i, name in enumerate(names):
        with open(tviz_dir / name, "rb") as f:
            port_png = imgcodec.decode_png(f.read())
        with open(jviz_dir / name, "rb") as f:
            np.testing.assert_array_equal(port_png, imgcodec.decode_png(f.read()), err_msg=name)
        np.testing.assert_array_equal(port_png, got[f"Detections_Left_Groundtruth_Right/{i}"][1])
        # both halves carry drawings over record i (one bucket: the
        # records' order): detections over 0.3 left, groundtruth right
        w = raw[i].shape[1]
        assert port_png.shape == (raw[i].shape[0], 2 * w, 3)
        assert not np.array_equal(port_png[:, :w], raw[i])
        assert not np.array_equal(port_png[:, w:], raw[i])
