"""Serving's encoded-image and tf.Example inputs and the export CLI,
against mtlx's `InferenceModel` and `export_inference_graph` on the CPU.

  * The tiny flagship model of `__graft_entry__` (resnet10, 64x64 canvas,
    float32) with the same weights on both sides (`bridge.py`), serving
    the same JPEG, PNG and Example bytes. mtlx runs eagerly
    (`jax.disable_jit`): jitted mtlx fuses multiply-adds on the CPU, the
    port matches eager mtlx (ROADMAP queue 3). Tolerances as in
    tests/test_torch_faster_rcnn.py: classes and num_detections exactly
    equal; boxes and scores allclose at rtol 1e-4 with an atol of 1e-4
    times the largest magnitude.
  * Inside the port, every input type gives detections equal to
    `predict_images` on the same decoded pixels (exactly).
  * The export CLI against mtlx's export_inference_graph on the same
    checkpoint steps: the same step chosen, the same pipeline.config
    (parsed with protobuf, bucket_multiple resolved), the same step in
    export_metadata.json; with --saved_model it also writes the serving
    program and its pipeline.config under saved_model/ (held to mtlx in
    tests/test_torch_saved_model.py).
"""

import dataclasses
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as graft
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.data import imgcodec
from mtlx_torch.data.example_decoder import build_example, decode_example
from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig
from mtlx_torch.export import exporter as texporter


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


RESIZER = ("keep_aspect", {"min_dimension": 48, "max_dimension": 64})


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _same_detections(got, want, exact=False):
    for key in ("detection_classes", "num_detections"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("detection_boxes", "detection_scores"):
        if exact:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            _close(got[key], want[key])


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


def _picture(rs, h, w):
    """A smooth image with two rectangles (a JPEG of noise is mostly noise)."""
    yy, xx = np.mgrid[0:h, 0:w]
    image = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 127 // (h + w)], -1)
    image = image.astype(np.uint8)
    image[h // 5: h // 2, w // 6: w // 2] = [220, 40, 60]
    image[h // 2: h - 4, w // 2: w - 6] = rs.randint(0, 256, 3)
    return image


def _jpeg(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def served():
    from mtlx.export.exporter import InferenceModel as JInferenceModel

    jmodel = graft._flagship(canvas=(64, 64), dtype=jnp.float32, **graft._TINY_KW)
    variables = _randomize(jmodel.init_variables(jax.random.PRNGKey(0)), 7)
    cfg = FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=torch.float32,
                           **graft._TINY_KW)
    port = FasterRCNN(cfg, device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables), strict=True)
    rs = np.random.RandomState(5)
    images = [_picture(rs, 90, 120), _picture(rs, 120, 90)]
    jpegs = [_jpeg(a) for a in images]
    pngs = [imgcodec.encode_png(a) for a in images]
    examples = [build_example(blob, fmt, a.shape[0], a.shape[1], f"im{i}", np.zeros((0, 4)),
                              [], [])
                for i, (a, blob, fmt) in enumerate(zip(images * 2, jpegs + pngs,
                                                       [b"jpeg"] * 2 + [b"png"] * 2))]
    return dict(
        port=texporter.InferenceModel(port, RESIZER, bucket_multiple=32, device="cpu"),
        mtlx=JInferenceModel(jmodel, variables, RESIZER, bucket_multiple=32),
        images=images, jpegs=jpegs, pngs=pngs, examples=examples)


@pytest.mark.parametrize("kind", ["jpegs", "pngs"])
def test_encoded_images_equal_mtlx(served, kind):
    blobs = served[kind]
    with jax.disable_jit():
        want = served["mtlx"].predict_encoded_images(blobs)
    got = served["port"].predict_encoded_images(blobs)
    assert (got["num_detections"] > 0).all()
    _same_detections(got, want)


def test_tf_examples_equal_mtlx(served):
    with jax.disable_jit():
        want = served["mtlx"].predict_tf_examples(served["examples"])
    got = served["port"].predict_tf_examples(served["examples"])
    _same_detections(got, want)


def test_every_input_type_equals_predict_images(served):
    port = served["port"]
    jpegs, pngs = served["jpegs"], served["pngs"]
    decoded_jpegs = [imgcodec.decode_jpeg(b, *port._target(*imgcodec.jpeg_dims(b)))
                     for b in jpegs]
    decoded_pngs = [imgcodec.decode_png(b) for b in pngs]
    assert all(np.array_equal(a, b) for a, b in zip(decoded_pngs, served["images"]))
    cases = [
        (port.predict_encoded_images(jpegs), decoded_jpegs),
        (port.predict_encoded_images(pngs), decoded_pngs),
        # one blob of each format in a batch: each takes its own path
        (port.predict_encoded_images([jpegs[0], pngs[1]]), [decoded_jpegs[0], decoded_pngs[1]]),
        (port.predict_tf_examples(served["examples"]),
         [decode_example(s)["image"] for s in served["examples"]]),
    ]
    for got, arrays in cases:
        _same_detections(got, port.predict_images(arrays), exact=True)


def test_encoded_images_reject_other_bytes(served):
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        served["port"].predict_encoded_images([served["jpegs"][0], b"GIF89a...."])


# a flagship-shaped pipeline at a 64x64 canvas (detection only)
_PIPELINE = """
model { faster_rcnn {
  num_classes: 3
  image_resizer { fixed_shape_resizer { height: 64 width: 64 } }
  feature_extractor { type: 'faster_rcnn_resnet50' first_stage_features_stride: 16 }
  first_stage_anchor_generator { grid_anchor_generator {
    scales: [0.5, 1.0] aspect_ratios: [1.0] } }
  first_stage_max_proposals: 8
  initial_crop_size: 14 maxpool_kernel_size: 2 maxpool_stride: 2
  second_stage_post_processing {
    batch_non_max_suppression { score_threshold: 0.0 iou_threshold: 0.6
      max_detections_per_class: 10 max_total_detections: 10 }
    score_converter: SOFTMAX }
} }
eval_config { num_examples: 4 }
"""


@pytest.fixture
def _mtlx_init_once(monkeypatch):
    """mtlx's FasterRCNN.init_variables once per model config and key: the
    test, mtlx's export and its restore flax-init the same full-width R50
    six times (about 10 s each on the CPU), and every call returns the
    same variables, which the checkpoints then overwrite."""
    from mtlx.detector.faster_rcnn import FasterRCNN as JFasterRCNN

    made = {}
    init = JFasterRCNN.init_variables

    def once(self, rng, batch_size: int = 1):
        key = (repr(self.cfg), np.asarray(jax.random.key_data(rng)
                                          if jnp.issubdtype(rng.dtype, jax.dtypes.prng_key)
                                          else rng).tobytes())
        if key not in made:
            made[key] = init(self, rng, batch_size)
        return made[key]

    monkeypatch.setattr(JFasterRCNN, "init_variables", once)
    return made


def test_export_cli_matches_mtlx(tmp_path, _mtlx_init_once):
    from google.protobuf import text_format

    from mtlx.builders import model_builder as jbuilder
    from mtlx.config import config_util as jconfig
    from mtlx.config.protos import pipeline_pb2
    from mtlx.export.exporter import export_inference_graph as jexport
    from mtlx.train import checkpoints as jckpt
    from mtlx.train.train_step import create_train_state, make_optimizer
    from mtlx_torch.builders import model_builder as tbuilder
    from mtlx_torch.config import config_util as tconfig
    from mtlx_torch.train import checkpoints as tckpt
    from mtlx_torch.train import train_step as ts

    pipeline = str(tmp_path / "pipeline.config")
    with open(pipeline, "w") as f:
        f.write(_PIPELINE)
    steps = (2, 5)
    # mtlx's checkpoints
    jdir = str(tmp_path / "jtrain")
    jmodel = jbuilder.build(jconfig.get_configs_from_pipeline_file(pipeline)["model"],
                            is_training=False)
    state = create_train_state(jmodel, jax.random.PRNGKey(0), make_optimizer())
    manager = jckpt.CheckpointManager(jdir)
    for step in steps:
        manager.save(step, state.replace(step=jnp.asarray(step, jnp.int32)))
    manager._mgr.wait_until_finished()
    # the port's, with weights that tell the steps apart
    tdir = str(tmp_path / "ttrain")
    tmodel = tbuilder.build(tconfig.get_configs_from_pipeline_file(pipeline)["model"],
                            is_training=False, device="cpu")
    tmodel.init_weights(torch.Generator().manual_seed(0))
    tmanager = tckpt.CheckpointManager(tdir)
    for step in steps:
        with torch.no_grad():
            tmodel.modules.box_predictor.class_logits.bias.fill_(step)
        tmanager.save(step, ts.create_train_state(tmodel, ts.make_optimizer()))
    tmanager.wait()

    for step, flag, want_multiple in ((None, [], 128), (2, ["--bucket_multiple", "64"], 64)):
        jout, tout = str(tmp_path / f"jexport{step}"), str(tmp_path / f"texport{step}")
        jexport(pipeline, jdir, jout, step, bucket_multiple=int(flag[1]) if flag else 0)
        argv = ["--pipeline_config_path", pipeline, "--trained_checkpoint_dir", tdir,
                "--output_directory", tout, *flag]
        assert texporter.main(argv + (["--checkpoint_step", str(step)] if step else [])) == tout
        parsed = []
        for out in (jout, tout):
            with open(os.path.join(out, "pipeline.config")) as f:
                parsed.append(text_format.Parse(f.read(), pipeline_pb2.TrainEvalPipelineConfig()))
        assert parsed[0] == parsed[1]
        assert parsed[1].bucketing.bucket_multiple == want_multiple
        with open(os.path.join(jout, "export_metadata.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(tout, "export_metadata.json")) as f:
            tmeta = json.load(f)
        assert tmeta["step"] == jmeta["step"] == (step or steps[-1])
        assert tmeta["format"] == "mtlx_torch-v1"
        loaded = texporter.InferenceModel.load(tout, device="cpu", dtype=torch.float32)
        assert loaded.bucket_multiple == want_multiple
        bias = loaded.model.modules.box_predictor.class_logits.bias
        assert torch.equal(bias, torch.full_like(bias, step or steps[-1]))

    # --saved_model writes the serving program and its pipeline.config beside
    # the bundle, as mtlx writes its SavedModel
    sm_out = str(tmp_path / "sm")
    texporter.main(["--pipeline_config_path", pipeline, "--trained_checkpoint_dir", tdir,
                    "--output_directory", sm_out, "--saved_model", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(sm_out, "saved_model"))) == ["model.pt2",
                                                                       "pipeline.config"]
    with open(os.path.join(sm_out, "saved_model", "pipeline.config")) as f:
        sm_text = f.read()
    with open(os.path.join(sm_out, "pipeline.config")) as f:
        assert sm_text == f.read()
    # eval_config.use_moving_averages exports the moving average where the
    # checkpoint has one, the weights where it has none, as mtlx's export
    from mtlx.export.exporter import _load_trained

    ema = str(tmp_path / "ema.config")
    with open(ema, "w") as f:
        f.write(_PIPELINE.replace("num_examples: 4", "num_examples: 4 use_moving_averages: true"))
    jema_dir, tema_dir = str(tmp_path / "jema"), str(tmp_path / "tema")
    jstate = create_train_state(jmodel, jax.random.PRNGKey(0), make_optimizer(), keep_ema=True)
    averaged = jax.tree_util.tree_map(np.asarray, jstate.ema_params)
    averaged["box_predictor"]["class_logits"]["bias"] = np.full_like(
        averaged["box_predictor"]["class_logits"]["bias"], 7.0)
    manager = jckpt.CheckpointManager(jema_dir)
    manager.save(9, jstate.replace(step=jnp.asarray(9, jnp.int32), ema_params=averaged))
    manager._mgr.wait_until_finished()
    tstate = ts.create_train_state(tmodel, ts.make_optimizer(), keep_ema=True)
    tstate.ema["box_predictor.class_logits.bias"].fill_(7.0)
    with torch.no_grad():
        tmodel.modules.box_predictor.class_logits.bias.fill_(9)
    tmanager = tckpt.CheckpointManager(tema_dir)
    tmanager.save(9, dataclasses.replace(tstate, step=9))
    tmanager.wait()
    for jsrc, tsrc, want in ((jema_dir, tema_dir, 7.0), (jdir, tdir, None)):
        _, _, restored = _load_trained(ema, jsrc)
        jbias = np.asarray(restored.params["box_predictor"]["class_logits"]["bias"])
        tout = texporter.export_inference_graph(ema, tsrc, str(tmp_path / f"e{want}"))
        bias = texporter.InferenceModel.load(tout, device="cpu", dtype=torch.float32
                                             ).model.modules.box_predictor.class_logits.bias
        if want is None:  # no moving average: both export the weights
            assert np.array_equal(jbias, np.zeros_like(jbias))  # mtlx's init bias
            assert torch.equal(bias, torch.full_like(bias, steps[-1]))
        else:
            assert np.array_equal(jbias, np.full_like(jbias, want))
            assert torch.equal(bias, torch.full_like(bias, want))
    assert len(_mtlx_init_once) == 1  # one config, one key: one init
    # two checkpoint dirs and four bundles of a full-width R50 (about a
    # GiB): pytest keeps each run's tmp_path
    shutil.rmtree(tmp_path)
