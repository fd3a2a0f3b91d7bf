"""R-FCN in the port (mtlx_torch/detector/rfcn.py, the position-sensitive
crop of mtlx_torch/ops/roi.py and RfcnBoxPredictor) against mtlx, on the
CPU in float32, with the flax weights carried over by the bridge.

  * position_sensitive_crop_regions against eager mtlx, both global_pool
    forms, 3x3 and 2x2 bins, boxes past the map's edges: the crops are
    the same arithmetic (bit-equal), and the means of the pooled form sum
    in another order, so rtol 1e-6 with an atol of 1e-6 times the largest
    magnitude; the batched-bins layout against the per-bin loop (mtlx's
    structure, one crop a bin on a copied channel group) bit for bit;
  * RfcnBoxPredictor: allclose (rtol 1e-4, atol 1e-4 times the largest
    magnitude: convolution sums in another order);
  * a tiny R-FCN (resnet10, 64x64, the PS crop at 3x3 bins of 2x2) with
    mtlx's own random draws: serving predict and postprocess (the same
    proposals, classes and counts exactly, boxes and scores within
    1e-5 on mtlx's stage outputs), the sampled proposals exactly, every
    Loss/* term and every parameter's gradient allclose, the second
    stage's kernel launches counted (two crops forward, two backward),
    and one make_train_step equal to mtlx's optimizer on mtlx's
    gradients (allclose);
  * the train, eval and export CLIs and InferenceModel on a small-canvas
    R-FCN pipeline with --device cpu.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtlx.ops import roi as jroi
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.kernels import roi_cuda
from mtlx_torch.ops import roi as troi


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-4):
    """allclose at rtol, with an atol of rtol times the largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def seeded_variables(init, seed, *args):
    """flax variables of init's shapes, from numpy (no init to compile):
    kernels normal with a 1 / sqrt(fan_in) deviation, biases and
    batch-norm offsets and means normal(0, 0.2), scales and variances
    uniform(0.5, 1.5)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rs.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rs.normal(0, 0.2, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _ps_case(seed, bins, depth=5, n=7, hw=(9, 11)):
    rs = np.random.RandomState(seed)
    c = bins[0] * bins[1] * depth
    image = rs.normal(0, 1, (*hw, c)).astype(np.float32)
    y0, x0 = rs.uniform(-0.3, 0.9, n), rs.uniform(-0.3, 0.9, n)
    boxes = np.stack([y0, x0, y0 + rs.uniform(0.05, 0.8, n), x0 + rs.uniform(0.05, 0.8, n)], 1)
    boxes[0] = [-0.2, -0.1, 1.3, 1.2]  # past every edge
    boxes[1] = [0.0, 0.0, 1.0, 1.0]  # the whole map
    return image, boxes.astype(np.float32)


def _per_bin_loop(image, boxes, crop_size, bins, global_pool):
    """mtlx's structure in the port: one crop a bin, on that bin's channel
    group (a contiguous copy, as the kernel wrapper takes), the bins
    stacked and averaged or tiled. [B, H, W, C] x [B, N, 4]."""
    by_n, bx_n = bins
    depth = image.shape[-1] // (by_n * bx_n)
    bch, bcw = crop_size[0] // by_n, crop_size[1] // bx_n
    y1, x1, y2, x2 = boxes.unbind(-1)
    step_y = (y2 - y1) / torch.tensor(float(by_n))
    step_x = (x2 - x1) / torch.tensor(float(bx_n))
    rows = []
    for by in range(by_n):
        row = []
        for bx in range(bx_n):
            i = by * bx_n + bx
            sub = torch.stack([y1 + by * step_y, x1 + bx * step_x,
                               y1 + (by + 1) * step_y, x1 + (bx + 1) * step_x], -1)
            group = image[..., i * depth:(i + 1) * depth].contiguous()
            crop = roi_cuda.crop_and_resize(group, sub.contiguous(), (bch, bcw))
            row.append(crop.mean(dim=(2, 3)) if global_pool else crop)
        rows.append(row)
    if global_pool:
        return torch.stack([c for r in rows for c in r], dim=1).mean(dim=1)
    return torch.cat([torch.cat(r, dim=3) for r in rows], dim=2)


@pytest.mark.parametrize("global_pool", [True, False], ids=["pooled", "tiled"])
@pytest.mark.parametrize("bins,crop", [((3, 3), (6, 6)), ((2, 2), (4, 6))], ids=["3x3", "2x2"])
def test_position_sensitive_crop_matches_mtlx(bins, crop, global_pool):
    image, boxes = _ps_case(bins[0] + global_pool, bins)
    want = np.asarray(jroi.position_sensitive_crop_regions(
        jnp.asarray(image), jnp.asarray(boxes), crop, bins, global_pool=global_pool))
    got = troi.position_sensitive_crop_regions(_t(image), _t(boxes), crop, bins,
                                               global_pool=global_pool).numpy()
    assert got.shape == want.shape
    if global_pool:
        _close(got, want, rtol=1e-6)
    else:  # the same samples: bit-equal
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("global_pool", [True, False], ids=["pooled", "tiled"])
@pytest.mark.parametrize("bins,crop", [((3, 3), (12, 12)), ((2, 2), (4, 6))], ids=["3x3", "2x2"])
def test_batched_bins_equal_the_per_bin_loop(bins, crop, global_pool):
    images, boxes = zip(*(_ps_case(s, bins, depth=21, n=9) for s in (5, 6)))
    image, boxes = _t(np.stack(images)), _t(np.stack(boxes))
    launches = roi_cuda.crop_and_resize.launches
    got = troi.position_sensitive_crop_regions(image, boxes, crop, bins, global_pool)
    want = _per_bin_loop(image, boxes, crop, bins, global_pool)
    assert torch.equal(got, want)
    assert roi_cuda.crop_and_resize.launches == launches  # CPU tensors: the plain version


@pytest.mark.parametrize("batch", [1, 2])
def test_position_sensitive_crop_hands_the_kernel_contiguous_tensors(batch, monkeypatch):
    """The kernel wrapper refuses non-contiguous tensors: the bin-major
    layout and the sub-boxes must be contiguous at any batch (at batch 1
    a reshape of the permuted map would be a view)."""
    seen = []
    fwd = roi_cuda._forward
    monkeypatch.setattr(roi_cuda, "_forward", lambda f, b, ch, cw: seen.append(
        (tuple(f.shape), f.is_contiguous(), b.is_contiguous())) or fwd(f, b, ch, cw))
    images, boxes = zip(*(_ps_case(s, (3, 3), depth=21, n=4) for s in range(batch)))
    troi.position_sensitive_crop_regions(_t(np.stack(images)), _t(np.stack(boxes)), (12, 12),
                                         (3, 3))
    assert seen == [((batch * 9, 9, 11, 21), True, True)]


def test_position_sensitive_crop_gradient_matches_the_loop():
    """d(score maps) through the batched layout equals the per-bin loop's."""
    image, boxes = _ps_case(9, (3, 3), depth=4, n=5)
    grads = []
    for fn in (lambda x: troi.position_sensitive_crop_regions(x, _t(boxes)[None], (6, 6), (3, 3)),
               lambda x: _per_bin_loop(x, _t(boxes)[None], (6, 6), (3, 3), True)):
        x = _t(image)[None].requires_grad_(True)
        (fn(x) * torch.arange(4.0)).sum().backward()
        grads.append(x.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-6, atol=1e-7)
    assert float(grads[0].abs().max()) > 0


def test_position_sensitive_crop_raises_as_mtlx():
    image = torch.zeros(1, 4, 4, 10)
    boxes = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        troi.position_sensitive_crop_regions(image, boxes, (6, 6), (3, 3))
    with pytest.raises(ValueError, match="crop_size"):
        troi.position_sensitive_crop_regions(torch.zeros(1, 4, 4, 18), boxes, (5, 6), (3, 3))


def test_rfcn_box_predictor_matches_mtlx():
    from mtlx.heads import box_predictors as jheads
    from mtlx_torch.heads import box_predictors as theads

    rs = np.random.RandomState(2)
    feats = rs.normal(0, 1, (2, 5, 6, 48)).astype(np.float32)
    y0, x0 = rs.uniform(0, 0.6, (2, 7)), rs.uniform(0, 0.6, (2, 7))
    boxes = np.stack([y0, x0, y0 + 0.35, x0 + 0.3], -1).astype(np.float32)
    fmod = jheads.RfcnBoxPredictor(num_classes=3, depth=32, crop_size=(6, 6), dtype=jnp.float32)
    variables = seeded_variables(fmod.init, 3, jnp.asarray(feats), jnp.asarray(boxes))
    want_cls, want_box = (np.asarray(x) for x in jax.jit(fmod.apply)(
        variables, jnp.asarray(feats), jnp.asarray(boxes)))
    port = theads.RfcnBoxPredictor(48, 3, (3, 3), 32, (6, 6), torch.float32)
    nested = {"params": {"rfcn_predictor": variables["params"]}}
    port.load_state_dict({k[len("rfcn_predictor."):]: v
                          for k, v in flax_to_state_dict(nested).items()}, strict=True)
    with torch.no_grad():
        cls, box = port(_t(feats), _t(boxes))
    assert cls.shape == (2, 7, 4) and box.shape == (2, 7, 3, 4)
    _close(cls.numpy(), want_cls)
    _close(box.numpy(), want_box)


# the tiny R-FCN: resnet10 on a 64x64 canvas, the predictor's 3x3 bins at
# 2x2 each (crop 6x6), as tests/test_ssd_rfcn.py's
_TINY = dict(
    num_classes=3, canvas_size=(64, 64), backbone="resnet10", anchor_scales=(0.5, 1.0),
    anchor_aspect_ratios=(1.0,), anchor_base_size=(32.0, 32.0), rpn_depth=32, rfcn_depth=32,
    rfcn_crop_size=(6, 6), first_stage_pre_nms_top_k=24, first_stage_max_proposals=12,
    first_stage_minibatch_size=16, second_stage_batch_size=8, max_gt_boxes=4,
)


def _jax_draws(rng, batch_size, num_proposals, num_anchors):
    """The uniforms mtlx's predict and loss draw from rng_predict and
    rng_loss, keyed as the port's draws (tests/test_torch_train_step.py)."""
    rng_predict, rng_loss = jax.random.split(rng)

    def sampler_draws(key, n):
        pos, neg = [], []
        for k in jax.random.split(key, batch_size):
            kp, kn = jax.random.split(k)
            pos.append(np.asarray(jax.random.uniform(kp, (n,))))
            neg.append(np.asarray(jax.random.uniform(kn, (n,))))
        return _t(np.stack(pos)), _t(np.stack(neg))

    d = {}
    d["proposal_pos"], d["proposal_neg"] = sampler_draws(rng_predict, num_proposals)
    d["anchor_pos"], d["anchor_neg"] = sampler_draws(rng_loss, num_anchors)
    return d, rng_predict, rng_loss


@pytest.fixture(scope="module")
def tiny():
    from mtlx.detector.rfcn import RFCN as JRFCN, RFCNConfig as JRFCNConfig
    from mtlx.train import train_step as jts
    from mtlx_torch.detector.rfcn import RFCN, RFCNConfig

    jmodel = JRFCN(JRFCNConfig(dtype=jnp.float32, **_TINY))
    variables = seeded_variables(jmodel.modules.init, 7, jnp.zeros((1, 64, 64, 3)))
    rs = np.random.RandomState(0)
    # true extents inside the canvas: jitted mtlx moves a sample on the
    # map's last row out of range by an ulp (ROADMAP.md queue 3)
    batch = {
        "image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "true_shape": np.asarray([[56, 60], [48, 56]], np.int32),
        "gt_boxes": np.asarray([[[2, 3, 54, 58], [20, 10, 50, 45], [0] * 4, [0] * 4],
                                [[4, 4, 44, 50], [10, 20, 30, 40], [0] * 4, [0] * 4]],
                               np.float32),
        "gt_classes": np.asarray([[0, 2, 0, 0], [1, 0, 0, 0]], np.int32),
        "gt_mask": np.asarray([[True, True, False, False], [True, True, False, False]]),
    }
    gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"], "mask": batch["gt_mask"]}
    images = jmodel.preprocess(jnp.asarray(batch["image"], jnp.float32))
    c = jmodel.cfg
    draws, rng_predict, rng_loss = _jax_draws(jax.random.PRNGKey(1), 2,
                                              c.first_stage_max_proposals,
                                              jmodel.anchors_for((64, 64)).shape[0])
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(params):
        pred = jmodel.predict({"params": params, "batch_stats": stats}, images,
                              batch["true_shape"], training=True, rng=rng_predict,
                              groundtruth=gt)
        losses = jmodel.loss(pred, gt, rng_loss)
        return losses["total_loss"], (losses, pred)

    (_, (jlosses, jpred)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jeval = jax.jit(lambda v: jmodel.predict(v, images, batch["true_shape"]))(variables)
    jdet = jmodel.postprocess(jeval, jnp.asarray(batch["true_shape"]))
    # mtlx's optimizer on mtlx's gradients: the parameters after one step
    tx = jts.make_optimizer(learning_rate=LR)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    port = RFCN(RFCNConfig(dtype=torch.float32, **_TINY), device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables), strict=True)
    np_tree = lambda tree: {k: np.asarray(v) for k, v in tree.items() if v is not None}
    return dict(jmodel=jmodel, batch=batch, gt=gt, draws=draws, rng_predict=rng_predict,
                jlosses={k: float(v) for k, v in jlosses.items()}, jpred=np_tree(jpred),
                jeval=np_tree(jeval), jdet=np_tree(jdet),
                jgrads=flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}),
                jnew=flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jnew),
                                         "batch_stats": stats}),
                port=port)


def _tgt(tiny):
    g = tiny["gt"]
    return {"boxes": _t(g["boxes"]), "classes": _t(g["classes"]).long(), "mask": _t(g["mask"])}


def test_tree_has_rfcn_predictor_on_block4():
    """As tests/test_ssd_rfcn.py holds mtlx: block4 runs image-wide before
    the predictor, whose reduce conv reads block4's 2048 channels; no
    box_predictor."""
    from mtlx_torch.detector.rfcn import RFCN, RFCNConfig

    state = RFCN(RFCNConfig(dtype=torch.float32, **_TINY), device="cpu").modules.state_dict()
    assert state["rfcn_predictor.reduce.weight"].shape == (32, 2048, 1, 1)
    assert state["rfcn_predictor.class_maps.weight"].shape == (9 * 4, 32, 1, 1)
    assert state["rfcn_predictor.box_maps.weight"].shape == (9 * 3 * 4, 32, 1, 1)
    assert any(k.startswith("classifier_backbone.block4.") for k in state)
    assert not any(k.startswith("box_predictor.") for k in state)


def test_rejects_mtl_refine():
    from mtlx_torch.detector.faster_rcnn import MTLConfig
    from mtlx_torch.detector.rfcn import RFCN, RFCNConfig

    with pytest.raises(ValueError, match="refine"):
        RFCN(RFCNConfig(num_classes=3, canvas_size=(64, 64),
                        mtl=MTLConfig(multiobject=True, refine=True)), device="cpu")


def test_serving_predict_and_postprocess(tiny):
    port, je, jd = tiny["port"], tiny["jeval"], tiny["jdet"]
    ts = _t(tiny["batch"]["true_shape"])
    images = port.preprocess(_t(tiny["batch"]["image"]).float())
    pred = port.predict(images, ts)
    np.testing.assert_array_equal(pred["proposal_mask"].numpy(), je["proposal_mask"])
    np.testing.assert_allclose(pred["proposal_boxes"].numpy(), je["proposal_boxes"],
                               rtol=1e-5, atol=1e-3)
    # the second stage on mtlx's proposals
    cls, box, _ = port._predict_second_stage(_t(je["rpn_features"]),
                                             _t(je["proposal_boxes"]), (64, 64))
    _close(cls, je["class_predictions"])
    _close(box, je["refined_box_encodings"])
    # the postprocess on mtlx's stage outputs
    det = port.postprocess({k: _t(v) for k, v in je.items()}, ts)
    np.testing.assert_array_equal(det["detection_classes"].numpy(), jd["detection_classes"])
    np.testing.assert_array_equal(det["num_detections"].numpy(), jd["num_detections"])
    np.testing.assert_allclose(det["detection_boxes"].numpy(), jd["detection_boxes"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(det["detection_scores"].numpy(), jd["detection_scores"],
                               rtol=1e-5, atol=1e-5)
    assert (det["num_detections"] > 0).all()
    # end to end, each side on its own stage outputs
    own = port.postprocess(pred, ts)
    np.testing.assert_array_equal(own["detection_classes"].numpy(), jd["detection_classes"])
    _close(own["detection_scores"], jd["detection_scores"])


def test_sampled_proposals_losses_gradients_and_launches(tiny):
    jm, jp, port, d = tiny["jmodel"], tiny["jpred"], tiny["port"], tiny["draws"]
    props, _, mask = jm._postprocess_rpn(jp["rpn_objectness_logits"], jp["rpn_box_encodings"],
                                         tiny["batch"]["true_shape"], jp["anchors"])
    want_p, want_m = jm._sample_proposals(tiny["rng_predict"], props, mask, tiny["gt"])
    got_p, got_m = port._sample_proposals(_t(props), _t(mask), _tgt(tiny),
                                          (d["proposal_pos"], d["proposal_neg"]))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))

    # the losses on mtlx's predictions
    got = port.loss({k: _t(v) for k, v in jp.items()}, _tgt(tiny), d)
    assert set(got) == set(tiny["jlosses"])
    for key, want in tiny["jlosses"].items():
        np.testing.assert_allclose(float(got[key]), want, rtol=1e-5, err_msg=key)
    assert tiny["jlosses"]["Loss/BoxClassifierLoss/localization_loss"] > 0

    # end to end: forward, losses, backward
    for p in port.modules.parameters():
        p.grad = None
    images = port.preprocess(_t(tiny["batch"]["image"]).float())
    pred = port.predict_train(images, _t(tiny["batch"]["true_shape"]), _tgt(tiny), d)
    assert pred["class_predictions"].shape == (2, 8, 4)
    assert pred["refined_box_encodings"].shape == (2, 8, 3, 4)
    np.testing.assert_array_equal(pred["proposal_mask"].numpy(), jp["proposal_mask"])
    losses = port.loss(pred, _tgt(tiny), d)
    for key, want in tiny["jlosses"].items():
        np.testing.assert_allclose(losses[key].item(), want, rtol=1e-4, err_msg=key)
    losses["total_loss"].backward()
    grads = {n: p.grad for n, p in port.modules.named_parameters()}
    assert set(grads) == set(tiny["jgrads"])
    for name, g in grads.items():
        assert g is not None, name
        _close(g.numpy(), tiny["jgrads"][name].numpy())
    assert float(grads["rfcn_predictor.class_maps.weight"].abs().max()) > 0


def test_second_stage_calls_the_crop_twice_each_way(tiny, monkeypatch):
    """One crop of the class maps and one of the box maps (each covering
    every bin of every image), and one backward of each."""
    port, d = tiny["port"], tiny["draws"]
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = roi_cuda._forward, roi_cuda.crop_and_resize_backward
    monkeypatch.setattr(roi_cuda, "_forward",
                        lambda f, b, ch, cw: calls["fwd"].append(tuple(f.shape)) or fwd(f, b, ch, cw))
    monkeypatch.setattr(roi_cuda, "crop_and_resize_backward",
                        lambda g, b, hw: calls["bwd"].append(tuple(g.shape)) or bwd(g, b, hw))
    images = port.preprocess(_t(tiny["batch"]["image"]).float())
    pred = port.predict_train(images, _t(tiny["batch"]["true_shape"]), _tgt(tiny), d)
    port.loss(pred, _tgt(tiny), d)["total_loss"].backward()
    assert calls["fwd"] == [(2 * 9, 4, 4, 4), (2 * 9, 4, 4, 12)]
    assert sorted(calls["bwd"]) == [(18, 8, 2, 2, 4), (18, 8, 2, 2, 12)]


def test_one_train_step_matches_mtlx(tiny):
    from mtlx_torch.detector.rfcn import RFCN
    from mtlx_torch.train import train_step as tts

    port = RFCN(tiny["port"].cfg, device="cpu")
    port.modules.load_state_dict(tiny["port"].modules.state_dict())
    state = tts.create_train_state(port, tts.make_optimizer(learning_rate=LR))
    b = {k: _t(v) for k, v in tiny["batch"].items()}
    state, metrics = tts.make_train_step(port)(state, b, draws=tiny["draws"])
    np.testing.assert_allclose(float(metrics["total_loss"]), tiny["jlosses"]["total_loss"],
                               rtol=1e-4)
    after = port.modules.state_dict()
    for name, want in tiny["jnew"].items():
        _close(after[name].numpy(), want.numpy())


_PIPELINE = """
model {{ faster_rcnn {{
  num_classes: 3
  image_resizer {{ fixed_shape_resizer {{ height: 64 width: 64 }} }}
  feature_extractor {{ type: 'faster_rcnn_resnet50' }}
  first_stage_anchor_generator {{ grid_anchor_generator {{
    scales: [0.5, 1.0] aspect_ratios: [1.0] height: 32 width: 32 }} }}
  first_stage_box_predictor_depth: 32
  first_stage_max_proposals: 8
  first_stage_minibatch_size: 16
  second_stage_batch_size: 4
  second_stage_box_predictor {{ rfcn_box_predictor {{
    conv_hyperparams {{ op: CONV regularizer {{ l2_regularizer {{ weight: 0.0001 }} }}
      initializer {{ truncated_normal_initializer {{ stddev: 0.01 }} }} }}
    num_spatial_bins_height: 3 num_spatial_bins_width: 3
    depth: 64 crop_height: 6 crop_width: 6 }} }}
  second_stage_post_processing {{
    batch_non_max_suppression {{ score_threshold: 0.0 iou_threshold: 0.6
      max_detections_per_class: 5 max_total_detections: 10 }}
    score_converter: SOFTMAX }}
}} }}
train_config {{
  batch_size: 2
  optimizer {{ momentum_optimizer {{
    learning_rate {{ constant_learning_rate {{ learning_rate: 0.001 }} }}
    momentum_optimizer_value: 0.9 }} use_moving_average: false }}
  num_steps: 2
  save_checkpoints_steps: 1
  max_number_of_boxes: 8
}}
train_input_reader {{ tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}" }}
eval_config {{ num_examples: 2 metrics_set: "pascal_voc_detection_metrics" }}
eval_input_reader {{ tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}" shuffle: false }}
"""


def write_cli_workdir(tmp, pipeline: str, n: int = 2, size: int = 64, classes=3):
    """n PNG records of noise with one red box each, a label map of
    `classes` names, and the pipeline pointing at them; returns its path."""
    from mtlx_torch.data import imgcodec, tfrecord
    from mtlx_torch.data.example_decoder import build_example

    record = str(tmp / "train.record")
    rs = np.random.RandomState(0)
    with tfrecord.TFRecordWriter(record) as w:
        for i in range(n):
            arr = rs.randint(0, 255, (size, size, 3), dtype=np.uint8)
            arr[8:40, 8:48] = [250, 30, 30]
            boxes = np.asarray([[8 / size, 8 / size, 40 / size, 48 / size]], np.float32)
            w.write(build_example(imgcodec.encode_png(arr), b"png", size, size, f"im{i}.png",
                                  boxes, [1], ["c1"]))
    label_map = str(tmp / "label_map.pbtxt")
    with open(label_map, "w") as f:
        for i in range(classes):
            f.write(f"item {{ id: {i + 1} name: 'c{i + 1}' }}\n")
    path = str(tmp / "pipeline.config")
    with open(path, "w") as f:
        f.write(pipeline.format(record=record, label_map=label_map))
    return path


def run_cli_chain(tmp, config, capsys, metric="Precision/mAP@0.5IOU", size=64,
                  resume=True):
    """train 1 step -> resume to 2 (or 2 steps at once) -> eval -> export
    -> InferenceModel, all with --device cpu; returns the metrics, the
    served model and its detections, and removes the train and export
    directories once all of it passed."""
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_cli

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        train_dir = str(tmp / "train")
        common = ["--pipeline_config_path", config, "--train_dir", train_dir, "--device", "cpu",
                  "--log_every", "1"]
        if resume:
            train_cli.main(common + ["--num_steps", "1"])
        train_cli.main(common)
        out = capsys.readouterr().out
        assert ("resumed from step 1" in out) == resume and "[train] done at step 2" in out, out
        losses = [json.loads(ln[8:]) for ln in out.splitlines() if ln.startswith("[train] {")]
        assert [ln["step"] for ln in losses] == [1, 2]
        assert all(np.isfinite(ln["total_loss"]) for ln in losses)
        assert ckpt_lib.CheckpointManager(train_dir).all_steps() == [1, 2]
        metrics = eval_cli.main(["--pipeline_config_path", config, "--checkpoint_dir", train_dir,
                                 "--eval_dir", str(tmp / "eval"), "--run_once", "--device", "cpu"])
        capsys.readouterr()
        assert np.isfinite(metrics[metric]), metrics
        export_dir = str(tmp / "export")
        exporter.main(["--pipeline_config_path", config, "--trained_checkpoint_dir", train_dir,
                       "--output_directory", export_dir])
        capsys.readouterr()
        served = InferenceModel.load(export_dir, device="cpu")
        det = served.predict_images([np.full((size, size, 3), 128, np.uint8)])
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(det["detection_scores"]).all()
    assert (det["detection_classes"] >= 1).all()
    # the checkpoints and the bundle (up to a GiB at full width) are not
    # needed past a pass; pytest keeps each run's tmp_path
    shutil.rmtree(train_dir)
    shutil.rmtree(export_dir)
    return metrics, served, det


def test_cli_train_resume_eval_export_serve(tmp_path, capsys):
    from mtlx_torch.detector.rfcn import RFCN

    config = write_cli_workdir(tmp_path, _PIPELINE)
    metrics, served, det = run_cli_chain(tmp_path, config, capsys)
    assert isinstance(served.model, RFCN)
    assert det["detection_boxes"].shape == (1, 10, 4)
