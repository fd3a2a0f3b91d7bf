"""The Faster R-CNN options of the paper's MTL refine slice, against mtlx on
the CPU: the refine path, second-stage dropout, live batch norm in both
trunks and the hard example miner.

Every model is the tiny resnet10 of `__graft_entry__` (64x64, float32)
with the same seeded weights on both sides (`bridge.py`), the batch of
tests/test_torch_train_step.py and JAX's own draws injected (the
dropout uniforms taken from the `dropout` rng exactly as flax's
nn.Dropout inside `box_predictor` draws them). mtlx runs one jitted
program per model (its training value and gradients, its detection-loss
gradients and its serving predictions), compiled once per module.

Tolerances ("allclose": rtol 1e-4 with an atol of 1e-4 times the
tensor's largest magnitude, as tests/test_torch_train_step.py; sums of
convolutions in another order):
  * refine serving: class logits and box refinements allclose; detection
    classes and counts equal, boxes and scores allclose
  * a refine train step: every Loss/* term within rtol 1e-4, every
    gradient allclose, the detection loss's gradient into mo_head and
    cl_head allclose and non-zero (mtlx tests/test_faster_rcnn.py:212)
  * dropout: losses rtol 1e-4; gradients allclose, the trunks' at 5e-3
    (a few ReLU inputs of block4 sit within float32 rounding of 0; the
    port in float64 lies within 2.3e-6 of mtlx there)
  * live batch norm: losses rtol 1e-4; every moving statistic of both
    trunks after the step within 1e-4 of the tensor's largest
    magnitude; the heads' gradients allclose, the trunks' at 1e-2
    (float32 sums through a live batch norm nearly cancel:
    tests/test_torch_live_bn.py; the largest seen was 8.5e-3, at block4's
    conv3 on the B x P ROI crops)
  * hard_example_mining_mask: index equality, exact
  * the second-stage loss with the miner on mtlx's predictions: rtol 1e-5
"""

import dataclasses
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mtlx.detector import faster_rcnn as jfr
from mtlx.losses import losses as jlosses
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.detector import faster_rcnn as tfr
from mtlx_torch.losses import losses as tlosses
from mtlx_torch.train import train_step as tts
from test_torch_rfcn import _jax_draws, run_cli_chain, seeded_variables, write_cli_workdir


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_TASKS = dict(multiobject=True, closeness=True, foreground=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


class _DropoutDraw(nn.Module):
    """The uniforms of flax's nn.Dropout at scope `box_predictor/Dropout_0`:
    the same scope path draws the same make_rng key, and
    jax.random.bernoulli(key, keep, shape) is uniform(key, shape) < keep."""

    shape: tuple
    depth: int = 0

    @nn.compact
    def __call__(self):
        if self.depth == 0:
            return _DropoutDraw(self.shape, 1, name="box_predictor")()
        if self.depth == 1:
            return _DropoutDraw(self.shape, 2, name="Dropout_0")()
        return jax.random.uniform(self.make_rng("dropout"), self.shape)


def _batch():
    return {
        "image": np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "true_shape": np.asarray([[56, 60], [48, 56]], np.int32),
        "gt_boxes": np.asarray([[[2, 3, 54, 58], [20, 10, 50, 45], [20, 10, 50, 45], [0, 0, 0, 0]],
                                [[4, 4, 44, 50], [10, 20, 30, 40], [0, 0, 0, 0], [0, 0, 0, 0]]],
                               np.float32),
        "gt_classes": np.asarray([[1, 3, 3, 0], [19, 0, 0, 0]], np.int32),
        "gt_mask": np.asarray([[True, True, True, False], [True, True, False, False]]),
    }


def _pair(seed, mtl, **kw):
    """mtlx's tiny model and every result of one jitted program, and the
    port's model with the same weights."""
    jcfg = jfr.FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=jnp.float32,
                                mtl=jfr.MTLConfig(**mtl), **graft._TINY_KW, **kw)
    jmodel = jfr.FasterRCNN(jcfg)
    variables = seeded_variables(jmodel.modules.init, seed, jnp.zeros((1, 64, 64, 3)))
    batch = _batch()
    gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"], "mask": batch["gt_mask"]}
    c = jmodel.cfg
    draws, rng_predict, rng_loss = _jax_draws(jax.random.PRNGKey(1), 2,
                                              c.first_stage_max_proposals,
                                              jmodel.anchors_for((64, 64)).shape[0])
    images = jmodel.preprocess(jnp.asarray(batch["image"], jnp.float32))
    ts = jnp.asarray(batch["true_shape"])
    stats = variables["batch_stats"]

    def train_pred(params):
        return jmodel.predict({"params": params, "batch_stats": stats}, images, ts,
                              training=True, rng=rng_predict, groundtruth=gt)

    def total(params):
        pred = train_pred(params)
        losses = jmodel.loss(pred, gt, rng_loss)
        return losses["total_loss"], (losses, pred)

    def detection_only(params):
        return sum(jmodel._second_stage_loss(train_pred(params), gt).values())

    @jax.jit
    def program(params):
        (_, (losses, pred)), grads = jax.value_and_grad(total, has_aux=True)(params)
        serving = jmodel.predict({"params": params, "batch_stats": stats}, images, ts)
        return (losses, pred, grads, jax.grad(detection_only)(params), serving,
                jmodel.postprocess(serving, ts))

    losses, pred, grads, det_grads, serving, det = jax.device_get(program(variables["params"]))
    if c.second_stage_dropout:
        width = variables["params"]["box_predictor"]["class_logits"]["kernel"].shape[0]
        shape = (2 * c.second_stage_batch_size, width)
        draws["dropout"] = _t(_DropoutDraw(shape).apply({}, rngs={"dropout": rng_predict}))

    tcfg = tfr.FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=torch.float32,
                                mtl=tfr.MTLConfig(**mtl), **graft._TINY_KW, **kw)
    port = tfr.FasterRCNN(tcfg, device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables, training_heads=True), strict=True)
    sd = lambda tree: flax_to_state_dict({"params": tree}, training_heads=True)
    return dict(jmodel=jmodel, variables=variables, batch=batch, gt=gt, draws=draws,
                losses={k: float(v) for k, v in losses.items()},
                pred={k: np.asarray(v) for k, v in pred.items() if k != "updated_batch_stats"},
                stats=pred.get("updated_batch_stats"), grads=sd(grads),
                det_grads=sd(det_grads), serving=serving, det=det, port=port)


def _tgt(case):
    g = case["gt"]
    return {"boxes": _t(g["boxes"]), "classes": _t(g["classes"]).long(), "mask": _t(g["mask"])}


def _forward_backward(case):
    port = case["port"]
    for p in port.modules.parameters():
        p.grad = None
    images = port.preprocess(_t(case["batch"]["image"]).float())
    pred = port.predict_train(images, _t(case["batch"]["true_shape"]), _tgt(case), case["draws"])
    losses = port.loss(pred, _tgt(case), case["draws"])
    losses["total_loss"].backward()
    return pred, losses


def _check_losses(losses, want):
    assert set(losses) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(losses[key].item(), w, rtol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def refine():
    return _pair(3, dict(ALL_TASKS, refine=True))


def test_refine_widens_the_box_predictor(refine):
    """2048 pooled + 1024 multi-object + 1024 closeness hidden, as mtlx's
    init builds it; the heads are held at eval too."""
    port = refine["port"]
    assert port.modules.refines and port.modules.box_predictor.in_features == 4096
    assert refine["variables"]["params"]["box_predictor"]["class_logits"]["kernel"].shape[0] == 4096
    assert port.dropout_shape(2) == (16, 4096)
    # refine needs the multi-object or the closeness head
    only_fg = tfr.FasterRCNN(tfr.FasterRCNNConfig(
        num_classes=3, canvas_size=(64, 64), dtype=torch.float32,
        mtl=tfr.MTLConfig(foreground=True, refine=True), **graft._TINY_KW), device="cpu")
    assert not only_fg.modules.refines and only_fg.modules.box_predictor.in_features == 2048


def test_refine_serving_equals_mtlx(refine):
    port, b = refine["port"], refine["batch"]
    shapes = _t(b["true_shape"])
    pred = port.predict(port.preprocess(_t(b["image"]).float()), shapes)
    det = port.postprocess(pred, shapes)
    js, jd = refine["serving"], refine["det"]
    np.testing.assert_array_equal(pred["proposal_mask"].numpy(), np.asarray(js["proposal_mask"]))
    _close(pred["class_predictions"].numpy(), js["class_predictions"])
    _close(pred["refined_box_encodings"].numpy(), js["refined_box_encodings"])
    np.testing.assert_array_equal(det["num_detections"].numpy(), np.asarray(jd["num_detections"]))
    np.testing.assert_array_equal(det["detection_classes"].numpy(),
                                  np.asarray(jd["detection_classes"]))
    _close(det["detection_boxes"].numpy(), jd["detection_boxes"])
    _close(det["detection_scores"].numpy(), jd["detection_scores"])
    assert int(det["num_detections"].sum()) > 0


def test_refine_second_stage_on_mtlx_proposals(refine):
    """The second stage alone, fed mtlx's serving features and proposals
    (the 7x7 mean pool of every proposal and the aux heads' hidden
    activations joined to the pooled features)."""
    js = refine["serving"]
    cls, box, _ = refine["port"]._predict_second_stage(_t(js["rpn_features"]),
                                                       _t(js["proposal_boxes"]), (64, 64))
    _close(cls.numpy(), js["class_predictions"])
    _close(box.numpy(), js["refined_box_encodings"])


def test_refine_train_step_losses_and_gradients(refine):
    pred, losses = _forward_backward(refine)
    np.testing.assert_array_equal(pred["proposal_mask"].numpy(), refine["pred"]["proposal_mask"])
    _check_losses(losses, refine["losses"])
    grads = {n: p.grad for n, p in refine["port"].modules.named_parameters()}
    assert set(grads) == set(refine["grads"])
    for name, g in grads.items():
        assert g is not None, name
        _close(g.numpy(), refine["grads"][name].numpy())


def test_detection_loss_reaches_the_aux_heads_through_refine(refine):
    """mtlx tests/test_faster_rcnn.py:212: the second-stage loss alone has
    a gradient in mo_head and cl_head, equal to jax.grad's."""
    port = refine["port"]
    for p in port.modules.parameters():
        p.grad = None
    images = port.preprocess(_t(refine["batch"]["image"]).float())
    pred = port.predict_train(images, _t(refine["batch"]["true_shape"]), _tgt(refine),
                              refine["draws"])
    sum(port._second_stage_loss(pred, _tgt(refine)).values()).backward()
    for name, p in port.modules.named_parameters():
        want = refine["det_grads"][name].numpy()
        if name.startswith(("mo_head.fc", "cl_head.fc", "mo_head.ln", "cl_head.ln")):
            assert float(np.abs(want).max()) > 0, name
        if p.grad is None:  # the heads the detection loss does not reach
            assert not want.any(), name
        else:
            _close(p.grad.numpy(), want)


def test_refine_train_step_through_make_train_step(refine):
    port = tfr.FasterRCNN(refine["port"].cfg, device="cpu")
    port.modules.load_state_dict(refine["port"].modules.state_dict())
    state = tts.create_train_state(port, tts.make_optimizer(learning_rate=0.01))
    b = {k: _t(v) for k, v in refine["batch"].items()}
    state, metrics = tts.make_train_step(port)(state, b, draws=refine["draws"])
    for key, want in refine["losses"].items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def dropout():
    return _pair(4, dict(ALL_TASKS, refine=True), second_stage_dropout=True,
                 second_stage_dropout_keep_prob=0.5)


def test_dropout_step_equals_mtlx(dropout):
    _, losses = _forward_backward(dropout)
    _check_losses(losses, dropout["losses"])
    for name, p in dropout["port"].modules.named_parameters():
        # a few of block4's ReLU inputs (of magnitude up to 500) lie within
        # float32 rounding of 0 and switch sides: the trunks' gradients
        # are held at 5e-3 (the port in float64 lies within 2.3e-6 of mtlx)
        trunk = name.startswith(("backbone.", "classifier_backbone."))
        _close(p.grad.numpy(), dropout["grads"][name].numpy(), rtol=5e-3 if trunk else 1e-4)
    # the draws drop: other uniforms give another loss
    other = dict(dropout["draws"], dropout=1.0 - dropout["draws"]["dropout"])
    _, changed = _forward_backward(dict(dropout, draws=other))
    assert abs(changed["total_loss"].item() - dropout["losses"]["total_loss"]) > 1e-3
    # make_draws draws them at the predictor's width
    draws = tts.make_draws(dropout["port"], 2, (64, 64), torch.Generator().manual_seed(0))
    assert draws["dropout"].shape == (16, 4096)
    # serving is deterministic: no draws needed
    port, b = dropout["port"], dropout["batch"]
    pred = port.predict(port.preprocess(_t(b["image"]).float()), _t(b["true_shape"]))
    _close(pred["class_predictions"].numpy(), dropout["serving"]["class_predictions"])


@pytest.fixture(scope="module")
def live_bn():
    return _pair(5, ALL_TASKS, batch_norm_trainable=True,
                 batch_norm_params=(0.9, 1e-3, True, True))


def test_live_batch_norm_step_equals_mtlx(live_bn):
    from mtlx_torch.backbones.resnet import live_batch_norms

    port = live_bn["port"]
    _, losses = _forward_backward(live_bn)
    _check_losses(losses, live_bn["losses"])
    norms = live_batch_norms(port.modules)
    trunk = [n for n in norms if n in set(live_batch_norms(port.modules.classifier_backbone))]
    assert trunk and len(norms) > len(trunk)
    assert all(n.batch_stats is not None for n in norms)  # both trunks ran in training mode
    for name, p in port.modules.named_parameters():
        trunk = name.startswith(("backbone.", "classifier_backbone."))
        _close(p.grad.numpy(), live_bn["grads"][name].numpy(), rtol=1e-2 if trunk else 1e-4)
    for norm in norms:
        norm.commit()
    want = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                     live_bn["stats"])})
    buffers = dict(port.modules.named_buffers())
    assert set(want) == set(buffers)
    for k, w in want.items():
        _close(buffers[k].numpy(), w.numpy())
    assert any(k.startswith("classifier_backbone.") for k in want)
    # eval reads the moving statistics and changes nothing
    before = {k: v.clone() for k, v in buffers.items()}
    b = live_bn["batch"]
    port.predict(port.preprocess(_t(b["image"]).float()), _t(b["true_shape"]))
    assert all(torch.equal(v, before[k]) for k, v in port.modules.named_buffers())


def test_live_batch_norm_train_step_commits_both_trunks(live_bn):
    port = tfr.FasterRCNN(live_bn["port"].cfg, device="cpu")
    port.modules.load_state_dict(live_bn["port"].modules.state_dict())
    before = {k: v.clone() for k, v in port.modules.named_buffers()}
    state = tts.create_train_state(port, tts.make_optimizer(learning_rate=0.01))
    b = {k: _t(v) for k, v in live_bn["batch"].items()}
    step = tts.make_train_step(port)
    step.warm_up(state, b, draws=live_bn["draws"])  # commits nothing
    assert all(torch.equal(v, before[k]) for k, v in port.modules.named_buffers())
    state, metrics = step(state, b, draws=live_bn["draws"])
    np.testing.assert_allclose(float(metrics["total_loss"]), live_bn["losses"]["total_loss"],
                               rtol=1e-4)
    for prefix in ("backbone.", "classifier_backbone."):
        assert any(not torch.equal(v, before[k]) for k, v in port.modules.named_buffers()
                   if k.startswith(prefix)), prefix


# ---- the hard example miner ----

_MINER_CASES = [
    dict(loss_type=t, max_negatives_per_positive=r, min_negatives_per_image=m,
         num_hard_examples=n, iou_threshold=0.5)
    for t in ("cls", "loc", "both") for (r, m, n) in ((0.0, 0, 6), (0.0, 0, 64), (2.0, 1, 8),
                                                      (1.0, 0, 64))
]


def _miner_inputs(seed, a=24):
    """Losses with ties (rounded, zeros) and boxes with duplicates and
    zero-area rows."""
    rs = np.random.RandomState(seed)
    y, x = rs.randint(0, 40, a), rs.randint(0, 40, a)
    boxes = np.stack([y, x, y + rs.randint(4, 24, a), x + rs.randint(4, 24, a)], 1).astype(
        np.float32)
    boxes[5] = boxes[2]
    boxes[9] = boxes[2]
    boxes[11] = [7, 7, 7, 20]  # zero area
    boxes[12] = [7, 7, 7, 20]
    cls = np.round(rs.uniform(0, 2, a), 1).astype(np.float32)
    cls[[3, 8, 15]] = 0.0
    cls[[5, 9]] = cls[2]
    loc = np.round(rs.uniform(0, 1, a), 1).astype(np.float32)
    loc[rs.uniform(size=a) < 0.5] = 0.0
    match = np.where(rs.uniform(size=a) < 0.35, rs.randint(0, 3, a), -1).astype(np.int32)
    return cls, loc, boxes, match


@pytest.mark.parametrize("case", _MINER_CASES,
                         ids=lambda c: f"{c['loss_type']}-cap{c['max_negatives_per_positive']}"
                                       f"-n{c['num_hard_examples']}")
def test_hard_example_mining_mask_equals_mtlx(case):
    jcfg = jlosses.HardExampleMinerConfig(**case)
    tcfg = tlosses.HardExampleMinerConfig(**case)
    assert tuple(jcfg) == tuple(tcfg)
    images = [_miner_inputs(s) for s in (0, 1, 2)]
    want = np.stack([np.asarray(jlosses.hard_example_mining_mask(
        jnp.asarray(c), jnp.asarray(lo), jnp.asarray(b), jnp.asarray(m), jcfg))
        for c, lo, b, m in images])
    got = tlosses.hard_example_mining_mask(*(_t(np.stack(x)) for x in zip(*images)), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("cap", [0.0, 3.0])
def test_miner_route(cap, monkeypatch):
    """Without a negatives cap the walk is one NMS call for the batch;
    with one it walks one IoU matrix an image, from one IoU call."""
    from mtlx_torch.geometry import box_ops
    from mtlx_torch.ops import nms as nms_lib

    calls = {"nms": 0, "iou": 0}
    nms, iou = nms_lib.batched_non_max_suppression, box_ops.iou

    def spy_nms(*a, **k):
        calls["nms"] += 1
        return nms(*a, **k)

    def spy_iou(*a, **k):
        calls["iou"] += 1
        return iou(*a, **k)

    monkeypatch.setattr(nms_lib, "batched_non_max_suppression", spy_nms)
    monkeypatch.setattr(box_ops, "iou", spy_iou)
    images = [_miner_inputs(s) for s in (0, 1)]
    tlosses.hard_example_mining_mask(*(_t(np.stack(x)) for x in zip(*images)),
                                     tlosses.HardExampleMinerConfig(max_negatives_per_positive=cap))
    assert calls == ({"nms": 1, "iou": 0} if cap == 0 else {"nms": 0, "iou": 1})


@pytest.mark.parametrize("case", [_MINER_CASES[i] for i in (1, 6, 11)],
                         ids=["cls-nocap", "loc-cap", "both-cap"])
def test_second_stage_loss_with_the_miner_equals_mtlx(refine, case):
    """On mtlx's training predictions: mtlx's normalisation (the kept
    ROIs' losses summed, over the proposal count)."""
    jcfg = dataclasses.replace(refine["jmodel"].cfg,
                               hard_example_miner=jlosses.HardExampleMinerConfig(**case))
    want = jfr.FasterRCNN(jcfg)._second_stage_loss(
        {k: jnp.asarray(v) for k, v in refine["pred"].items()}, refine["gt"])
    port = tfr.FasterRCNN(dataclasses.replace(
        refine["port"].cfg, hard_example_miner=tlosses.HardExampleMinerConfig(**case)),
        device="cpu")
    got = port._second_stage_loss({k: _t(v) for k, v in refine["pred"].items()}, _tgt(refine))
    plain = refine["port"]._second_stage_loss({k: _t(v) for k, v in refine["pred"].items()},
                                              _tgt(refine))
    for key, w in want.items():
        np.testing.assert_allclose(float(got[key]), float(w), rtol=1e-5, err_msg=key)
        assert float(got[key]) <= float(plain[key]) + 1e-7  # a subset, summed


# ---- the builder ----

_PIPELINE = """
model {{ faster_rcnn {{
  num_classes: 3
  image_resizer {{ fixed_shape_resizer {{ height: 64 width: 64 }} }}
  feature_extractor {{ type: 'faster_rcnn_resnet50' batch_norm_trainable: true
    batch_norm {{ decay: 0.9 epsilon: 0.001 center: true scale: true }} }}
  first_stage_anchor_generator {{ grid_anchor_generator {{
    scales: [0.5, 1.0] aspect_ratios: [1.0] height: 32 width: 32 }} }}
  first_stage_box_predictor_depth: 32
  first_stage_max_proposals: 8
  first_stage_minibatch_size: 16
  second_stage_batch_size: 4
  second_stage_box_predictor {{ mask_rcnn_box_predictor {{
    use_dropout: true dropout_keep_probability: 0.6 }} }}
  second_stage_post_processing {{
    batch_non_max_suppression {{ score_threshold: 0.0 iou_threshold: 0.6
      max_detections_per_class: 5 max_total_detections: 10 }}
    score_converter: SOFTMAX }}
  second_stage_localization_loss_weight: 2.0
  second_stage_classification_loss_weight: 1.5
  hard_example_miner {{ num_hard_examples: 3 iou_threshold: 0.7 loss_type: BOTH
    max_negatives_per_positive: {cap} min_negatives_per_image: 1 }}
  mtl {{ window: true closeness: true edgemask: true refine: true
    window_loss_weight: 0.3 closeness_loss_weight: 0.3 edgemask_loss_weight: 0.5 }}
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
eval_config {{ num_examples: 2 num_visualizations: 2 metrics_set: "pascal_voc_detection_metrics"
  visualization_export_dir: "{viz_dir}" }}
eval_input_reader {{ tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}" shuffle: false }}
"""


def _pipeline(tmp_path, cap=0):
    text = _PIPELINE.replace("{cap}", str(cap)).replace("{viz_dir}",
                                                          str(tmp_path / "viz"))
    return write_cli_workdir(tmp_path, text)


def test_refine_pipeline_builds_mtlx_config_and_tree(tmp_path):
    from mtlx.builders import model_builder as jbuilder
    from mtlx.config import config_util as jconfig
    from mtlx_torch.builders import model_builder as tbuilder
    from mtlx_torch.config import config_util as tconfig

    path = _pipeline(tmp_path)
    for training in (False, True):
        ref = jbuilder.build(jconfig.get_configs_from_pipeline_file(path)["model"],
                             is_training=training)
        model = tbuilder.build(tconfig.get_configs_from_pipeline_file(path)["model"],
                               is_training=training, device="cpu")
        c = model.cfg
        assert [f.name for f in dataclasses.fields(c)] == [
            f.name for f in dataclasses.fields(ref.cfg)]
        for f in dataclasses.fields(c):
            g, w = getattr(c, f.name), getattr(ref.cfg, f.name)
            if f.name == "dtype":
                assert jnp.dtype(w).name == str(g).split(".")[-1]
            elif f.name == "mtl":
                assert dataclasses.asdict(g) == dataclasses.asdict(w)
            else:
                assert g == w, f.name
        assert c.mtl.refines and c.batch_norm_trainable
        assert c.second_stage_dropout == training
        assert c.hard_example_miner == tlosses.HardExampleMinerConfig(
            3, np.float32(0.7).item(), "both", 1.5, 2.0, 0.0, 1)
        shapes = jax.eval_shape(ref.modules.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))
        # a refine model holds the aux heads at eval too: the bridge maps them
        tree = flax_to_state_dict(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes), training_heads=True)
        want = {k: tuple(v.shape) for k, v in model.modules.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in tree.items()} == want
        assert want["box_predictor.class_logits.weight"] == (4, 2048 + 1024 + 1024)
        assert any(k.startswith("mo_head.") for k in want) and "fg_head.conv.weight" in want
        assert any(k.startswith("classifier_backbone.") and k.endswith(".var") for k in want)


def test_rfcn_refuses_the_miner_in_training():
    from mtlx_torch.builders import model_builder as tbuilder
    from mtlx_torch.config import config_util as tconfig
    from test_torch_rfcn import _PIPELINE as RFCN_PIPELINE

    text = RFCN_PIPELINE.replace(
        "  second_stage_batch_size: 4\n",
        "  second_stage_batch_size: 4\n  hard_example_miner { num_hard_examples: 3 }\n")
    text = text.replace("{{", "{").replace("}}", "}")
    model = tconfig.parse_pipeline_text(text).model
    assert tbuilder.build_config(model, is_training=False).hard_example_miner is None
    with pytest.raises(ValueError, match="R-FCN"):
        tbuilder.build_config(model, is_training=True)


# ---- the CLIs ----

def test_cli_refine_with_the_training_options(tmp_path, capsys):
    """The train CLI (refine, dropout, live batch norm, the miner with a
    negatives cap), a restart, the eval CLI with its visualizations, the
    export CLI and the bundle served from every input type: the bundle
    holds the aux heads and `refine: true`."""
    import io

    from PIL import Image

    from mtlx_torch.config import config_util as tconfig
    from mtlx_torch.data import imgcodec
    from mtlx_torch.data.example_decoder import build_example
    from mtlx_torch.utils.summary_writer import read_events

    config = _pipeline(tmp_path, cap=2)
    _, served, det = run_cli_chain(tmp_path, config, capsys)
    state = served.model.modules.state_dict()
    assert served.model.modules.refines and any(k.startswith("cl_head.") for k in state)
    assert tconfig.parse_pipeline_text(served.pipeline_text).model.faster_rcnn.mtl.refine
    # the eval CLI drew num_visualizations images into its event file and PNGs
    events = [e for name in os.listdir(tmp_path / "eval") if name.startswith("events.")
              for e in read_events(str(tmp_path / "eval" / name))]
    images = {tag: v for e in events for tag, v in e.get("values", []) if isinstance(v, tuple)}
    assert sorted(images) == [f"Detections_Left_Groundtruth_Right/{i}" for i in range(2)]
    for i in range(2):
        h, w, png = images[f"Detections_Left_Groundtruth_Right/{i}"]
        assert (h, w) == (64, 128)
        with open(tmp_path / "viz" / f"export-2-{i}.png", "rb") as f:
            assert np.array_equal(imgcodec.decode_png(f.read()), imgcodec.decode_png(png))
    # every input type serves the refine bundle alike
    arr = np.random.RandomState(5).randint(0, 255, (64, 64, 3), dtype=np.uint8)
    want = served.predict_images([arr])
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    jpeg_arr = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    png = imgcodec.encode_png(arr)
    example = build_example(png, b"png", 64, 64, "x.png", np.zeros((0, 4), np.float32), [], [])
    for got in (served.predict_encoded_images([png]), served.predict_tf_examples([example]),
                served.predict_image_tensor(arr[None])):
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    got = served.predict_encoded_images([buf.getvalue()])
    np.testing.assert_array_equal(got["num_detections"],
                                  served.predict_images([jpeg_arr])["num_detections"])
