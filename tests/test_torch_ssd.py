"""The SSD family of the port (mtlx_torch/detector/ssd.py and its modules)
against mtlx on the CPU in float32:

  * MobileNet-v1 at depth multiplier 0.25 on 64x64 and 75x75 images (the
    odd sizes take the stride-2 SAME pads' extra pixel after), the feature
    pyramid on random endpoints, the convolutional box predictor (with its
    1x1 layers and sigmoid, the NHWC anchor order) and a whole tiny SSD's
    serving outputs: allclose, rtol 1e-4 with an atol of 1e-4 times the
    largest magnitude (convolution sums in another order), from mtlx's
    variables carried over by the bridge (seeded numpy values);
  * the multi-grid anchors exactly (1917 at 300x300), the IoA and
    negative-squared-distance similarities, the sigmoid loss with class
    indices, the exact canvas of a fixed-shape resizer (300x300 -> 300x300
    for SSD, 320x320 otherwise), the matches of the assignment and the
    hard-negative picks (with ties) index-exact, the postprocess's NMS
    selections index-exact;
  * one tiny SSD train step with live batch norm, RMSProp and the moving
    average of the weights against mtlx's jitted step: the losses within
    1e-4 relative, the parameters, the moving statistics and the moving
    average after the step within 5e-4 of each tensor's largest magnitude,
    and every gradient within 2e-2 of its leaf's largest magnitude of
    jax.grad's. The gradients' tolerance is mtlx's float32 rounding: the
    offsets and scales of a batch norm whose output feeds another batch
    norm get a gradient that is a nearly cancelling sum, which mtlx's
    float32 reduction lands about 1e-2 of the leaf's largest magnitude
    off the float64 result; the test also holds the port's float32
    gradients within 5e-4 of its own float64 ones on the same input;
  * both SSD configs built by both builders to the same config and the
    same parameter tree, in eval and in training, with the same
    regularization scopes, optimizer (RMSProp, its schedule, the moving
    average's decay), augmentations and evaluators;
  * the train, eval and export CLIs and InferenceModel with --device cpu
    on 64x64 pipelines of both trunks, with ssd_random_crop, RMSProp and
    the moving average in training and use_moving_averages in eval.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx_torch.bridge import flax_to_state_dict
from test_torch_live_bn import TINY_SSD, ssd_batch
from test_torch_rfcn import run_cli_chain, seeded_variables, write_cli_workdir


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("ssd_mobilenet_v1_voc", "ssd_inception_v2_voc")


def _close(got, want, rtol=1e-4):
    """allclose at rtol, with an atol of rtol times the largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _sub_state(variables):
    """A module's own state_dict from its flax variables (the bridge maps
    top-level modules; wrap under a known one and strip it)."""
    tree = {c: {"backbone": v} for c, v in variables.items()}
    return {k.split(".", 1)[1]: v for k, v in flax_to_state_dict(tree).items()}


@pytest.mark.parametrize("hw", [64, 75])
def test_mobilenet_matches_mtlx(hw):
    from mtlx.backbones.mobilenet import MobileNetV1 as JMobileNetV1
    from mtlx_torch.backbones.mobilenet import MobileNetV1

    jmod = JMobileNetV1(0.25, 8, dtype=jnp.float32)
    variables = seeded_variables(jmod.init, hw, jnp.zeros((1, hw, hw, 3)))
    x = np.random.RandomState(hw).uniform(-1, 1, (2, hw, hw, 3)).astype(np.float32)
    want = jmod.apply(variables, jnp.asarray(x))
    port = MobileNetV1(0.25, 8, torch.float32)
    port.load_state_dict(_sub_state(variables))
    got = port(torch.from_numpy(x))
    assert port.out_channels == [128, 256]
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert got[0].shape[1] == -(-hw // 16)  # 64 -> 4, 75 -> 38 -> 19 -> 10 -> 5
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)


def test_feature_maps_match_mtlx():
    from mtlx.backbones.feature_maps import MultiResolutionFeatureMaps as JMaps
    from mtlx.backbones.feature_maps import ssd_layer_depths as jdepths
    from mtlx_torch.backbones.feature_maps import MultiResolutionFeatureMaps, ssd_layer_depths

    assert ssd_layer_depths(6) == jdepths(6) == [-1, -1, 512, 256, 256, 128]
    assert ssd_layer_depths(4) == jdepths(4)
    rs = np.random.RandomState(0)
    ends = [rs.normal(0, 1, (2, 5, 5, 24)).astype(np.float32),
            rs.normal(0, 1, (2, 3, 3, 40)).astype(np.float32)]
    jmod = JMaps(layer_depths=tuple(jdepths(6)), depth_multiplier=0.25, min_depth=16,
                 dtype=jnp.float32)
    variables = seeded_variables(jmod.init, 1, [jnp.asarray(e) for e in ends])
    want = jmod.apply(variables, [jnp.asarray(e) for e in ends])
    port = MultiResolutionFeatureMaps([24, 40], ssd_layer_depths(6), 0.25, 16,
                                      dtype=torch.float32)
    port.load_state_dict(_sub_state(variables))
    got = port([torch.from_numpy(e) for e in ends])
    assert port.out_channels == [24, 40, 128, 64, 64, 32]
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)


@pytest.mark.parametrize("kw", [
    dict(), dict(num_layers=4, min_scale=0.2, max_scale=0.8, aspect_ratios=(1.0, 2.0, 0.5)),
    dict(reduce_boxes_in_lowest_layer=False, interpolated_scale_aspect_ratio=0.0),
    dict(scales=(0.1, 0.3, 0.5, 0.7, 0.8, 0.9)),
])
def test_multi_grid_anchors_match_mtlx_exactly(kw):
    from mtlx.anchors.multi_grid import create_ssd_anchors as jcreate
    from mtlx.detector.ssd import SSD as JSSD
    from mtlx_torch.anchors.multi_grid import create_ssd_anchors
    from mtlx_torch.detector.ssd import SSD

    shapes = SSD._feature_shapes((300, 300), kw.get("num_layers", 6))
    assert shapes == JSSD._feature_shapes((300, 300), kw.get("num_layers", 6))
    gen, jgen = create_ssd_anchors(**kw), jcreate(**kw)
    assert gen.num_anchors_per_location == jgen.num_anchors_per_location
    got, want = gen.generate(shapes).numpy(), np.asarray(jgen.generate(shapes))
    np.testing.assert_array_equal(got, want)
    if not kw:
        assert shapes == [(19, 19), (10, 10), (5, 5), (3, 3), (2, 2), (1, 1)]
        assert got.shape == (1917, 4)


def test_conv_box_predictor_matches_mtlx():
    from mtlx.heads.box_predictors import ConvolutionalBoxPredictor as JPredictor
    from mtlx_torch.heads.box_predictors import ConvolutionalBoxPredictor

    feats = np.random.RandomState(2).normal(0, 1, (2, 5, 4, 12)).astype(np.float32)
    for kw in (dict(), dict(min_depth=8, max_depth=16, num_layers_before_predictor=2,
                            apply_sigmoid_to_scores=True, kernel_size=1)):
        jmod = JPredictor(num_classes=3, num_anchors_per_location=6, dtype=jnp.float32, **kw)
        variables = seeded_variables(jmod.init, 4, jnp.asarray(feats))
        wc, wb = jmod.apply(variables, jnp.asarray(feats))
        port = ConvolutionalBoxPredictor(12, 3, 6, dtype=torch.float32, **kw)
        port.load_state_dict(_sub_state(variables))
        gc, gb = port(torch.from_numpy(feats))
        assert gc.shape == (2, 5 * 4 * 6, 4) and gb.shape == (2, 5 * 4 * 6, 4)
        _close(gc.detach().numpy(), wc)
        _close(gb.detach().numpy(), wb)
    # the anchor index is fastest, then x, then y: anchor a of cell (y, x)
    # is row (y * W + x) * A + a, as the multi-grid anchors are laid out
    port = ConvolutionalBoxPredictor(12, 3, 6, dtype=torch.float32, kernel_size=1)
    with torch.no_grad():
        out = port.box_encoder(torch.from_numpy(feats).permute(0, 3, 1, 2))
    _, box = port(torch.from_numpy(feats))
    y, x, a = 3, 2, 5
    assert torch.equal(box[1, (y * 4 + x) * 6 + a], out[1, 4 * a:4 * a + 4, y, x])


def test_similarities_and_sigmoid_loss_match_mtlx():
    from mtlx.assign import similarity as jsim
    from mtlx.losses import losses as jlosses
    from mtlx_torch.assign import similarity as tsim
    from mtlx_torch.losses import losses as tlosses

    rs = np.random.RandomState(0)
    a = np.sort(rs.uniform(0, 1, (2, 5, 4)), axis=-1).astype(np.float32)[..., [0, 1, 2, 3]]
    a = np.stack([a[..., 0], a[..., 1], a[..., 0] + 0.3, a[..., 1] + 0.2], -1)
    b = np.stack([a[:, :3, 0] - 0.1, a[:, :3, 1], a[:, :3, 2], a[:, :3, 3] + 0.1], -1)
    b[0, 2] = 0  # a zero-area row
    for name in ("ioa_similarity", "neg_sq_dist_similarity", "iou_similarity"):
        got = getattr(tsim, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jsim, name)(a, b)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    logits = rs.normal(0, 2, (2, 7, 4)).astype(np.float32)
    targets = (rs.uniform(0, 1, (2, 7, 4)) < 0.3).astype(np.float32)
    weights = rs.uniform(0, 1, (2, 7)).astype(np.float32)
    for idx in (None, np.array([0, 2])):
        got = tlosses.weighted_sigmoid_classification_loss(
            torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(weights),
            None if idx is None else torch.from_numpy(idx)).numpy()
        want = jlosses.weighted_sigmoid_classification_loss(logits, targets, weights, idx)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("resizer,exact", [
    ("fixed_shape_resizer { height: 300 width: 300 }", True),
    ("fixed_shape_resizer { height: 300 width: 300 }", False),
    ("fixed_shape_resizer { height: 75 width: 130 }", True),
    ("keep_aspect_ratio_resizer { min_dimension: 96 max_dimension: 160 }", True),
])
def test_canvas_from_resizer_matches_mtlx(resizer, exact):
    from google.protobuf import text_format as pb_text_format
    from mtlx.builders.model_builder import canvas_from_resizer as jcanvas
    from mtlx.config.protos import pipeline_pb2
    from mtlx_torch.builders.model_builder import canvas_from_resizer
    from mtlx_torch.config import config_util

    text = f"model {{ ssd {{ image_resizer {{ {resizer} }} }} }}"
    ours = config_util.parse_pipeline_text(text).model.ssd.image_resizer
    theirs = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig()).model.ssd
    got = canvas_from_resizer(ours, 16, exact_fixed_shape=exact)
    assert got == jcanvas(theirs.image_resizer, 16, exact_fixed_shape=exact)
    if resizer.startswith("fixed_shape_resizer { height: 300"):
        assert got == ((300, 300) if exact else (320, 320))


def test_hard_negative_mining_matches_mtlx_with_ties():
    from mtlx_torch.detector.ssd import mine_hard_negatives

    rs = np.random.RandomState(0)
    losses = np.round(rs.uniform(0, 2, (3, 40)), 1).astype(np.float32)  # many ties
    neg = rs.uniform(0, 1, (3, 40)) < 0.8
    matches = np.asarray([2.0, 0.0, 9.0], np.float32)

    def mtlx_rule(per_anchor_cls, neg_mask, num_matches):  # mtlx's SSD.loss, per image
        num_neg = jnp.minimum(jnp.maximum(3.0 * num_matches, 3.0),
                              jnp.sum(neg_mask.astype(jnp.float32)))
        neg_losses = jnp.where(neg_mask, per_anchor_cls, -jnp.inf)
        ranks = jnp.argsort(jnp.argsort(-neg_losses))
        return neg_mask & (ranks < num_neg)

    want = jax.vmap(mtlx_rule)(losses, neg, matches)
    got = mine_hard_negatives(torch.from_numpy(losses), torch.from_numpy(neg),
                              torch.from_numpy(matches), 3.0, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum(-1).tolist() == [6, 3, min(27, int(neg[2].sum()))]
    every = mine_hard_negatives(torch.from_numpy(losses), torch.from_numpy(neg),
                                torch.from_numpy(matches), 0.0, 0)
    assert torch.equal(every, torch.from_numpy(neg))


@pytest.fixture(scope="module")
def tiny():
    """A tiny SSD (MobileNet x 0.25, 4 maps, live batch norm) on both
    sides with seeded weights, and mtlx's jitted train step with RMSProp
    and the moving average."""
    from google.protobuf import text_format as pb_text_format
    from mtlx.builders import optimizer_builder as jopt
    from mtlx.config.protos import pipeline_pb2
    from mtlx.detector.ssd import SSD as JSSD, SSDConfig as JSSDConfig
    from mtlx.train import train_step as jts

    jmodel = JSSD(JSSDConfig(dtype=jnp.float32, **TINY_SSD))
    variables = seeded_variables(jmodel.modules.init, 5, jnp.zeros((1, 64, 64, 3)))
    batch = ssd_batch()
    text = ("train_config { optimizer { rms_prop_optimizer { learning_rate { "
            "exponential_decay_learning_rate { initial_learning_rate: 0.004 decay_steps: 10 "
            "decay_factor: 0.95 } } momentum_optimizer_value: 0.9 decay: 0.9 epsilon: 1.0 } "
            "moving_average_decay: 0.99 } gradient_clipping_by_norm: 100.0 }")
    train_config = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig()).train_config
    tx, _, decay = jopt.build(train_config.optimizer, train_config)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx,
                           ema_params=jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    new_state, jmetrics = jax.jit(jts.make_train_step(jmodel, ema_decay=decay))(
        state, batch, jax.random.PRNGKey(0))
    images = jmodel.preprocess(jnp.asarray(batch["image"], jnp.float32))
    gt = {"boxes": jnp.asarray(batch["gt_boxes"]), "classes": jnp.asarray(batch["gt_classes"]),
          "mask": jnp.asarray(batch["gt_mask"])}

    def loss_fn(params):
        pred = jmodel.predict({"params": params, "batch_stats": variables["batch_stats"]},
                              images, training=True)
        return jmodel.loss(pred, gt)["total_loss"]

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(
        jmodel=jmodel, variables=variables, batch=batch, text=text, decay=decay,
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        jgrads=flax_to_state_dict({"params": np_tree(grads)}),
        jnew=flax_to_state_dict({"params": np_tree(new_state.params),
                                 "batch_stats": np_tree(new_state.batch_stats)}),
        jema=flax_to_state_dict({"params": np_tree(new_state.ema_params)}),
    )


def _port(tiny, dtype=torch.float32):
    from mtlx_torch.detector.ssd import SSD, SSDConfig

    model = SSD(SSDConfig(dtype=dtype, **TINY_SSD), device="cpu")
    model.modules.load_state_dict(flax_to_state_dict(tiny["variables"]))
    model.modules.to(dtype)
    return model


def test_serving_predict_and_postprocess_match_mtlx(tiny, monkeypatch):
    from mtlx_torch.kernels import nms_cuda

    port, jm = _port(tiny), tiny["jmodel"]
    images = tiny["batch"]["image"].astype(np.float32)
    shapes = np.asarray([[64, 64], [50, 40], [64, 30], [20, 64]], np.int32)
    jpred = jm.predict(tiny["variables"], jm.preprocess(jnp.asarray(images)))
    jdet = jm.postprocess(jpred, jnp.asarray(shapes))
    calls = []
    plain = nms_cuda.non_max_suppression
    monkeypatch.setattr(nms_cuda, "non_max_suppression",
                        lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))
    pred = port.predict(port.preprocess(torch.from_numpy(images)))
    det = port.postprocess(pred, torch.from_numpy(shapes))
    assert calls == [(4 * 3, pred["anchors"].shape[0], 4)]  # every class of every image
    for k in ("class_predictions_with_background", "box_encodings"):
        _close(pred[k].numpy(), jpred[k])
    np.testing.assert_array_equal(pred["anchors"].numpy(), np.asarray(jpred["anchors"]))
    np.testing.assert_array_equal(det["num_detections"].numpy(), jdet["num_detections"])
    np.testing.assert_array_equal(det["detection_classes"].numpy(), jdet["detection_classes"])
    _close(det["detection_scores"].numpy(), jdet["detection_scores"])
    _close(det["detection_boxes"].numpy(), jdet["detection_boxes"])
    assert float(det["detection_boxes"].max()) <= 1.0
    # training-mode predict is the train entry; the canvas is fixed
    with pytest.raises(NotImplementedError):
        port.predict(torch.zeros(1, 64, 64, 3), training=True)
    with pytest.raises(ValueError, match="whole canvas"):
        port.predict(torch.zeros(1, 64, 32, 3))


def test_assignment_is_one_similarity_call_and_matches_mtlx(tiny, monkeypatch):
    from mtlx.assign import matcher as jmatcher

    port, jm = _port(tiny), tiny["jmodel"]
    b = tiny["batch"]
    gt = jm._normalize_gt(jnp.asarray(b["gt_boxes"]))
    onehot = jax.nn.one_hot(jnp.asarray(b["gt_classes"]) + 1, 4)
    want = jax.vmap(lambda g, o, m: jm._assigner.assign(
        jm.anchors, g, gt_labels=o, gt_mask=m, unmatched_cls_target=jax.nn.one_hot(0, 4)).match)(
        gt, onehot, jnp.asarray(b["gt_mask"]))
    calls = []
    sim = port._assigner.similarity_fn
    port._assigner = port._assigner._replace(
        similarity_fn=lambda g, a: calls.append(g.shape) or sim(g, a))
    seen = {}
    matcher = port._assigner.matcher_fn
    port._assigner = port._assigner._replace(
        matcher_fn=lambda s, **k: seen.setdefault("match", matcher(s, **k)))
    pred = port.predict(port.preprocess(torch.from_numpy(b["image"]).float()))
    port.loss(dict(pred), {"boxes": torch.from_numpy(b["gt_boxes"]),
                           "classes": torch.from_numpy(b["gt_classes"]),
                           "mask": torch.from_numpy(b["gt_mask"])})
    assert calls == [(4, 3, 4)]  # the whole batch's ground truth in one call
    np.testing.assert_array_equal(seen["match"].numpy(), np.asarray(want))
    assert int((seen["match"] >= 0).sum()) > 0 and jmatcher.UNMATCHED == -1


def test_train_step_matches_mtlx(tiny):
    from mtlx_torch.builders import optimizer_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.train import train_step as tts

    port = _port(tiny)
    b = {k: torch.from_numpy(v) for k, v in tiny["batch"].items()}
    # gradients, against jax.grad and against the port's own float64
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = _port(tiny, dtype)
        pred = model.predict_train(model.preprocess(b["image"].to(dtype)), b["true_shape"], {})
        loss = model.loss(pred, {"boxes": b["gt_boxes"].to(dtype), "classes": b["gt_classes"],
                                 "mask": b["gt_mask"]})["total_loss"]
        loss.backward()
        grads[dtype] = {n: p.grad.double().numpy() for n, p in model.modules.named_parameters()}
    for n, w in tiny["jgrads"].items():
        w = w.numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(grads[torch.float32][n] - w).max() <= 2e-2 * scale, n
        assert np.abs(grads[torch.float32][n] - grads[torch.float64][n]).max() <= 5e-4 * scale, n

    train_config = config_util.parse_pipeline_text(tiny["text"]).train_config
    tx, _, decay = optimizer_builder.build(train_config.optimizer, train_config)
    assert decay == pytest.approx(tiny["decay"]) and tx.kind == "rmsprop"
    state = tts.create_train_state(port, tx, keep_ema=True)
    state, metrics = tts.make_train_step(port, ema_decay=decay)(state, b)
    for k, w in tiny["jmetrics"].items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=1e-4, err_msg=k)
    after = port.modules.state_dict()
    for name, want in tiny["jnew"].items():
        tol = 1e-4 if name.endswith((".mean", ".var")) else 5e-4
        _close(after[name].numpy(), want.numpy(), rtol=tol)
    for name, want in tiny["jema"].items():
        _close(state.ema[name].numpy(), want.numpy(), rtol=5e-4)
    assert state.opt_state.count == 1 and state.opt_state.nu is not None


def test_faster_rcnn_live_batch_norm_training_raises():
    """Live batch norm in a Faster R-CNN's training no longer raises
    NotImplementedError (it is ported; tests/test_torch_refine.py holds it
    to mtlx): a training forward runs both trunks on the batch's
    statistics. What still raises is a training forward without its
    draws."""
    from mtlx_torch.backbones.resnet import live_batch_norms
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig
    from mtlx_torch.train.train_step import make_draws

    cfg = FasterRCNNConfig(num_classes=2, canvas_size=(64, 64), backbone="resnet10",
                           batch_norm_trainable=True, dtype=torch.float32)
    model = FasterRCNN(cfg, device="cpu")  # serving reads the moving statistics
    images, shapes = torch.zeros(1, 64, 64, 3), torch.tensor([[64, 64]])
    with pytest.raises(KeyError, match="proposal_pos"):
        model.predict_train(images, shapes, {}, {})
    gt = {"boxes": torch.tensor([[[8.0, 8.0, 40.0, 40.0]]]), "classes": torch.tensor([[1]]),
          "mask": torch.tensor([[True]])}
    norms = live_batch_norms(model.modules)
    for norm in norms:
        norm.batch_stats = None
    model.predict_train(images, shapes, gt,
                        make_draws(model, 1, (64, 64), torch.Generator().manual_seed(0)))
    assert all(norm.batch_stats is not None for norm in norms)
    assert live_batch_norms(model.modules.classifier_backbone)


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build_equal_to_mtlx(name):
    from mtlx.builders import model_builder as jbuilder
    from mtlx.builders import optimizer_builder as jopt
    from mtlx.builders import preprocessor_builder as jprep
    from mtlx.config import config_util as jconfig
    from mtlx.eval import eval as jeval
    from mtlx_torch.builders import model_builder as tbuilder
    from mtlx_torch.builders import optimizer_builder as topt
    from mtlx_torch.builders import preprocessor_builder as tprep
    from mtlx_torch.config import config_util as tconfig
    from mtlx_torch.eval import eval as teval

    path = os.path.join(_REPO, "configs", f"{name}.config")
    ours, theirs = (tconfig.get_configs_from_pipeline_file(path),
                    jconfig.get_configs_from_pipeline_file(path))
    for training in (False, True):
        ref = jbuilder.build(theirs["model"], is_training=training)
        model = tbuilder.build(ours["model"], is_training=training, device="cpu")
        assert type(model).__name__ == type(ref).__name__ == "SSD"
        got, want = dataclasses.asdict(model.cfg), dataclasses.asdict(ref.cfg)
        assert str(got.pop("dtype")).split(".")[-1] == jnp.dtype(want.pop("dtype")).name
        assert got == want
        assert model.cfg.canvas_size == (300, 300)
        assert model.cfg.batch_norm_trainable == training
        np.testing.assert_array_equal(model.anchors.numpy(), np.asarray(ref.anchors))
        assert model.anchors.shape == (1917, 4)
        shapes = jax.eval_shape(ref.modules.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 300, 300, 3)))
        tree = flax_to_state_dict(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        assert {k: tuple(v.shape) for k, v in tree.items()} == \
            {k: tuple(v.shape) for k, v in model.modules.state_dict().items()}
    assert tbuilder.regularization_scopes(ours["model"]) == \
        jbuilder.regularization_scopes(theirs["model"])
    tc, jc = ours["train_config"], theirs["train_config"]
    tx, lr, decay = topt.build(tc.optimizer, tc)
    jtx, jlr, jdecay = jopt.build(jc.optimizer, jc)
    assert (tx.kind, tx.momentum, tx.decay) == ("rmsprop", pytest.approx(0.9), pytest.approx(0.9))
    assert tx.epsilon == 1.0 and decay == jdecay == pytest.approx(0.9999)
    for count in (0, 1, 800720, 2000000):
        assert np.float32(lr(count)) == np.float32(jlr(count)), count
    assert tprep.build(tc.data_augmentation_options) == \
        jprep.build(jc.data_augmentation_options)
    assert [n for n, _ in tprep.build(tc.data_augmentation_options)] == \
        ["random_horizontal_flip", "ssd_random_crop"]
    categories = [{"id": i + 1, "name": f"c{i}"} for i in range(20)]
    assert [type(e).__name__ for e in teval.build_evaluators(ours["eval_config"], categories)] \
        == [type(e).__name__ for e in jeval.build_evaluators(theirs["eval_config"], categories)]


_SSD_PIPELINE = """
model {{ ssd {{
  num_classes: 3
  image_resizer {{ fixed_shape_resizer {{ height: 64 width: 64 }} }}
  feature_extractor {{ type: 'EXTRACTOR' depth_multiplier: 1.0 min_depth: 16
    conv_hyperparams {{ regularizer {{ l2_regularizer {{ weight: 0.00004 }} }}
      batch_norm {{ train: true decay: 0.9997 center: true scale: true epsilon: 0.001 }} }} }}
  box_coder {{ faster_rcnn_box_coder {{ y_scale: 10.0 x_scale: 10.0 height_scale: 5.0
    width_scale: 5.0 }} }}
  matcher {{ argmax_matcher {{ matched_threshold: 0.5 unmatched_threshold: 0.5 }} }}
  similarity_calculator {{ iou_similarity {{ }} }}
  anchor_generator {{ ssd_anchor_generator {{ num_layers: 6 min_scale: 0.2 max_scale: 0.95
    aspect_ratios: 1.0 aspect_ratios: 2.0 aspect_ratios: 0.5 aspect_ratios: 3.0
    aspect_ratios: 0.3333 }} }}
  box_predictor {{ convolutional_box_predictor {{ kernel_size: 3 box_code_size: 4 use_dropout: false
    conv_hyperparams {{ regularizer {{ l2_regularizer {{ weight: 0.00004 }} }} }} }} }}
  loss {{ classification_loss {{ weighted_sigmoid {{ }} }}
    localization_loss {{ weighted_smooth_l1 {{ }} }}
    hard_example_miner {{ num_hard_examples: 3000 iou_threshold: 0.99 loss_type: CLASSIFICATION
      max_negatives_per_positive: 3 min_negatives_per_image: 3 }}
    classification_weight: 1.0 localization_weight: 1.0 }}
  normalize_loss_by_num_matches: true
  post_processing {{ batch_non_max_suppression {{ score_threshold: 1e-8 iou_threshold: 0.6
    max_detections_per_class: 10 max_total_detections: 10 }} score_converter: SIGMOID }}
}} }}
train_config {{
  batch_size: 2
  optimizer {{ rms_prop_optimizer {{ learning_rate {{ exponential_decay_learning_rate {{
    initial_learning_rate: 0.004 decay_steps: 800720 decay_factor: 0.95 }} }}
    momentum_optimizer_value: 0.9 decay: 0.9 epsilon: 1.0 }} }}
  data_augmentation_options {{ random_horizontal_flip {{ }} }}
  data_augmentation_options {{ ssd_random_crop {{ }} }}
  num_steps: 2
  save_checkpoints_steps: 1
  max_number_of_boxes: 8
}}
train_input_reader {{ tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}" }}
eval_config {{ num_examples: 2 use_moving_averages: true }}
eval_input_reader {{ tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}" shuffle: false }}
"""


@pytest.mark.parametrize("extractor", ["ssd_mobilenet_v1", "ssd_inception_v2"])
def test_cli_train_resume_eval_export_serve(extractor, tmp_path, capsys):
    from mtlx_torch.detector.ssd import SSD
    from mtlx_torch.train import checkpoints as ckpt_lib

    config = write_cli_workdir(tmp_path, _SSD_PIPELINE.replace("EXTRACTOR", extractor))
    train_dir = tmp_path / "train"
    seen = {}
    restore = ckpt_lib.CheckpointManager.restore

    def spy(self, state, step=None, params_only=False, use_ema=False):
        out = restore(self, state, step, params_only, use_ema)
        if params_only:  # eval and export read the moving average
            seen.setdefault("ema", []).append(use_ema)
        else:
            seen["ema_kept"] = out.ema is not None and out.opt_state.nu is not None
        return out

    ckpt_lib.CheckpointManager.restore = spy
    try:
        metrics, served, det = run_cli_chain(tmp_path, config, capsys)
    finally:
        ckpt_lib.CheckpointManager.restore = restore
    assert not train_dir.exists()  # the chain removed its checkpoints
    assert seen == {"ema_kept": True, "ema": [True, True]}
    assert isinstance(served.model, SSD) and served.model.cfg.feature_extractor == extractor
    assert det["detection_boxes"].shape == (1, 10, 4)
    assert np.isfinite(metrics["Precision/mAP@0.5IOU"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_box_predictor_dropout_is_flax_dropout(dtype):
    """Training dropout drops the class branch's input where the uniform
    draw is not below keep_prob and divides the rest by keep_prob in the
    compute type, as flax's nn.Dropout does with bernoulli(keep_prob) =
    uniform < keep_prob; the box branch and eval are untouched."""
    import flax.linen as nn

    from mtlx_torch.heads.box_predictors import ConvolutionalBoxPredictor

    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    rs = np.random.RandomState(0)
    feats = rs.normal(0, 1, (2, 3, 4, 8)).astype(np.float32)
    u = rs.uniform(0, 1, (2, 3, 4, 8)).astype(np.float32)
    port = ConvolutionalBoxPredictor(8, 2, 3, kernel_size=1, use_dropout=True,
                                     dropout_keep_prob=0.8, dtype=tdt).eval()
    eval_cls, eval_box = port(torch.from_numpy(feats))
    port.train()
    cls, box = port(torch.from_numpy(feats), torch.from_numpy(u))
    assert torch.equal(box, eval_box) and not torch.equal(cls, eval_cls)
    # flax's dropout of the same features with the same keep decisions
    rate = 1.0 - 0.8
    x = jnp.asarray(feats, jdt)
    want = jax.lax.select(jnp.asarray(u) < 1.0 - rate, x / (1.0 - rate), jnp.zeros_like(x))
    dropped = nn.Dropout(rate, deterministic=False).apply(
        {}, x, rngs={"dropout": jax.random.PRNGKey(0)})
    kept = np.asarray(dropped) != 0
    np.testing.assert_array_equal(np.asarray(dropped, np.float32)[kept],
                                  np.asarray(x / (1.0 - rate), np.float32)[kept])
    port.eval()
    with torch.no_grad():
        ref_cls, _ = port(torch.from_numpy(np.asarray(want, np.float32)).to(tdt))
    torch.testing.assert_close(cls, ref_cls, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dropout draws"):
        port.train()
        port(torch.from_numpy(feats))
