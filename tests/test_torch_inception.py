"""The Inception-v2 and Inception-ResNet-v2 trunks of the port
(mtlx_torch/backbones/inception_v2.py, inception_resnet_v2.py) and the
configs that use them, against mtlx on the CPU in float32.

  * both trunks at full width on small images, the proposal features on
    an even and an odd image (the stride-2 SAME pads differ) and the box
    classifier features on an odd and an even crop: allclose, rtol 1e-4
    with an atol of 1e-4 times the largest magnitude (convolution sums in
    another order; the largest difference seen was 4e-6 of the largest
    magnitude). mtlx's variables are made from its init's shapes with
    seeded numpy values (batch norm randomized; no init to compile),
    carried over by the bridge;
  * the Inception-ResNet-v2 second stage (17x17 crops, a 1x1 / stride-1
    maxpool, 1536-wide box predictor) on the same stride-16 map and
    proposals: allclose as above;
  * one train step of a tiny-canvas Inception-v2 Faster R-CNN with mtlx's
    own random draws: every Loss/* term (rtol 1e-4), every parameter's
    gradient against jax.grad (the frozen batch norm at epsilon 1e-3, the
    average pools counting their padding, and the proposal trunk's
    Mixed_5a-5c, which the port keeps but does not compute: zero on both
    sides) within 5e-4 of the leaf's largest magnitude, and the
    parameters after make_train_step against mtlx's optimizer on mtlx's
    gradients, allclose as above. The gradients' tolerance is the float32
    rounding of XLA's CPU backward through the 4x4 maps: on this input
    mtlx's float32 gradients lie up to 2.6e-4 of a leaf's largest
    magnitude from the port's float64 ones, the port's float32 ones
    within 3.4e-6 of them, and both sides in float64 within 1.3e-6;
  * the three configs of this family (the two Inception Faster R-CNNs and
    the R-FCN R101) built by both builders to the same config and the
    same parameter tree (every path and shape), in eval and in training;
  * the train, eval and export CLIs and InferenceModel with --device cpu
    on small-canvas pipelines of both trunks, the Inception-ResNet-v2 one
    with the three MTL tasks and the COCO, OpenImages and Pascal metrics.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtlx.backbones import inception_resnet_v2 as jirv2
from mtlx.backbones import inception_v2 as jiv2
from mtlx_torch.backbones import inception_resnet_v2 as tirv2
from mtlx_torch.backbones import inception_v2 as tiv2
from mtlx_torch.bridge import flax_to_state_dict
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
CONFIGS = ("faster_rcnn_inception_v2_voc07", "faster_rcnn_inception_resnet_v2_mtl_coco",
           "rfcn_resnet101_voc07")


def _close(got, want, rtol=1e-4):
    """allclose at rtol, with an atol of rtol times the largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _load(module, variables, top):
    nested = {col: {top: tree} for col, tree in variables.items()}
    state = {k[len(top) + 1:]: v for k, v in flax_to_state_dict(nested).items()}
    module.load_state_dict(state, strict=True)
    return module.eval()


def _check_trunk(jmod, port, x, top):
    variables = seeded_variables(jmod.init, 1, jnp.asarray(x[:1]))
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    port = _load(port, variables, top)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("hw", [(64, 64), (67, 61)], ids=["even", "odd"])
def test_inception_v2_proposal_features(hw):
    x = np.random.RandomState(hw[0]).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    port = tiv2.InceptionV2ProposalFeatures(dtype=torch.float32)
    assert port.out_channels == 576
    _check_trunk(jiv2.InceptionV2ProposalFeatures(dtype=jnp.float32), port, x, "backbone")


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)], ids=["odd", "even"])
def test_inception_v2_box_classifier_features(hw):
    x = np.random.RandomState(hw[0]).normal(0, 1, (3, *hw, 576)).astype(np.float32)
    port = tiv2.InceptionV2BoxClassifierFeatures(dtype=torch.float32)
    assert port.out_channels == 1024
    _check_trunk(jiv2.InceptionV2BoxClassifierFeatures(dtype=jnp.float32), port, x,
                 "classifier_backbone")


def test_inception_v2_both_endpoints():
    """The whole trunk (the SSD extractor's): Mixed_4e and Mixed_5c."""
    x = np.random.RandomState(3).normal(0, 1, (1, 67, 61, 3)).astype(np.float32)
    jmod = jiv2.InceptionV2(dtype=jnp.float32)
    variables = seeded_variables(jmod.init, 2, jnp.asarray(x))
    want = [np.asarray(y) for y in jax.jit(jmod.apply)(variables, jnp.asarray(x))]
    port = _load(tiv2.InceptionV2(dtype=torch.float32), variables, "backbone")
    with torch.no_grad():
        got = [y.numpy() for y in port(torch.from_numpy(x))]
    assert [g.shape for g in got] == [(1, 5, 4, 576), (1, 3, 2, 1024)]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("hw", [(64, 64), (67, 61)], ids=["even", "odd"])
def test_inception_resnet_v2_proposal_features(hw):
    x = np.random.RandomState(hw[0]).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    port = tirv2.InceptionResnetV2ProposalFeatures(torch.float32)
    assert port.out_channels == 1088
    _check_trunk(jirv2.InceptionResnetV2ProposalFeatures(dtype=jnp.float32), port, x, "backbone")


@pytest.mark.parametrize("hw", [(5, 5), (4, 4)], ids=["odd", "even"])
def test_inception_resnet_v2_box_classifier_features(hw):
    x = np.random.RandomState(hw[0]).normal(0, 1, (2, *hw, 1088)).astype(np.float32)
    port = tirv2.InceptionResnetV2BoxClassifierFeatures(torch.float32)
    assert port.out_channels == 1536
    _check_trunk(jirv2.InceptionResnetV2BoxClassifierFeatures(dtype=jnp.float32), port, x,
                 "classifier_backbone")


def test_inception_bn_defaults():
    """slim's inception batch norm: epsilon 1e-3 (decay 0.9997), not
    resnet's 1e-5; the up convs of the residual blocks have a bias."""
    port = tirv2.InceptionResnetV2BoxClassifierFeatures(torch.float32)
    assert port.block8_1.b0.bn.epsilon == 1e-3 and tirv2.INCEPTION_BN.momentum == 0.9997
    assert port.block8_1.up.bias is not None and port.block8_1.b0.conv.bias is None
    assert port.block8_10.relu is False and port.block8_9.relu is True


def test_inception_resnet_v2_second_stage():
    """17x17 crops with the identity maxpool (1x1 / stride 1), the 1536-wide
    box predictor."""
    from mtlx.detector.faster_rcnn import FasterRCNN as JFasterRCNN
    from mtlx.detector.faster_rcnn import FasterRCNNConfig as JConfig
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig

    kw = dict(num_classes=3, canvas_size=(64, 64), backbone="inception_resnet_v2",
              initial_crop_size=17, maxpool_kernel_size=1, maxpool_stride=1)
    jmodel = JFasterRCNN(JConfig(dtype=jnp.float32, **kw))
    variables = seeded_variables(jmodel.modules.init, 3, jnp.zeros((1, 64, 64, 3)))
    rs = np.random.RandomState(4)
    feats = rs.normal(0, 1, (1, 4, 4, 1088)).astype(np.float32)
    proposals = np.asarray([[[3, 4, 40, 50], [10, 12, 30, 61], [0, 0, 56, 60]]], np.float32)
    want = jax.jit(lambda v, f, p: jmodel._predict_second_stage(v, f, p, False, None,
                                                                (64, 64))[:2])(
        variables, jnp.asarray(feats), jnp.asarray(proposals))
    port = FasterRCNN(FasterRCNNConfig(dtype=torch.float32, **kw), device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert port.modules.box_predictor.class_logits.in_features == 1536
    assert port.modules.rpn.conv.in_channels == 1088
    cls, box, _ = port._predict_second_stage(torch.from_numpy(feats),
                                             torch.from_numpy(proposals), (64, 64))
    _close(cls.numpy(), want[0])
    _close(box.numpy(), want[1])


_TINY_IV2 = dict(
    num_classes=3, canvas_size=(64, 64), backbone="inception_v2", anchor_scales=(0.5, 1.0),
    anchor_aspect_ratios=(1.0,), anchor_base_size=(32.0, 32.0), rpn_depth=32,
    first_stage_pre_nms_top_k=24, first_stage_max_proposals=12, first_stage_minibatch_size=16,
    second_stage_batch_size=8, max_gt_boxes=4,
)


def test_inception_v2_train_step_matches_mtlx():
    from mtlx.detector.faster_rcnn import FasterRCNN as JFasterRCNN
    from mtlx.detector.faster_rcnn import FasterRCNNConfig as JConfig
    from mtlx.train import train_step as jts
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig
    from mtlx_torch.train import train_step as tts

    lr = 0.01
    jmodel = JFasterRCNN(JConfig(dtype=jnp.float32, **_TINY_IV2))
    variables = seeded_variables(jmodel.modules.init, 5, jnp.zeros((1, 64, 64, 3)))
    rs = np.random.RandomState(6)
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
    draws, rng_predict, rng_loss = _jax_draws(jax.random.PRNGKey(2), 2,
                                              jmodel.cfg.first_stage_max_proposals,
                                              jmodel.anchors_for((64, 64)).shape[0])
    images = jmodel.preprocess(jnp.asarray(batch["image"], jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(params):
        pred = jmodel.predict({"params": params, "batch_stats": stats}, images,
                              batch["true_shape"], training=True, rng=rng_predict,
                              groundtruth=gt)
        losses = jmodel.loss(pred, gt, rng_loss)
        return losses["total_loss"], losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jts.make_optimizer(learning_rate=lr)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    jgrads_sd = flax_to_state_dict({"params": to_np(jgrads)})
    jnew = flax_to_state_dict({"params": to_np(optax.apply_updates(params, updates)),
                               "batch_stats": stats})

    port = FasterRCNN(FasterRCNNConfig(dtype=torch.float32, **_TINY_IV2), device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables), strict=True)
    state = tts.create_train_state(port, tts.make_optimizer(learning_rate=lr))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    dead = [n for n in state.params if n.startswith("backbone.body.mixed_5")]
    assert dead
    # the gradients of one forward and backward, as the step takes them
    for p in state.params.values():
        p.grad = None
    tgt = {"boxes": tb["gt_boxes"], "classes": tb["gt_classes"].long(), "mask": tb["gt_mask"]}
    pred = port.predict_train(port.preprocess(tb["image"].float()), tb["true_shape"], tgt, draws)
    losses = port.loss(pred, tgt, draws)
    assert set(losses) == set(jlosses)
    for key, want in jlosses.items():
        np.testing.assert_allclose(losses[key].item(), float(want), rtol=1e-4, err_msg=key)
    losses["total_loss"].backward()
    assert set(state.params) == set(jgrads_sd)
    for name, p in state.params.items():
        want = jgrads_sd[name].numpy()
        if name in dead:
            assert p.grad is None and not want.any(), name
        else:
            _close(p.grad.numpy(), want, rtol=5e-4)
    assert float(state.params["backbone.body.conv1.depthwise.weight"].grad.abs().max()) > 0

    state, metrics = tts.make_train_step(port)(state, tb, draws=draws)
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jlosses["total_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(jgrads)),
                               rtol=1e-4)
    after = port.modules.state_dict()
    for name, want in jnew.items():
        _close(after[name].numpy(), want.numpy())


def assert_same_config(got, want):
    """The port's config equals mtlx's field by field (dtype by name, the
    initializers as the port's specs)."""
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert jnp.dtype(w).name == str(g).split(".")[-1]
        elif f.name == "rpn_conv_initializer":
            assert g == ("truncated_normal", pytest.approx(0.01)), g
        elif f.name == "second_stage_fc_initializer":
            assert (g is None) == (w is None), f.name
            if g is not None:
                assert g == ("variance_scaling", 1.0, "fan_avg", "uniform")
        elif f.name == "mtl":
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build_equal_to_mtlx(name):
    from mtlx.builders import model_builder as jbuilder
    from mtlx.config import config_util as jconfig
    from mtlx_torch.builders import model_builder as tbuilder
    from mtlx_torch.config import config_util as tconfig

    path = os.path.join(_REPO, "configs", f"{name}.config")
    for training in (False, True):
        ref = jbuilder.build(jconfig.get_configs_from_pipeline_file(path)["model"],
                             is_training=training)
        model = tbuilder.build(tconfig.get_configs_from_pipeline_file(path)["model"],
                               is_training=training, device="cpu")
        assert type(model).__name__ == type(ref).__name__
        assert_same_config(model.cfg, ref.cfg)
        if training and name.endswith("_mtl_coco"):
            assert model.cfg.mtl.multiobject and model.cfg.mtl.closeness
        shapes = jax.eval_shape(ref.modules.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))
        tree = flax_to_state_dict(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes), training_heads=training)
        want = {k: tuple(v.shape) for k, v in model.modules.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in tree.items()} == want


_IV2_PIPELINE = """
model {{ faster_rcnn {{
  num_classes: 3
  image_resizer {{ keep_aspect_ratio_resizer {{ min_dimension: 48 max_dimension: 64 }} }}
  feature_extractor {{ type: 'faster_rcnn_inception_v2' first_stage_features_stride: 16 }}
  first_stage_anchor_generator {{ grid_anchor_generator {{
    scales: [0.5, 1.0] aspect_ratios: [1.0] height: 32 width: 32 }} }}
  first_stage_box_predictor_depth: 32
  first_stage_max_proposals: 8
  first_stage_minibatch_size: 16
  second_stage_batch_size: 4
  initial_crop_size: 14 maxpool_kernel_size: 2 maxpool_stride: 2
  second_stage_box_predictor {{ mask_rcnn_box_predictor {{ }} }}
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
  data_augmentation_options {{ random_horizontal_flip {{ }} }}
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

# the IRv2 MTL COCO config's second stage (17x17 crops, no maxpool, the
# atrous RPN) and MTL tasks on a 64x64 canvas
_IRV2_PIPELINE = (_IV2_PIPELINE
                  .replace("faster_rcnn_inception_v2", "faster_rcnn_inception_resnet_v2")
                  .replace("initial_crop_size: 14 maxpool_kernel_size: 2 maxpool_stride: 2",
                           "initial_crop_size: 17 maxpool_kernel_size: 1 maxpool_stride: 1\n"
                           "  first_stage_atrous_rate: 2\n"
                           "  mtl {{ window: true closeness: true edgemask: true\n"
                           "    window_loss_weight: 0.3 closeness_loss_weight: 0.3\n"
                           "    edgemask_loss_weight: 0.5 }}")
                  .replace('metrics_set: "pascal_voc_detection_metrics"',
                           'metrics_set: "coco_detection_metrics"\n'
                           '  metrics_set: "open_images_V2_detection_metrics"\n'
                           '  metrics_set: "pascal_voc_detection_metrics"'))


@pytest.mark.parametrize("trunk", ["inception_v2", "inception_resnet_v2"])
def test_cli_train_resume_eval_export_serve(trunk, tmp_path, capsys):
    pipeline = _IV2_PIPELINE if trunk == "inception_v2" else _IRV2_PIPELINE
    config = write_cli_workdir(tmp_path, pipeline)
    # the restart is the same code for every trunk: the R-FCN and
    # Inception-v2 chains resume, the IRv2 one trains its 2 steps at once
    metrics, served, det = run_cli_chain(tmp_path, config, capsys,
                                         resume=trunk == "inception_v2")
    assert served.model.cfg.backbone == trunk
    assert det["detection_boxes"].shape == (1, 10, 4)
    if trunk == "inception_resnet_v2":
        for key in ("DetectionBoxes_Precision/mAP", "OpenImagesV2_Precision/mAP@0.5IOU"):
            assert np.isfinite(metrics[key]), key
