"""The last modules of mtlx that the port gained, each held to its mtlx
counterpart on the CPU on the same seeded inputs:

  * backbone remat (ResNet trunks): a live batch norm trunk's gradients
    and moving statistics are bitwise those without remat (each unit
    recomputed once in the backward); tests/test_torch_spatial.py holds a
    resnet10 step with remat to mtlx's jitted remat step;
  * the backbone dispatch: any name but the two Inceptions builds the
    ResNet of mtlx's resnet_depth, with mtlx's parameter tree;
  * greedy_bipartite_match index for index (ties, row and column masks),
    and the FastRCNN and Multibox target-assigner presets (matches equal,
    targets within 1e-6);
  * SpaceToDepthConv1 against mtlx's and against the plain stem (1e-5,
    mtlx's own), even and odd canvases;
  * Inception-v2 and SSD Inception-v2 at depth multiplier 0.5 (1e-4 of
    the largest magnitude);
  * every component builder on config snippets parsed by the port's
    reader and by protobuf for mtlx's builders (equal components), and
    the three losses with their gradients (1e-6 relative);
  * the box lists, shape_utils, category_util and test_utils.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf import text_format as pb_text_format

from mtlx_torch.bridge import flax_to_state_dict
from test_torch_rfcn import seeded_variables
from test_torch_ssd import _close, _sub_state

import test_torch_distributed as two_ranks


def _boxes(rs, lead, scale=1.0):
    """Seeded float32 boxes [*lead, 4], ymin <= ymax and xmin <= xmax."""
    u = np.sort(rs.uniform(0, scale, (*lead, 2, 2)), axis=-1)  # [[y0, y1], [x0, x1]]
    return u.reshape(*lead, 4)[..., [0, 2, 1, 3]].astype(np.float32)


# ---- backbone remat ----


def _trunk_grads(remat: bool, state):
    from mtlx_torch.backbones import resnet

    trunk = resnet.ResNetProposalFeatures(10, torch.float32, bn_trainable=True, remat=remat)
    trunk.load_state_dict(state)
    trunk.train()
    calls = []
    forward = resnet.Bottleneck.forward

    def counted(self, x):
        calls.append(None)
        return forward(self, x)

    x = torch.from_numpy(np.random.RandomState(0).normal(0, 1, (2, 64, 64, 3)).astype(np.float32))
    x.requires_grad_(True)
    resnet.Bottleneck.forward = counted
    try:
        (trunk(x) ** 2).sum().backward()
    finally:
        resnet.Bottleneck.forward = forward
    for norm in resnet.live_batch_norms(trunk):
        norm.commit()
    grads = {n: p.grad.clone() for n, p in trunk.named_parameters()}
    grads["input"] = x.grad
    return grads, {k: v.clone() for k, v in trunk.state_dict().items()}, len(calls)


def test_remat_same_gradients_and_statistics():
    from mtlx_torch.backbones import resnet

    rs = np.random.RandomState(1)
    state = {k: torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(np.float32))
             if k.endswith((".scale", ".var")) else v
             for k, v in resnet.ResNetProposalFeatures(10, torch.float32, True).state_dict().items()}
    plain, plain_state, plain_calls = _trunk_grads(False, state)
    remat, remat_state, remat_calls = _trunk_grads(True, state)
    assert remat_calls == 2 * plain_calls == 6  # each unit recomputed once
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
    for k in plain_state:  # the moving statistics committed once, alike
        assert torch.equal(plain_state[k], remat_state[k]), k
    assert not torch.equal(plain_state["bn1.mean"], state["bn1.mean"])


# ---- the backbone dispatch ----


@pytest.mark.parametrize("name", ["resnet10", "resnet101", "vgg_16", "inception_v2"])
def test_backbone_dispatch_follows_mtlx(name):
    """mtlx builds the ResNet of resnet_depth (50 for an unknown name) for
    every backbone but the two Inceptions; the port's trunk has mtlx's
    parameter tree."""
    from mtlx.detector.faster_rcnn import FasterRCNN as JFasterRCNN
    from mtlx.detector.faster_rcnn import FasterRCNNConfig as JConfig
    from mtlx_torch.detector.faster_rcnn import FasterRCNNConfig, make_trunk

    kw = dict(num_classes=3, canvas_size=(64, 64), backbone=name, rpn_depth=16,
              max_gt_boxes=4)
    shapes = jax.eval_shape(JFasterRCNN(JConfig(dtype=jnp.float32, **kw)).modules.init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(zeros).items()
            if k.startswith(("backbone.", "classifier_backbone."))}
    proposal, classifier = make_trunk(FasterRCNNConfig(dtype=torch.float32, **kw))
    got = {f"backbone.{k}": tuple(v.shape) for k, v in proposal.state_dict().items()}
    got.update({f"classifier_backbone.{k}": tuple(v.shape)
                for k, v in classifier.state_dict().items()})
    assert got == want


# ---- the greedy bipartite matcher and the presets ----


@pytest.mark.parametrize("case", ["ties", "masks", "tall", "empty"])
def test_greedy_bipartite_match_equals_mtlx(case):
    from mtlx.assign import matcher as jmatcher
    from mtlx_torch.assign import matcher

    rs = np.random.RandomState(len(case))
    rows, cols = (9, 5) if case == "tall" else (5, 8)
    sim = rs.randint(0, 3, (3, rows, cols)).astype(np.float32)  # many ties
    row_mask = rs.uniform(size=(3, rows)) > (0.3 if case == "masks" else -1)
    col_mask = rs.uniform(size=(3, cols)) > (0.3 if case == "masks" else -1)
    if case == "empty":
        row_mask[:] = False
    want = jax.jit(jax.vmap(jmatcher.greedy_bipartite_match))(sim, row_mask, col_mask)
    got = matcher.greedy_bipartite_match(torch.from_numpy(sim), torch.from_numpy(row_mask),
                                         torch.from_numpy(col_mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("preset", [("FastRCNN", None), ("Multibox", None),
                                    ("FasterRCNN", "proposal")])
def test_target_assigner_presets_equal_mtlx(preset):
    from mtlx.assign import target_assigner as jta
    from mtlx_torch.assign import target_assigner as tta

    rs = np.random.RandomState(4)
    anchors = np.sort(rs.uniform(0, 1, (40, 2, 2)), axis=1).transpose(0, 2, 1).reshape(40, 4)
    anchors = anchors[:, [0, 2, 1, 3]].astype(np.float32)
    gt = np.concatenate([anchors[rs.choice(40, (2, 5))][..., :2],
                         anchors[rs.choice(40, (2, 5))][..., 2:]], axis=-1)
    gt = np.concatenate([np.minimum(gt[..., :2], gt[..., 2:]),
                         np.maximum(gt[..., :2], gt[..., 2:])], axis=-1).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    labels = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (2, 5))]
    jassigner = jta.create_target_assigner(*preset, negative_class_weight=0.5)
    want = jta.batch_assign(jassigner, jnp.asarray(anchors), gt_boxes=jnp.asarray(gt),
                            gt_labels=jnp.asarray(labels), gt_mask=jnp.asarray(mask))
    got = tta.create_target_assigner(*preset, negative_class_weight=0.5).assign(
        torch.from_numpy(anchors), torch.from_numpy(gt), gt_labels=torch.from_numpy(labels),
        gt_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.match.numpy(), np.asarray(want.match))
    assert (got.match.numpy() >= 0).any()
    for field in ("cls_targets", "cls_weights", "reg_targets", "reg_weights"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


# ---- SpaceToDepthConv1 and Inception-v2 at depth multiplier 0.5 ----


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (63, 64)])
def test_space_to_depth_stem_equals_mtlx_and_plain_stem(hw):
    from mtlx.backbones.resnet import SpaceToDepthConv1 as JSpaceToDepthConv1
    from mtlx_torch.backbones.resnet import SpaceToDepthConv1
    from mtlx_torch.layers import Conv2d

    x = np.random.RandomState(hw[1]).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    jmod = JSpaceToDepthConv1(64, dtype=jnp.float32)
    variables = seeded_variables(jmod.init, 5, jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    weight = torch.from_numpy(np.asarray(variables["params"]["kernel"])).permute(3, 2, 0, 1)
    port = SpaceToDepthConv1(64, torch.float32)
    port.load_state_dict({"weight": weight})
    plain = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=torch.float32)
    plain.load_state_dict({"weight": weight})
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(tx).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain(tx).permute(0, 2, 3, 1).detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_space_to_depth_trunk_loads_the_plain_stem():
    from mtlx_torch.backbones import resnet

    plain = resnet.ResNetProposalFeatures(10, torch.float32)
    s2d = resnet.ResNetProposalFeatures(10, torch.float32, conv0_space_to_depth=True)
    assert isinstance(s2d.conv1, resnet.SpaceToDepthConv1)
    s2d.load_state_dict(plain.state_dict(), strict=True)
    x = torch.from_numpy(np.random.RandomState(0).normal(0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(s2d(x).numpy(), plain(x).numpy(), rtol=1e-5, atol=1e-5)


def test_inception_v2_half_depth_equals_mtlx():
    from mtlx.backbones.inception_v2 import InceptionV2 as JInceptionV2
    from mtlx_torch.backbones.inception_resnet_v2 import BNKnobs
    from mtlx_torch.backbones.inception_v2 import InceptionV2, mixed_4e_channels

    jmod = JInceptionV2(depth_multiplier=0.5, min_depth=8, dtype=jnp.float32)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = seeded_variables(jmod.init, 6, jnp.asarray(x))
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = InceptionV2(torch.float32, BNKnobs(), depth_multiplier=0.5, min_depth=8)
    port.load_state_dict(_sub_state(variables))
    assert port.channels_16 == mixed_4e_channels(0.5, 8) == 288
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)


def test_ssd_inception_v2_half_depth_equals_mtlx():
    from mtlx.detector.ssd import SSD as JSSD, SSDConfig as JSSDConfig
    from mtlx_torch.detector.ssd import SSD, SSDConfig

    kw = dict(num_classes=3, canvas_size=(64, 64), feature_extractor="ssd_inception_v2",
              depth_multiplier=0.5, min_depth=8, num_layers=4)
    jmodel = JSSD(JSSDConfig(dtype=jnp.float32, **kw))
    x = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = seeded_variables(jmodel.modules.init, 7, jnp.zeros((1, 64, 64, 3)))
    want = jax.jit(jmodel.modules.apply)(variables, jnp.asarray(x))
    model = SSD(SSDConfig(dtype=torch.float32, **kw), device="cpu")
    model.modules.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        cls, box, _ = model.modules(torch.from_numpy(x))
    _close(cls.numpy(), want[0])
    _close(box.numpy(), want[1])


# ---- the component builders ----


def _both(name: str, text: str):
    """(the port's message, protobuf's) of `text`."""
    from mtlx.config.protos import components_pb2, pipeline_pb2
    from mtlx_torch.config import text_format

    module = pipeline_pb2 if name == "InputReader" else components_pb2
    want = pb_text_format.Parse(text, getattr(module, name)())
    return text_format.parse(text_format.pipeline_schema(), text, f"mtlx.protos.{name}"), want


@pytest.mark.parametrize("text", [
    "grid_anchor_generator { scales: [0.5, 1.0] aspect_ratios: [1.0, 2.0] height: 128 "
    "width: 96 height_stride: 8 width_stride: 16 height_offset: 4 width_offset: 2 }",
    "grid_anchor_generator { }",
    "ssd_anchor_generator { num_layers: 3 min_scale: 0.3 max_scale: 0.6 "
    "aspect_ratios: [1.0, 2.0] reduce_boxes_in_lowest_layer: false }",
])
def test_build_anchor_generator_equals_mtlx(text):
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    port, ref = _both("AnchorGenerator", text)
    shapes = [(3, 2), (2, 1), (1, 1)] if "ssd" in text else (3, 2)
    want = np.asarray(jcb.build_anchor_generator(ref).generate(shapes))
    got = cb.build_anchor_generator(port).generate(shapes).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("text", [
    "faster_rcnn_box_coder { y_scale: 5.0 x_scale: 5.0 height_scale: 2.5 width_scale: 2.5 }",
    "mean_stddev_box_coder { stddev: 0.1 }",
    "square_box_coder { scale_factor: 2.0 }",
    "keypoint_box_coder { num_keypoints: 2 }",
])
def test_build_box_coder_equals_mtlx(text):
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    port, ref = _both("BoxCoder", text)
    jcoder, coder = jcb.build_box_coder(ref), cb.build_box_coder(port)
    assert coder.code_size == jcoder.code_size
    rs = np.random.RandomState(0)
    boxes, anchors = _boxes(rs, (6,), 10.0), _boxes(rs, (6,), 10.0)
    tb, ta = torch.from_numpy(boxes), torch.from_numpy(anchors)
    if "keypoint" in text:
        kp = rs.uniform(0, 10, (6, 2, 2)).astype(np.float32)
        want = jcoder.encode(boxes, kp, anchors)
        got = coder.encode(tb, torch.from_numpy(kp), ta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for g, w in zip(coder.decode(got, ta), jcoder.decode(want, anchors)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        return
    want = jcoder.encode(boxes, anchors)
    got = coder.encode(tb, ta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(coder.decode(got, ta).numpy(),
                               np.asarray(jcoder.decode(want, anchors)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("text", [
    "argmax_matcher { matched_threshold: 0.6 unmatched_threshold: 0.4 "
    "force_match_for_each_row: true }",
    "argmax_matcher { matched_threshold: 0.6 unmatched_threshold: 0.4 "
    "negatives_lower_than_unmatched: false }",
    "argmax_matcher { ignore_thresholds: true }",
    "bipartite_matcher { }",
])
def test_build_matcher_equals_mtlx(text):
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    port, ref = _both("Matcher", text)
    sim = np.random.RandomState(1).uniform(0, 1, (4, 9)).astype(np.float32)
    mask = np.asarray([True, True, True, False])
    want = np.asarray(jcb.build_matcher(ref)(jnp.asarray(sim), row_mask=jnp.asarray(mask)))
    got = cb.build_matcher(port)(torch.from_numpy(sim), row_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) > 1


@pytest.mark.parametrize("name", ["iou_similarity", "ioa_similarity", "neg_sq_dist_similarity"])
def test_build_similarity_equals_mtlx(name):
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    port, ref = _both("RegionSimilarityCalculator", f"{name} {{}}")
    rs = np.random.RandomState(2)
    a, b = _boxes(rs, (3,)), _boxes(rs, (5,))
    want = np.asarray(jcb.build_region_similarity_calculator(ref)(a, b))
    got = cb.build_region_similarity_calculator(port)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_build_post_processing_and_resizer_equal_mtlx():
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    port, ref = _both("PostProcessing",
                      "batch_non_max_suppression { score_threshold: 0.1 iou_threshold: 0.5 "
                      "max_detections_per_class: 7 max_total_detections: 9 } "
                      "score_converter: SOFTMAX")
    assert cb.build_post_processing(port) == jcb.build_post_processing(ref)
    for text in ("keep_aspect_ratio_resizer { min_dimension: 300 max_dimension: 500 }",
                 "fixed_shape_resizer { height: 300 width: 300 }"):
        port, ref = _both("ImageResizer", text)
        assert cb.build_image_resizer(port) == jcb.build_image_resizer(ref)


@pytest.mark.parametrize("text", [
    "classification_loss { weighted_softmax { logit_scale: 2.0 } } "
    "localization_loss { weighted_l2 {} } "
    "hard_example_miner { num_hard_examples: 10 loss_type: LOCALIZATION } "
    "classification_weight: 1.5 localization_weight: 0.5",
    "classification_loss { bootstrapped_sigmoid { alpha: 0.3 hard_bootstrap: true } } "
    "localization_loss { weighted_iou {} }",
    "classification_loss { bootstrapped_sigmoid { alpha: 0.7 } } "
    "localization_loss { weighted_smooth_l1 {} } classification_weight: 2.0",
    "classification_loss { weighted_sigmoid {} }",
])
def test_build_losses_equal_mtlx(text):
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    port, ref = _both("Loss", text)
    jcls, jloc, jcw, jlw, jminer = jcb.build_losses(ref)
    cls, loc, cw, lw, miner = cb.build_losses(port)
    assert (cw, lw) == (jcw, jlw)
    assert (miner is None) == (jminer is None)
    if miner is not None:
        assert tuple(miner) == tuple(jminer)
    rs = np.random.RandomState(3)
    logits = rs.normal(0, 2, (2, 6, 4)).astype(np.float32)
    targets = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (2, 6))]
    weights = rs.uniform(0, 1, (2, 6)).astype(np.float32)
    boxes = _boxes(rs, (2, 6))
    target_boxes = boxes + rs.uniform(-0.02, 0.02, boxes.shape).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(cls(t(logits), t(targets), t(weights)).numpy(),
                               np.asarray(jcls(logits, targets, weights)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loc(t(boxes), t(target_boxes), t(weights)).numpy(),
                               np.asarray(jloc(boxes, target_boxes, weights)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("text", [
    "op: FC regularizer { l2_regularizer { weight: 0.004 } } initializer { "
    "variance_scaling_initializer { factor: 1.0 uniform: true mode: FAN_AVG } } "
    "activation: RELU_6",
    "regularizer { l1_regularizer { weight: 0.5 } } initializer { "
    "truncated_normal_initializer { stddev: 0.03 } } activation: RELU "
    "batch_norm { train: true }",
    "initializer { variance_scaling_initializer { factor: 2.0 mode: FAN_IN } }",
])
def test_build_hyperparams_equal_mtlx(text):
    """The settings equal mtlx's, and the initializer draws from mtlx's
    distribution: a [256, 384] kernel's standard deviation within 3% of
    mtlx's draw's, and inside its bounds."""
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    port, ref = _both("Hyperparams", text)
    want, got = jcb.build_hyperparams(ref), cb.build_hyperparams(port)
    assert {k: v for k, v in got.items() if k != "initializer"} == \
        {k: v for k, v in want.items() if k != "initializer"}
    kernel = np.asarray(want["initializer"](jax.random.PRNGKey(0), (384, 256), jnp.float32))
    weight = got["initializer"](torch.empty(256, 384), torch.Generator().manual_seed(0))
    assert abs(float(weight.std()) / kernel.std() - 1) < 0.03
    assert float(weight.abs().max()) <= np.abs(kernel).max() * 1.05


def test_build_input_reader_equals_mtlx(tmp_path):
    from mtlx.builders import component_builders as jcb
    from mtlx_torch.builders import component_builders as cb

    path = two_ranks._records(str(tmp_path / "x.record"), 3)
    port, ref = _both("InputReader", f'tf_record_input_reader {{ input_path: "{path}" }}')
    kw = dict(canvas_size=(64, 64), resizer=("fixed", {"height": 64, "width": 64}), max_boxes=4)
    want, got = jcb.build_input_reader(ref, **kw), cb.build_input_reader(port, **kw)
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got.get(i), want.get(i)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_allclose(a["gt_boxes"], b["gt_boxes"], rtol=1e-6)
    got.close()


# ---- the three losses with their gradients ----


@pytest.mark.parametrize("loss", ["l2", "iou", "bootstrap_soft", "bootstrap_hard"])
def test_losses_and_gradients_equal_mtlx(loss):
    from mtlx.losses import losses as jl
    from mtlx_torch.losses import losses as tl

    rs = np.random.RandomState(5)
    w = rs.uniform(0, 1, (2, 7)).astype(np.float32)
    if loss in ("l2", "iou"):
        target = _boxes(rs, (2, 7))
        pred = target + rs.uniform(-0.02, 0.02, target.shape).astype(np.float32)
        jfn, tfn = ((jl.weighted_l2_loss, tl.weighted_l2_loss) if loss == "l2"
                    else (jl.weighted_iou_loss, tl.weighted_iou_loss))
    else:
        kind = loss.split("_")[1]
        pred = rs.normal(0, 2, (2, 7, 3)).astype(np.float32)
        target = (rs.uniform(size=pred.shape) > 0.6).astype(np.float32)
        jfn = functools.partial(jl.bootstrapped_sigmoid_classification_loss, alpha=0.4,
                                bootstrap_type=kind)
        tfn = functools.partial(tl.bootstrapped_sigmoid_classification_loss, alpha=0.4,
                                bootstrap_type=kind)
    want = np.asarray(jfn(pred, target, w))
    want_grad = np.asarray(jax.grad(lambda p: jfn(p, target, w).sum())(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = tfn(tp, torch.from_numpy(target), torch.from_numpy(w))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), want_grad, rtol=1e-5, atol=1e-6)


# ---- box lists, shape_utils, category_util, test_utils ----


def test_box_list_equals_mtlx():
    from mtlx.geometry import box_list as jbl
    from mtlx_torch.geometry import box_list as bl

    rs = np.random.RandomState(6)
    boxes = _boxes(rs, (5,), 10.0)
    scores = rs.uniform(size=5).astype(np.float32)
    scores[3] = scores[1]  # a tie: the stable order keeps index order
    jb, tb = jbl.BoxList(boxes, scores=scores), bl.BoxList(torch.from_numpy(boxes),
                                                           scores=torch.from_numpy(scores))
    np.testing.assert_allclose(tb.area().numpy(), np.asarray(jb.area()), rtol=1e-6)
    for jout, tout in (
        (jbl.sort_by_field(jb, "scores"), bl.sort_by_field(tb, "scores")),
        (jb.clip_to_window(jnp.asarray([1.0, 2.0, 8.0, 9.0])),
         tb.clip_to_window([1.0, 2.0, 8.0, 9.0])),
        (jb.scale(0.5, 2.0), tb.scale(0.5, 2.0)),
        (jb.gather(jnp.asarray([4, 0, 2])), tb.gather([4, 0, 2])),
        (jbl.concatenate([jb, jb]), bl.concatenate([tb, tb])),
    ):
        np.testing.assert_allclose(tout.get().numpy(), np.asarray(jout.get()), rtol=1e-6)
        np.testing.assert_array_equal(tout.get_field("scores").numpy(),
                                      np.asarray(jout.get_field("scores")))
    with pytest.raises(ValueError, match="expected 5"):
        tb.add_field("bad", torch.zeros(4))
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        bl.BoxList(torch.zeros(3))
    assert tb.get_extra_fields() == ["scores"] and tb.num_boxes() == 5


def test_np_box_list_equals_mtlx():
    from mtlx.geometry import np_box_list as jnbl
    from mtlx_torch.geometry import np_box_list as nbl

    rs = np.random.RandomState(7)
    boxes = _boxes(rs, (8,), 10.0)
    scores = rs.uniform(size=8)
    made = []
    for module in (jnbl, nbl):
        b = module.BoxList(boxes)
        b.add_field("scores", scores)
        made.append(b)
    for fn in (lambda m, b: m.non_max_suppression(b, 4, 0.2),
               lambda m, b: m.non_max_suppression(b, 0),
               lambda m, b: m.sort_by_field(b, "scores", descending=False),
               lambda m, b: m.clip_to_window(b, [1, 1, 6, 6])):
        want, got = fn(jnbl, made[0]), fn(nbl, made[1])
        np.testing.assert_array_equal(got.get(), want.get())
        np.testing.assert_array_equal(got.get_field("scores"), want.get_field("scores"))
    for name in ("area", "iou", "ioa"):
        args = (made[1],) if name == "area" else (made[1], made[1])
        jargs = (made[0],) if name == "area" else (made[0], made[0])
        np.testing.assert_array_equal(getattr(nbl, name)(*args), getattr(jnbl, name)(*jargs))
    with pytest.raises(ValueError, match="invalid box data"):
        nbl.BoxList(np.asarray([[2, 0, 1, 1]]))


def test_shape_utils_equal_mtlx():
    from mtlx.ops import shape_utils as jsu
    from mtlx_torch.ops import shape_utils as su

    x = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    for size, axis in ((6, 0), (2, 0), (5, 1), (3, 1), (1, -1)):
        want = np.asarray(jsu.pad_or_clip_along_axis(jnp.asarray(x), size, axis, pad_value=-1))
        np.testing.assert_array_equal(
            su.pad_or_clip_along_axis(torch.from_numpy(x), size, axis, pad_value=-1).numpy(),
            want)
        np.testing.assert_array_equal(su.pad_or_clip_along_axis(x, size, axis, pad_value=-1),
                                      jsu.pad_or_clip_along_axis(x, size, axis, pad_value=-1))
    idx = np.asarray([1, 4])
    np.testing.assert_array_equal(su.indices_to_dense_vector(torch.from_numpy(idx), 6, 2.0,
                                                             -1.0).numpy(),
                                  np.asarray(jsu.indices_to_dense_vector(idx, 6, 2.0, -1.0)))
    classes = np.asarray([[0, 2], [1, 1]])
    np.testing.assert_array_equal(su.padded_one_hot_encoding(torch.from_numpy(classes), 3, 2)
                                  .numpy(), np.asarray(jsu.padded_one_hot_encoding(classes, 3, 2)))
    mask = np.asarray([[True, False, True], [False, False, False]])
    np.testing.assert_array_equal(su.mask_count(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jsu.mask_count(mask)))
    np.testing.assert_array_equal(su.nearest_neighbor_upsampling(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jsu.nearest_neighbor_upsampling(jnp.asarray(x), 2)))


def test_category_util_round_trips_with_mtlx(tmp_path):
    from mtlx.utils import category_util as jcu
    from mtlx_torch.utils import category_util as cu

    cats = [{"id": 3, "name": "dog"}, {"id": 1, "name": "cat, tabby"}, {"id": 2, "name": "c\"ow"}]
    cu.save_categories_to_csv_file(cats, str(tmp_path / "port.csv"))
    jcu.save_categories_to_csv_file(cats, str(tmp_path / "mtlx.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "mtlx.csv").read_bytes()
    assert cu.load_categories_from_csv_file(str(tmp_path / "mtlx.csv")) == \
        jcu.load_categories_from_csv_file(str(tmp_path / "port.csv")) == \
        sorted(cats, key=lambda c: c["id"])


def test_test_utils_equal_mtlx():
    from mtlx.utils import test_utils as jtu
    from mtlx_torch.utils import test_utils as tu

    np.testing.assert_array_equal(tu.create_diagonal_gradient_image(4, 6, 3),
                                  jtu.create_diagonal_gradient_image(4, 6, 3))
    np.testing.assert_array_equal(tu.create_random_boxes(7, 20, 30, seed=3),
                                  jtu.create_random_boxes(7, 20, 30, seed=3))
    boxes, anchors = np.ones((2, 4), np.float32) * 3, np.ones((2, 4), np.float32)
    coder, jcoder = tu.mock_box_coder(), jtu.mock_box_coder()
    np.testing.assert_array_equal(coder.encode(torch.from_numpy(boxes), torch.from_numpy(anchors))
                                  .numpy(), np.asarray(jcoder.encode(boxes, anchors)))
    np.testing.assert_array_equal(tu.MockAnchorGenerator().generate((3, 3)).numpy(),
                                  np.asarray(jtu.MockAnchorGenerator().generate((3, 3))))
    assert tu.MockAnchorGenerator.num_anchors_per_location == 1
    np.testing.assert_array_equal(tu.mock_matcher([0, -1, 1])(None).numpy(),
                                  np.asarray(jtu.mock_matcher([0, -1, 1])(None)))
