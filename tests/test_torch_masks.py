"""Instance masks and keypoints, against mtlx on the CPU: every module of
the slice on the same seeded inputs.

Exact (equal arrays, NaN where mtlx has NaN):
  * keypoint_ops and the keypoint coder's keypoint codes (eager mtlx;
    its box codes within an ulp: XLA's log and exp are not torch's)
  * np_mask_ops
  * the Example decoder on records with PNG instance masks and keypoints,
    written by either package; the loader's gt_instance_masks (PIL
    bilinear onto round(true / 8), thresholded) and gt_keypoints, and the
    worker loader's batches equal to the in-process ones
  * the flips' masks and keypoints with JAX's draws; host geometry's
    keypoints (NaN outside the window); the window resample of the masks
    (eager mtlx); the bucket cut of the masks
Within a stated tolerance (float32 sums in another order):
  * MaskHead through the bridge: rtol 1e-5 with an atol of 1e-5 of the
    largest magnitude (the transpose conv's kernel flipped by bridge.py)
  * _mask_loss on mtlx's proposals and predictions: rtol 1e-5 (mtlx crops
    the targets with two matmuls, the port with the bilinear gather)
  * one resnet10 mask train step (jitted mtlx, JAX's draws): every loss
    term rtol 1e-4, every gradient within 1e-4 of its largest magnitude
  * the postprocess's detection_masks: within 1e-5; classes and counts
    equal
  * the Pascal, weighted Pascal and COCO instance-segmentation evaluators
    on the same masks: every metric within 1e-12
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mtlx.coders import box_coders as jcoders
from mtlx.data import example_decoder as jdec
from mtlx.data import host_geometry as jhg
from mtlx.data import loader as jloader
from mtlx.data import preprocessor as jprep
from mtlx.data import tfrecord as jtfrecord
from mtlx.detector import faster_rcnn as jfr
from mtlx.eval import coco_evaluation as jcoco
from mtlx.eval import object_detection_evaluation as jode
from mtlx.geometry import keypoint_ops as jkp
from mtlx.geometry import np_mask_ops as jmask
from mtlx.heads import box_predictors as jheads
from mtlx.train import train as jtrain
from mtlx.train import train_step as jts
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.coders import box_coders as tcoders
from mtlx_torch.data import example_decoder as tdec
from mtlx_torch.data import grain_loader
from mtlx_torch.data import host_geometry as thg
from mtlx_torch.data import loader as tloader
from mtlx_torch.data import preprocessor as tprep
from mtlx_torch.data import tfrecord as ttfrecord
from mtlx_torch.detector import faster_rcnn as tfr
from mtlx_torch.eval import coco_evaluation as tcoco
from mtlx_torch.eval import object_detection_evaluation as tode
from mtlx_torch.geometry import keypoint_ops as tkp
from mtlx_torch.geometry import np_mask_ops as tmask
from mtlx_torch.heads import box_predictors as theads
from mtlx_torch.train import train as ttrain
from mtlx_torch.train import train_step as tts
from test_torch_host_geometry import CHAIN, OPS, _sample
from test_torch_rfcn import _jax_draws, seeded_variables


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------- geometry


def test_keypoint_ops_and_coder_equal_mtlx():
    rs = np.random.RandomState(0)
    kp = rs.uniform(-0.2, 1.2, (2, 5, 4, 2)).astype(np.float32)
    window = np.asarray([[0.1, 0.2, 0.9, 0.8], [0.0, 0.0, 1.0, 0.5]], np.float32)[:, None, :]
    k, w = _t(kp), _t(window)
    cases = [
        (tkp.scale(k, 2.5, 0.75), jkp.scale(kp, 2.5, 0.75)),
        (tkp.clip_to_window(k, w), jkp.clip_to_window(kp, window)),
        (tkp.prune_outside_window(k, w), jkp.prune_outside_window(kp, window)),
        (tkp.change_coordinate_frame(k, w), jkp.change_coordinate_frame(kp, window)),
        (tkp.to_normalized_coordinates(k, 375, 500), jkp.to_normalized_coordinates(kp, 375, 500)),
        (tkp.to_absolute_coordinates(k, 375, 500), jkp.to_absolute_coordinates(kp, 375, 500)),
        (tkp.flip_horizontal(k, 0.5), jkp.flip_horizontal(kp, 0.5)),
        (tkp.flip_horizontal(k, 0.4, [1, 0, 3, 2]), jkp.flip_horizontal(kp, 0.4, [1, 0, 3, 2])),
        (tkp.flip_vertical(k, 0.3, [0, 2, 1, 3]), jkp.flip_vertical(kp, 0.3, [0, 2, 1, 3])),
        (tkp.rot90(k), jkp.rot90(kp)),
    ]
    for i, (got, want) in enumerate(cases):
        _equal(got.numpy(), want, f"case {i}")
    assert np.isnan(cases[2][0].numpy()).any()  # some fall outside a window

    anchors = np.sort(rs.uniform(0, 100, (6, 2, 2)), axis=1).reshape(6, 4)[:, [0, 2, 1, 3]]
    anchors = anchors.astype(np.float32)
    boxes = (anchors + rs.normal(0, 3, anchors.shape)).astype(np.float32)
    points = rs.uniform(0, 100, (6, 3, 2)).astype(np.float32)
    # the keypoint codes exactly; the box codes' log and exp within an ulp
    # (XLA's and torch's differ there: the box coder of earlier slices)
    codes = tcoders.keypoint_encode(_t(boxes), _t(points), _t(anchors))
    want = np.asarray(jcoders.keypoint_encode(boxes, points, anchors))
    _equal(codes.numpy()[:, 4:], want[:, 4:])
    np.testing.assert_allclose(codes.numpy()[:, :4], want[:, :4], rtol=3e-7)
    got_b, got_k = tcoders.keypoint_decode(_t(want), _t(anchors), 3)
    want_b, want_k = jcoders.keypoint_decode(want, anchors, 3)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=3e-7)
    _equal(got_k.numpy(), want_k)


def test_np_mask_ops_equal_mtlx():
    rs = np.random.RandomState(1)
    a = (rs.uniform(size=(5, 12, 9)) < 0.4).astype(np.uint8) * 255  # 0 / 255 coded
    b = rs.uniform(size=(3, 12, 9)) < 0.5
    for fn in ("intersection", "iou", "ioa"):
        _equal(getattr(tmask, fn)(a, b), getattr(jmask, fn)(a, b), fn)
    _equal(tmask.area(a), jmask.area(a))
    assert tmask.iou(a[:0], b).shape == (0, 3)
    with pytest.raises(ValueError):
        tmask.area(a[0])


# ---------------------------------------------------------------- records


CANVAS = (96, 128)
SIZES = ((40, 70), (70, 40), (50, 60))


def _annotations(rs, h, w, k, p=3):
    y0, x0 = rs.uniform(0, 0.6, k), rs.uniform(0, 0.6, k)
    boxes = np.stack([y0, x0, y0 + rs.uniform(0.1, 0.4, k), x0 + rs.uniform(0.1, 0.4, k)],
                     1).astype(np.float32)
    masks = [(rs.uniform(size=(h, w)) < 0.3).astype(np.uint8) for _ in range(k)]
    for m, (a, b_, c, d) in zip(masks, boxes):  # a solid block inside each box
        m[int(a * h):int(c * h), int(b_ * w):int(d * w)] = 1
    keypoints = rs.uniform(-0.1, 1.05, (k, p, 2)).astype(np.float32)
    return boxes, masks, keypoints


@pytest.fixture(scope="module")
def mask_records(tmp_path_factory):
    """Records with PNG images, masks and keypoints: one file written by
    mtlx's build_example, one by the port's, of the same content."""
    from mtlx_torch.data import imgcodec

    tmp = tmp_path_factory.mktemp("mask_records")
    paths = {"mtlx": str(tmp / "mtlx.record"), "port": str(tmp / "port.record")}
    rs = np.random.RandomState(2)
    with jtfrecord.TFRecordWriter(paths["mtlx"]) as wj, \
            ttfrecord.TFRecordWriter(paths["port"]) as wt:
        for i in range(6):
            h, w = SIZES[i % 3]
            k = rs.randint(1, 5)
            boxes, masks, keypoints = _annotations(rs, h, w, k)
            png = imgcodec.encode_png(rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
            args = (png, b"png", h, w, f"im{i}", boxes, rs.randint(1, 4, k), ["c"] * k)
            kw = dict(difficult=(np.arange(k) == 1).astype(int), instance_masks=masks,
                      keypoints=keypoints)
            wj.write(jdec.build_example(*args, **kw).SerializeToString())
            wt.write(tdec.build_example(*args, **kw))
    return paths


def test_decoder_reads_masks_and_keypoints_as_mtlx(mask_records):
    for path in mask_records.values():
        for raw in jtfrecord.read_records(path):
            want = jdec.decode_example(raw, decode_image=False, load_instance_masks=True)
            got = tdec.decode_example(raw, decode_image=False, load_instance_masks=True)
            for key in ("groundtruth_instance_masks", "groundtruth_keypoints",
                        "groundtruth_boxes", "groundtruth_classes"):
                assert got[key].dtype == want[key].dtype, key
                _equal(got[key], want[key], key)
            assert "groundtruth_instance_masks" not in tdec.decode_example(raw,
                                                                            decode_image=False)


@pytest.mark.parametrize("resizer,keep_difficult", [
    (("keep_aspect", {"min_dimension": 60, "max_dimension": 128}), True),
    (("fixed", {"height": 96, "width": 96}), False)])
def test_loader_masks_and_keypoints_equal_mtlx(mask_records, resizer, keep_difficult):
    kw = dict(canvas_size=CANVAS, resizer=resizer, max_boxes=5, load_instance_masks=True,
              num_keypoints=3, keep_difficult=keep_difficult)
    theirs = jloader.DetectionDataset([mask_records["port"]], **kw)
    ours = tloader.DetectionDataset([mask_records["mtlx"]], **kw)
    for i in range(len(ours)):
        want, got = theirs.get(i), ours.get(i)
        for key in ("gt_instance_masks", "gt_keypoints", "gt_boxes", "gt_mask", "true_shape"):
            assert got[key].dtype == want[key].dtype, key
            _equal(got[key], want[key], f"{key} of record {i}")
        assert got["gt_instance_masks"].shape == (5, 12, 16)
        assert got["gt_instance_masks"].any()
    ours.close()


def test_worker_loader_ships_masks_and_keypoints(mask_records):
    ds = tloader.DetectionDataset([mask_records["port"]], canvas_size=CANVAS,
                                  resizer=("keep_aspect", {"min_dimension": 60,
                                                           "max_dimension": 128}),
                                  max_boxes=5, load_instance_masks=True, num_keypoints=3)
    kw = dict(shuffle=True, seed=3, pack_images=True, bucket_multiple=32)
    want = list(tloader.batches(ds, 2, epochs=1, **kw))
    loader = grain_loader.make_grain_loader(ds, 2, worker_count=1, num_epochs=1, **kw)
    got = list(loader)
    loader.close()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("gt_instance_masks", "gt_keypoints", "image"):
            _equal(g[key], w[key], key)
    ds.close()


# ---------------------------------------------------------------- augmentation


def _aug_batch(rs, b=3, g=4, p=3, canvas=(64, 96), ms=8):
    h, w = canvas
    true = np.asarray([[60, 90], [44, 96], [64, 70]][:b], np.int32)
    return {
        "image": rs.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
        "true_shape": true,
        "boxes": np.sort(rs.uniform(0, 60, (b, g, 2, 2)), axis=2).reshape(b, g, 4)[
            ..., [0, 2, 1, 3]].astype(np.float32),
        "classes": rs.randint(0, 3, (b, g)).astype(np.int32),
        "mask": rs.uniform(size=(b, g)) < 0.8,
        "instance_masks": (rs.uniform(size=(b, g, h // ms, w // ms)) < 0.4).astype(np.float32),
        "keypoints": rs.uniform(0, 64, (b, g, p, 2)).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["random_horizontal_flip", "random_vertical_flip"])
def test_flips_carry_masks_and_keypoints_as_mtlx(name):
    batch = _aug_batch(np.random.RandomState(4))
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    wants = [getattr(jprep, name)(keys[i], {k: v[i] for k, v in batch.items()})
             for i in range(3)]
    uniforms = torch.stack([_t(jax.random.uniform(k)) for k in keys])
    assert (uniforms < 0.5).any() and (uniforms >= 0.5).any()
    got = tprep.TRANSFORMS[name]({k: _t(v) for k, v in batch.items()}, uniforms)
    for key in ("image", "boxes", "instance_masks", "keypoints"):
        _equal(got[key].numpy(), np.stack([np.asarray(w[key]) for w in wants]), key)


def test_host_geometry_keypoints_equal_mtlx():
    rs = np.random.RandomState(6)
    for chain in ([OPS[0]], CHAIN):
        theirs = jhg.HostGeometry(chain, 48, 64, (64, 64))
        ours = thg.HostGeometry(chain, 48, 64, (64, 64))
        nan = 0
        for i in range(10):
            sample = _sample(rs, i)
            h, w = sample["true_shape"]
            sample["gt_keypoints"] = rs.uniform(0, [h, w], (6, 3, 2)).astype(np.float32)
            sample["gt_instance_masks"] = (rs.uniform(size=(6, 8, 8)) < 0.5).astype(np.uint8)
            want = theirs(sample, np.random.default_rng([5, i]))
            got = ours(sample, np.random.default_rng([5, i]))
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert got[k].dtype == v.dtype, k
                _equal(got[k], v, f"{k} of sample {i}")
            nan += int(np.isnan(got["gt_keypoints"]).any())
        assert nan  # some keypoints fall outside a crop


def test_window_resample_and_bucket_cut_of_masks_equal_mtlx():
    rs = np.random.RandomState(7)
    geometry = jhg.HostGeometry(CHAIN, 48, 64, (64, 64))
    outs = [geometry(_sample(rs, i), np.random.default_rng([2, i])) for i in range(3)]
    batch = {k: np.stack([o[k] for o in outs]) for k in
             ("true_shape", "aug_window", "aug_src_shape", "aug_pad_color", "aug_content",
              "gt_boxes", "gt_mask")}
    batch["image"] = rs.uniform(0, 255, (3, 64, 64, 3)).astype(np.float32)
    batch["gt_classes"] = np.zeros((3, 6), np.int32)
    batch["gt_instance_masks"] = (rs.uniform(size=(3, 6, 8, 8)) < 0.5).astype(np.float32)
    want = jtrain.make_augmented_batch_fn([])(jax.random.PRNGKey(0), 0,
                                              {k: jnp.asarray(v) for k, v in batch.items()})
    got = ttrain.make_augmented_batch_fn([])({k: _t(v) for k, v in batch.items()}, {})
    _equal(got["gt_instance_masks"].numpy(), want["gt_instance_masks"])
    _equal(got["image"].numpy(), want["image"])
    assert 0 < float(got["gt_instance_masks"].mean()) < 1

    masks = (rs.uniform(size=(2, 3, 80 // 8, 128 // 8)) < 0.5).astype(np.uint8)
    images = np.zeros((2, 40, 70, 3), np.uint8)
    want = jts.pad_batch_to_bucket({"image": jnp.asarray(images),
                                    "gt_instance_masks": jnp.asarray(masks)}, (80, 128), 32)
    got = tts.pad_batch_to_bucket({"image": _t(images), "gt_instance_masks": _t(masks)},
                                  (80, 128), 32)
    _equal(got["gt_instance_masks"].numpy(), want["gt_instance_masks"])
    assert got["gt_instance_masks"].shape == (2, 3, 8, 12)


def test_unsafe_augmentation_refused_with_masks():
    batch = {k: _t(v) for k, v in _aug_batch(np.random.RandomState(8)).items()}
    batch = {"image": batch["image"], "true_shape": batch["true_shape"],
             "gt_boxes": batch["boxes"], "gt_classes": batch["classes"],
             "gt_mask": batch["mask"], "gt_keypoints": batch["keypoints"]}
    augment = ttrain.make_augmented_batch_fn([("random_rotation90", {})])
    with pytest.raises(ValueError, match="random_rotation90"):
        augment(batch, {"aug_0": torch.zeros(3)})
    out = ttrain.make_augmented_batch_fn([("random_horizontal_flip", {})])(
        batch, {"aug_0": torch.zeros(3)})
    assert not torch.equal(out["gt_keypoints"], batch["gt_keypoints"])


# ---------------------------------------------------------------- model


def test_mask_head_through_the_bridge_equals_mtlx():
    head = jheads.MaskHead(num_classes=5, conv_depth=16, dtype=jnp.float32)
    x = np.random.RandomState(9).normal(size=(3, 7, 7, 24)).astype(np.float32)
    variables = seeded_variables(head.init, 10, jnp.zeros((1, 7, 7, 24)))
    want = np.asarray(head.apply(variables, x))
    port = theads.MaskHead(24, 5, 16, dtype=torch.float32)
    state = flax_to_state_dict({"params": {"mask_head": variables["params"]}})
    port.load_state_dict({k[len("mask_head."):]: v for k, v in state.items()}, strict=True)
    got = port(_t(x))
    assert got.shape == want.shape == (3, 14, 14, 5) and got.dtype == torch.float32
    _close(got.detach().numpy(), want, 1e-5)
    # the flip is needed: the kernel taken as it is gives another map
    kernel = variables["params"]["upsample"]["kernel"]
    port.upsample.weight.data = _t(np.transpose(kernel, (2, 3, 0, 1)))
    assert np.abs(port(_t(x)).detach().numpy() - want).max() > 1e-2


MASK_KW = dict(predict_instance_masks=True, mask_prediction_conv_depth=32)


def _gt_masks(batch, rs):
    """[B, G, 8, 8] masks at stride 8 of the 64x64 canvas: each box's
    cells set, and some noise."""
    masks = (rs.uniform(size=(2, 4, 8, 8)) < 0.15).astype(np.uint8)
    for b in range(2):
        for g in range(4):
            y0, x0, y1, x1 = (batch["gt_boxes"][b, g] / 8).astype(int)
            masks[b, g, y0:y1 + 1, x0:x1 + 1] = 1
    return masks


@pytest.fixture(scope="module")
def mask_pair():
    """mtlx's tiny resnet10 mask model and one jitted program's losses,
    gradients, training predictions, serving predictions and detections;
    the port's model with the same weights."""
    from test_torch_refine import _batch

    jcfg = jfr.FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=jnp.float32,
                                **graft._TINY_KW, **MASK_KW)
    jmodel = jfr.FasterRCNN(jcfg)
    variables = seeded_variables(jmodel.modules.init, 11, jnp.zeros((1, 64, 64, 3)))
    batch = _batch()
    batch["gt_instance_masks"] = _gt_masks(batch, np.random.RandomState(12))
    gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"], "mask": batch["gt_mask"],
          "instance_masks": batch["gt_instance_masks"]}
    c = jmodel.cfg
    draws, rng_predict, rng_loss = _jax_draws(jax.random.PRNGKey(1), 2,
                                              c.first_stage_max_proposals,
                                              jmodel.anchors_for((64, 64)).shape[0])
    images = jmodel.preprocess(jnp.asarray(batch["image"], jnp.float32))
    ts = jnp.asarray(batch["true_shape"])
    stats = variables["batch_stats"]

    def total(params):
        pred = jmodel.predict({"params": params, "batch_stats": stats}, images, ts,
                              training=True, rng=rng_predict, groundtruth=gt)
        losses = jmodel.loss(pred, gt, rng_loss)
        return losses["total_loss"], (losses, pred)

    @jax.jit
    def program(params):
        (_, (losses, pred)), grads = jax.value_and_grad(total, has_aux=True)(params)
        serving = jmodel.predict({"params": params, "batch_stats": stats}, images, ts)
        return losses, pred, grads, serving, jmodel.postprocess(serving, ts)

    losses, pred, grads, serving, det = jax.device_get(program(variables["params"]))
    port = tfr.FasterRCNN(tfr.FasterRCNNConfig(num_classes=20, canvas_size=(64, 64),
                                               dtype=torch.float32, **graft._TINY_KW, **MASK_KW),
                          device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables), strict=True)
    return dict(jmodel=jmodel, batch=batch, gt=gt, draws=draws, port=port,
                losses={k: float(v) for k, v in losses.items()}, pred=pred,
                grads=flax_to_state_dict({"params": grads}), serving=serving, det=det)


def _tgt(case):
    g = case["gt"]
    return {"boxes": _t(g["boxes"]), "classes": _t(g["classes"]).long(), "mask": _t(g["mask"]),
            "instance_masks": _t(g["instance_masks"])}


def test_mask_loss_on_mtlx_predictions(mask_pair):
    pred = {k: _t(mask_pair["pred"][k]) for k in ("proposal_boxes", "proposal_mask",
                                                  "mask_predictions", "rpn_features")}
    want = float(mask_pair["jmodel"]._mask_loss(mask_pair["pred"], mask_pair["gt"])
                 ["Loss/BoxClassifierLoss/mask_loss"])
    got = mask_pair["port"]._mask_loss(pred, _tgt(mask_pair))["Loss/BoxClassifierLoss/mask_loss"]
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    assert want == mask_pair["losses"]["Loss/BoxClassifierLoss/mask_loss"] > 0
    # the class's channel is the one scored: another gives another loss
    pred["mask_predictions"] = pred["mask_predictions"].roll(1, dims=-1)
    other = mask_pair["port"]._mask_loss(pred, _tgt(mask_pair))
    assert abs(other["Loss/BoxClassifierLoss/mask_loss"].item() - want) > 1e-4


def test_mask_train_step_equals_mtlx(mask_pair):
    port, b = mask_pair["port"], mask_pair["batch"]
    for p in port.modules.parameters():
        p.grad = None
    images = port.preprocess(_t(b["image"]).float())
    pred = port.predict_train(images, _t(b["true_shape"]), _tgt(mask_pair), mask_pair["draws"])
    assert pred["mask_predictions"].shape == (2, 8, 14, 14, 20)
    losses = port.loss(pred, _tgt(mask_pair), mask_pair["draws"])
    assert set(losses) == set(mask_pair["losses"])
    for key, want in mask_pair["losses"].items():
        np.testing.assert_allclose(losses[key].item(), want, rtol=1e-4, err_msg=key)
    losses["total_loss"].backward()
    grads = {n: p.grad for n, p in port.modules.named_parameters()}
    assert set(grads) == set(mask_pair["grads"])
    for name, g in grads.items():
        assert g is not None, name
        _close(g.numpy(), mask_pair["grads"][name].numpy(), 1e-4)
    assert float(grads["mask_head.upsample.weight"].abs().max()) > 0
    # the train step's entry takes the masks from the batch (on a copy: the
    # step moves the weights)
    port = tfr.FasterRCNN(port.cfg, device="cpu")
    port.modules.load_state_dict(mask_pair["port"].modules.state_dict())
    state = tts.create_train_state(port, tts.make_optimizer(learning_rate=0.01))
    batch = {k: _t(v) for k, v in b.items()}
    _, metrics = tts.make_train_step(port)(state, batch, draws=mask_pair["draws"])
    np.testing.assert_allclose(float(metrics["Loss/BoxClassifierLoss/mask_loss"]),
                               mask_pair["losses"]["Loss/BoxClassifierLoss/mask_loss"],
                               rtol=1e-4)


def test_postprocess_detection_masks_equal_mtlx(mask_pair):
    port, js, jd = mask_pair["port"], mask_pair["serving"], mask_pair["det"]
    pred = {k: _t(v) for k, v in js.items()}
    det = port.postprocess(pred, _t(mask_pair["batch"]["true_shape"]))
    _equal(det["num_detections"].numpy(), jd["num_detections"])
    _equal(det["detection_classes"].numpy(), jd["detection_classes"])
    assert det["detection_masks"].shape == (2, 300, 14, 14)
    _close(det["detection_masks"].numpy(), jd["detection_masks"], 1e-5)
    assert int(det["num_detections"].sum()) > 0
    # the serving path from the image: its mask logits as mtlx's (which
    # proposal a detection keeps among near-equal ones of these random
    # weights may differ, so the masks are not compared there)
    shapes = _t(mask_pair["batch"]["true_shape"])
    pred = port.predict(port.preprocess(_t(mask_pair["batch"]["image"]).float()), shapes)
    _close(pred["mask_predictions"].numpy(), js["mask_predictions"], 1e-4)
    served = port.postprocess(pred, shapes)["detection_masks"]
    assert served.shape == (2, 300, 14, 14) and 0 <= float(served.min()) <= 1


def test_multiclass_nms_extra_fields_equal_mtlx():
    from mtlx.ops import nms as jnms
    from mtlx_torch.ops import nms as tnms

    rs = np.random.RandomState(13)
    y0, x0 = rs.uniform(0, 50, (2, 12, 1)), rs.uniform(0, 50, (2, 12, 1))
    boxes = np.concatenate([y0, x0, y0 + rs.uniform(5, 30, (2, 12, 1)),
                            x0 + rs.uniform(5, 30, (2, 12, 1))], -1).astype(np.float32)
    boxes = np.repeat(boxes[:, :, None], 3, axis=2)
    scores = rs.uniform(size=(2, 12, 3)).astype(np.float32)
    extra = rs.normal(size=(2, 12, 2, 5)).astype(np.float32)
    kw = dict(score_threshold=0.2, iou_threshold=0.5, max_size_per_class=4, max_total_size=9)
    want = jnms.batch_multiclass_non_max_suppression(boxes, scores, extra_fields={"m": extra},
                                                     **kw)
    got = tnms.batch_multiclass_non_max_suppression(_t(boxes), _t(scores),
                                                    extra_fields={"m": _t(extra)}, **kw)
    _equal(got.classes.numpy(), want.classes)
    _equal(got.extra_fields["m"].numpy(), want.extra_fields["m"])
    one = tnms.multiclass_non_max_suppression(_t(boxes[1]), _t(scores[1]),
                                              extra_fields={"m": _t(extra[1])}, **kw)
    _equal(one.extra_fields["m"].numpy(), want.extra_fields["m"][1])


def test_model_builder_mask_options():
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util

    flagship = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "configs", "faster_rcnn_resnet50_mtl_voc0712.config")
    with open(flagship) as f:
        text = f.read()
    text = text.replace(
        "        use_dropout: false\n",
        "        use_dropout: false\n        predict_instance_masks: true\n"
        "        mask_prediction_conv_depth: 64\n", 1)
    model = model_builder.build(config_util.parse_pipeline_text(text).model, is_training=True,
                                device="cpu")
    assert model.cfg.predict_instance_masks and model.cfg.mask_prediction_conv_depth == 64
    assert model.modules.mask_head.conv1.weight.shape == (64, 2048, 3, 3)
    with pytest.raises(ValueError, match="predict_keypoints"):
        model_builder.build(config_util.parse_pipeline_text(text.replace(
            "predict_instance_masks: true", "predict_keypoints: true")).model,
            is_training=False, device="cpu")


# ---------------------------------------------------------------- evaluators


def _eval_inputs(rs, n=5, h=24, w=32):
    images = []
    for i in range(n):
        g = rs.randint(1, 5)
        gt_masks = rs.uniform(size=(g, h, w)) < 0.3
        gt_classes = rs.randint(1, 4, g)
        d = rs.randint(0, 7)
        pick = rs.randint(0, g, d)
        det_masks = gt_masks[pick] ^ (rs.uniform(size=(d, h, w)) < 0.1)
        det_classes = np.where(rs.uniform(size=d) < 0.8, gt_classes[pick], rs.randint(1, 4, d))
        boxes = np.tile([[0, 0, h, w]], (g, 1)).astype(np.float32)
        images.append((f"im{i}", {
            "groundtruth_boxes": boxes, "groundtruth_classes": gt_classes,
            "groundtruth_difficult": rs.uniform(size=g) < 0.1,
            "groundtruth_instance_masks": gt_masks,
        }, {
            "detection_boxes": np.tile([[0, 0, h, w]], (d, 1)).astype(np.float32),
            "detection_scores": rs.uniform(size=d).astype(np.float32),
            "detection_classes": det_classes, "detection_masks": det_masks,
        }))
    return images


@pytest.mark.parametrize("name", ["PascalInstanceSegmentationEvaluator",
                                  "WeightedPascalInstanceSegmentationEvaluator",
                                  "CocoMaskEvaluator"])
def test_instance_segmentation_evaluators_equal_mtlx(name):
    categories = [{"id": i, "name": f"c{i}"} for i in (1, 2, 3)]
    mod = (jcoco, tcoco) if name.startswith("Coco") else (jode, tode)
    theirs, ours = (getattr(m, name)(categories) for m in mod)
    for image_id, gt, det in _eval_inputs(np.random.RandomState(14)):
        for ev in (theirs, ours):
            ev.add_single_ground_truth_image_info(image_id, gt)
            ev.add_single_detected_image_info(image_id, det)
    want, got = theirs.evaluate(), ours.evaluate()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
    assert any(np.isfinite(v) and v > 0 for v in got.values())
