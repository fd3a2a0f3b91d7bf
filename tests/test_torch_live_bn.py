"""The training machinery the SSD configs add to the port, against mtlx on
the CPU:

  * LiveBatchNorm (mtlx_torch/backbones/resnet.py), a torch.autograd.Function
    with mtlx's folded forward and hand-written backward: the training
    output, the moving statistics after the step, the input gradient and
    the scale and offset gradients against mtlx's LiveBatchNorm and its
    custom_vjp, within 1e-5 of each tensor's largest magnitude in float32
    (the differences seen were under 8e-7); in bfloat16 the outputs and
    the input gradient within 1/128 of the largest magnitude (one bfloat16
    ulp at the top of the range; they came out equal), the parameter
    gradients and statistics, float32 on both sides, within 1e-5; the eval
    output from the moving statistics likewise; an eval forward changes
    nothing;
  * Inception-v2 with live batch norm (SSD's second trunk): both
    endpoints and every moving statistic after one training forward,
    against mtlx's InceptionV2(bn_trainable=True) (tests/test_keypoints_
    backbones.py's mtlx test, held to the numbers): within 1e-4 of the
    largest magnitude at stride 16 and 1e-3 at stride 32, where batch norm
    over 8 values a channel amplifies float32 rounding (the port in
    float64 lies 5.4e-4 from mtlx's float32 there);
  * RMSProp, Adam and momentum with the moving average of the weights,
    three steps of an exponential-decay schedule with the bias multiplier
    and the clip, against optax's chain as mtlx's optimizer_builder
    builds it (rtol 1e-6: rsqrt and the bias correction's power may round
    an ulp apart), and the checkpoint round trip of their state;
  * ssd_random_crop (mtlx_torch/data/preprocessor.py) with JAX's own draws
    on a batch of images of two true shapes, with and without ground
    truth: the masks and true shapes equal, the boxes within 1e-6 of the
    largest coordinate (mtlx's eager CPU arithmetic lands up to two
    float32 ulps off a plain float32 evaluation of the same formulas, which
    the port follows), the pixels within 1e-2 (of 0-255) through one crop
    of the whole batch with contiguous inputs; the builder's kwargs equal
    mtlx's;
  * two ranks over gloo, each taking one SSD step with live batch norm on
    its half of a global batch (the batch norm's sums all-reduced forward
    and backward): bitwise equal to each other; against mtlx's
    single-process float32 step on the whole batch the losses within 1e-4
    relative, the parameters and moving statistics within 5e-4 of each
    tensor's largest magnitude (one process of the port lies 1.5e-4 from
    mtlx there: mtlx's float32 sums of the gradients at a batch norm's
    offsets nearly cancel, tests/test_torch_ssd.py); against the port's
    own one-process step on the whole batch within 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtlx_torch.backbones.resnet import FrozenBatchNorm, LiveBatchNorm, live_batch_norms, make_norm
from mtlx_torch.bridge import flax_to_state_dict


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bn_case(seed=0):
    rs = np.random.RandomState(seed)
    return dict(
        x=(rs.normal(0, 3, (4, 8, 8, 16)) + 1.5).astype(np.float32),
        scale=np.linspace(0.5, 1.5, 16).astype(np.float32),
        bias=np.linspace(-0.3, 0.4, 16).astype(np.float32),
        mean=rs.normal(0, 0.2, 16).astype(np.float32),
        var=rs.uniform(0.5, 1.5, 16).astype(np.float32),
        cotangent=rs.normal(0, 1, (4, 8, 8, 16)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_live_batch_norm_matches_mtlx(dtype):
    from mtlx.backbones.resnet import LiveBatchNorm as JLiveBatchNorm

    c = _bn_case()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jbn = JLiveBatchNorm(momentum=0.9, epsilon=1e-3, dtype=jdt)
    stats = {"mean": c["mean"], "var": c["var"]}
    x = jnp.asarray(c["x"], jdt)

    def forward(xx, params):
        return jbn.apply({"params": params, "batch_stats": stats}, xx,
                         use_running_average=False, mutable=["batch_stats"])

    params = {"scale": c["scale"], "bias": c["bias"]}
    y, vjp, mutated = jax.vjp(lambda xx, p: forward(xx, p)[0], x, params) + (
        forward(x, params)[1]["batch_stats"],)
    dx, dparams = vjp(jnp.asarray(c["cotangent"], jdt))

    bn = LiveBatchNorm(16, momentum=0.9, epsilon=1e-3)
    bn.load_state_dict({k: torch.from_numpy(c[k]) for k in ("scale", "bias", "mean", "var")})
    bn.train()
    xt = torch.from_numpy(c["x"]).to(tdt).permute(0, 3, 1, 2).detach().requires_grad_(True)
    yt = bn(xt)
    yt.backward(torch.from_numpy(c["cotangent"]).to(tdt).permute(0, 3, 1, 2))
    bn.commit()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    big = 1e-5 if dtype == "float32" else 1 / 128
    assert yt.dtype == tdt and xt.grad.dtype == tdt
    assert _rel(nhwc(yt), np.asarray(y, np.float32)) <= big
    assert _rel(nhwc(xt.grad), np.asarray(dx, np.float32)) <= big
    assert _rel(bn.scale.grad.numpy(), np.asarray(dparams["scale"], np.float32)) <= 1e-5
    assert _rel(bn.bias.grad.numpy(), np.asarray(dparams["bias"], np.float32)) <= 1e-5
    for k in ("mean", "var"):
        assert _rel(getattr(bn, k).numpy(), np.asarray(mutated[k])) <= 1e-5, k

    # eval reads the moving statistics and changes nothing
    bn.eval()
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with torch.no_grad():
        ye = bn(torch.from_numpy(c["x"]).to(tdt).permute(0, 3, 1, 2))
    want = jbn.apply({"params": params, "batch_stats": mutated}, x, use_running_average=True)
    assert _rel(nhwc(ye), np.asarray(want, np.float32)) <= big
    assert bn.batch_stats is None
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_make_norm_live_and_frozen_share_names():
    live, frozen = make_norm(8, True), make_norm(8, False)
    assert isinstance(live, LiveBatchNorm) and isinstance(frozen, FrozenBatchNorm)
    assert list(live.state_dict()) == list(frozen.state_dict()) == ["scale", "bias", "mean", "var"]
    assert [n for n, _ in live.named_parameters()] == ["scale", "bias"]
    no_affine = LiveBatchNorm(8, center=False, scale=False)
    assert list(no_affine.state_dict()) == ["mean", "var"]
    x = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(0))
    no_affine.train()
    y = no_affine(x)
    assert torch.allclose(y.mean((0, 2, 3)), torch.zeros(8), atol=1e-5)


def test_inception_v2_live_batch_norm_matches_mtlx():
    from mtlx.backbones.inception_v2 import InceptionV2 as JInceptionV2
    from mtlx_torch.backbones.inception_resnet_v2 import BNKnobs
    from mtlx_torch.backbones.inception_v2 import InceptionV2
    from mtlx_torch.backbones.resnet import BNSpec
    from test_torch_rfcn import seeded_variables

    jmod = JInceptionV2(dtype=jnp.float32, bn_trainable=True, bn_momentum=0.9)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = seeded_variables(jmod.init, 3, jnp.zeros((1, 64, 64, 3)))
    (e16, e32), mutated = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    port = InceptionV2(torch.float32, BNKnobs(True, BNSpec(0.9, 1e-3)))
    tree = flax_to_state_dict({"params": {"backbone": variables["params"]},
                               "batch_stats": {"backbone": variables["batch_stats"]}})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in tree.items()})
    port.train()
    g16, g32 = port(torch.from_numpy(x))
    assert _rel(g16.detach().numpy(), e16) <= 1e-4
    # batch norm over 8 values a channel (two 2x2 maps) amplifies float32
    # rounding at stride 32: the port in float64 lies 5.4e-4 from mtlx here
    assert _rel(g32.detach().numpy(), e32) <= 1e-3
    norms = live_batch_norms(port)
    assert len(norms) == len([m for m in port.modules() if hasattr(m, "var")])
    for norm in norms:
        norm.commit()
    want = {k.split(".", 1)[1]: v for k, v in flax_to_state_dict(
        {"batch_stats": {"backbone": jax.tree_util.tree_map(np.asarray,
                                                            mutated["batch_stats"])}}).items()}
    buffers = dict(port.named_buffers())
    assert set(want) == set(buffers)
    for k, w in want.items():
        assert _rel(buffers[k].numpy(), w.numpy()) <= 1e-4, k


_OPTIMIZERS = {
    "rmsprop": """rms_prop_optimizer {{ learning_rate {{ {lr} }}
        momentum_optimizer_value: 0.9 decay: 0.9 epsilon: 1.0 }}""",
    "adam": "adam_optimizer {{ learning_rate {{ {lr} }} }}",
    "momentum": """momentum_optimizer {{ learning_rate {{ {lr} }}
        momentum_optimizer_value: 0.9 }}""",
}
_LR = ("exponential_decay_learning_rate { initial_learning_rate: 0.004 decay_steps: 2 "
       "decay_factor: 0.95 }")


def _optimizer_protos(kind):
    from google.protobuf import text_format as pb_text_format
    from mtlx.config.protos import pipeline_pb2
    from mtlx_torch.config import config_util

    text = ("train_config { optimizer { " + _OPTIMIZERS[kind].format(lr=_LR)
            + " moving_average_decay: 0.9 } gradient_clipping_by_norm: 5.0 "
            "bias_grad_multiplier: 2.0 }")
    ours = config_util.parse_pipeline_text(text).train_config
    theirs = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig()).train_config
    return ours, theirs


@pytest.mark.parametrize("kind", sorted(_OPTIMIZERS))
def test_optimizer_and_moving_average_match_optax(kind):
    from mtlx.builders import optimizer_builder as jbuilder
    from mtlx_torch.builders import optimizer_builder as tbuilder

    ours, theirs = _optimizer_protos(kind)
    jtx, _, jdecay = jbuilder.build(theirs.optimizer, theirs)
    tx, _, decay = tbuilder.build(ours.optimizer, ours)
    assert decay == jdecay == pytest.approx(0.9) and tx.kind == kind
    rs = np.random.RandomState(0)
    names = ["conv.weight", "conv.bias", "bn.scale"]
    shapes = [(4, 3, 3, 3), (4,), (4,)]
    params = {n: rs.normal(0, 1, s).astype(np.float32) for n, s in zip(names, shapes)}
    tparams = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    # mtlx's tree: the bias multiplier matches a `bias` key
    jparams = {"conv": {"kernel": params["conv.weight"], "bias": params["conv.bias"]},
               "bn": {"scale": params["bn.scale"]}}
    jstate, state = jtx.init(jparams), tx.init(tparams)
    jema = jax.tree_util.tree_map(jnp.asarray, jparams)
    ema = {n: p.clone() for n, p in tparams.items()}
    for step in range(3):
        scale = 10.0 if step == 1 else 0.1  # the clip acts at step 1 only
        grads = {n: (rs.normal(0, scale, v.shape)).astype(np.float32) for n, v in params.items()}
        jgrads = {"conv": {"kernel": grads["conv.weight"], "bias": grads["conv.bias"]},
                  "bn": {"scale": grads["bn.scale"]}}
        updates, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        d = jnp.float32(jdecay)
        jema = jax.tree_util.tree_map(lambda e, p: e * d + p * (1.0 - d), jema, jparams)
        tupdates, state = tx.update({n: torch.from_numpy(g) for n, g in grads.items()}, state)
        torch._foreach_add_([tparams[n] for n in state.names], tupdates)
        f = np.float32
        ema = {n: e * float(f(decay)) + tparams[n] * float(f(1) - f(decay))
               for n, e in ema.items()}
        flat = {"conv.weight": jparams["conv"]["kernel"], "conv.bias": jparams["conv"]["bias"],
                "bn.scale": jparams["bn"]["scale"]}
        flat_ema = {"conv.weight": jema["conv"]["kernel"], "conv.bias": jema["conv"]["bias"],
                    "bn.scale": jema["bn"]["scale"]}
        for n in names:
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(flat[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{kind} step {step} {n}")
            np.testing.assert_allclose(ema[n].numpy(), np.asarray(flat_ema[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{kind} ema step {step} {n}")
    assert state.count == 3 and (state.nu is None) == (kind == "momentum")


def test_checkpoint_round_trip_of_moments_and_moving_average(tmp_path):
    """RMSProp's second moment, its momentum trace and the moving average
    survive a save and restore; eval / export read the moving average."""
    from mtlx_torch.builders import optimizer_builder
    from mtlx_torch.detector.ssd import SSD, SSDConfig
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train_step as tts

    cfg = SSDConfig(num_classes=2, canvas_size=(64, 64), depth_multiplier=0.25, num_layers=3,
                    batch_norm_trainable=True, dtype=torch.float32)
    ours, _ = _optimizer_protos("rmsprop")
    tx, _, decay = optimizer_builder.build(ours.optimizer, ours)
    model = SSD(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    state = tts.create_train_state(model, tx, keep_ema=True)
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)),
             "true_shape": torch.tensor([[64, 64], [64, 64]], dtype=torch.int32),
             "gt_boxes": torch.tensor([[[4.0, 4, 40, 40]], [[10.0, 20, 60, 50]]]),
             "gt_classes": torch.tensor([[0], [1]]), "gt_mask": torch.tensor([[True], [True]])}
    state, _ = tts.make_train_step(model, ema_decay=decay)(state, batch)
    manager = ckpt_lib.CheckpointManager(str(tmp_path))
    manager.save(1, state)
    manager.wait()
    other = SSD(cfg, device="cpu")
    restored = manager.restore(tts.create_train_state(other, tx, keep_ema=True))
    assert restored.step == 1 and restored.opt_state.count == 1
    for a, b in zip(restored.opt_state.nu + restored.opt_state.trace,
                    state.opt_state.nu + state.opt_state.trace):
        assert torch.equal(a, b)
    params = dict(model.modules.named_parameters())
    for n, e in state.ema.items():
        assert torch.equal(restored.ema[n], e)
    assert sum(not torch.equal(e, params[n]) for n, e in state.ema.items()) > len(params) // 2
    for n, b in model.modules.named_buffers():  # the live batch norm's statistics
        assert torch.equal(dict(other.modules.named_buffers())[n], b)
    averaged = SSD(cfg, device="cpu")
    manager.restore(tts.TrainState(0, averaged, None, None), params_only=True, use_ema=True)
    for n, p in averaged.modules.named_parameters():
        assert torch.equal(p.detach(), state.ema[n])
    with pytest.raises(ValueError, match="another optimizer"):
        manager.restore(tts.create_train_state(SSD(cfg, device="cpu"), tts.make_optimizer()))


def jax_crop_draws(rng, batch_size, num_branches, option_index=0, attempts=8):
    """The draws mtlx's batch_preprocess takes for ssd_random_crop (the
    option at option_index), keyed as the port's."""
    branch, keep, windows = [], [], []
    for key in jax.random.split(rng, batch_size):
        pick, crop = jax.random.split(jax.random.fold_in(key, option_index))
        branch.append(int(jax.random.randint(pick, (), 0, num_branches)))
        rk, rw = jax.random.split(crop)
        keep.append(float(jax.random.uniform(rk)))
        windows.append([[float(jax.random.uniform(q)) for q in jax.random.split(kk, 4)]
                        for kk in jax.random.split(rw, attempts)])
    return {"branch": torch.tensor(branch), "keep": torch.tensor(keep, dtype=torch.float32),
            "windows": torch.tensor(windows, dtype=torch.float32)}


def _crop_batch(seed, b=16, hw=(48, 64), g=4):
    rs = np.random.RandomState(seed)
    shapes = np.array([[48, 64], [40, 50]] * (b // 2), np.int32)
    boxes = np.zeros((b, g, 4), np.float32)
    mask = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rs.randint(0, g + 1)):  # some images have no ground truth
            y0, x0 = rs.uniform(0, shapes[i, 0] - 10), rs.uniform(0, shapes[i, 1] - 10)
            boxes[i, j] = [y0, x0, y0 + rs.uniform(5, shapes[i, 0] - y0),
                           x0 + rs.uniform(5, shapes[i, 1] - x0)]
            mask[i, j] = True
    return {"image": rs.uniform(0, 255, (b, *hw, 3)).astype(np.float32), "boxes": boxes,
            "classes": np.zeros((b, g), np.int32), "mask": mask, "true_shape": shapes}


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_random_crop_matches_mtlx(seed, monkeypatch):
    from mtlx.data import preprocessor as jprep
    from mtlx_torch.data import preprocessor as tprep
    from mtlx_torch.kernels import roi_cuda

    batch = _crop_batch(seed)
    rng = jax.random.PRNGKey(seed + 3)
    want = jprep.batch_preprocess(rng, {k: jnp.asarray(v) for k, v in batch.items()},
                                  [("ssd_random_crop", {"operations": ()})])
    draws = jax_crop_draws(rng, len(batch["image"]), 7)
    assert len(set(draws["branch"].tolist())) >= 4  # the keep branch and crops
    calls = []
    plain = roi_cuda.crop_and_resize

    def spy(features, boxes, *a, **k):
        calls.append((features.shape, features.is_contiguous(), boxes.is_contiguous()))
        return plain(features, boxes, *a, **k)

    monkeypatch.setattr(roi_cuda, "crop_and_resize", spy)
    got = tprep.ssd_random_crop({k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    assert calls == [((16, 48, 64, 3), True, True)]  # one crop of the whole batch
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["true_shape"].numpy(), np.asarray(want["true_shape"]))
    w = np.asarray(want["boxes"])
    np.testing.assert_allclose(got["boxes"].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), rtol=0, atol=1e-2)
    kept = draws["branch"] == 0
    assert torch.equal(got["image"][kept], torch.from_numpy(batch["image"])[kept])


def test_ssd_random_crop_builder_matches_mtlx():
    from google.protobuf import text_format as pb_text_format
    from mtlx.builders import preprocessor_builder as jprep
    from mtlx.config.protos import pipeline_pb2
    from mtlx_torch.builders import preprocessor_builder as tprep
    from mtlx_torch.config import config_util

    for step in ("ssd_random_crop {}",
                 "ssd_random_crop { operations { min_object_covered: 0.3 min_area: 0.2 "
                 "max_area: 0.9 overlap_thresh: 0.4 random_coef: 0.25 } operations { "
                 "min_aspect_ratio: 0.5 max_aspect_ratio: 2.0 } }"):
        text = f"train_config {{ data_augmentation_options {{ random_horizontal_flip {{}} }} " \
               f"data_augmentation_options {{ {step} }} }}"
        ours = config_util.parse_pipeline_text(text).train_config.data_augmentation_options
        theirs = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
        want = jprep.build(theirs.train_config.data_augmentation_options)
        assert tprep.build(ours) == want


def test_configured_operations_match_mtlx():
    """Configured operations: no keep branch, per-branch random_coef."""
    from mtlx.data import preprocessor as jprep
    from mtlx_torch.data import preprocessor as tprep

    ops = (dict(min_object_covered=0.3, min_aspect_ratio=0.5, max_aspect_ratio=2.0,
                min_area=0.2, max_area=0.9, overlap_thresh=0.4, random_coef=0.5),
           dict(min_object_covered=0.0, min_aspect_ratio=1.0, max_aspect_ratio=1.0,
                min_area=0.3, max_area=1.0, overlap_thresh=0.0, random_coef=0.0))
    batch = _crop_batch(5)
    rng = jax.random.PRNGKey(11)
    want = jprep.batch_preprocess(rng, {k: jnp.asarray(v) for k, v in batch.items()},
                                  [("ssd_random_crop", {"operations": ops})])
    draws = jax_crop_draws(rng, len(batch["image"]), 2)
    got = tprep.ssd_random_crop({k: torch.from_numpy(v) for k, v in batch.items()}, draws,
                                operations=ops)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["true_shape"].numpy(), np.asarray(want["true_shape"]))
    w = np.asarray(want["boxes"])
    np.testing.assert_allclose(got["boxes"].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), rtol=0, atol=1e-2)


# one rank of the two-rank SSD step (see the module docstring)
_RANK_STEP = r"""
import sys
import torch
from mtlx_torch.detector.ssd import SSD, SSDConfig
from mtlx_torch.parallel import distributed
from mtlx_torch.train import train_step as tts

torch.set_num_threads(1)
data = torch.load(sys.argv[1], weights_only=False)
device, replicas = distributed.init_process_group("cpu")
model = SSD(SSDConfig(dtype=torch.float32, **data["cfg"]), device="cpu")
model.modules.load_state_dict(data["weights"], strict=True)
state = tts.create_train_state(model, tts.make_optimizer(learning_rate=data["lr"]))
batch = {k: replicas.rows(v) for k, v in data["batch"].items()}
state, metrics = tts.make_train_step(model, replicas=replicas)(state, batch)
torch.save({"metrics": {k: v.clone() for k, v in metrics.items()},
            "state": {k: v.detach().clone() for k, v in model.modules.state_dict().items()}},
           f"{sys.argv[2]}.{replicas.rank}")
distributed.destroy_process_group()
"""

TINY_SSD = dict(num_classes=3, canvas_size=(64, 64), depth_multiplier=0.25, min_depth=8,
                num_layers=4, batch_norm_trainable=True, bn_momentum=0.9,
                max_detections_per_class=10, max_total_detections=10)


def ssd_batch(seed=0, b=4):
    """A global batch of b 64x64 images whose halves hold different numbers
    of boxes."""
    rs = np.random.RandomState(seed)
    z = [0, 0, 0, 0]
    boxes = [[[2, 3, 54, 58], [20, 10, 50, 45], [4, 30, 30, 50]],
             [[4, 4, 44, 50], [10, 20, 30, 40], z],
             [[6, 8, 50, 44], z, z],
             [[3, 5, 40, 30], [20, 22, 48, 50], z]]
    return {
        "image": rs.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8),
        "true_shape": np.full((b, 2), 64, np.int32),
        "gt_boxes": np.asarray(boxes[:b], np.float32),
        "gt_classes": np.asarray([[1, 2, 0], [0, 2, 0], [1, 0, 0], [2, 1, 0]][:b], np.int32),
        "gt_mask": np.asarray([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 0]][:b], bool),
    }


def test_two_rank_ssd_step_equals_mtlx_global_step(tmp_path):
    import socket

    from mtlx.detector.ssd import SSD as JSSD, SSDConfig as JSSDConfig
    from mtlx.train import train_step as jts
    from test_torch_rfcn import seeded_variables

    jmodel = JSSD(JSSDConfig(dtype=jnp.float32, **TINY_SSD))
    variables = seeded_variables(jmodel.modules.init, 5, jnp.zeros((1, 64, 64, 3)))
    batch = ssd_batch()
    lr = 0.01
    tx = jts.make_optimizer(learning_rate=lr)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    new_state, jmetrics = jax.jit(jts.make_train_step(jmodel))(state, batch,
                                                               jax.random.PRNGKey(0))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))

    data = str(tmp_path / "data.pt")
    torch.save({"weights": flax_to_state_dict(variables), "cfg": TINY_SSD, "lr": lr,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}, data)
    out = str(tmp_path / "out.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = lambda r: dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                         MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                         PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_STEP, data, out], env=env(r),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [torch.load(f"{out}.{r}") for r in range(2)]
    for name, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][name]), name
    for key, w in jmetrics.items():
        np.testing.assert_allclose(float(ranks[0]["metrics"][key]), float(w), rtol=1e-4,
                                   err_msg=key)
    got = ranks[0]["state"]
    assert set(got) == set(want)
    # against mtlx's float32 step on the whole batch: 5e-4 of each tensor's
    # largest magnitude (one process of the port lies 1.5e-4 from it: mtlx's
    # float32 sums of the gradients at a batch norm's offsets nearly cancel)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=5e-4 * max(np.abs(w).max(), 1e-30), err_msg=name)
    # against the port's own step on the whole batch in one process: the
    # all-reduced statistics and gradients leave only summation order
    from mtlx_torch.detector.ssd import SSD, SSDConfig
    from mtlx_torch.train import train_step as tts

    one = SSD(SSDConfig(dtype=torch.float32, **TINY_SSD), device="cpu")
    one.modules.load_state_dict(flax_to_state_dict(variables))
    state = tts.create_train_state(one, tts.make_optimizer(learning_rate=lr))
    _, metrics = tts.make_train_step(one)(state, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
    for key, w in metrics.items():
        np.testing.assert_allclose(float(ranks[0]["metrics"][key]), float(w), rtol=1e-5,
                                   err_msg=key)
    for name, w in one.modules.state_dict().items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=name)
    # the moving statistics moved, by the global batch's statistics
    before = flax_to_state_dict(variables)
    assert all(not torch.equal(got[n], before[n]) for n in want if n.endswith(".var"))
