"""The training slice as a whole: the tiny MTL model of __graft_entry__
(resnet10, 64x64, float32, all three aux tasks) with the same weights in
mtlx and in the port, and JAX's own random draws injected into the port
(derived as mtlx derives them: fold_in(rng, step) -> split into the
predict and loss keys -> split per image -> split into pos and neg keys
-> uniform).

  * the sampled proposals (on mtlx's RPN proposals): exactly equal
  * every Loss/* term: on mtlx's predictions, and end to end
  * the gradient of every parameter (jax.grad of mtlx's loss_fn against
    the port's .grad, mapped through the bridge's paths)
  * the parameters after one make_train_step step

"allclose" is rtol 1e-4 with an atol of 1e-4 times the tensor's largest
magnitude (sums of convolutions in another order). Observed max
differences: losses 6e-7 relative; gradients 4.3e-5 of the tensor's
largest magnitude (rpn.box_encodings.weight, the worst); grad_norm
2.8e-5 relative; parameters after the step 8.5e-6 of the tensor's
largest magnitude.

make_optimizer alone is held against optax on a toy tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from mtlx.train import train_step as jts
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig, MTLConfig
from mtlx_torch.train import train_step as tts


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


LR = 0.01


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


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


def jax_draws(rng, step, batch_size, num_proposals, num_anchors):
    """The uniforms mtlx's train step draws, keyed as the port's draws."""
    rng_predict, rng_loss = jax.random.split(jax.random.fold_in(rng, step))

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
    jmodel = graft._flagship(canvas=(64, 64), dtype=jnp.float32, **graft._TINY_KW)
    variables = _randomize(jmodel.init_variables(jax.random.PRNGKey(0)), 7)
    rs = np.random.RandomState(0)
    batch = {
        "image": rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        # true extents inside the canvas: a box edge at the canvas edge puts
        # a crop sample exactly on the map's last row, which jitted mtlx
        # moves out of range by an ulp (ROADMAP.md queue 3)
        "true_shape": np.asarray([[56, 60], [48, 56]], np.int32),
        "gt_boxes": np.asarray([[[2, 3, 54, 58], [20, 10, 50, 45], [20, 10, 50, 45], [0, 0, 0, 0]],
                                [[4, 4, 44, 50], [10, 20, 30, 40], [0, 0, 0, 0], [0, 0, 0, 0]]],
                               np.float32),
        "gt_classes": np.asarray([[1, 3, 3, 0], [19, 0, 0, 0]], np.int32),
        "gt_mask": np.asarray([[True, True, True, False], [True, True, False, False]]),
    }
    gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"], "mask": batch["gt_mask"]}
    rng = jax.random.PRNGKey(1)
    anchors = jmodel.anchors_for((64, 64))
    c = jmodel.cfg
    draws, rng_predict, rng_loss = jax_draws(rng, 0, 2, c.first_stage_max_proposals,
                                             anchors.shape[0])
    images = jmodel.preprocess(jnp.asarray(batch["image"], jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(params):
        pred = jmodel.predict({"params": params, "batch_stats": stats}, images,
                              batch["true_shape"], training=True, rng=rng_predict,
                              groundtruth=gt)
        losses = jmodel.loss(pred, gt, rng_loss)
        return losses["total_loss"], (losses, pred)

    (_, (jlosses, jpred)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jts.make_optimizer(learning_rate=LR)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), tx=tx)
    new_state, jmetrics = jax.jit(jts.make_train_step(jmodel))(state, batch, rng)

    cfg = FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=torch.float32,
                           mtl=MTLConfig(multiobject=True, closeness=True, foreground=True),
                           **graft._TINY_KW)
    port = FasterRCNN(cfg, device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables, training_heads=True), strict=True)
    return dict(jmodel=jmodel, variables=variables, batch=batch, gt=gt, draws=draws,
                rng_predict=rng_predict, rng_loss=rng_loss,
                jlosses={k: float(v) for k, v in jlosses.items()},
                jpred={k: np.asarray(v) for k, v in jpred.items()},
                jgrads=flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)},
                                          training_heads=True),
                jnew=flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
                    "params": new_state.params, "batch_stats": new_state.batch_stats}),
                    training_heads=True),
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                port=port)


def _tgt(tiny):
    g = tiny["gt"]
    return {"boxes": _t(g["boxes"]), "classes": _t(g["classes"]).long(), "mask": _t(g["mask"])}


def test_sampled_proposals_equal_mtlx(tiny):
    jm, jp, port = tiny["jmodel"], tiny["jpred"], tiny["port"]
    props, _, mask = jm._postprocess_rpn(jp["rpn_objectness_logits"], jp["rpn_box_encodings"],
                                         tiny["batch"]["true_shape"], jp["anchors"])
    want_p, want_m = jm._sample_proposals(tiny["rng_predict"], props, mask, tiny["gt"])
    d = tiny["draws"]
    got_p, got_m = port._sample_proposals(_t(props), _t(mask), _tgt(tiny),
                                          (d["proposal_pos"], d["proposal_neg"]))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    # the jitted predict's proposals: the same selection, coordinates
    # within an ulp of the eager decode
    np.testing.assert_allclose(got_p.numpy(), jp["proposal_boxes"], rtol=1e-6, atol=1e-5)
    assert 0 < got_m.sum() < got_m.numel()


def test_losses_on_mtlx_predictions(tiny):
    pred = {k: _t(v) for k, v in tiny["jpred"].items()}
    got = tiny["port"].loss(pred, _tgt(tiny), tiny["draws"])
    assert set(got) == set(tiny["jlosses"])
    for key, want in tiny["jlosses"].items():
        np.testing.assert_allclose(float(got[key]), want, rtol=1e-5, err_msg=key)
    # the batch has second-stage positives: the box loss is live
    assert tiny["jlosses"]["Loss/BoxClassifierLoss/localization_loss"] > 0


def _port_forward_backward(tiny):
    port = tiny["port"]
    batch = tiny["batch"]
    for p in port.modules.parameters():
        p.grad = None
    images = port.preprocess(_t(batch["image"]).float())
    pred = port.predict_train(images, _t(batch["true_shape"]), _tgt(tiny), tiny["draws"])
    losses = port.loss(pred, _tgt(tiny), tiny["draws"])
    losses["total_loss"].backward()
    return pred, losses


def test_end_to_end_losses_and_gradients(tiny):
    pred, losses = _port_forward_backward(tiny)
    np.testing.assert_array_equal(pred["proposal_mask"].numpy(), tiny["jpred"]["proposal_mask"])
    np.testing.assert_allclose(pred["proposal_boxes"].detach().numpy(),
                               tiny["jpred"]["proposal_boxes"], rtol=1e-5, atol=1e-3)
    for key, want in tiny["jlosses"].items():
        np.testing.assert_allclose(losses[key].item(), want, rtol=1e-4, err_msg=key)
    grads = {n: p.grad for n, p in tiny["port"].modules.named_parameters()}
    assert set(grads) == set(tiny["jgrads"])
    for name, g in grads.items():
        assert g is not None, name
        _close(g.numpy(), tiny["jgrads"][name].numpy())
    for head in ("rpn.", "box_predictor.", "fg_head.", "mo_head.", "cl_head."):
        assert any(float(g.abs().max()) > 0 for n, g in grads.items() if n.startswith(head)), head


def test_one_train_step_matches_mtlx(tiny):
    port = FasterRCNN(tiny["port"].cfg, device="cpu")
    port.modules.load_state_dict(tiny["port"].modules.state_dict())
    state = tts.create_train_state(port, tts.make_optimizer(learning_rate=LR))
    b = {k: _t(v) for k, v in tiny["batch"].items()}
    state, metrics = tts.make_train_step(port)(state, b, draws=tiny["draws"])
    assert state.step == 1
    for key, want in tiny["jmetrics"].items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-4, err_msg=key)
    after = port.modules.state_dict()
    for name, want in tiny["jnew"].items():
        _close(after[name].numpy(), want.numpy(), rtol=1e-4)


def _toy():
    rs = np.random.RandomState(3)
    params = {"a": {"kernel": rs.normal(size=(3, 4)).astype(np.float32),
                    "bias": rs.normal(size=(4,)).astype(np.float32)},
              "b": {"scale": rs.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda x, s=s: (rs.normal(size=x.shape) * s).astype(np.float32),
                                    params) for s in (0.5, 30.0, 1.0)]
    return params, grads


def _named(tree):
    return {f"{m}.{'weight' if k == 'kernel' else k}": torch.from_numpy(np.array(v))
            for m, sub in tree.items() for k, v in sub.items()}


@pytest.mark.parametrize("case", ["constant", "schedule", "bias-multiplier-and-freeze"])
def test_make_optimizer_matches_optax(case):
    """Three updates: one under the clip norm, one far above it (clip
    triggered), one more; the schedule case crosses boundaries at counts 1
    and 2."""
    params, grads = _toy()
    kw = {}
    if case == "schedule":
        lr_j = optax.piecewise_constant_schedule(0.003, {1: 0.1, 2: 0.5})
        lr_t = tts.PiecewiseConstantSchedule(0.003, {1: 0.1, 2: 0.5})
    else:
        lr_j = lr_t = 0.003
    if case == "bias-multiplier-and-freeze":
        kw = dict(bias_grad_multiplier=2.0, freeze_variables=("^b/",))
    jtx = jts.make_optimizer(learning_rate=lr_j, **kw)
    ttx = tts.make_optimizer(learning_rate=lr_t, **kw)
    jstate, tstate = jtx.init(params), ttx.init(_named(params))
    jp, tp = params, _named(params)
    for g in grads:
        jupd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update(_named(g), tstate)
        torch._foreach_add_([tp[n] for n in tstate.names], tupd)
        for name, want in _named(jp).items():
            np.testing.assert_allclose(tp[name].numpy(), want.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)
    assert float(tts.global_norm(list(_named(grads[1]).values()))) > 10.0  # clipped


def test_schedule_switches_at_the_boundary():
    j = optax.piecewise_constant_schedule(0.003, {60000: 0.1, 80000: 0.1})
    t = tts.PiecewiseConstantSchedule(0.003, {60000: 0.1, 80000: 0.1})
    for count in (0, 59999, 60000, 60001, 79999, 80000, 90000):
        assert np.float32(j(count)) == t(count), count


def test_regularization_fn_matches_mtlx():
    assert tts.make_regularization_fn([("rpn", "l2_regularizer", 0.0)]) is None
    assert jts.make_regularization_fn([("rpn", "l2_regularizer", 0.0)]) is None
    rs = np.random.RandomState(4)
    tree = {"rpn": {"conv": {"kernel": rs.normal(size=(3, 3, 2, 4)).astype(np.float32),
                             "bias": rs.normal(size=(4,)).astype(np.float32)}},
            "box_predictor": {"class_logits": {"kernel": rs.normal(size=(5, 3)).astype(np.float32)}}}
    scopes = [("rpn", "l2_regularizer", 0.5), ("box_predictor", "l1_regularizer", 0.25)]
    want = float(jts.make_regularization_fn(scopes)(tree))
    named = flax_to_state_dict({"params": tree})
    got = float(tts.make_regularization_fn(scopes)(named))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_serving_then_training_share_the_anchor_cache(tiny):
    """Anchors cached by an inference-mode predict can be saved for a
    backward pass."""
    port = FasterRCNN(tiny["port"].cfg, device="cpu")
    port.modules.load_state_dict(tiny["port"].modules.state_dict())
    b = tiny["batch"]
    images = port.preprocess(_t(b["image"]).float())
    port.predict(images, _t(b["true_shape"]))
    assert not port.anchors_for((64, 64)).is_inference()
    losses = port.loss(port.predict_train(images, _t(b["true_shape"]), _tgt(tiny), tiny["draws"]),
                       _tgt(tiny), tiny["draws"])
    losses["total_loss"].backward()
    np.testing.assert_allclose(losses["total_loss"].item(), tiny["jlosses"]["total_loss"], rtol=1e-4)
