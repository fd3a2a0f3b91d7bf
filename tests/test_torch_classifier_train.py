"""The port's classifier train step (mtlx_torch/train/train_classifier.py
`make_classifier_step`) against mtlx's on the CPU: two float32 steps of
a classifier with live batch norm (ResNet at depth 10 and MobileNet-v1,
full width, 32x32, batch 16) against mtlx's step (jax.value_and_grad of
the mean softmax cross-entropy, clip by global norm 10, SGD with
momentum 0.9 on optax.cosine_decay_schedule, the mutated batch
statistics), jitted, each step from the same state (the second from
mtlx's parameters, statistics and momentum trace after the first): the
loss within 1e-4 relative (mtlx's float32 logits lie about 1e-4 of
their largest magnitude from float64 ones at this size), the accuracy
exactly, the learning rate within 1e-6 relative, the moving statistics
allclose at rtol 1e-4 with an atol of 1e-4 times the tensor's largest
magnitude; at the first step the port's float32 gradients within
GRAD64_TOL of its float64 ones from the same state; each parameter's
update within twice the two sides' own float32 gradient errors at that
tensor (against the port's float64 gradients) plus UPDATE_TOL of mtlx's
(L2; see the constants for the measured spreads). The CLI is
tests/test_torch_classifier_cli.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtlx.backbones import mobilenet as jmob
from mtlx.backbones import resnet as jres
from mtlx_torch.backbones import mobilenet as tmob
from mtlx_torch.backbones import resnet as tres
from mtlx_torch.bridge import flax_tree_to_state_dict
from mtlx_torch.train import train_classifier as tcls
from mtlx_torch.train import train_step as ts
from test_torch_rfcn import seeded_variables


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


NUM_CLASSES, SIDE, BATCH, LR, NUM_STEPS = 5, 32, 16, 0.1, 4
# L2 of the difference over L2, per tensor. At the first step mtlx's
# float32 gradients lie up to 5.4e-3 from the port's float64 ones
# (through the live batch norms' nearly cancelling sums) and the port's
# float32 ones within 2.6e-5, which GRAD64_TOL holds; after one update at
# learning rate 0.1 MobileNet's float32 gradients on both sides lie about
# 1e-2 from float64. Each parameter's update is held to mtlx's within
# twice the two sides' own float32 gradient errors at that tensor (each
# against the port's float64 gradients from the same state) plus
# UPDATE_TOL
UPDATE_TOL = 1e-3
GRAD64_TOL = 2e-4
NETS = {
    "resnet10": (lambda: jres.ResNetClassifier(10, NUM_CLASSES, dtype=jnp.float32),
                 lambda: tres.ResNetClassifier(10, NUM_CLASSES, dtype=torch.float32),
                 jres.preprocess_images, tres.preprocess_images),
    "mobilenet_v1": (lambda: jmob.MobileNetV1Classifier(NUM_CLASSES, dtype=jnp.float32),
                     lambda: tmob.MobileNetV1Classifier(NUM_CLASSES, dtype=torch.float32),
                     lambda x: x * (2.0 / 255.0) - 1.0, tcls.mobilenet_preprocess),
}


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _mtlx_step(model, preprocess):
    """mtlx/train/train_classifier.py's optimizer and step (main :92-121),
    which also returns its raw gradients."""
    schedule = optax.cosine_decay_schedule(LR, NUM_STEPS)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.sgd(schedule, momentum=0.9))

    @jax.jit
    def step(params, batch_stats, opt_state, images, labels):
        def loss_fn(p):
            logits, mutated = model.apply({"params": p, "batch_stats": batch_stats},
                                          preprocess(images), train=True,
                                          mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            acc = jnp.mean(jnp.argmax(logits, -1) == labels)
            return jnp.mean(ce), (acc, mutated["batch_stats"])

        (loss, (acc, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, acc, grads

    return tx, schedule, step


def _float64(net):
    """The port's network computing in float64 (the truth the float32
    gradients are held to)."""
    net.double()
    for m in net.modules():
        if isinstance(getattr(m, "compute_dtype", None), torch.dtype):
            m.compute_dtype = torch.float64
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return net


def _l2_rel(got, want):
    return float((got.double() - want.double()).norm() / max(want.double().norm(), 1e-30))


@pytest.mark.parametrize("name", list(NETS))
def test_classifier_steps_equal_mtlx(name):
    make_j, make_t, pre_j, pre_t = NETS[name]
    model = make_j()
    variables = seeded_variables(model.init, 0, jnp.zeros((1, SIDE, SIDE, 3)))
    tx, schedule, jstep = _mtlx_step(model, pre_j)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    net = make_t()
    net.load_state_dict(flax_tree_to_state_dict(variables), strict=True)
    port = tcls.Classifier(net, pre_t)
    tx_t = tcls.make_optimizer(LR, NUM_STEPS)
    state = ts.create_train_state(port, tx_t)
    step = tcls.make_classifier_step(port)
    net64 = _float64(make_t())

    rs = np.random.RandomState(3)
    for i in range(2):
        if i:  # both sides start the step from mtlx's state
            net.load_state_dict(flax_tree_to_state_dict({"params": params,
                                                         "batch_stats": stats}))
            trace = flax_tree_to_state_dict({"params": opt_state[1][0].trace})
            for name_, t in zip(state.opt_state.names, state.opt_state.trace):
                t.copy_(trace[name_])
        before = {k: v.clone() for k, v in net.state_dict().items()}
        net64.load_state_dict(before)
        net64.zero_grad(set_to_none=True)
        np.testing.assert_allclose(tx_t.lr(i), schedule(i), rtol=1e-6)
        images = rs.uniform(0, 255, (BATCH, SIDE, SIDE, 3)).astype(np.float32)
        labels = rs.randint(0, NUM_CLASSES, BATCH)
        params, stats, opt_state, loss, acc, jgrads = jstep(params, stats, opt_state, images,
                                                             labels)
        state, t_loss, t_acc = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-4)
        assert t_acc.item() == float(acc)
        # the gradients of the same state in float64
        tcls.softmax_cross_entropy(net64.train()(pre_t(torch.from_numpy(images)).double()),
                                   torch.from_numpy(labels)).mean().backward()
        grads64 = {k: p.grad for k, p in net64.named_parameters()}
        jgrads = flax_tree_to_state_dict({"params": jgrads})
        want = flax_tree_to_state_dict({"params": params, "batch_stats": stats})
        got = net.state_dict()
        assert sorted(got) == sorted(want)
        for key, p in net.named_parameters():
            port_err = _l2_rel(p.grad, grads64[key])
            if i == 0:
                assert port_err < GRAD64_TOL, key
            mtlx_err = _l2_rel(jgrads[key], grads64[key])
            assert _l2_rel(got[key] - before[key], want[key] - before[key]) \
                < 2 * (mtlx_err + port_err) + UPDATE_TOL, key
        for key, _ in net.named_buffers():  # the moving statistics
            _close(got[key].numpy(), want[key].numpy())
    assert state.step == 2 and state.opt_state.count == 2
