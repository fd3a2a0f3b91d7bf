"""The classification networks of the port (mtlx_torch/backbones/:
ResNetClassifier, MobileNetV1Classifier, Inception v1 / v3 / v4, VGG-16
and AlexNet, Features and Classifier each) against mtlx on the CPU in
float32.

mtlx's variables are made from its init's shapes with seeded numpy
values (no init to compile; batch norm randomized) and carried over by
`bridge.flax_tree_to_state_dict`. One jitted mtlx apply a network, at
the smallest input the network takes, gives both the logits and the
trunk's output (flax's captured intermediates of `body` / `features`).
Tolerance: allclose at rtol 1e-4 with an atol of 1e-4 times the largest
magnitude (convolution sums in another order), as the Inception-v2 /
IRv2 trunks' test. The classifiers with live batch norm are compared in
eval (the moving statistics); tests/test_torch_classifier_train.py
holds them in training.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.backbones import alexnet as jalex
from mtlx.backbones import inception_v1 as jinc1
from mtlx.backbones import inception_v3 as jinc3
from mtlx.backbones import inception_v4 as jinc4
from mtlx.backbones import mobilenet as jmob
from mtlx.backbones import resnet as jres
from mtlx.backbones import vgg as jvgg
from mtlx_torch.backbones import alexnet as talex
from mtlx_torch.backbones import inception_v1 as tinc1
from mtlx_torch.backbones import inception_v3 as tinc3
from mtlx_torch.backbones import inception_v4 as tinc4
from mtlx_torch.backbones import mobilenet as tmob
from mtlx_torch.backbones import resnet as tres
from mtlx_torch.backbones import vgg as tvgg
from mtlx_torch.bridge import flax_tree_to_state_dict
from test_torch_rfcn import seeded_variables


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


NUM_CLASSES = 10
F32 = torch.float32
# name: (mtlx classifier, port classifier, smallest image side, the
# trunk's scope); widths in full, ResNet at depth 10 (one unit a stage)
CASES = {
    "resnet10": (lambda: jres.ResNetClassifier(10, NUM_CLASSES, dtype=jnp.float32),
                 lambda s: tres.ResNetClassifier(10, NUM_CLASSES, dtype=F32), 33, "body"),
    "mobilenet_v1": (lambda: jmob.MobileNetV1Classifier(NUM_CLASSES, dtype=jnp.float32),
                     lambda s: tmob.MobileNetV1Classifier(NUM_CLASSES, dtype=F32), 33, "body"),
    "inception_v1": (lambda: jinc1.InceptionV1Classifier(NUM_CLASSES, jnp.float32),
                     lambda s: tinc1.InceptionV1Classifier(NUM_CLASSES, F32), 33, "body"),
    "inception_v3": (lambda: jinc3.InceptionV3Classifier(NUM_CLASSES, jnp.float32),
                     lambda s: tinc3.InceptionV3Classifier(NUM_CLASSES, F32), 33, "body"),
    "inception_v4": (lambda: jinc4.InceptionV4Classifier(NUM_CLASSES, jnp.float32),
                     lambda s: tinc4.InceptionV4Classifier(NUM_CLASSES, F32), 33, "body"),
    "vgg16": (lambda: jvgg.VGG16Classifier(NUM_CLASSES, jnp.float32),
              lambda s: tvgg.VGG16Classifier(NUM_CLASSES, F32, image_size=s), 32, "features"),
    "alexnet": (lambda: jalex.AlexNetClassifier(NUM_CLASSES, jnp.float32),
                lambda s: talex.AlexNetClassifier(NUM_CLASSES, F32, image_size=s), 67,
                "features"),
}


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _port(make, side, variables):
    net = make(side)
    net.load_state_dict(flax_tree_to_state_dict(variables), strict=True)
    return net.eval()


class _DropoutDraws(fnn.Module):
    """The uniforms of AlexNetClassifier's nn.Dropout at scopes
    `Dropout_0` and `Dropout_1`: the same scope path draws the same
    make_rng key, and jax.random.bernoulli(key, keep, shape) is
    uniform(key, shape) < keep."""

    shape: tuple
    leaf: bool = False

    @fnn.compact
    def __call__(self):
        if self.leaf:
            return jax.random.uniform(self.make_rng("dropout"), self.shape)
        return [_DropoutDraws(self.shape, True, name=f"Dropout_{i}")() for i in range(2)]


@pytest.mark.parametrize("name", list(CASES))
def test_classifier_and_trunk_equal_mtlx(name):
    make_j, make_t, side, trunk = CASES[name]
    model = make_j()
    images = np.random.RandomState(1).normal(0, 1, (2, side, side, 3)).astype(np.float32)
    variables = seeded_variables(model.init, 0, jnp.zeros((1, side, side, 3)))
    logits, state = jax.jit(lambda v, x: model.apply(
        v, x, capture_intermediates=lambda mdl, _: mdl.name == trunk,
        mutable=["intermediates"]))(variables, images)
    want_trunk = state["intermediates"][trunk]["__call__"][0]
    net = _port(make_t, side, variables)
    x = torch.from_numpy(images)
    with torch.no_grad():
        got_trunk = getattr(net, trunk)(x)
        got = net(x)
    assert got.dtype == torch.float32 and got.shape == (2, NUM_CLASSES)
    _close(got.numpy(), logits)
    want_trunk = list(want_trunk) if isinstance(want_trunk, (list, tuple)) else [want_trunk]
    got_trunk = list(got_trunk) if isinstance(got_trunk, (list, tuple)) else [got_trunk]
    assert len(got_trunk) == len(want_trunk)
    for g, w in zip(got_trunk, want_trunk):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)


def test_alexnet_dropout_with_flax_draws():
    """AlexNet's classifier with its two dropouts on (deterministic=False),
    the port given flax's uniforms: allclose as above."""
    make_j, make_t, side, _ = CASES["alexnet"]
    model = make_j()
    images = np.random.RandomState(2).normal(0, 1, (2, side, side, 3)).astype(np.float32)
    variables = seeded_variables(model.init, 3, jnp.zeros((1, side, side, 3)))
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda v, x: model.apply(v, x, deterministic=False,
                                            rngs={"dropout": key}))(variables, images)
    draws = _DropoutDraws((2, 4096)).apply({}, rngs={"dropout": key})
    net = _port(make_t, side, variables)
    uniforms = [torch.from_numpy(np.array(d)) for d in draws]
    assert [tuple(u.shape) for u in uniforms] == list(net.dropout_shapes(2))
    with torch.no_grad():
        got = net(torch.from_numpy(images), deterministic=False, dropout_uniforms=uniforms)
        plain = net(torch.from_numpy(images))
    _close(got.numpy(), want)
    assert not np.allclose(got.numpy(), plain.numpy())  # the dropouts acted
    with pytest.raises(ValueError, match="dropout draws"):
        net(torch.from_numpy(images), deterministic=False)
