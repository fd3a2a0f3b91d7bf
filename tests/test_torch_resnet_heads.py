"""The port's ResNet trunk and heads against mtlx's flax modules, with the
flax weights carried over by the bridge. float32 on both sides;
tolerance rtol 1e-4 / atol 1e-4 (convolutions sum in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.backbones import resnet as jresnet
from mtlx.heads import box_predictors as jheads
from mtlx_torch.backbones import resnet as tresnet
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.heads import box_predictors as theads


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize(variables, seed):
    """Random batch-norm affines and statistics, so the frozen-BN fold is
    exercised (flax's init leaves them at the identity)."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rs.normal(0, 0.2, x.shape).astype(np.float32)
        return x  # kernels keep flax's init

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _load(module, variables, top):
    """Bridge flax variables of one module, nested under the detector's
    top-level name `top`, into the port's module of the same structure."""
    nested = {col: {top: tree} for col, tree in variables.items()}
    state = {k[len(top) + 1:]: v for k, v in flax_to_state_dict(nested).items()}
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.mark.parametrize("slim", [False, True], ids=["stride-first", "slim"])
@pytest.mark.parametrize("hw", [(64, 64), (67, 61)], ids=["even", "odd"])
def test_proposal_features_match_flax(hw, slim):
    rs = np.random.RandomState(hw[0] + slim)
    x = rs.normal(0, 1, (2, *hw, 3)).astype(np.float32)  # O(1) activations
    fmod = jresnet.ResNetProposalFeatures(depth=10, dtype=jnp.float32, slim_stride_order=slim)
    variables = _randomize(fmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), 1)
    want = np.asarray(fmod.apply(variables, jnp.asarray(x)))
    port = _load(tresnet.ResNetProposalFeatures(10, torch.float32, slim_stride_order=slim),
                 variables, "backbone")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_box_classifier_features_match_flax():
    rs = np.random.RandomState(3)
    x = rs.normal(0, 1, (3, 7, 7, 1024)).astype(np.float32)
    fmod = jresnet.ResNetBoxClassifierFeatures(depth=10, dtype=jnp.float32)
    variables = _randomize(fmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 7, 7, 1024))), 2)
    want = np.asarray(fmod.apply(variables, jnp.asarray(x)))
    port = _load(tresnet.ResNetBoxClassifierFeatures(10, torch.float32), variables,
                 "classifier_backbone")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("atrous", [1, 2])
def test_rpn_head_matches_flax(atrous):
    rs = np.random.RandomState(atrous)
    feats = rs.normal(0, 1, (2, 5, 7, 16)).astype(np.float32)
    fmod = jheads.RPNHead(num_anchors_per_location=3, depth=32, atrous_rate=atrous,
                          dtype=jnp.float32)
    variables = _randomize(fmod.init(jax.random.PRNGKey(2), jnp.asarray(feats)), 3)
    want_obj, want_box = fmod.apply(variables, jnp.asarray(feats))
    port = _load(theads.RPNHead(16, 3, depth=32, atrous_rate=atrous, dtype=torch.float32),
                 variables, "rpn")
    with torch.no_grad():
        obj, box = port(torch.from_numpy(feats))
    assert obj.shape == (2, 5 * 7 * 3, 2) and box.shape == (2, 5 * 7 * 3, 4)
    np.testing.assert_allclose(obj.numpy(), np.asarray(want_obj), **TOL)
    np.testing.assert_allclose(box.numpy(), np.asarray(want_box), **TOL)


def test_box_predictor_matches_flax():
    rs = np.random.RandomState(4)
    pooled = rs.normal(0, 1, (6, 32)).astype(np.float32)
    fmod = jheads.MaskRCNNBoxPredictor(num_classes=5, dtype=jnp.float32)
    variables = _randomize(fmod.init(jax.random.PRNGKey(3), jnp.asarray(pooled)), 4)
    want_cls, want_box = fmod.apply(variables, jnp.asarray(pooled))
    port = _load(theads.MaskRCNNBoxPredictor(32, 5, torch.float32), variables, "box_predictor")
    with torch.no_grad():
        cls, box = port(torch.from_numpy(pooled))
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), **TOL)
    np.testing.assert_allclose(box.numpy(), np.asarray(want_box), **TOL)
