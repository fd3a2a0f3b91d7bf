"""The weight bridge at ResNet-50 depth, and the flagship config: the port's
`flagship_config()`, its parse of the pipeline file and mtlx's builder
must agree field by field."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.builders import model_builder as jbuilder
from mtlx.config import config_util as jconfig
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.builders import model_builder as tbuilder
from mtlx_torch.config import config_util as tconfig
from mtlx_torch.detector.faster_rcnn import FasterRCNNModules, flagship_config

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "faster_rcnn_resnet50_mtl_voc0712.config")


@pytest.fixture(scope="module")
def flagship_shapes():
    """Shapes of every variable of mtlx's flagship model as it trains (the
    MTL heads included), from jax.eval_shape: nothing is compiled."""
    configs = jconfig.get_configs_from_pipeline_file(FLAGSHIP)
    model = jbuilder.build(configs["model"], is_training=True)
    return jax.eval_shape(model.modules.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))


def _zeros_like(shapes):
    return jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)


def test_bridge_maps_every_inference_leaf_at_depth_50(flagship_shapes):
    state = flax_to_state_dict(_zeros_like(flagship_shapes))
    port = FasterRCNNModules(flagship_config(dtype=torch.bfloat16)).state_dict()
    assert sorted(state) == sorted(port)
    for key, t in port.items():
        assert tuple(state[key].shape) == tuple(t.shape), key
    # the training-only MTL heads were in the tree and were skipped
    assert {"fg_head", "mo_head", "cl_head"} <= set(flagship_shapes["params"])
    assert not any(k.startswith(("fg_head", "mo_head", "cl_head")) for k in state)


def test_bridge_transposes_kernels():
    rs = np.random.RandomState(0)
    conv = rs.normal(size=(3, 3, 4, 5)).astype(np.float32)  # HWIO
    dense = rs.normal(size=(6, 7)).astype(np.float32)  # [in, out]
    state = flax_to_state_dict({"params": {
        "rpn": {"conv": {"kernel": conv}},
        "box_predictor": {"class_logits": {"kernel": dense, "bias": np.ones(7, np.float32)}},
    }})
    np.testing.assert_array_equal(state["rpn.conv.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["box_predictor.class_logits.weight"].numpy(), dense.T)


@pytest.mark.parametrize("variables", [
    {"params": {"mask_head": {"conv1": {"kernel": np.zeros((3, 3, 2, 2), np.float32)}}}},
    {"params": {"rpn": {"conv": {"gamma": np.zeros(2, np.float32)}}}},
    {"batch_stats": {"backbone": {"bn1": {"count": np.zeros(2, np.float32)}}}},
    {"cache": {"rpn": {"conv": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}}}},
], ids=["unported-module", "unknown-param", "unknown-stat", "unknown-collection"])
def test_bridge_raises_on_unmapped_leaves(variables):
    with pytest.raises(ValueError):
        flax_to_state_dict(variables)


def test_flagship_config_matches_both_builders():
    port_parsed = tbuilder.build_config(
        tconfig.get_configs_from_pipeline_file(FLAGSHIP)["model"], is_training=False
    )
    assert flagship_config() == port_parsed

    jconfigs = jconfig.get_configs_from_pipeline_file(FLAGSHIP)
    ref = jbuilder.build(jconfigs["model"], is_training=False).cfg
    port = flagship_config()
    fr = jconfigs["model"].faster_rcnn
    for field in dataclasses.fields(ref):
        name = field.name
        want, got = getattr(ref, name), getattr(port, name)
        if name == "dtype":
            assert jnp.dtype(want).name == str(got).split(".")[-1]
        elif name == "rpn_conv_initializer":
            init = fr.first_stage_box_predictor_conv_hyperparams.initializer
            assert got == ("truncated_normal", init.truncated_normal_initializer.stddev)
        elif name == "second_stage_fc_initializer":
            vs = fr.second_stage_box_predictor.mask_rcnn_box_predictor.fc_hyperparams \
                .initializer.variance_scaling_initializer
            assert got == ("variance_scaling", vs.factor, "fan_avg", "uniform")
        elif name == "mtl":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, name
    assert port.num_classes == 20 and port.rpn_depth == 512


def test_flagship_train_config_matches_both_builders():
    from mtlx_torch.detector.faster_rcnn import flagship_train_config

    port_parsed = tbuilder.build_config(
        tconfig.get_configs_from_pipeline_file(FLAGSHIP)["model"], is_training=True
    )
    assert flagship_train_config() == port_parsed
    ref = jbuilder.build(jconfig.get_configs_from_pipeline_file(FLAGSHIP)["model"],
                         is_training=True).cfg
    port = flagship_train_config()
    for field in dataclasses.fields(ref):
        want, got = getattr(ref, field.name), getattr(port, field.name)
        if field.name == "mtl":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.multiobject and got.closeness and got.foreground
        elif field.name not in ("dtype", "rpn_conv_initializer", "second_stage_fc_initializer"):
            assert got == want, field.name  # the initializers are checked above
    assert dataclasses.replace(port, mtl=flagship_config().mtl) == flagship_config()


def test_bridge_maps_every_training_leaf_at_depth_50(flagship_shapes):
    from mtlx_torch.detector.faster_rcnn import flagship_train_config

    state = flax_to_state_dict(_zeros_like(flagship_shapes), training_heads=True)
    modules = FasterRCNNModules(flagship_train_config())
    port = modules.state_dict()
    assert sorted(state) == sorted(port)
    for key, t in port.items():
        assert tuple(state[key].shape) == tuple(t.shape), key
    # every flax param is a trained parameter of the port, every batch
    # statistic a buffer
    params = dict(modules.named_parameters())
    n_params = len(jax.tree_util.tree_leaves(flagship_shapes["params"]))
    assert len(params) == n_params
    assert all(k.endswith((".mean", ".var")) for k in set(port) - set(params))
    assert all(p.dtype == torch.float32 for p in params.values())


def test_optimizer_builder_matches_mtlx():
    from mtlx.builders import optimizer_builder as jopt
    from mtlx_torch.builders import optimizer_builder as topt

    tc = tconfig.get_configs_from_pipeline_file(FLAGSHIP)["train_config"]
    jc = jconfig.get_configs_from_pipeline_file(FLAGSHIP)["train_config"]
    tx, lr, ema = topt.build(tc.optimizer, tc)
    _, jlr, jema = jopt.build(jc.optimizer, jc)
    assert ema is None and jema is None
    assert tx.momentum == pytest.approx(0.9) and tx.clip == 10.0
    assert not tx.bias_grad_multiplier and not tx.freeze
    for count in (0, 59999, 60000, 79999, 80000, 89999):
        assert np.float32(jlr(count)) == lr(count), count
