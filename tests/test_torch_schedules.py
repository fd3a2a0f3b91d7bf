"""The port's learning-rate schedules and the optimizer built from a
pipeline, against mtlx's optax schedules and optimizer on the CPU.

Tolerances:
  * each schedule against optax at every count from 0 to total + 5:
    rtol 1e-6 (float32 rounding; both evaluate in float32 in the same
    operation order, and the cosine's last ulp can differ);
  * the optimizer built from the learnability tool's CONFIG against the
    optax chain mtlx builds from the same text, over 40 updates that cross
    the warm-up: the updates within rtol 1e-6 and an atol of 1e-6 times
    the update's largest magnitude (float32, the same operation order).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtlx_torch.builders import optimizer_builder as topt
from mtlx_torch.config import config_util as tconfig
from mtlx_torch.tools import synthetic_e2e_check as ttool
from mtlx_torch.train.train_step import ExponentialDecaySchedule, WarmupCosineDecaySchedule

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# mtlx's tool, tools/synthetic_e2e_check.py, loaded from its file
_spec = importlib.util.spec_from_file_location(
    "mtlx_synthetic_e2e_check", os.path.join(_REPO, "tools", "synthetic_e2e_check.py"))
jtool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtool)


def _assert_schedule(port, ref, counts):
    got = np.asarray([port(c) for c in counts], np.float32)
    want = np.asarray([np.float32(ref(jnp.int32(c))) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("init,peak,warmup,total", [
    (0.001, 0.01, 30, 300),  # the learnability tool's schedule
    (0.0, 0.003, 0, 1000),
    (0.0002, 0.04, 100, 2000),
    (0.001, 0.01, 1, 2),
])
def test_warmup_cosine_equals_optax(init, peak, warmup, total):
    _assert_schedule(WarmupCosineDecaySchedule(init, peak, warmup, total),
                     optax.warmup_cosine_decay_schedule(init, peak, warmup, total),
                     range(total + 6))


def test_warmup_cosine_raises_as_optax_does():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.001, 0.01, 30, 2)
    with pytest.raises(ValueError, match="decay_steps > warmup_steps"):
        WarmupCosineDecaySchedule(0.001, 0.01, 30, 2)


@pytest.mark.parametrize("staircase", [True, False])
@pytest.mark.parametrize("init,steps,rate", [
    (0.004, 800, 0.95),  # the SSD configs' schedule
    (0.1, 7, 0.5),
    (0.1, 3, 1.5),
    (0.1, 0, 0.5),  # no transition: constant
    (0.1, 3, 0.0),  # zero rate: constant
])
def test_exponential_decay_equals_optax(init, steps, rate, staircase):
    total = max(steps, 10) * 3
    _assert_schedule(ExponentialDecaySchedule(init, steps, rate, staircase),
                     optax.exponential_decay(init, steps, rate, staircase=staircase),
                     range(total + 6))


def test_builder_maps_the_protos():
    pipeline = tconfig.parse_pipeline_text("""
train_config { optimizer { momentum_optimizer {
  learning_rate { exponential_decay_learning_rate {
    initial_learning_rate: 0.004 decay_steps: 800 decay_factor: 0.95 } }
  momentum_optimizer_value: 0.9 } use_moving_average: false } }""")
    _, lr, _ = topt.build(pipeline.train_config.optimizer, pipeline.train_config)
    assert isinstance(lr, ExponentialDecaySchedule)
    assert lr.staircase  # the proto's default
    _assert_schedule(lr, optax.exponential_decay(0.004, 800, 0.95, staircase=True),
                     range(0, 4000, 7))


def _tool_config(tool, steps: int) -> str:
    return tool.CONFIG.format(steps=steps, record="/r", label_map="/l",
                              resizer="fixed_shape_resizer { height: 128 width: 128 }")


def test_tool_optimizer_equals_mtlx():
    from google.protobuf import text_format

    from mtlx.builders import optimizer_builder as jopt
    from mtlx.config.protos import pipeline_pb2

    assert ttool.CONFIG == jtool.CONFIG
    steps = 40
    tcfg = tconfig.parse_pipeline_text(_tool_config(ttool, steps)).train_config
    jcfg = text_format.Parse(_tool_config(jtool, steps),
                             pipeline_pb2.TrainEvalPipelineConfig()).train_config
    ttx, tlr, tema = topt.build(tcfg.optimizer, tcfg)
    jtx, jlr, jema = jopt.build(jcfg.optimizer, jcfg)
    assert tema is None and jema is None
    _assert_schedule(tlr, jlr, range(steps + 6))

    rs = np.random.RandomState(0)
    shapes = {"backbone.conv.weight": (3, 4), "box.bias": (5,)}
    params = {k: rs.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for step in range(steps):
        scale = 40.0 if step % 7 == 0 else 1.0  # some steps clip at norm 10
        grads = {k: (rs.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                  jparams)
        tupd, tstate = ttx.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate)
        for name, t in zip(tstate.names, tupd):
            want = np.asarray(jupd[name])
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{step} {name}")
