"""The MTL aux heads against mtlx's flax modules, with the flax weights
carried over by the bridge (float32 both sides; rtol 1e-5 / atol 1e-5,
and 1e-4 behind the LayerNorm, whose one-pass variance mean(x^2) -
mean(x)^2 cancels and so depends on the order of the sums). The pooled
inputs have a mean of 1 and a spread of 0.05, where flax's LayerNorm
(epsilon 1e-6, one-pass variance) and nn.LayerNorm's defaults (1e-5,
two-pass variance) part by more than 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.heads import aux_heads as jaux
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.heads import aux_heads as taux

TOL = dict(rtol=1e-5, atol=1e-5)


def _load(module, variables, top):
    nested = {col: {top: tree} for col, tree in variables.items()}
    state = {k[len(top) + 1:]: v
             for k, v in flax_to_state_dict(nested, training_heads=True).items()}
    module.load_state_dict(state, strict=True)
    return module


def _randomize_ln(variables, seed):
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-2].key == "ln":
            return rs.normal(1.0 if path[-1].key == "scale" else 0.0, 0.3, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def test_foreground_head_matches_flax():
    feats = np.random.RandomState(0).normal(0, 1, (2, 5, 7, 16)).astype(np.float32)
    fmod = jaux.ForegroundHead(depth=8, dtype=jnp.float32)
    variables = fmod.init(jax.random.PRNGKey(0), jnp.asarray(feats))
    want = np.asarray(fmod.apply(variables, jnp.asarray(feats)))
    port = _load(taux.ForegroundHead(16, depth=8, dtype=torch.float32), variables, "fg_head")
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    assert got.shape == (2, 5, 7)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("head", ["multiobject", "closeness"])
def test_pooled_heads_match_flax(head):
    rs = np.random.RandomState(1)
    pooled = (1.0 + 0.05 * rs.normal(size=(3, 6, 32))).astype(np.float32)
    cls = {"multiobject": (jaux.MultiObjectHead, taux.MultiObjectHead, "mo_head"),
           "closeness": (jaux.ClosenessHead, taux.ClosenessHead, "cl_head")}[head]
    fmod = cls[0](num_classes=5, hidden=24, dtype=jnp.float32)
    variables = _randomize_ln(fmod.init(jax.random.PRNGKey(2), jnp.asarray(pooled)), 3)
    want_logits, want_hidden = fmod.apply(variables, jnp.asarray(pooled))
    port = _load(cls[1](32, 5, hidden=24, dtype=torch.float32), variables, cls[2])
    with torch.no_grad():
        logits, hidden = port(torch.from_numpy(pooled))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), rtol=1e-4, atol=1e-4)
    # torch's own LayerNorm defaults would not match here
    ln = torch.nn.functional.layer_norm(torch.from_numpy(pooled), (32,))
    ref_ln = np.asarray(jax.vmap(jax.vmap(lambda x: (x - x.mean()) * jax.lax.rsqrt(
        jnp.maximum(0.0, (x * x).mean() - x.mean() ** 2) + 1e-6)))(jnp.asarray(pooled)))
    assert np.abs(ln.numpy() - ref_ln).max() > 1e-3
