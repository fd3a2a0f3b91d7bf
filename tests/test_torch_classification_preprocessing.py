"""The port's classification preprocessing
(mtlx_torch/data/classification_preprocessing.py) against mtlx's on the
CPU: vgg_preprocess and inception_preprocess, train and eval, on a batch
of images of two shapes and two output sizes, with JAX's draws injected
(each image's key split as mtlx splits it, and `jax.random.uniform` of
each leaf key passed as the port's [0, 1) draw).

Tolerance: the crop boxes within 1e-6 relative; the images allclose at
rtol 1e-5 with an atol of 1e-5 times the largest magnitude, the one the
mask targets of the port take (mtlx crops with the two-matmul
crop_and_resize_mxu, the port with the gather crop, whose sums round
differently). The crop goes through one batch_crop_and_resize call a
batch (spied).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.data import classification_preprocessing as jcp
from mtlx_torch.data import classification_preprocessing as tcp
from mtlx_torch.ops import roi as troi

B = 8


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _jax_draws(keys, style):
    """Each image's uniforms as mtlx's preprocess draws them from its key."""
    out = {k: [] for k in tcp.DRAW_KEYS}
    for key in keys:
        if style == "vgg":
            r_crop, r_flip = jax.random.split(key)
            r_bright = None
        else:
            r_crop, r_flip, r_bright = jax.random.split(key, 3)
        subs = dict(zip(("area", "aspect", "y", "x"), jax.random.split(r_crop, 4)))
        subs["flip"] = r_flip
        for k, sub in subs.items():
            out[k].append(float(jax.random.uniform(sub)))
        out["brightness"].append(float(jax.random.uniform(r_bright)) if r_bright is not None
                                 else 0.0)
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


@pytest.fixture
def crop_calls(monkeypatch):
    calls = []
    real = troi.batch_crop_and_resize

    def spy(images, boxes, crop_size, **kw):
        calls.append((tuple(images.shape), tuple(boxes.shape), crop_size))
        return real(images, boxes, crop_size, **kw)

    monkeypatch.setattr(troi, "batch_crop_and_resize", spy)
    return calls


@pytest.mark.parametrize("style", ["vgg", "inception"])
@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("hw,out_size", [((37, 52), (24, 24)), ((48, 40), (17, 29))])
def test_preprocess_equal_mtlx(style, is_training, hw, out_size, crop_calls):
    rs = np.random.RandomState(hw[0] + out_size[1])
    images = rs.uniform(0, 255, (B, *hw, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(hw[1]), B)
    jfn = jcp.vgg_preprocess if style == "vgg" else jcp.inception_preprocess
    tfn = tcp.vgg_preprocess if style == "vgg" else tcp.inception_preprocess
    want = np.stack([np.asarray(jfn(k, jnp.asarray(im), out_size, is_training))
                     for k, im in zip(keys, images)])
    draws = _jax_draws(keys, style) if is_training else None
    got = tfn(torch.from_numpy(images), draws, out_size, is_training)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got.numpy(), want)
    assert crop_calls == [((B, *hw, 3), (B, 1, 4), out_size)]
    if is_training:  # both flip sides occur
        assert 0 < int((draws["flip"] < 0.5).sum()) < B


def test_crop_boxes_equal_mtlx():
    """The random crop's boxes: mtlx's arithmetic, each side capped."""
    h, w = 30, 70
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    draws = _jax_draws(keys, "inception")
    got = tcp.random_crop_boxes(draws, h, w).numpy()
    for i, key in enumerate(keys):
        r_crop = jax.random.split(key, 3)[0]
        r_area, r_aspect, r_y, r_x = jax.random.split(r_crop, 4)
        area = jax.random.uniform(r_area, minval=0.08, maxval=1.0)
        aspect = jax.random.uniform(r_aspect, minval=0.75, maxval=1.333)
        ch = jnp.minimum(jnp.sqrt(area * h * w / aspect), h)
        cw = jnp.minimum(jnp.sqrt(area * h * w / aspect) * aspect, w)
        y0 = jax.random.uniform(r_y) * (h - ch)
        x0 = jax.random.uniform(r_x) * (w - cw)
        want = np.asarray([y0 / h, x0 / w, (y0 + ch) / h, (x0 + cw) / w])
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-7)
    assert (got[:, 2] - got[:, 0] == 1.0).any()  # a side capped at the image's


def test_draws_and_their_absence():
    gen = torch.Generator().manual_seed(0)
    draws = tcp.make_draws(3, gen)
    assert list(draws) == list(tcp.DRAW_KEYS)
    assert all(v.shape == (3,) and (v >= 0).all() and (v < 1).all() for v in draws.values())
    images = torch.rand(3, 20, 20, 3) * 255
    with pytest.raises(ValueError, match="needs the draws"):
        tcp.inception_preprocess(images, {"area": draws["area"]}, (8, 8))
    with pytest.raises(ValueError, match="needs the draws"):
        tcp.vgg_preprocess(images, None, (8, 8))
    # eval needs none, and a training call is a function of its draws
    assert tcp.vgg_preprocess(images, None, (8, 8), is_training=False).shape == (3, 8, 8, 3)
    a = tcp.inception_preprocess(images, draws, (8, 8))
    assert torch.equal(a, tcp.inception_preprocess(images, draws, (8, 8)))
    # jax.random.bernoulli(key, 0.5) is uniform(key) < 0.5: a flip at 0.4999, none at 0.5
    edge = dict(draws, flip=torch.tensor([0.4999, 0.5, 0.9]))
    flipped = tcp.vgg_preprocess(images, edge, (8, 8))
    plain = tcp.vgg_preprocess(images, dict(edge, flip=torch.ones(3)), (8, 8))
    assert torch.equal(flipped[0], plain[0].flip(1)) and torch.equal(flipped[1:], plain[1:])
