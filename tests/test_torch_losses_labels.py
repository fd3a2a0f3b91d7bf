"""The port's losses, MTL pseudo-labels, windows and horizontal flip
against mtlx on the CPU, on the same seeded inputs (float32). Random
draws (sampled windows, the flip) are JAX's own, injected. Tolerance
rtol 1e-6 / atol 1e-6 (one-ulp differences of exp and log); the flip,
the foreground mask and the windows of integer-valued boxes are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.data import preprocessor as jprep
from mtlx.labels import recycle as jrec
from mtlx.losses import losses as jloss
from mtlx_torch.data import preprocessor as tprep
from mtlx_torch.labels import recycle as trec
from mtlx_torch.losses import losses as tloss

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gt(seed, g=7, scale=64.0):
    rs = np.random.RandomState(seed)
    c = rs.uniform(0, scale, (g, 2))
    hw = rs.uniform(2, scale / 2, (g, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], 1).astype(np.float32)
    classes = rs.randint(0, 20, g).astype(np.int32)
    mask = np.ones(g, bool)
    mask[-2:] = False
    boxes[-1] = 0.0
    classes[-2] = -1  # a padded row whose class is out of range
    boxes[2], classes[2] = boxes[1], classes[1]  # a duplicate object
    return boxes, classes, mask


def test_losses_match_mtlx():
    rs = np.random.RandomState(0)
    pred = rs.normal(0, 2, (3, 50, 4)).astype(np.float32)
    target = rs.normal(0, 2, (3, 50, 4)).astype(np.float32)
    w = rs.uniform(0, 1, (3, 50)).astype(np.float32)
    logits = rs.normal(0, 3, (3, 50, 21)).astype(np.float32)
    soft = rs.dirichlet(np.ones(21), (3, 50)).astype(np.float32)
    bin_labels = (rs.uniform(size=(3, 50, 21)) < 0.3).astype(np.float32)
    cases = [
        (tloss.weighted_smooth_l1_loss(_t(pred), _t(target), _t(w)),
         jloss.weighted_smooth_l1_loss(pred, target, w)),
        (tloss.sigmoid_cross_entropy(_t(logits), _t(bin_labels)),
         jloss.sigmoid_cross_entropy(logits, bin_labels)),
        (tloss.softmax_cross_entropy(_t(logits), _t(soft)),
         jloss.softmax_cross_entropy(logits, soft)),
        (tloss.weighted_softmax_classification_loss(_t(logits), _t(soft), _t(w)),
         jloss.weighted_softmax_classification_loss(logits, soft, w)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_one_hot_is_zero_out_of_range():
    idx = np.asarray([[0, 3, -1, 4, 5]])
    np.testing.assert_array_equal(trec.one_hot(_t(idx), 5).numpy(),
                                  np.asarray(jax.nn.one_hot(idx, 5)))


@pytest.mark.parametrize("seed", [0, 1])
def test_label_generators_match_mtlx(seed):
    boxes, classes, mask = _gt(seed)
    windows = np.asarray(jrec.enlarged_windows(boxes, 2.0))
    got_w = trec.enlarged_windows(_t(boxes), 2.0).numpy()
    np.testing.assert_array_equal(got_w, windows)
    np.testing.assert_allclose(
        trec.multiobject_labels(_t(windows), _t(boxes), _t(classes).long(), _t(mask), 20).numpy(),
        np.asarray(jrec.multiobject_labels(windows, boxes, classes, mask, 20)), **TOL)
    np.testing.assert_allclose(
        trec.closeness_labels(_t(boxes), _t(classes).long(), _t(mask), 20, 0.5).numpy(),
        np.asarray(jrec.closeness_labels(boxes, classes, mask, 20, 0.5)), **TOL)
    norm = boxes / 64.0
    np.testing.assert_array_equal(
        trec.foreground_mask(_t(norm), _t(mask), (4, 5)).numpy(),
        np.asarray(jrec.foreground_mask(norm, mask, (4, 5))))
    # batched, as the detector calls them
    got = trec.closeness_labels(_t(np.stack([boxes, boxes])), _t(np.stack([classes, classes])).long(),
                                _t(np.stack([mask, mask])), 20, 0.5).numpy()
    np.testing.assert_allclose(got[1], np.asarray(jrec.closeness_labels(boxes, classes, mask, 20, 0.5)),
                               **TOL)


def test_sampled_windows_with_jax_draws():
    boxes, _, _ = _gt(3)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jrec.sampled_windows(key, jnp.asarray(boxes), 2.0))
    k_scale, k_off = jax.random.split(key)
    u_scale = np.asarray(jax.random.uniform(k_scale, (boxes.shape[0], 2)))
    u_off = np.asarray(jax.random.uniform(k_off, (boxes.shape[0], 2)))
    got = trec.sampled_windows(_t(boxes), 2.0, (_t(u_scale), _t(u_off))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_horizontal_flip_with_jax_draws():
    rs = np.random.RandomState(2)
    b = 6
    images = rs.uniform(0, 255, (b, 16, 24, 3)).astype(np.float32)
    boxes = np.stack([_gt(i, 5, 16.0)[0] for i in range(b)])
    true_shape = np.asarray([[16, 24], [12, 20], [16, 17], [9, 24], [16, 1], [16, 24]], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(9), b)
    want_img, want_box, u = [], [], []
    for i, key in enumerate(keys):
        out = jprep.random_horizontal_flip(key, {"image": jnp.asarray(images[i]),
                                                 "boxes": jnp.asarray(boxes[i]),
                                                 "true_shape": jnp.asarray(true_shape[i])})
        want_img.append(np.asarray(out["image"]))
        want_box.append(np.asarray(out["boxes"]))
        u.append(float(jax.random.uniform(key)))  # bernoulli(key, p) = uniform(key) < p
    got = tprep.random_horizontal_flip({"image": _t(images), "boxes": _t(boxes),
                                        "true_shape": _t(true_shape)}, torch.tensor(u))
    np.testing.assert_array_equal(got["image"].numpy(), np.stack(want_img))
    np.testing.assert_array_equal(got["boxes"].numpy(), np.stack(want_box))
    flipped = np.asarray(u) < 0.5
    assert flipped.any() and not flipped.all()


def test_other_augmentations_raise():
    with pytest.raises(NotImplementedError, match="queue 1"):
        tprep.batch_preprocess({}, [("random_crop_image", {})], {})
