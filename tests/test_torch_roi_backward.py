"""The crop's d(features) backward (the backward kernel's plain version on
the CPU) against mtlx: `jax.vjp` of mtlx.ops.roi.crop_and_resize_mxu and
the Pallas backward kernel `_bwd_kernel` in interpret mode (float32,
atol 1e-5: the interpolation matrices sum the taps in another order);
gradcheck of the autograd Function in float64; `mean_pooled_crop` and its
gradient against mtlx; the backward kernel's algorithm (a per-pixel gather
in a fixed order) rendered in numpy against both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mtlx.kernels import roi_pallas
from mtlx.ops import roi as jroi
from mtlx_torch.kernels import roi_cuda
from mtlx_torch.ops import roi as troi


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-5


def _inputs(seed, h, w, c, n, ch, cw):
    rs = np.random.RandomState(seed)
    img = rs.normal(0, 1, (h, w, c)).astype(np.float32)
    corners = rs.uniform(-0.3, 1.3, (n, 4))  # some past [0, 1] on each side
    boxes = np.concatenate([np.minimum(corners[:, :2], corners[:, 2:]),
                            np.maximum(corners[:, :2], corners[:, 2:])], 1)
    boxes[0] = [0.0, 0.0, 1.0, 1.0]  # corners on the edge pixels (clamped hi taps)
    boxes[1] = [0.4, 0.4, 0.4, 0.4]  # a point box
    dout = rs.normal(0, 1, (n, ch, cw, c)).astype(np.float32)
    return img, boxes.astype(np.float32), dout


def _pallas_bwd(dout, boxes, h, w):
    """roi_pallas._bwd_kernel through pl.pallas_call(interpret=True)."""
    n, ch, cw, c = dout.shape
    jb = jnp.asarray(boxes)
    wy = jroi._interp_matrix(jb[:, 0], jb[:, 2], ch, h)
    wx = jroi._interp_matrix(jb[:, 1], jb[:, 3], cw, w)
    return pl.pallas_call(
        roi_pallas._bwd_kernel,
        grid=(n,),
        in_specs=[
            pl.BlockSpec((1, ch, cw, c), lambda i: (i, 0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, ch, h), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, cw, w), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((h, w, c), lambda i: (0, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((h, w, c), jnp.float32),
        scratch_shapes=[pltpu.VMEM((ch, w, c), jnp.float32)],
        interpret=True,
    )(jnp.asarray(dout), wy, wx)


def _vjp_mxu(img, boxes, dout):
    ch, cw = dout.shape[1:3]
    _, vjp = jax.vjp(lambda x: jroi.crop_and_resize_mxu(x, jnp.asarray(boxes), (ch, cw)),
                     jnp.asarray(img))
    return np.asarray(vjp(jnp.asarray(dout))[0])


@pytest.mark.parametrize("ref", ["vjp-mxu", "pallas"])
@pytest.mark.parametrize("shape,n,crop", [
    ((12, 16, 8), 9, (6, 6)),
    ((9, 7, 5), 6, (1, 1)),  # crop size 1 samples the box centre
    ((10, 11, 4), 5, (3, 4)),
])
def test_backward_matches_mtlx(ref, shape, n, crop):
    h, w, c = shape
    img, boxes, dout = _inputs(n + h, h, w, c, n, *crop)
    want = _vjp_mxu(img, boxes, dout) if ref == "vjp-mxu" else np.asarray(
        _pallas_bwd(dout, boxes, h, w))
    got = roi_cuda.crop_and_resize_backward(torch.from_numpy(dout)[None],
                                            torch.from_numpy(boxes)[None], (h, w))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=ATOL)


def test_autograd_runs_the_backward_and_skips_the_boxes():
    imgs, boxes, douts = zip(*(_inputs(s, 8, 10, 6, 5, 4, 3) for s in range(2)))
    feats = torch.from_numpy(np.stack(imgs)).requires_grad_()
    bx = torch.from_numpy(np.stack(boxes)).requires_grad_()
    out = troi.batch_crop_and_resize(feats, bx, (4, 3))
    out.backward(torch.from_numpy(np.stack(douts)))
    assert bx.grad is None
    for i in range(2):
        np.testing.assert_allclose(feats.grad[i].numpy(), _vjp_mxu(imgs[i], boxes[i], douts[i]),
                                   rtol=0, atol=ATOL)


def test_gradcheck_float64():
    img, boxes, _ = _inputs(4, 5, 6, 2, 4, 3, 3)
    feats = torch.from_numpy(img).double()[None].requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f: roi_cuda.crop_and_resize(f, torch.from_numpy(boxes)[None], (3, 3)), (feats,))


def test_bfloat16_backward_rounds_the_float32_sum_once():
    _, boxes, dout = _inputs(5, 8, 8, 16, 6, 5, 5)
    d16 = torch.from_numpy(dout)[None].bfloat16()
    got = roi_cuda.crop_and_resize_backward(d16, torch.from_numpy(boxes)[None], (8, 8))
    want = roi_cuda.crop_and_resize_backward(d16.float(), torch.from_numpy(boxes)[None], (8, 8))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("crop", [(7, 7), (1, 1)])
def test_mean_pooled_crop_and_its_gradient_match_mtlx(crop):
    img, boxes, _ = _inputs(6, 9, 12, 8, 7, *crop)
    cot = np.random.RandomState(1).normal(size=(7, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jroi.mean_pooled_crop(x, jnp.asarray(boxes), crop),
                        jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_()
    got = troi.mean_pooled_crop(x, torch.from_numpy(boxes), crop)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=ATOL)
    # batched over images, as the detector pools
    got_b = troi.mean_pooled_crop(torch.from_numpy(np.stack([img, img])),
                                  torch.from_numpy(np.stack([boxes, boxes])), crop)
    np.testing.assert_allclose(got_b[1].numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)


# ---------------------------------------------------------------------------
# The algorithm of the backward kernel (csrc/roi_crop.cu), rendered in numpy:
# a gather. Every pixel of d(features) adds the terms of the samples that
# touch it, box by box, sample row by sample row, sample column by sample
# column, in float32; no pixel is written by two owners. The kernel itself
# runs only on a CUDA device.


def _tap_weight(lo, frac, in_range, p):
    """The weight with which one sample position feeds pixel coordinate p:
    1 - frac on its lo tap, frac on lo + 1, nothing elsewhere."""
    if not in_range:
        return np.float32(0)
    if lo == p:
        return np.float32(1) - frac
    return frac if lo + 1 == p else np.float32(0)


def _gather_backward(dout, boxes, h, w):
    n, ch, cw, c = dout.shape
    (y_lo, _, y_frac, y_in), (x_lo, _, x_frac, x_in) = (
        tuple(t[0].numpy() for t in axis)
        for axis in roi_cuda._sample_points(torch.from_numpy(boxes)[None], (ch, cw), h, w))
    out = np.zeros((h, w, c), np.float32)
    for py in range(h):
        for px in range(w):
            acc = np.zeros(c, np.float32)
            for k in range(n):
                wys = [(i, _tap_weight(y_lo[k, i], y_frac[k, i], y_in[k, i], py))
                       for i in range(ch)]
                wxs = [(j, _tap_weight(x_lo[k, j], x_frac[k, j], x_in[k, j], px))
                       for j in range(cw)]
                for i, wy in wys:
                    if wy == 0:
                        continue
                    for j, wx in wxs:
                        if wx != 0:
                            acc += dout[k, i, j] * (wy * wx)
            out[py, px] = acc
    return out


def _gather_case(kind, h, w, n, crop):
    """Boxes that put samples where the gather could go wrong."""
    img, boxes, dout = _inputs(len(kind) + n, h, w, 3, n, *crop)
    ch, cw = crop
    if kind == "integer":  # sample coordinates on pixel centres: fraction 0
        y0 = np.arange(n) % max(h - ch + 1, 1)
        x0 = np.arange(n) % max(w - cw + 1, 1)
        boxes = np.stack([y0 / (h - 1), x0 / (w - 1), (y0 + ch - 1) / (h - 1),
                          (x0 + cw - 1) / (w - 1)], 1).astype(np.float32)
    elif kind == "full-canvas":  # the last samples sit on limit - 1: clamped hi taps
        boxes[:] = [0.0, 0.0, 1.0, 1.0]
    elif kind == "degenerate":  # all of an axis's samples on one coordinate
        boxes[:, 2] = boxes[:, 0]
        boxes[::2, 3] = boxes[::2, 1]
    elif kind == "out-of-range":  # wholly or partly off the map
        boxes[:, :2] -= 0.7
        boxes[::2, 2:] += 0.9
    elif kind == "inverted":  # descending sample coordinates
        boxes = boxes[:, [2, 3, 0, 1]].copy()
    return img, boxes, dout


@pytest.mark.parametrize("crop", [(4, 3), (1, 1)])
@pytest.mark.parametrize("kind", ["mixed", "integer", "full-canvas", "degenerate",
                                  "out-of-range", "inverted"])
def test_gather_form_equals_the_plain_backward_and_mtlx(kind, crop):
    h, w, n = 7, 6, 6
    img, boxes, dout = _gather_case(kind, h, w, n, crop)
    got = _gather_backward(dout, boxes, h, w)
    plain = roi_cuda.crop_and_resize_backward_plain(
        torch.from_numpy(dout)[None], torch.from_numpy(boxes)[None], (h, w))[0].numpy()
    # the same float32 terms in another order: a few ulp of the sum of
    # their magnitudes
    magnitude = roi_cuda.crop_and_resize_backward_plain(
        torch.from_numpy(np.abs(dout))[None], torch.from_numpy(boxes)[None], (h, w))[0].numpy()
    assert (np.abs(got - plain) <= 1e-6 * magnitude).all()
    np.testing.assert_array_equal(got == 0, magnitude == 0)  # the same pixels are touched
    np.testing.assert_allclose(got, _vjp_mxu(img, boxes, dout), rtol=0, atol=ATOL)
    if kind in ("mixed", "integer", "full-canvas"):
        assert np.abs(got).max() > 0


class _CudaLooking(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel would launch")

    def no_fallback(*a, **k):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(roi_cuda, "crop_and_resize_backward_plain", no_fallback)
    _, boxes, dout = _inputs(0, 8, 8, 4, 3, 2, 2)
    d = torch.from_numpy(dout)[None].as_subclass(_CudaLooking)
    bx = torch.from_numpy(boxes)[None].as_subclass(_CudaLooking)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        roi_cuda.crop_and_resize_backward(d, bx, (8, 8))
    assert roi_cuda.crop_and_resize_backward.launches == 0
