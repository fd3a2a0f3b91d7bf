"""The crop's d(features) backward (the backward kernel's plain version on
the CPU) against mtlx: `jax.vjp` of mtlx.ops.roi.crop_and_resize_mxu and
the Pallas backward kernel `_bwd_kernel` in interpret mode (float32,
atol 1e-5: the interpolation matrices sum the taps in another order);
gradcheck of the autograd Function in float64; `mean_pooled_crop` and its
gradient against mtlx."""

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
