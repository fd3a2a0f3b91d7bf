"""The port's ROI crop (the kernel's plain version on the CPU) against mtlx:
the gather crop, the MXU einsum crop and the Pallas forward kernel in
interpret mode. Tolerance atol 1e-5 (the einsum and the Pallas matmuls
sum the two taps in another order)."""

import functools

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


def _inputs(seed, h, w, c, n):
    rs = np.random.RandomState(seed)
    img = rs.normal(0, 1, (h, w, c)).astype(np.float32)
    corners = rs.uniform(-0.3, 1.3, (n, 4))  # some past [0, 1] on each side
    boxes = np.concatenate([np.minimum(corners[:, :2], corners[:, 2:]),
                            np.maximum(corners[:, :2], corners[:, 2:])], 1)
    boxes[0] = [0.0, 0.0, 1.0, 1.0]  # the whole map, corners exactly on pixels
    boxes[1] = [0.4, 0.4, 0.4, 0.4]  # a point box
    return img, boxes.astype(np.float32)


def _pallas_fwd(img, boxes, crop):
    """roi_pallas._fwd_kernel through pl.pallas_call(interpret=True)."""
    h, w, c = img.shape
    n = boxes.shape[0]
    ch, cw = crop
    jb = jnp.asarray(boxes)
    wy = jroi._interp_matrix(jb[:, 0], jb[:, 2], ch, h)
    wx = jroi._interp_matrix(jb[:, 1], jb[:, 3], cw, w)
    return pl.pallas_call(
        roi_pallas._fwd_kernel,
        grid=(n,),
        in_specs=[
            pl.BlockSpec((h, w, c), lambda i: (0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, ch, h), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, cw, w), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, ch, cw, c), lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, ch, cw, c), jnp.float32),
        scratch_shapes=[pltpu.VMEM((ch, w, c), jnp.float32)],
        interpret=True,
    )(jnp.asarray(img), wy, wx)


REFERENCES = {
    "gather": lambda img, boxes, crop: jroi.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), crop),
    "mxu": lambda img, boxes, crop: jroi.crop_and_resize_mxu(jnp.asarray(img), jnp.asarray(boxes), crop),
    "pallas": _pallas_fwd,
}


@pytest.mark.parametrize("ref", sorted(REFERENCES))
@pytest.mark.parametrize("shape,n,crop", [
    ((12, 16, 8), 9, (6, 6)),
    ((9, 7, 5), 6, (1, 1)),  # crop size 1 samples the box centre
    ((10, 11, 4), 5, (1, 4)),
])
def test_crop_matches_mtlx(ref, shape, n, crop):
    img, boxes = _inputs(n + sum(shape), *shape, n)
    got = troi.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), crop)
    want = np.asarray(REFERENCES[ref](img, boxes, crop))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_batch_crop_matches_per_image():
    imgs, boxes = zip(*(_inputs(s, 8, 10, 16, 7) for s in range(3)))
    got = troi.batch_crop_and_resize(torch.from_numpy(np.stack(imgs)),
                                     torch.from_numpy(np.stack(boxes)), (5, 4))
    want = jax.vmap(functools.partial(jroi.crop_and_resize, crop_size=(5, 4)))(
        jnp.asarray(np.stack(imgs)), jnp.asarray(np.stack(boxes)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_bfloat16_rounds_the_float32_crop_once():
    img, boxes = _inputs(3, 12, 12, 16, 8)
    f32 = troi.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), (7, 7))
    bf16 = troi.crop_and_resize(torch.from_numpy(img).bfloat16(), torch.from_numpy(boxes), (7, 7))
    want = troi.crop_and_resize(torch.from_numpy(img).bfloat16().float(),
                                torch.from_numpy(boxes), (7, 7))
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, want.bfloat16(), rtol=0, atol=0)
    assert f32.dtype == torch.float32


def test_nonzero_extrapolation_value_raises():
    img, boxes = _inputs(0, 8, 8, 4, 3)
    with pytest.raises(NotImplementedError):
        troi.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), (4, 4),
                             extrapolation_value=1.0)


class _CudaLooking(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel would launch")

    def no_fallback(*a, **k):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(roi_cuda, "crop_and_resize_plain", no_fallback)
    img, boxes = _inputs(0, 8, 8, 4, 3)
    feats = torch.from_numpy(img)[None].as_subclass(_CudaLooking)
    bx = torch.from_numpy(boxes)[None].as_subclass(_CudaLooking)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        roi_cuda.crop_and_resize(feats, bx, (4, 4))
    assert roi_cuda.crop_and_resize.launches == 0
