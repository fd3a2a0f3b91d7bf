"""The ROI crop (TF `crop_and_resize`): the CUDA kernels of
`csrc/roi_crop.cu`, forward and d(features) backward, and their plain
PyTorch versions (port of mtlx/kernels/roi_pallas.py: `_crop_fwd` via
`crop_and_resize_fused`, and `_crop_bwd_image` of its custom VJP).

`crop_and_resize` takes features `[B, H, W, C]` (float32 or bfloat16,
NHWC) and per-image normalized boxes `[B, N, 4]` float32 and returns
`[B, N, ch, cw, C]` in the feature type. Normalized corners map to pixel
centres at `y * (H - 1)`, the sample grid includes both ends, size 1
samples the centre, and a sample outside `[0, limit - 1]` on either axis
reads 0. The four taps are interpolated in float32 and rounded once.

When the features require a gradient, the crop is a
`torch.autograd.Function`: the forward kernel, then the backward kernel
for d(features); the boxes get no gradient (mtlx returns a zero
cotangent for them, and every caller passes constant boxes).

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. Both go through the ops `mtlx::crop_and_resize` and
`mtlx::crop_and_resize_backward` of `kernels/ops.py`, which
`torch.export` keeps as one call each. The forward kernel and its plain
version agree bit for bit, in float32 and bfloat16 (the kernel repeats
the plain version's operation order and is compiled without fused
multiply-add; it walks a box's sample rows in order and reuses the
x-blend of a source row that two sample rows share, which has the same
bits as a fresh one). The backward kernel is a gather: one warp owns
each pixel of d(features) and adds the terms of the samples that touch
it in a fixed order (box, sample row, sample column) in float32
registers, with no atomics and no scratch map, so two runs give the same
bits. The plain version adds the same terms tap by tap (`index_add_`),
so the two agree to float32 rounding of each sum.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from mtlx_torch.kernels import build, ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward kernel keeps one box's ch + cw sample positions (8 bytes
# each) in a 40 KB table in shared memory
_MAX_CROP_EXTENT = 5000


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float64 for float64 (so
    gradcheck can run), float32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _sample_points(boxes: Tensor, crop_size: Tuple[int, int], h: int, w: int):
    """Per axis (lo, hi, frac, in_range) of every sample point: mtlx's
    _sample_coords and the gather crop's sample_axis, batched over
    images. [B, N, 4] -> y parts [B, N, ch], x parts [B, N, cw]."""
    from mtlx_torch.ops.roi import _sample_coords

    def sample_axis(coords, limit):
        lo = torch.floor(coords)
        frac = coords - lo
        lo_i = torch.clamp(lo.to(torch.int64), 0, limit - 1)
        hi_i = torch.clamp(lo_i + 1, 0, limit - 1)
        in_range = (coords >= 0.0) & (coords <= limit - 1)
        return lo_i, hi_i, frac, in_range

    y1, x1, y2, x2 = boxes.unbind(-1)  # [B, N]
    ys = _sample_coords(y1, y2, crop_size[0], h)  # [B, N, ch]
    xs = _sample_coords(x1, x2, crop_size[1], w)  # [B, N, cw]
    return sample_axis(ys, h), sample_axis(xs, w)


def crop_and_resize_plain(
    features: Tensor, boxes: Tensor, crop_size: Tuple[int, int]
) -> Tensor:
    """The crop in plain PyTorch: the gather form of
    mtlx.ops.roi.crop_and_resize, batched over images."""
    b, h, w, _ = features.shape
    (y_lo, y_hi, y_frac, y_in), (x_lo, x_hi, x_frac, x_in) = _sample_points(
        boxes, crop_size, h, w
    )
    bi = torch.arange(b, device=features.device)[:, None, None, None]
    acc = _acc_dtype(features.dtype)

    def gather2d(yi, xi):  # [B, N, ch] x [B, N, cw] -> [B, N, ch, cw, C]
        return features[bi, yi[..., :, None], xi[..., None, :]].to(acc)

    tl = gather2d(y_lo, x_lo)
    tr = gather2d(y_lo, x_hi)
    bl = gather2d(y_hi, x_lo)
    br = gather2d(y_hi, x_hi)
    yf = y_frac[..., :, None, None]
    xf = x_frac[..., None, :, None]
    top = tl + (tr - tl) * xf
    bottom = bl + (br - bl) * xf
    out = top + (bottom - top) * yf
    valid = (y_in[..., :, None] & x_in[..., None, :])[..., None]
    return torch.where(valid, out, 0.0).to(features.dtype)


def crop_and_resize_backward_plain(
    dout: Tensor, boxes: Tensor, image_hw: Tuple[int, int]
) -> Tensor:
    """d(features) of the crop in plain PyTorch: each sample point's
    gradient goes to its four taps with the bilinear weights, summed by
    `index_add_` in float32 (float64 for float64) and rounded once to
    dout's type. [B, N, ch, cw, C] x [B, N, 4] -> [B, H, W, C]."""
    b, n, ch, cw, c = dout.shape
    h, w = image_hw
    (y_lo, y_hi, y_frac, y_in), (x_lo, x_hi, x_frac, x_in) = _sample_points(
        boxes, (ch, cw), h, w
    )
    acc = _acc_dtype(dout.dtype)
    valid = (y_in[..., :, None] & x_in[..., None, :])[..., None]  # [B, N, ch, cw, 1]
    g = torch.where(valid, dout.to(acc), 0.0)
    bi = torch.arange(b, device=dout.device)[:, None, None, None]
    dimg = torch.zeros((b * h * w, c), dtype=acc, device=dout.device)
    for yi, wy in ((y_lo, 1.0 - y_frac), (y_hi, y_frac)):
        for xi, wx in ((x_lo, 1.0 - x_frac), (x_hi, x_frac)):
            weight = (wy[..., :, None] * wx[..., None, :]).to(acc)  # [B, N, ch, cw]
            flat = (bi * h + yi[..., :, None]) * w + xi[..., None, :]
            dimg.index_add_(0, flat.reshape(-1), (g * weight[..., None]).reshape(-1, c))
    return dimg.reshape(b, h, w, c).to(dout.dtype)


def _check_cuda(what: str, tensors, boxes: Tensor):
    if boxes.device != tensors.device:
        raise ValueError(f"boxes are on {boxes.device}, {what} on {tensors.device}")
    if tensors.dtype not in _DTYPE_CODES:
        raise TypeError(f"the crop kernels take float32 or bfloat16 {what}, got {tensors.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"the crop kernels take float32 boxes, got {boxes.dtype}")
    if not (tensors.is_contiguous() and boxes.is_contiguous()):
        raise ValueError(f"{what} and boxes must be contiguous")


def _check_aligned(what: str, tensors: Tensor):
    """The kernels read 16 bytes at a time; a traced tensor has no address
    yet, so the launch checks this."""
    if tensors.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary")


def _forward(features: Tensor, boxes: Tensor, ch: int, cw: int) -> Tensor:
    """The `mtlx::crop_and_resize` op (`kernels/ops.py`): the forward
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if features.device.type == "cuda":
        build.load_library("roi_crop")  # raises without CUDA or nvcc
        _check_cuda("features (NHWC)", features, boxes)
    elif features.device.type != "cpu":
        raise ValueError(f"unsupported device {features.device}")
    return ops.crop_and_resize(features, boxes, ch, cw)


def _launch_forward(features: Tensor, boxes: Tensor, ch: int, cw: int) -> Tensor:
    """The forward kernel on CUDA tensors that `_forward` checked (the op's
    CUDA implementation)."""
    lib = build.load_library("roi_crop")
    _check_aligned("features (NHWC)", features)
    b, h, w, c = features.shape
    n = boxes.shape[1]
    out = torch.empty((b, n, ch, cw, c), dtype=features.dtype, device=features.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = lib.mtlx_roi_crop_fwd(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(), b, h, w, c,
            n, ch, cw, _DTYPE_CODES[features.dtype], stream,
        )
    build.check(lib, err, "roi_crop")
    crop_and_resize.launches += 1
    return out


def crop_and_resize_backward(dout: Tensor, boxes: Tensor, image_hw: Tuple[int, int]) -> Tensor:
    """d(features) [B, H, W, C] of the crop, in dout's type: the
    `mtlx::crop_and_resize_backward` op, the backward kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if dout.dim() != 5 or boxes.dim() != 3 or tuple(boxes.shape[:2]) != tuple(dout.shape[:2]):
        raise ValueError(f"want dout [B, N, ch, cw, C] and boxes [B, N, 4]; got "
                         f"{tuple(dout.shape)} and {tuple(boxes.shape)}")
    if dout.device.type == "cuda":
        build.load_library("roi_crop")  # raises without CUDA or nvcc
        _check_cuda("dout", dout, boxes)
        ch, cw = dout.shape[2], dout.shape[3]
        if ch + cw > _MAX_CROP_EXTENT:
            raise ValueError(f"crop {ch} x {cw} is past the backward kernel's sample tables "
                             f"(ch + cw <= {_MAX_CROP_EXTENT})")
    elif dout.device.type != "cpu":
        raise ValueError(f"unsupported device {dout.device}")
    return ops.crop_and_resize_backward(dout, boxes, int(image_hw[0]), int(image_hw[1]))


def _launch_backward(dout: Tensor, boxes: Tensor, h: int, w: int) -> Tensor:
    """The backward kernel on CUDA tensors that `crop_and_resize_backward`
    checked (the op's CUDA implementation)."""
    lib = build.load_library("roi_crop")
    _check_aligned("dout", dout)
    b, n, ch, cw, c = dout.shape
    out = torch.empty((b, h, w, c), dtype=dout.dtype, device=dout.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        err = lib.mtlx_roi_crop_bwd(
            dout.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            b, h, w, c, n, ch, cw, _DTYPE_CODES[dout.dtype], stream,
        )
    build.check(lib, err, "roi_crop backward")
    crop_and_resize_backward.launches += 1
    return out


crop_and_resize_backward.launches = 0


class _CropAndResize(torch.autograd.Function):
    """The crop with its d(features) backward; no gradient for the boxes."""

    @staticmethod
    def forward(ctx, features, boxes, ch, cw):
        ctx.save_for_backward(boxes)
        ctx.image_hw = (features.shape[1], features.shape[2])
        return _forward(features, boxes, ch, cw)

    @staticmethod
    def backward(ctx, dout):
        (boxes,) = ctx.saved_tensors
        return crop_and_resize_backward(dout.contiguous(), boxes, ctx.image_hw), None, None, None


def crop_and_resize(
    features: Tensor,
    boxes: Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> Tensor:
    """[B, H, W, C] x [B, N, 4] -> [B, N, ch, cw, C]: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors; differentiable in
    the features."""
    if extrapolation_value != 0.0:
        raise NotImplementedError(
            "the ROI crop supports extrapolation_value=0.0 only (as "
            "mtlx.kernels.roi_pallas.crop_and_resize_fused)"
        )
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 or (
        boxes.shape[0] != features.shape[0]
    ):
        raise ValueError(
            f"want features [B, H, W, C] and boxes [B, N, 4]; got "
            f"{tuple(features.shape)} and {tuple(boxes.shape)}"
        )
    ch, cw = int(crop_size[0]), int(crop_size[1])
    if ch < 1 or cw < 1:
        raise ValueError(f"crop_size must be positive, got {crop_size}")
    if torch.is_grad_enabled() and features.requires_grad:
        return _CropAndResize.apply(features, boxes.detach(), ch, cw)
    return _forward(features, boxes.detach(), ch, cw)


crop_and_resize.launches = 0
