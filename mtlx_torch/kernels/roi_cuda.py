"""Forward of the ROI crop (TF `crop_and_resize`): the CUDA kernel
`csrc/roi_crop.cu` and its plain PyTorch version (port of the forward of
mtlx/kernels/roi_pallas.py, `_crop_fwd` via `crop_and_resize_fused`).

`crop_and_resize` takes features `[B, H, W, C]` (float32 or bfloat16,
NHWC) and per-image normalized boxes `[B, N, 4]` float32 and returns
`[B, N, ch, cw, C]` in the feature type. Normalized corners map to pixel
centres at `y * (H - 1)`, the sample grid includes both ends, size 1
samples the centre, and a sample outside `[0, limit - 1]` on either axis
reads 0. The four taps are interpolated in float32 and rounded once.

CPU tensors take `crop_and_resize_plain`; CUDA tensors launch the kernel
or raise. In float32 the two agree bit for bit (the kernel repeats the
plain version's operation order and is compiled without fused
multiply-add). The d(image) backward waits for the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from mtlx_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def crop_and_resize_plain(
    features: Tensor, boxes: Tensor, crop_size: Tuple[int, int]
) -> Tensor:
    """The crop in plain PyTorch: the gather form of
    mtlx.ops.roi.crop_and_resize, batched over images."""
    from mtlx_torch.ops.roi import _sample_coords

    b, h, w, _ = features.shape
    ch, cw = crop_size
    y1, x1, y2, x2 = boxes.unbind(-1)  # [B, N]
    ys = _sample_coords(y1, y2, ch, h)  # [B, N, ch]
    xs = _sample_coords(x1, x2, cw, w)  # [B, N, cw]

    def sample_axis(coords, limit):
        lo = torch.floor(coords)
        frac = coords - lo
        lo_i = torch.clamp(lo.to(torch.int64), 0, limit - 1)
        hi_i = torch.clamp(lo_i + 1, 0, limit - 1)
        in_range = (coords >= 0.0) & (coords <= limit - 1)
        return lo_i, hi_i, frac, in_range

    y_lo, y_hi, y_frac, y_in = sample_axis(ys, h)
    x_lo, x_hi, x_frac, x_in = sample_axis(xs, w)
    bi = torch.arange(b, device=features.device)[:, None, None, None]

    def gather2d(yi, xi):  # [B, N, ch] x [B, N, cw] -> [B, N, ch, cw, C]
        return features[bi, yi[..., :, None], xi[..., None, :]].float()

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


def crop_and_resize(
    features: Tensor,
    boxes: Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> Tensor:
    """[B, H, W, C] x [B, N, 4] -> [B, N, ch, cw, C]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
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
    if features.device.type == "cpu":
        return crop_and_resize_plain(features, boxes, (ch, cw))
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    lib = build.load_library("roi_crop")  # raises without CUDA or nvcc
    if boxes.device != features.device:
        raise ValueError(f"boxes are on {boxes.device}, features on {features.device}")
    if features.dtype not in _DTYPE_CODES:
        raise TypeError(f"the crop kernel takes float32 or bfloat16, got {features.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"the crop kernel takes float32 boxes, got {boxes.dtype}")
    if not (features.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("features (NHWC) and boxes must be contiguous")
    if features.data_ptr() % 16:
        raise ValueError("features must start on a 16-byte boundary")
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


crop_and_resize.launches = 0
