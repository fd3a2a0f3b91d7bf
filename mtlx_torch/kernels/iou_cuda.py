"""Pairwise IoU matrix: the CUDA kernel `csrc/iou.cu` and its plain PyTorch
version (port of mtlx/kernels/iou_pallas.py `iou_matrix`).

`iou_matrix` takes boxes `[P, N, 4]` and `[P, M, 4]` float32 (either side
may have P = 1 and is then shared by every problem) and returns
`[P, N, M]` float32; a pair whose union is not positive (zero-area
padding rows) gets 0.

CPU tensors take `iou_matrix_plain`; CUDA tensors launch the kernel or
raise. The two agree bit for bit: the kernel evaluates mtlx's operation
order and is compiled without fused multiply-add, so the matcher's
argmaxes and thresholds see the same values on both devices.
"""

from __future__ import annotations

import torch
from torch import Tensor

from mtlx_torch.kernels import build

EPSILON = 1e-30  # mtlx.geometry.box_ops.EPSILON


def iou_matrix_plain(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """IoU in plain PyTorch, in mtlx.geometry.box_ops.iou's operation
    order. [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    ih = torch.clamp_min(
        torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0]), 0.0
    )
    iw = torch.clamp_min(
        torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1]), 0.0
    )
    inter = ih * iw
    a1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    a2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, EPSILON), 0.0)


def iou_matrix(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """[P|1, N, 4] x [P|1, M, 4] -> [P, N, M]: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if boxes1.dim() != 3 or boxes2.dim() != 3 or boxes1.shape[-1] != 4 or (
        boxes2.shape[-1] != 4
    ):
        raise ValueError(f"want boxes [P, N, 4] and [P, M, 4]; got "
                         f"{tuple(boxes1.shape)} and {tuple(boxes2.shape)}")
    p1, p2 = boxes1.shape[0], boxes2.shape[0]
    if p1 != p2 and 1 not in (p1, p2):
        raise ValueError(f"problem counts {p1} and {p2} do not broadcast")
    if boxes1.device.type == "cpu":
        return iou_matrix_plain(boxes1, boxes2)
    if boxes1.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes1.device}")
    lib = build.load_library("iou")  # raises without CUDA or nvcc
    if boxes2.device != boxes1.device:
        raise ValueError(f"boxes are on {boxes1.device} and {boxes2.device}")
    if boxes1.dtype != torch.float32 or boxes2.dtype != torch.float32:
        raise TypeError(f"the IoU kernel takes float32 boxes, got {boxes1.dtype}, {boxes2.dtype}")
    if not (boxes1.is_contiguous() and boxes2.is_contiguous()):
        raise ValueError("boxes must be contiguous")
    p, n, m = max(p1, p2), boxes1.shape[1], boxes2.shape[1]
    if p > 65535 or n > 8 * 65535:
        raise ValueError(f"too many problems or rows for one launch: P={p}, N={n}")
    out = torch.empty((p, n, m), dtype=torch.float32, device=boxes1.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(boxes1.device):
        stream = torch.cuda.current_stream(boxes1.device).cuda_stream
        err = lib.mtlx_iou_f32(boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(),
                               p, n, m, int(p1 == 1 and p > 1), int(p2 == 1 and p > 1),
                               stream)
    build.check(lib, err, "iou")
    iou_matrix.launches += 1
    return out


iou_matrix.launches = 0
