"""Greedy non-max suppression: the CUDA kernels of `csrc/nms.cu` and their
plain PyTorch version (port of mtlx/kernels/nms_pallas.py).

`non_max_suppression` solves P independent single-class problems in one
call: `[P, N, 4]` float32 boxes, `[P, N]` float32 scores and `[P, N]`
bool validity, in any order -> `[P, max_out]` int32 indices and
`[P, max_out]` bool keep. Priority is score descending, then the lower
index; a box is suppressed when its IoU with the pick is greater than
`iou_threshold`; invalid rows and rows whose score is not greater than
`score_threshold` never get picked and suppress nothing; empty slots hold
index 0 and keep False.

On the card the greedy loop is not repeated step by step (that is a chain
of max_out dependent reductions on one SM). The rows are put in priority
order (a rank by counting over a packed 64-bit key), the suppression
decisions of every ordered pair are computed in parallel as a bit mask,
64 columns a word, and one block per problem scans the ordered rows 64 at
a time against a `removed` bit vector. Up to `SMALL_MAX_BOXES` rows one
block does all three in shared memory in a single launch; above, the
three stages are kernels over the whole grid, mask and scan alternating
over bands of rows so that what the scan never reads is never computed
(see the header of `csrc/nms.cu`).

CPU tensors take `non_max_suppression_plain`; CUDA tensors launch the
kernels or raise. Both go through the `mtlx::non_max_suppression` op of
`kernels/ops.py`, which `torch.export` keeps as one call. The two agree
exactly: the kernels order by the same key, evaluate IoU in the plain
version's operation order and are compiled without fused multiply-add.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from mtlx_torch.kernels import build, ops

_NEG = -1e10  # mtlx.ops.nms._NEG: the score of a dead row
# the largest N of one problem: the scan keeps `removed` in 128 words of
# 64 bits (kMaxBoxes in csrc/nms.cu)
MAX_BOXES = 8192
# up to here one block per problem works in shared memory in one launch
# (kSmallMaxBoxes): the same device time as the pipeline and three
# launches less of host time; at 1024 rows the pipeline is faster
SMALL_MAX_BOXES = 512
# the forms of the C interface
_FORM_BY_N, _FORM_SINGLE_LAUNCH, _FORM_BANDED = 0, 1, 2


def non_max_suppression_plain(
    boxes: Tensor,
    scores: Tensor,
    valid: Tensor,
    max_out: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
):
    """Greedy NMS over P problems at once, in plain PyTorch (the
    reference loop of mtlx.ops.nms.non_max_suppression_padded and the
    arithmetic of mtlx.kernels.nms_pallas._nms_kernel)."""
    p, n = scores.shape
    dev = scores.device
    live = torch.where(valid, scores, _NEG)
    live = torch.where(live > score_threshold, live, _NEG)
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    area = (ymax - ymin) * (xmax - xmin)
    col = torch.arange(n, device=dev)
    rows = torch.arange(p, device=dev)
    idx = torch.zeros((p, max_out), dtype=torch.int32, device=dev)
    keep = torch.zeros((p, max_out), dtype=torch.bool, device=dev)
    for k in range(max_out):
        best = torch.argmax(live, dim=1)  # the first maximum: lower index wins ties
        ok = live[rows, best] > _NEG / 2
        if not bool(ok.any()):
            break  # every later slot stays empty
        by0 = ymin[rows, best][:, None]
        bx0 = xmin[rows, best][:, None]
        by1 = ymax[rows, best][:, None]
        bx1 = xmax[rows, best][:, None]
        barea = (by1 - by0) * (bx1 - bx0)
        ih = torch.clamp_min(torch.minimum(ymax, by1) - torch.maximum(ymin, by0), 0.0)
        iw = torch.clamp_min(torch.minimum(xmax, bx1) - torch.maximum(xmin, bx0), 0.0)
        inter = ih * iw
        union = area + barea - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-30), 0.0)
        suppress = (iou > iou_threshold) | (col[None, :] == best[:, None])
        live = torch.where(ok[:, None] & suppress, _NEG, live)
        idx[:, k] = torch.where(ok, best, 0).to(torch.int32)
        keep[:, k] = ok
    return idx, keep


def _dispatch(boxes, scores, valid, max_out, iou_threshold, score_threshold, form):
    """`non_max_suppression` with the form of the kernels given: by N (what
    every caller gets), the single launch, or the banded pipeline (which
    also takes a small N; the smoke run holds both forms to the plain
    version). Checks the arguments, then calls the `mtlx::non_max_suppression`
    op (`kernels/ops.py`): the plain version on the CPU, the kernels on the
    card."""
    if scores.dim() != 2 or boxes.shape != (*scores.shape, 4) or valid.shape != scores.shape:
        raise ValueError(
            f"want boxes [P, N, 4], scores [P, N], valid [P, N]; got "
            f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(valid.shape)}"
        )
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if boxes.device.type == "cuda":
        build.load_library("nms")  # raises without CUDA or nvcc
        for name, t in (("boxes", boxes), ("scores", scores), ("valid", valid)):
            if t.device != boxes.device:
                raise ValueError(f"{name} is on {t.device}, boxes on {boxes.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
            raise TypeError(
                f"the NMS kernel takes float32 boxes and scores, got "
                f"{boxes.dtype} and {scores.dtype}"
            )
        if scores.shape[1] > MAX_BOXES:
            raise ValueError(f"N={scores.shape[1]} boxes are more than the NMS kernels take "
                             f"({MAX_BOXES})")
    elif boxes.device.type != "cpu":
        raise ValueError(f"unsupported device {boxes.device}")
    return ops.non_max_suppression(boxes, scores, valid, int(max_out), float(iou_threshold),
                                   float(score_threshold), form)


def _launch(boxes, scores, valid, max_out, iou_threshold, score_threshold, form):
    """The kernels on CUDA tensors that `_dispatch` checked (the op's CUDA
    implementation)."""
    lib = build.load_library("nms")
    p, n = scores.shape
    idx = torch.empty((p, max_out), dtype=torch.int32, device=boxes.device)
    keep = torch.empty((p, max_out), dtype=torch.bool, device=boxes.device)
    if p == 0 or max_out == 0:
        return idx, keep
    if n == 0:
        return idx.zero_(), keep.zero_()
    nbytes = lib.mtlx_nms_scratch_bytes(p, n, form)
    if nbytes < 0:
        raise ValueError(f"the NMS kernels (form {form}) do not take P={p}, N={n}")
    # the banded pipeline's partial ranks, ordered boxes and indices, mask
    # and scan state (nothing for the single launch); needs no zeroing
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.mtlx_nms_f32(
            boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), p, n,
            max_out, ctypes.c_float(iou_threshold),
            ctypes.c_float(score_threshold), scratch.data_ptr(), form,
            idx.data_ptr(), keep.data_ptr(), stream,
        )
    build.check(lib, err, "nms")
    non_max_suppression.launches += 1
    return idx, keep


def non_max_suppression(
    boxes: Tensor,
    scores: Tensor,
    valid: Tensor,
    max_out: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
):
    """Greedy NMS over P problems: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors. See the module docstring."""
    return _dispatch(boxes, scores, valid, max_out, iou_threshold, score_threshold,
                     _FORM_BY_N)


non_max_suppression.launches = 0
