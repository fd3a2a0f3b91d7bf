"""The four hand-written kernels as torch ops, namespace `mtlx`.

    torch.ops.mtlx.non_max_suppression(boxes, scores, valid, max_out,
                                       iou_threshold, score_threshold, form=0)
        -> (idx int32 [P, max_out], keep bool [P, max_out])
    torch.ops.mtlx.crop_and_resize(features, boxes, ch, cw) -> [B, N, ch, cw, C]
    torch.ops.mtlx.crop_and_resize_backward(dout, boxes, h, w) -> [B, H, W, C]
    torch.ops.mtlx.iou_matrix(boxes1, boxes2) -> [P, N, M]

Each op has a CPU implementation (the kernel's plain version), a CUDA
implementation (the kernel's `ctypes` launch on the current stream, which
adds one to the public wrapper's `.launches`) and a fake implementation
that gives only the output's shape and type. The fake one is what
`torch.export` traces, so an exported program calls the ops by name and
runs the kernels when it is served on the card.

The public wrappers (`nms_cuda.non_max_suppression`,
`roi_cuda.crop_and_resize`, `iou_cuda.iou_matrix`) check their arguments
and then call these ops on both devices; call the wrappers, not the ops.
Importing this module registers the ops: a process that loads an exported
program imports it first. It imports nothing of the port at import time;
the implementations import their kernel module at their first call.
"""

import torch
from torch import Tensor


@torch.library.custom_op("mtlx::non_max_suppression", mutates_args=(), device_types="cpu")
def non_max_suppression(boxes: Tensor, scores: Tensor, valid: Tensor, max_out: int,
                        iou_threshold: float, score_threshold: float,
                        form: int = 0) -> tuple[Tensor, Tensor]:
    from mtlx_torch.kernels import nms_cuda

    return nms_cuda.non_max_suppression_plain(boxes, scores, valid, max_out, iou_threshold,
                                              score_threshold)


@non_max_suppression.register_kernel("cuda")
def _(boxes, scores, valid, max_out, iou_threshold, score_threshold, form=0):
    from mtlx_torch.kernels import nms_cuda

    return nms_cuda._launch(boxes, scores, valid, max_out, iou_threshold, score_threshold, form)


@non_max_suppression.register_fake
def _(boxes, scores, valid, max_out, iou_threshold, score_threshold, form=0):
    shape = (scores.shape[0], max_out)
    return scores.new_empty(shape, dtype=torch.int32), scores.new_empty(shape, dtype=torch.bool)


@torch.library.custom_op("mtlx::crop_and_resize", mutates_args=(), device_types="cpu")
def crop_and_resize(features: Tensor, boxes: Tensor, ch: int, cw: int) -> Tensor:
    from mtlx_torch.kernels import roi_cuda

    return roi_cuda.crop_and_resize_plain(features, boxes, (ch, cw))


@crop_and_resize.register_kernel("cuda")
def _(features, boxes, ch, cw):
    from mtlx_torch.kernels import roi_cuda

    return roi_cuda._launch_forward(features, boxes, ch, cw)


@crop_and_resize.register_fake
def _(features, boxes, ch, cw):
    b, _, _, c = features.shape
    return features.new_empty((b, boxes.shape[1], ch, cw, c))


@torch.library.custom_op("mtlx::crop_and_resize_backward", mutates_args=(), device_types="cpu")
def crop_and_resize_backward(dout: Tensor, boxes: Tensor, h: int, w: int) -> Tensor:
    from mtlx_torch.kernels import roi_cuda

    return roi_cuda.crop_and_resize_backward_plain(dout, boxes, (h, w))


@crop_and_resize_backward.register_kernel("cuda")
def _(dout, boxes, h, w):
    from mtlx_torch.kernels import roi_cuda

    return roi_cuda._launch_backward(dout, boxes, h, w)


@crop_and_resize_backward.register_fake
def _(dout, boxes, h, w):
    return dout.new_empty((dout.shape[0], h, w, dout.shape[-1]))


@torch.library.custom_op("mtlx::iou_matrix", mutates_args=(), device_types="cpu")
def iou_matrix(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    from mtlx_torch.kernels import iou_cuda

    return iou_cuda.iou_matrix_plain(boxes1, boxes2)


@iou_matrix.register_kernel("cuda")
def _(boxes1, boxes2):
    from mtlx_torch.kernels import iou_cuda

    return iou_cuda._launch(boxes1, boxes2)


@iou_matrix.register_fake
def _(boxes1, boxes2):
    p = torch.sym_max(boxes1.shape[0], boxes2.shape[0])
    dtype = torch.promote_types(boxes1.dtype, boxes2.dtype)
    return boxes1.new_empty((p, boxes1.shape[1], boxes2.shape[1]), dtype=dtype)
