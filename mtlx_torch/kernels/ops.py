"""The hand-written kernels as torch ops, namespace `mtlx`.

    torch.ops.mtlx.non_max_suppression(boxes, scores, valid, max_out,
                                       iou_threshold, score_threshold, form=0)
        -> (idx int32 [P, max_out], keep bool [P, max_out])
    torch.ops.mtlx.crop_and_resize(features, boxes, ch, cw) -> [B, N, ch, cw, C]
    torch.ops.mtlx.crop_and_resize_backward(dout, boxes, h, w) -> [B, H, W, C]
    torch.ops.mtlx.iou_matrix(boxes1, boxes2) -> [P, N, M]
    torch.ops.mtlx.paired_sums(a, b) -> [2, C] float32
    torch.ops.mtlx.bn_forward_sums(x, gamma, beta, epsilon)
        -> (stats [3, C] float32, consts [2, C] in x's type)
    torch.ops.mtlx.bn_backward_sums(dy, x, mean, var, inv, gamma, gmean, gvar, epsilon, n)
        -> (grads [2, C] float32, consts [3, C] in x's type)
    torch.ops.mtlx.bn_forward_constants(sums, gamma, beta, epsilon, n, dtype)
        -> (stats [3, C] float32, consts [2, C] in dtype)
    torch.ops.mtlx.bn_backward_constants(sums, local, mean, var, inv, gamma, gmean, gvar,
                                         epsilon, n, dtype)
        -> (grads [2, C] float32, consts [3, C] in dtype)
    torch.ops.mtlx.bn_affine(p, a, c, q=None, b=None) -> p's shape, type and layout

Each op has a CPU implementation (the kernel's plain version), a CUDA
implementation (the kernel's `ctypes` launch on the current stream, which
adds one to the public wrapper's `.launches`) and a fake implementation
that gives only the output's shape and type. The fake one is what
`torch.export` traces, so an exported program calls the ops by name and
runs the kernels when it is served on the card.

The public wrappers (`nms_cuda.non_max_suppression`,
`roi_cuda.crop_and_resize`, `iou_cuda.iou_matrix`, and `batch_norm_cuda`'s
`paired_sums`, `forward_sums`, `backward_sums`, `forward_constants`,
`backward_constants` and `bn_affine`) check their arguments and then call
these ops on both devices, except that an eager call of live batch norm's
wrappers on CUDA tensors launches its kernel without the op's dispatch (a
host cost as large as the launch, paid four times a batch norm a step);
call the wrappers, not the ops.
Importing this module registers the ops: a process that loads an exported
program imports it first. It imports nothing of the port at import time;
the implementations import their kernel module at their first call.
"""

from typing import Optional

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


@torch.library.custom_op("mtlx::paired_sums", mutates_args=(), device_types="cpu")
def paired_sums(a: Tensor, b: Tensor) -> Tensor:
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda.paired_sums_plain(a, b)


@paired_sums.register_kernel("cuda")
def _(a, b):
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda._launch_sums(a, b)


@paired_sums.register_fake
def _(a, b):
    return a.new_empty((2, a.shape[1]), dtype=torch.promote_types(a.dtype, torch.float32))


@torch.library.custom_op("mtlx::bn_affine", mutates_args=(), device_types="cpu")
def bn_affine(p: Tensor, a: Tensor, c: Tensor, q: Optional[Tensor] = None,
              b: Optional[Tensor] = None) -> Tensor:
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda.bn_affine_plain(p, a, c, q, b)


@bn_affine.register_kernel("cuda")
def _(p, a, c, q=None, b=None):
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda._launch_affine(p, a, c, q, b)


@bn_affine.register_fake
def _(p, a, c, q=None, b=None):
    return torch.empty_like(p)


def _stats_dtype(t: Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


@torch.library.custom_op("mtlx::bn_forward_sums", mutates_args=(), device_types="cpu")
def bn_forward_sums(x: Tensor, gamma: Tensor, beta: Tensor,
                    epsilon: float) -> tuple[Tensor, Tensor]:
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda.forward_sums_plain(x, gamma, beta, epsilon)


@bn_forward_sums.register_kernel("cuda")
def _(x, gamma, beta, epsilon):
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda._launch_forward_sums(x, gamma, beta, epsilon)


@bn_forward_sums.register_fake
def _(x, gamma, beta, epsilon):
    c = x.shape[1]
    dtype = torch.promote_types(_stats_dtype(x), gamma.dtype)
    return x.new_empty((3, c), dtype=dtype), x.new_empty((2, c))


@torch.library.custom_op("mtlx::bn_backward_sums", mutates_args=(), device_types="cpu")
def bn_backward_sums(dy: Tensor, x: Tensor, mean: Tensor, var: Tensor, inv: Tensor,
                     gamma: Tensor, gmean: Optional[Tensor], gvar: Optional[Tensor],
                     epsilon: float, n: int) -> tuple[Tensor, Tensor]:
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda.backward_sums_plain(dy, x, mean, var, inv, gamma, gmean, gvar,
                                               epsilon, n)


@bn_backward_sums.register_kernel("cuda")
def _(dy, x, mean, var, inv, gamma, gmean, gvar, epsilon, n):
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda._launch_backward_sums(dy, x, mean, var, inv, gamma, gmean, gvar,
                                                 epsilon, n)


@bn_backward_sums.register_fake
def _(dy, x, mean, var, inv, gamma, gmean, gvar, epsilon, n):
    c = x.shape[1]
    dtype = torch.promote_types(_stats_dtype(x), mean.dtype)
    return x.new_empty((2, c), dtype=dtype), x.new_empty((3, c))


@torch.library.custom_op("mtlx::bn_forward_constants", mutates_args=(), device_types="cpu")
def bn_forward_constants(sums: Tensor, gamma: Tensor, beta: Tensor, epsilon: float, n: int,
                         dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda.forward_constants_plain(sums, gamma, beta, epsilon, n, dtype)


@bn_forward_constants.register_kernel("cuda")
def _(sums, gamma, beta, epsilon, n, dtype):
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda._launch_forward_constants(sums, gamma, beta, epsilon, n, dtype)


@bn_forward_constants.register_fake
def _(sums, gamma, beta, epsilon, n, dtype):
    c = sums.shape[1]
    return (sums.new_empty((3, c), dtype=torch.promote_types(sums.dtype, gamma.dtype)),
            sums.new_empty((2, c), dtype=dtype))


@torch.library.custom_op("mtlx::bn_backward_constants", mutates_args=(), device_types="cpu")
def bn_backward_constants(sums: Tensor, local: Tensor, mean: Tensor, var: Tensor, inv: Tensor,
                          gamma: Tensor, gmean: Optional[Tensor], gvar: Optional[Tensor],
                          epsilon: float, n: int, dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda.backward_constants_plain(sums, local, mean, var, inv, gamma, gmean,
                                                    gvar, epsilon, n, dtype)


@bn_backward_constants.register_kernel("cuda")
def _(sums, local, mean, var, inv, gamma, gmean, gvar, epsilon, n, dtype):
    from mtlx_torch.kernels import batch_norm_cuda

    return batch_norm_cuda._launch_backward_constants(sums, local, mean, var, inv, gamma, gmean,
                                                      gvar, epsilon, n, dtype)


@bn_backward_constants.register_fake
def _(sums, local, mean, var, inv, gamma, gmean, gvar, epsilon, n, dtype):
    c = sums.shape[1]
    return (sums.new_empty((2, c), dtype=torch.promote_types(sums.dtype, mean.dtype)),
            sums.new_empty((3, c), dtype=dtype))
