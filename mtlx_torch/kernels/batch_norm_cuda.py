"""Train-mode batch norm's full-size work: the CUDA kernels of
`csrc/batch_norm.cu` and their plain PyTorch versions (port of mtlx's
`_paired_sums` and the folded affine of `_bn_train`, mtlx/backbones/
resnet.py).

`paired_sums(a, b)` takes two [N, C, H, W] tensors and returns [2, C]:
(sum(a), sum(a * b)) per channel, accumulated in float32 (float64 for
float64 tensors, which only the CPU takes). `bn_affine(p, a, c, q=None,
b=None)` returns (p * a) + c, or ((p * a) + (q * b)) + c, with
per-channel vectors a, b, c [C] in p's type, each operation rounded to
that type in that order; the output has p's type and layout.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. The kernels take float32 and bfloat16 in the two dense layouts
that reach them: channels-last memory (every model on the card) and
contiguous NCHW, both operands of a call in one layout. `bn_affine`
agrees with its plain version bit for bit given the same vectors;
`paired_sums` adds in another order than `torch.sum`, within 1e-5 of each
channel's sum of term magnitudes. A `paired_sums` call launches two
kernels, the per-block partial sums and their fixed-order total, and
counts one in `paired_sums.launches`: the counts are calls.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from mtlx_torch.kernels import build, ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHANNELS_LAST, NCHW = 0, 1


def layout_of(t: Tensor) -> Optional[int]:
    """CHANNELS_LAST or NCHW where the [N, C, H, W] tensor is dense in
    that layout (channels-last where both hold: then C or H * W is 1 and
    the two orders are one), else None."""
    if t.dim() != 4:
        return None
    if t.is_contiguous(memory_format=torch.channels_last):
        return CHANNELS_LAST
    if t.is_contiguous():
        return NCHW
    return None


def in_layout_of(t: Tensor, like: Tensor) -> Tensor:
    """t in like's dense layout (no copy where it already is); t as it is
    where like is in neither layout (the plain versions take any
    strides)."""
    layout = layout_of(like)
    if layout == CHANNELS_LAST:
        return t.contiguous(memory_format=torch.channels_last)
    if layout == NCHW:
        return t.contiguous()
    return t


def paired_sums_plain(a: Tensor, b: Tensor) -> Tensor:
    """(sum(a), sum(a * b)) per channel of [N, C, H, W] tensors in plain
    PyTorch, in float32 (float64 for float64 tensors): [2, C]."""
    dt = torch.promote_types(a.dtype, torch.float32)
    af = a.to(dt)
    return torch.stack([af.sum((0, 2, 3)), (af * b.to(dt)).sum((0, 2, 3))])


def bn_affine_plain(p: Tensor, a: Tensor, c: Tensor, q: Optional[Tensor] = None,
                    b: Optional[Tensor] = None) -> Tensor:
    """((p * a) [+ (q * b)]) + c per channel in plain PyTorch, in p's type."""
    y = p * a[:, None, None]
    if q is not None:
        y = y + q * b[:, None, None]
    return y + c[:, None, None]


def _eager(*tensors) -> bool:
    """True where a call runs now on real tensors, so a CUDA call may
    launch its kernel without the op dispatcher; a tracer (`torch.export`,
    `torch.compile`, fake tensors) goes through the registered op."""
    return not torch.compiler.is_compiling() and all(type(t) is Tensor for t in tensors)


def paired_sums(a: Tensor, b: Tensor) -> Tensor:
    """[2, C] float32: (sum(a), sum(a * b)) per channel of [N, C, H, W]
    tensors: the kernels for CUDA tensors, the plain version for CPU
    tensors, through the `mtlx::paired_sums` op (`kernels/ops.py`) except
    for an eager CUDA call, which launches directly (the op's dispatch
    costs as much host time as the launch)."""
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"want a and b [N, C, H, W] of one shape; got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.is_cuda and _eager(a, b):
        return _launch_sums(a, b)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    return ops.paired_sums(a, b)


def bn_affine(p: Tensor, a: Tensor, c: Tensor, q: Optional[Tensor] = None,
              b: Optional[Tensor] = None) -> Tensor:
    """((p * a) [+ (q * b)]) + c with per-channel vectors [C] in p's type:
    the kernel for CUDA tensors, the plain version for CPU tensors, through
    the `mtlx::bn_affine` op except for an eager CUDA call, as
    `paired_sums`."""
    if p.dim() != 4:
        raise ValueError(f"want p [N, C, H, W]; got {tuple(p.shape)}")
    if (q is None) != (b is None):
        raise ValueError("q and b come together")
    for name, v in (("a", a), ("c", c), ("b", b)):
        if v is not None and (v.dim() != 1 or v.shape[0] != p.shape[1]):
            raise ValueError(f"bn_affine: {name} must be [C] = [{p.shape[1]}], got "
                             f"{tuple(v.shape)}")
    if p.is_cuda and _eager(p, a, c) and (q is None or _eager(q, b)):
        return _launch_affine(p, a, c, q, b)
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {p.device}")
    return ops.bn_affine(p, a, c, q, b)


def _check_cuda(what: str, like: Tensor, others, vectors=()) -> int:
    """Raise unless like is a float32 or bfloat16 [N, C, H, W] tensor in a
    dense layout, every (name, tensor) of others has its shape, device,
    type and layout, and every (name, vector) of vectors is a contiguous
    vector of its device and type; returns the layout."""
    if like.dtype not in _DTYPE_CODES:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16 tensors, got {like.dtype}")
    layout = layout_of(like)
    if layout is None:
        raise ValueError(f"{what}: strides {like.stride()}: the kernel reads channels-last "
                         "memory or contiguous NCHW")
    for name, t in others:
        if t is like:
            continue
        if t.shape != like.shape:
            raise ValueError(f"{what}: want [N, C, H, W] tensors of one shape; {name} is "
                             f"{tuple(t.shape)}, against {tuple(like.shape)}")
        if t.device != like.device or t.dtype != like.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, against "
                            f"{like.dtype} on {like.device}")
        if layout_of(t) != layout:
            raise ValueError(f"{what}: {name} (strides {t.stride()}) must be in the layout of "
                             f"the first operand (strides {like.stride()})")
    for name, v in vectors:
        if v.device != like.device or v.dtype != like.dtype or not v.is_contiguous():
            raise TypeError(f"{what}: {name} must be a contiguous {like.dtype} vector on "
                            f"{like.device}, got {v.dtype} on {v.device}")
    n, c, h, w = like.shape
    if c > 65535 or n > 2**31 - 1:
        raise ValueError(f"{what}: {n} images of {c} channels is past one launch")
    return layout


def _stream(t: Tensor) -> int:
    """The current stream of t's card, as a raw pointer (as compiled
    PyTorch code reads it, without a Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# float32 elements of a paired-sums workspace, by (layout, n, c, hw,
# type code, card): the C side's grid rule, asked once a shape
_workspace_floats = {}


def _launch_sums(a: Tensor, b: Tensor) -> Tensor:
    """The paired-sums kernels on CUDA tensors (the op's CUDA
    implementation; an eager call's, through `paired_sums`): two kernel
    launches, counted as one call in `paired_sums.launches`."""
    layout = _check_cuda("paired_sums", a, [("b", b)])
    if a.get_device() != torch.cuda.current_device():  # launch on a's card
        with torch.cuda.device(a.get_device()):
            return _launch_sums(a, b)
    lib = build.load_library("batch_norm")  # raises without CUDA or nvcc
    n, c, h, w = a.shape
    dtype = _DTYPE_CODES[a.dtype]
    key = (layout, n, c, h * w, dtype, a.get_device())
    floats = _workspace_floats.get(key)
    if floats is None:
        floats = _workspace_floats[key] = lib.mtlx_bn_sums_workspace(layout, n, c, h * w,
                                                                     dtype)
    out = torch.empty((2, c), dtype=torch.float32, device=a.device)
    work = torch.empty(floats, dtype=torch.float32, device=a.device)
    err = lib.mtlx_bn_paired_sums(a.data_ptr(), b.data_ptr(), work.data_ptr(), out.data_ptr(),
                                  layout, n, c, h * w, dtype, _stream(a))
    build.check(lib, err, "paired_sums")
    paired_sums.launches += 1
    return out


def _launch_affine(p: Tensor, a: Tensor, c: Tensor, q: Optional[Tensor],
                   b: Optional[Tensor]) -> Tensor:
    """The affine kernel on CUDA tensors (the op's CUDA implementation; an
    eager call's, through `bn_affine`)."""
    vectors = [("a", a), ("c", c)] + ([("b", b)] if b is not None else [])
    layout = _check_cuda("bn_affine", p, [("q", q)] if q is not None else [], vectors)
    if p.get_device() != torch.cuda.current_device():  # launch on p's card
        with torch.cuda.device(p.get_device()):
            return _launch_affine(p, a, c, q, b)
    lib = build.load_library("batch_norm")
    n, ch, h, w = p.shape
    out = torch.empty_like(p)
    err = lib.mtlx_bn_affine(p.data_ptr(), None if q is None else q.data_ptr(), a.data_ptr(),
                             None if b is None else b.data_ptr(), c.data_ptr(), out.data_ptr(),
                             layout, n, ch, h * w, _DTYPE_CODES[p.dtype], _stream(p))
    build.check(lib, err, "bn_affine")
    bn_affine.launches += 1
    return out


paired_sums.launches = 0
bn_affine.launches = 0
