"""Train-mode batch norm's work: the CUDA kernels of `csrc/batch_norm.cu`
and their plain PyTorch versions (port of mtlx's `_bn_train`,
mtlx/backbones/resnet.py: its `_paired_sums`, its per-channel constants
and its folded affine).

`paired_sums(a, b)` takes two [N, C, H, W] tensors and returns [2, C]:
(sum(a), sum(a * b)) per channel, accumulated in float32 (float64 for
float64 tensors, which only the CPU takes). `forward_sums(x, gamma, beta,
epsilon)` adds the sums of (x, x) and folds them into the forward's
per-channel values: stats [3, C] float32 (mean, var, inv) and consts [2,
C] in x's type (a = inv, c = beta - mean * inv, so y = x * a + c).
`backward_sums(dy, x, mean, var, inv, gamma, gmean, gvar, epsilon, n)`
does the same for the backward: the sums of (dy, x) folded into grads [2,
C] float32 (dgamma, dbeta) and consts [3, C] in x's type (a, b, c, so dx
= dy * a + x * b + c). `forward_constants` and `backward_constants` fold
sums that are already complete (the data-parallel ranks' all-reduced
sums) in the same way. `bn_affine(p, a, c, q=None, b=None)` returns (p *
a) + c, or ((p * a) + (q * b)) + c, with per-channel vectors a, b, c [C]
in p's type, each operation rounded to that type in that order; the
output has p's type and layout.

CPU tensors take the plain versions (the C-length torch ops of
`_BatchNormTrain`, mtlx_torch/backbones/resnet.py); CUDA tensors launch
the kernels or raise. The kernels take float32 and bfloat16 in the two
dense layouts that reach them: channels-last memory (every model on the
card) and contiguous NCHW, both operands of a call in one layout, with
float32 statistics. `bn_affine` agrees with its plain version bit for
bit given the same vectors; the sums add in another order than
`torch.sum`, within 1e-5 of each channel's sum of term magnitudes; the
folded values equal the plain version's on the same sums bit for bit
where CUDA rounds as ATen does (chip_smoke.py holds them). Every call is
one kernel launch: each sums call (of the four sums wrappers and the two
constants wrappers) adds one to `paired_sums.launches`, each affine call
to `bn_affine.launches`.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def forward_constants_plain(sums: Tensor, gamma: Tensor, beta: Tensor, epsilon: float, n: int,
                            dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """The forward's per-channel values from the sums [2, C] of (x, x)
    over n elements a channel, as mtlx's `_bn_train_impl`: stats [3, C] =
    (mean, var, inv) with var = E[x^2] - E[x]^2 clamped at 0 and inv =
    gamma * rsqrt(var + eps); consts [2, C] in `dtype` = (inv, beta - mean
    * inv)."""
    s1, s2 = sums[0], sums[1]
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    inv = gamma * torch.rsqrt(var + epsilon)
    return (torch.stack([mean, var, inv]),
            torch.stack([inv.to(dtype), (beta - mean * inv).to(dtype)]))


def forward_sums_plain(x: Tensor, gamma: Tensor, beta: Tensor,
                       epsilon: float) -> Tuple[Tensor, Tensor]:
    """`forward_constants_plain` of x's own paired sums."""
    return forward_constants_plain(paired_sums_plain(x, x), gamma, beta, epsilon,
                                   x.numel() // x.shape[1], x.dtype)


def backward_constants_plain(sums: Tensor, local: Tensor, mean: Tensor, var: Tensor, inv: Tensor,
                             gamma: Tensor, gmean: Optional[Tensor], gvar: Optional[Tensor],
                             epsilon: float, n: int, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """The backward's per-channel values, as mtlx's `_bn_train_bwd`, from
    the sums [2, C] of (dy, dy * x) over n elements a channel and this
    rank's own sums `local` (the same sums without data-parallel ranks):
    grads [2, C] = (dgamma, dbeta) from `local`; consts [3, C] in `dtype`
    = (a, b, c) of dx = dy * a + x * b + c. gmean and gvar, the incoming
    gradients of the batch statistics, may be None (zero)."""
    gmean = torch.zeros_like(mean) if gmean is None else gmean
    gvar = torch.zeros_like(var) if gvar is None else gvar
    rsig = torch.rsqrt(var + epsilon)  # inv / gamma, but gamma may be 0
    grads = torch.stack([rsig * (local[1] - mean * local[0]), local[0]])
    s1, sx = sums[0], sums[1]
    stot = sx - mean * s1
    gv = gvar - 0.5 * rsig * rsig * rsig * gamma * stot
    gmu = gmean - inv * s1 - 2.0 * mean * gv
    return grads, torch.stack([inv.to(dtype), (2.0 * gv / n).to(dtype), (gmu / n).to(dtype)])


def backward_sums_plain(dy: Tensor, x: Tensor, mean: Tensor, var: Tensor, inv: Tensor,
                        gamma: Tensor, gmean: Optional[Tensor], gvar: Optional[Tensor],
                        epsilon: float, n: int) -> Tuple[Tensor, Tensor]:
    """`backward_constants_plain` of the paired sums of (dy, x)."""
    sums = paired_sums_plain(dy, x)
    return backward_constants_plain(sums, sums, mean, var, inv, gamma, gmean, gvar, epsilon, n,
                                    x.dtype)


def bn_affine_plain(p: Tensor, a: Tensor, c: Tensor, q: Optional[Tensor] = None,
                    b: Optional[Tensor] = None) -> Tensor:
    """((p * a) [+ (q * b)]) + c per channel in plain PyTorch, in p's type."""
    y = p * a[:, None, None]
    if q is not None:
        y = y + q * b[:, None, None]
    return y + c[:, None, None]


# the tensor types of an eager call (gamma and beta are parameters)
_REAL = (Tensor, torch.nn.Parameter)


def _eager(*tensors) -> bool:
    """True where a call runs now on real tensors (None for an absent
    one), so a CUDA call may launch its kernel without the op dispatcher;
    a tracer (`torch.export`, `torch.compile`, fake tensors) goes through
    the registered op."""
    return not torch.compiler.is_compiling() and all(t is None or type(t) in _REAL
                                                     for t in tensors)


def _on(t: Tensor) -> None:
    """Raise unless t lies on a device that the ops take."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _four_d(what: str, t: Tensor, other: Optional[Tensor] = None) -> None:
    if t.dim() != 4 or (other is not None and other.shape != t.shape):
        raise ValueError(f"{what}: want [N, C, H, W] tensors of one shape; got "
                         f"{tuple(t.shape)}" + ("" if other is None else
                                               f" and {tuple(other.shape)}"))


def paired_sums(a: Tensor, b: Tensor) -> Tensor:
    """[2, C] float32: (sum(a), sum(a * b)) per channel of [N, C, H, W]
    tensors: the kernel for CUDA tensors, the plain version for CPU
    tensors, through the `mtlx::paired_sums` op (`kernels/ops.py`) except
    for an eager CUDA call, which launches directly (the op's dispatch
    costs as much host time as the launch)."""
    _four_d("paired_sums", a, b)
    if a.is_cuda and _eager(a, b):
        return _launch_sums(a, b)
    _on(a)
    return ops.paired_sums(a, b)


def forward_sums(x: Tensor, gamma: Tensor, beta: Tensor,
                 epsilon: float) -> Tuple[Tensor, Tensor]:
    """(stats [3, C] float32 = mean, var, inv; consts [2, C] in x's type =
    inv, beta - mean * inv) of x's batch statistics: one launch of the
    sums kernel for CUDA tensors, the plain version for CPU tensors,
    through `mtlx::bn_forward_sums` except for an eager CUDA call."""
    _four_d("forward_sums", x)
    if x.is_cuda and _eager(x, gamma, beta):
        return _launch_forward_sums(x, gamma, beta, epsilon)
    _on(x)
    return ops.bn_forward_sums(x, gamma, beta, epsilon)


def backward_sums(dy: Tensor, x: Tensor, mean: Tensor, var: Tensor, inv: Tensor, gamma: Tensor,
                  gmean: Optional[Tensor], gvar: Optional[Tensor], epsilon: float,
                  n: int) -> Tuple[Tensor, Tensor]:
    """(grads [2, C] float32 = dgamma, dbeta; consts [3, C] in x's type =
    a, b, c of dx = dy * a + x * b + c) from the sums of (dy, x) over n
    elements a channel and the forward's stats: one launch of the sums
    kernel for CUDA tensors, the plain version for CPU tensors, through
    `mtlx::bn_backward_sums` except for an eager CUDA call."""
    _four_d("backward_sums", dy, x)
    if dy.is_cuda and _eager(dy, x, mean, var, inv, gamma, gmean, gvar):
        return _launch_backward_sums(dy, x, mean, var, inv, gamma, gmean, gvar, epsilon, n)
    _on(dy)
    return ops.bn_backward_sums(dy, x, mean, var, inv, gamma, gmean, gvar, epsilon, n)


def forward_constants(sums: Tensor, gamma: Tensor, beta: Tensor, epsilon: float, n: int,
                      dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """`forward_sums`' outputs from complete sums [2, C] of (x, x) over n
    elements a channel (the ranks' all-reduced sums): a one-block launch
    for CUDA tensors, the plain version for CPU tensors."""
    if sums.dim() != 2 or sums.shape[0] != 2:
        raise ValueError(f"forward_constants: want sums [2, C], got {tuple(sums.shape)}")
    if sums.is_cuda and _eager(sums, gamma, beta):
        return _launch_forward_constants(sums, gamma, beta, epsilon, n, dtype)
    _on(sums)
    return ops.bn_forward_constants(sums, gamma, beta, epsilon, n, dtype)


def backward_constants(sums: Tensor, local: Tensor, mean: Tensor, var: Tensor, inv: Tensor,
                       gamma: Tensor, gmean: Optional[Tensor], gvar: Optional[Tensor],
                       epsilon: float, n: int, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """`backward_sums`' outputs from the ranks' sums [2, C] of (dy, dy *
    x), with dgamma and dbeta from this rank's sums `local` [2, C]: a
    one-block launch for CUDA tensors, the plain version for CPU
    tensors."""
    if sums.dim() != 2 or sums.shape[0] != 2 or local.shape != sums.shape:
        raise ValueError(f"backward_constants: want sums and local [2, C], got "
                         f"{tuple(sums.shape)} and {tuple(local.shape)}")
    if sums.is_cuda and _eager(sums, local, mean, var, inv, gamma, gmean, gvar):
        return _launch_backward_constants(sums, local, mean, var, inv, gamma, gmean, gvar,
                                          epsilon, n, dtype)
    _on(sums)
    return ops.bn_backward_constants(sums, local, mean, var, inv, gamma, gmean, gvar, epsilon,
                                     n, dtype)


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
    if p.is_cuda and _eager(p, a, c, q, b):
        return _launch_affine(p, a, c, q, b)
    _on(p)
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


def _check_stats(what: str, device: torch.device, c: int, vectors) -> list:
    """The (name, vector) pairs' vectors, each a float32 [C] vector on the
    card (None stays None; an incoming gradient is made contiguous, as
    autograd may hand over an expanded one); raise on anything else."""
    out = []
    for name, v in vectors:
        if v is not None:
            if v.device != device or v.dtype != torch.float32 or v.shape != (c,):
                raise TypeError(f"{what}: {name} must be a float32 [{c}] vector on {device}, "
                                f"got {v.dtype} {tuple(v.shape)} on {v.device}")
            v = v.contiguous()
        out.append(v)
    return out


def _stream(t: Tensor) -> int:
    """The current stream of t's card, as a raw pointer (as compiled
    PyTorch code reads it, without a Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


# float32 elements of a sums workspace, by (layout, n, c, hw, type code,
# card): the C side's grid rule, asked once a shape
_workspace_floats = {}
# the sums kernels' tickets by (card, stream): zeroed once, left zeroed by
# every launch
_tickets = {}


def _sums_scratch(lib, layout: int, t: Tensor, stream: int) -> Tuple[Tensor, Tensor]:
    """(a workspace for a sums launch over t's shape, the tickets of t's
    card and this stream)."""
    n, c, h, w = t.shape
    key = (layout, n, c, h * w, _DTYPE_CODES[t.dtype], t.get_device())
    floats = _workspace_floats.get(key)
    if floats is None:
        floats = _workspace_floats[key] = lib.mtlx_bn_sums_workspace(*key[:5])
    tickets = _tickets.get((key[5], stream))
    if tickets is None:
        tickets = _tickets[(key[5], stream)] = torch.zeros(lib.mtlx_bn_tickets(),
                                                           dtype=torch.int32, device=t.device)
    return torch.empty(floats, dtype=torch.float32, device=t.device), tickets


def _launch_sums(a: Tensor, b: Tensor) -> Tensor:
    """The sums kernel on CUDA tensors, writing the sums (the op's CUDA
    implementation; an eager call's, through `paired_sums`): one launch."""
    layout = _check_cuda("paired_sums", a, [("b", b)])
    if a.get_device() != torch.cuda.current_device():  # launch on a's card
        with torch.cuda.device(a.get_device()):
            return _launch_sums(a, b)
    lib = build.load_library("batch_norm")  # raises without CUDA or nvcc
    n, c, h, w = a.shape
    stream = _stream(a)
    work, tickets = _sums_scratch(lib, layout, a, stream)
    out = torch.empty((2, c), dtype=torch.float32, device=a.device)
    err = lib.mtlx_bn_paired_sums(a.data_ptr(), b.data_ptr(), work.data_ptr(),
                                  tickets.data_ptr(), out.data_ptr(), layout, n, c, h * w,
                                  _DTYPE_CODES[a.dtype], stream)
    build.check(lib, err, "paired_sums")
    paired_sums.launches += 1
    return out


def _launch_forward_sums(x: Tensor, gamma: Tensor, beta: Tensor,
                         epsilon: float) -> Tuple[Tensor, Tensor]:
    """The sums kernel on CUDA tensors with the forward's constants (the
    op's CUDA implementation; an eager call's): one launch."""
    layout = _check_cuda("forward_sums", x, [])
    if x.get_device() != torch.cuda.current_device():
        with torch.cuda.device(x.get_device()):
            return _launch_forward_sums(x, gamma, beta, epsilon)
    n, c, h, w = x.shape
    gamma, beta = _check_stats("forward_sums", x.device, c, [("gamma", gamma), ("beta", beta)])
    lib = build.load_library("batch_norm")
    stream = _stream(x)
    work, tickets = _sums_scratch(lib, layout, x, stream)
    stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
    consts = torch.empty((2, c), dtype=x.dtype, device=x.device)
    err = lib.mtlx_bn_forward_sums(x.data_ptr(), work.data_ptr(), tickets.data_ptr(),
                                   gamma.data_ptr(), beta.data_ptr(), epsilon, n * h * w,
                                   stats.data_ptr(), consts.data_ptr(), layout, n, c, h * w,
                                   _DTYPE_CODES[x.dtype], stream)
    build.check(lib, err, "forward_sums")
    paired_sums.launches += 1
    return stats, consts


def _launch_backward_sums(dy: Tensor, x: Tensor, mean: Tensor, var: Tensor, inv: Tensor,
                          gamma: Tensor, gmean: Optional[Tensor], gvar: Optional[Tensor],
                          epsilon: float, count: int) -> Tuple[Tensor, Tensor]:
    """The sums kernel on CUDA tensors with the backward's constants (the
    op's CUDA implementation; an eager call's): one launch."""
    layout = _check_cuda("backward_sums", dy, [("x", x)])
    if dy.get_device() != torch.cuda.current_device():
        with torch.cuda.device(dy.get_device()):
            return _launch_backward_sums(dy, x, mean, var, inv, gamma, gmean, gvar, epsilon,
                                         count)
    n, c, h, w = dy.shape
    mean, var, inv, gamma, gmean, gvar = _check_stats("backward_sums", dy.device, c, [
        ("mean", mean), ("var", var), ("inv", inv), ("gamma", gamma), ("gmean", gmean),
        ("gvar", gvar)])
    lib = build.load_library("batch_norm")
    stream = _stream(dy)
    work, tickets = _sums_scratch(lib, layout, dy, stream)
    grads = torch.empty((2, c), dtype=torch.float32, device=dy.device)
    consts = torch.empty((3, c), dtype=dy.dtype, device=dy.device)
    err = lib.mtlx_bn_backward_sums(dy.data_ptr(), x.data_ptr(), work.data_ptr(),
                                    tickets.data_ptr(), mean.data_ptr(), var.data_ptr(),
                                    inv.data_ptr(), gamma.data_ptr(), _ptr(gmean), _ptr(gvar),
                                    epsilon, count, grads.data_ptr(), consts.data_ptr(), layout,
                                    n, c, h * w, _DTYPE_CODES[dy.dtype], stream)
    build.check(lib, err, "backward_sums")
    paired_sums.launches += 1
    return grads, consts


def _check_sums(what: str, sums: Tensor, dtype: torch.dtype) -> int:
    if sums.dtype != torch.float32 or not sums.is_contiguous():
        raise TypeError(f"{what}: want contiguous float32 sums, got {sums.dtype} strides "
                        f"{sums.stride()}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: the constants are float32 or bfloat16, not {dtype}")
    if sums.shape[1] > 65535:
        raise ValueError(f"{what}: {sums.shape[1]} channels is past one launch")
    return _DTYPE_CODES[dtype]


def _launch_forward_constants(sums: Tensor, gamma: Tensor, beta: Tensor, epsilon: float,
                              count: int, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """The forward's constants from complete sums on the card: one
    one-block launch."""
    code = _check_sums("forward_constants", sums, dtype)
    if sums.get_device() != torch.cuda.current_device():
        with torch.cuda.device(sums.get_device()):
            return _launch_forward_constants(sums, gamma, beta, epsilon, count, dtype)
    c = sums.shape[1]
    gamma, beta = _check_stats("forward_constants", sums.device, c,
                               [("gamma", gamma), ("beta", beta)])
    lib = build.load_library("batch_norm")
    stats = torch.empty((3, c), dtype=torch.float32, device=sums.device)
    consts = torch.empty((2, c), dtype=dtype, device=sums.device)
    err = lib.mtlx_bn_forward_constants(sums.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                        epsilon, count, stats.data_ptr(), consts.data_ptr(), c,
                                        code, _stream(sums))
    build.check(lib, err, "forward_constants")
    paired_sums.launches += 1
    return stats, consts


def _launch_backward_constants(sums: Tensor, local: Tensor, mean: Tensor, var: Tensor,
                               inv: Tensor, gamma: Tensor, gmean: Optional[Tensor],
                               gvar: Optional[Tensor], epsilon: float, count: int,
                               dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """The backward's constants from the ranks' sums and this rank's on
    the card: one one-block launch."""
    code = _check_sums("backward_constants", sums, dtype)
    _check_sums("backward_constants", local, dtype)
    if sums.get_device() != torch.cuda.current_device():
        with torch.cuda.device(sums.get_device()):
            return _launch_backward_constants(sums, local, mean, var, inv, gamma, gmean, gvar,
                                              epsilon, count, dtype)
    c = sums.shape[1]
    if local.device != sums.device:
        raise TypeError(f"backward_constants: local is on {local.device}, sums on {sums.device}")
    mean, var, inv, gamma, gmean, gvar = _check_stats("backward_constants", sums.device, c, [
        ("mean", mean), ("var", var), ("inv", inv), ("gamma", gamma), ("gmean", gmean),
        ("gvar", gvar)])
    lib = build.load_library("batch_norm")
    grads = torch.empty((2, c), dtype=torch.float32, device=sums.device)
    consts = torch.empty((3, c), dtype=dtype, device=sums.device)
    err = lib.mtlx_bn_backward_constants(sums.data_ptr(), local.data_ptr(), mean.data_ptr(),
                                         var.data_ptr(), inv.data_ptr(), gamma.data_ptr(),
                                         _ptr(gmean), _ptr(gvar), epsilon, count,
                                         grads.data_ptr(), consts.data_ptr(), c, code,
                                         _stream(sums))
    build.check(lib, err, "backward_constants")
    paired_sums.launches += 1
    return grads, consts


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
    err = lib.mtlx_bn_affine(p.data_ptr(), _ptr(q), a.data_ptr(), _ptr(b), c.data_ptr(),
                             out.data_ptr(), layout, n, ch, h * w, _DTYPE_CODES[p.dtype],
                             _stream(p))
    build.check(lib, err, "bn_affine")
    bn_affine.launches += 1
    return out


paired_sums.launches = 0
bn_affine.launches = 0
