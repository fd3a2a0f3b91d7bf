"""Train-mode live batch norm on its ops (mtlx_torch/kernels/
batch_norm_cuda.py: the sums folded into the per-channel constants,
`forward_sums` and `backward_sums`, or with data-parallel ranks
`paired_sums` and `forward_constants` / `backward_constants`, and the
affine `bn_affine`; the CUDA kernels of kernels/csrc/batch_norm.cu on the
card and their plain versions here on the CPU), against mtlx on the CPU:

  * `_BatchNormTrain` (mtlx_torch/backbones/resnet.py), composed of the
    plain versions, against mtlx's `_bn_train` custom_vjp, forward
    (y, mean, var) and VJP (dx, dgamma, dbeta, with cotangents on all
    three outputs), on seeded numpy inputs of 2x19x6x5 and 2x64x8x8 in
    float32 and bfloat16, the port's input in channels-last memory and in
    contiguous NCHW: tests/test_torch_live_bn.py's tolerances, each
    relative to the tensor's largest magnitude: float32 y and dx within
    1e-5; bfloat16 y and dx within 1/128 (one bfloat16 ulp at the top of
    the range); mean, var, dgamma and dbeta (float32 on both sides) within
    1e-5;
  * `torch.autograd.gradcheck` of `_BatchNormTrain` in float64 in both
    layouts;
  * the fused plain versions (`forward_sums_plain`, `backward_sums_plain`,
    and the constants alone on sums that differ from this rank's)
    against mtlx's `_bn_train_impl` and `_bn_train_bwd` called directly,
    float32, with the incoming gradients of mean and var given and absent
    (mtlx takes zeros where the port takes None): y, mean, var, inv, dx,
    dgamma, dbeta within 1e-5 of the largest magnitude, as above;
  * `torch.library.opcheck` of `mtlx::paired_sums`, `mtlx::bn_affine`
    (with and without q), `mtlx::bn_forward_sums`, `mtlx::bn_backward_sums`
    (gmean and gvar given and absent), `mtlx::bn_forward_constants` and
    `mtlx::bn_backward_constants` on CPU tensors;
  * LiveBatchNorm in training reaches exactly four ops, the forward's sums
    with its constants, the affine, the backward's sums with its
    constants, the affine, and computes nothing else (a dispatch mode
    records every op: no C-length op, no zeros for the unused gradients
    of mean and var);
  * under fake tensors (as `torch.export` traces), CUDA calls of every
    wrapper go through the registered ops' fake implementations and
    launch nothing, where an eager CUDA call would launch its kernel
    directly;
  * the affine's plain version in bfloat16 equals the kernel's arithmetic
    (float32 operations, each rounded to bfloat16 in the plain order) bit
    for bit, and the layout helpers and the wrappers' argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mtlx_torch.backbones.resnet import LiveBatchNorm, _BatchNormTrain
from mtlx_torch.kernels import batch_norm_cuda as bn

SHAPES = [(2, 19, 6, 5), (2, 64, 8, 8)]
LAYOUTS = ["channels_last", "nchw"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _nchw(a_nhwc: np.ndarray, dtype, layout: str) -> torch.Tensor:
    """The NHWC array as an [N, C, H, W] tensor in the given memory layout."""
    t = torch.from_numpy(a_nhwc).to(dtype).permute(0, 3, 1, 2)
    return t if layout == "channels_last" else t.contiguous()


def _case(shape, seed):
    n, c, h, w = shape
    rs = np.random.RandomState(seed)
    return dict(x=(rs.normal(0, 2, (n, h, w, c)) + 0.7).astype(np.float32),
                gamma=rs.uniform(0.5, 1.5, c).astype(np.float32),
                beta=rs.normal(0, 0.3, c).astype(np.float32),
                gy=rs.normal(0, 1, (n, h, w, c)).astype(np.float32),
                gmean=rs.normal(0, 0.1, c).astype(np.float32),
                gvar=rs.normal(0, 0.1, c).astype(np.float32))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_train_on_plain_ops_equals_mtlx(shape, dtype, layout):
    from mtlx.backbones.resnet import _bn_train

    c = _case(shape, seed=shape[1])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    eps = 1e-3
    x = jnp.asarray(c["x"], jdt)
    outs, vjp = jax.vjp(lambda xx, g, b: _bn_train(xx, g, b, eps, jdt), x,
                        jnp.asarray(c["gamma"]), jnp.asarray(c["beta"]))
    jdx, jdgamma, jdbeta = vjp((jnp.asarray(c["gy"], jdt), jnp.asarray(c["gmean"]),
                                jnp.asarray(c["gvar"])))

    xt = _nchw(c["x"], tdt, layout).requires_grad_(True)
    gamma = torch.from_numpy(c["gamma"]).requires_grad_(True)
    beta = torch.from_numpy(c["beta"]).requires_grad_(True)
    y, mean, var = _BatchNormTrain.apply(xt, gamma, beta, eps, None)
    assert y.dtype == tdt and bn.layout_of(y) == bn.layout_of(xt)
    torch.autograd.backward((y, mean, var), (_nchw(c["gy"], tdt, layout),
                                             torch.from_numpy(c["gmean"]),
                                             torch.from_numpy(c["gvar"])))
    assert xt.grad.dtype == tdt
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    big = 1e-5 if dtype == "float32" else 1 / 128
    assert _rel(nhwc(y), np.asarray(outs[0], np.float32)) <= big
    assert _rel(nhwc(xt.grad), np.asarray(jdx, np.float32)) <= big
    for name, got, want in (("mean", mean, outs[1]), ("var", var, outs[2]),
                            ("dgamma", gamma.grad, jdgamma), ("dbeta", beta.grad, jdbeta)):
        assert _rel(got.detach().numpy(), np.asarray(want)) <= 1e-5, name


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_plain_versions_equal_mtlx(shape, given):
    """The sums folded into the constants, forward and backward, against
    mtlx's `_bn_train_impl` and `_bn_train_bwd` on the same float32
    inputs; without data-parallel ranks (the sums of this rank) and with
    them (the constants alone on sums added over two ranks, dgamma and
    dbeta from this rank's)."""
    from mtlx.backbones.resnet import _bn_train_bwd, _bn_train_impl

    c = _case(shape, seed=shape[1] + 7)
    eps, n = 1e-3, shape[0] * shape[2] * shape[3]
    y, mean, var, inv = _bn_train_impl(jnp.asarray(c["x"]), jnp.asarray(c["gamma"]),
                                       jnp.asarray(c["beta"]), eps, jnp.float32)
    zero = np.zeros(shape[1], np.float32)
    gmean, gvar = (c["gmean"], c["gvar"]) if given else (zero, zero)
    jdx, jdgamma, jdbeta = _bn_train_bwd(eps, jnp.float32, (jnp.asarray(c["x"]),
                                                            jnp.asarray(c["gamma"]), mean, var,
                                                            inv, n),
                                         (jnp.asarray(c["gy"]), jnp.asarray(gmean),
                                          jnp.asarray(gvar)))

    x, gy = _nchw(c["x"], torch.float32, "nchw"), _nchw(c["gy"], torch.float32, "nchw")
    gamma, beta = torch.from_numpy(c["gamma"]), torch.from_numpy(c["beta"])
    stats, consts = bn.forward_sums_plain(x, gamma, beta, eps)
    got_y = bn.bn_affine_plain(x, consts[0], consts[1])
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    assert _rel(nhwc(got_y), np.asarray(y)) <= 1e-5
    for name, got, want in zip(("mean", "var", "inv"), stats, (mean, var, inv)):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-5, name
    tg = lambda k: torch.from_numpy(c[k]) if given else None
    args = (stats[0], stats[1], stats[2], gamma, tg("gmean"), tg("gvar"), eps, n)
    grads, consts = bn.backward_sums_plain(gy, x, *args)
    dx = bn.bn_affine_plain(gy, consts[0], consts[2], q=x, b=consts[1])
    assert _rel(nhwc(dx), np.asarray(jdx)) <= 1e-5
    assert _rel(grads[0].numpy(), np.asarray(jdgamma)) <= 1e-5
    assert _rel(grads[1].numpy(), np.asarray(jdbeta)) <= 1e-5
    # two ranks: the constants alone on the sums of both ranks' halves
    # equal the one-rank path; dgamma and dbeta are this rank's own
    halves = [bn.paired_sums_plain(gy[i::2], x[i::2]) for i in range(2)]
    grads2, consts2 = bn.backward_constants_plain(halves[0] + halves[1], halves[0], *args,
                                                  torch.float32)
    for got, want in zip(consts2, consts):
        assert _rel(got.numpy(), want.numpy()) <= 1e-5
    assert torch.equal(grads2[1], halves[0][0])
    fstats, fconsts = bn.forward_constants_plain(
        sum(bn.paired_sums_plain(x[i::2], x[i::2]) for i in range(2)), gamma, beta, eps, n,
        torch.float32)
    for got, want in zip((*fstats, *fconsts), (*stats, *bn.forward_sums_plain(x, gamma, beta,
                                                                             eps)[1])):
        assert _rel(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bn_train_gradcheck_float64(layout):
    rs = np.random.RandomState(3)
    x = _nchw(rs.normal(0.4, 1.5, (2, 4, 5, 3)), torch.float64, layout).requires_grad_(True)
    gamma = torch.from_numpy(rs.uniform(0.5, 1.5, 3)).requires_grad_(True)
    beta = torch.from_numpy(rs.normal(0, 0.3, 3)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda xx, g, b: _BatchNormTrain.apply(xx, g, b, 1e-3, None), (x, gamma, beta))


def _op_cases():
    rs = np.random.RandomState(4)
    t = lambda *s: torch.from_numpy(rs.normal(0, 1, s).astype(np.float32))
    a, b = t(2, 19, 6, 5), t(2, 19, 6, 5)
    v = [t(19) for _ in range(3)]
    cl = a.contiguous(memory_format=torch.channels_last)
    pos = v[2].abs() + 0.5  # a variance
    sums, local = t(2, 19), t(2, 19)
    return [("paired_sums", (a, b)), ("paired_sums", (cl, cl)),
            ("bn_affine", (a, v[0], v[1])), ("bn_affine", (cl, v[0], v[1], cl, v[2])),
            ("bn_affine", (a.bfloat16(), *(x.bfloat16() for x in v[:2]), b.bfloat16(),
                           v[2].bfloat16())),
            ("bn_forward_sums", (a, v[0], v[1], 1e-3)),
            ("bn_forward_sums", (cl.bfloat16(), v[0], v[1], 1e-3)),
            ("bn_backward_sums", (b, a, v[0], pos, v[1], v[2], None, None, 1e-3, 60)),
            ("bn_backward_sums", (cl.bfloat16(), cl.bfloat16(), v[0], pos, v[1], v[2], v[1],
                                  v[0], 1e-3, 60)),
            ("bn_forward_constants", (sums, v[0], v[1], 1e-3, 60, torch.bfloat16)),
            ("bn_backward_constants", (sums, local, v[0], pos, v[1], v[2], None, v[0], 1e-3,
                                       120, torch.float32))]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_ops_opcheck(case):
    name, args = _op_cases()[case]
    torch.library.opcheck(getattr(torch.ops.mtlx, name).default, args)


class _Ops(TorchDispatchMode):
    """Records every op dispatched inside it that computes (views and
    aliases such as autograd's detach left out): (name, the largest numel
    among its tensor arguments and results)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
        size = max([t.numel() for t in flat if isinstance(t, torch.Tensor)], default=0)
        self.seen.append((str(func.overloadpacket), size))
        return out


def test_live_batch_norm_reaches_only_the_two_ops(monkeypatch):
    """Each direction is two ops, the sums with their constants and the
    affine: no other op computes anything."""
    names = ("paired_sums", "forward_sums", "backward_sums", "forward_constants",
             "backward_constants", "bn_affine")
    calls = dict.fromkeys(names, 0)
    counters = bn.paired_sums, bn.bn_affine
    launches = [f.launches for f in counters]
    for name in calls:
        real = getattr(bn, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(bn, name, counted)
    rs = np.random.RandomState(5)
    x = _nchw(rs.normal(0, 1, (2, 8, 8, 64)).astype(np.float32), torch.float32,
              "channels_last").requires_grad_(True)
    gy = _nchw(rs.normal(0, 1, (2, 8, 8, 64)).astype(np.float32), torch.float32,
               "channels_last")
    norm = LiveBatchNorm(64).train()
    with _Ops() as mode:
        norm(x).backward(gy)
    assert [name for name, _ in mode.seen] == [
        "mtlx.bn_forward_sums", "mtlx.bn_affine", "mtlx.bn_backward_sums", "mtlx.bn_affine"
    ], mode.seen
    assert all(size == x.numel() for _, size in mode.seen), mode.seen
    assert calls == dict(paired_sums=0, forward_sums=1, backward_sums=1, forward_constants=0,
                         backward_constants=0, bn_affine=2)
    assert norm.batch_stats is not None
    assert x.grad is not None and norm.scale.grad is not None and norm.bias.grad is not None
    # CPU tensors take the plain versions: no kernel launch is counted
    assert [f.launches for f in counters] == launches


def test_tracers_take_the_registered_ops():
    from torch._subclasses.fake_tensor import FakeTensorMode

    launches = bn.paired_sums.launches, bn.bn_affine.launches
    assert bn._eager(torch.zeros(1))
    with FakeTensorMode():
        x = torch.empty(2, 6, 5, 19, device="cuda", dtype=torch.bfloat16).permute(0, 3, 1, 2)
        v = torch.empty(19, device="cuda", dtype=torch.bfloat16)
        f = torch.empty(19, device="cuda")
        assert not bn._eager(x)
        sums = bn.paired_sums(x, x)
        y = bn.bn_affine(x, v, v, q=x, b=v)
        fwd = bn.forward_sums(x, f, f, 1e-3)
        bwd = bn.backward_sums(x, x, f, f, f, f, None, f, 1e-3, 60)
        fwd_c = bn.forward_constants(sums, f, f, 1e-3, 60, torch.bfloat16)
        bwd_c = bn.backward_constants(sums, sums, f, f, f, f, f, None, 1e-3, 60, torch.bfloat16)
    assert sums.shape == (2, 19) and sums.dtype == torch.float32 and sums.is_cuda
    assert y.shape == x.shape and y.dtype == torch.bfloat16 and y.is_cuda
    assert bn.layout_of(y) == bn.CHANNELS_LAST
    for (stats, consts), rows in ((fwd, (3, 2)), (bwd, (2, 3)), (fwd_c, (3, 2)), (bwd_c, (2, 3))):
        assert stats.shape == (rows[0], 19) and stats.dtype == torch.float32 and stats.is_cuda
        assert consts.shape == (rows[1], 19) and consts.dtype == torch.bfloat16 and consts.is_cuda
    assert (bn.paired_sums.launches, bn.bn_affine.launches) == launches


@pytest.mark.parametrize("with_q", [False, True])
def test_bf16_affine_is_each_operation_rounded_in_order(with_q):
    """The kernel's arithmetic: float32 operations, each rounded to
    bfloat16, in the plain version's order; equal bit for bit."""
    rs = np.random.RandomState(6)
    t = lambda *s: torch.from_numpy(rs.normal(0, 3, s).astype(np.float32)).bfloat16()
    p, q = t(3, 19, 7, 5), t(3, 19, 7, 5)
    a, b, c = t(19), t(19), t(19)
    r = lambda v: v.bfloat16().float()
    ch = lambda v: v.float()[:, None, None]
    want = r(p.float() * ch(a))
    if with_q:
        want = r(want + r(q.float() * ch(b)))
    want = r(want + ch(c)).bfloat16()
    got = bn.bn_affine(p, a, c, q, b) if with_q else bn.bn_affine(p, a, c)
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       want.view(torch.int16))


def test_layouts_and_argument_checks():
    x = torch.zeros(2, 5, 4, 3)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert bn.layout_of(x) == bn.NCHW and bn.layout_of(cl) == bn.CHANNELS_LAST
    assert bn.layout_of(x[:, :, ::2]) is None and bn.layout_of(x[0]) is None
    # C = 1 or H * W = 1: one memory order, taken as channels-last
    assert bn.layout_of(torch.zeros(2, 1, 4, 3)) == bn.CHANNELS_LAST
    assert bn.layout_of(torch.zeros(2, 5, 1, 1)) == bn.CHANNELS_LAST
    assert bn.in_layout_of(x, cl).is_contiguous(memory_format=torch.channels_last)
    assert bn.in_layout_of(cl, x).is_contiguous()
    assert bn.in_layout_of(cl, cl) is cl
    strided = x[:, :, ::2]
    assert bn.in_layout_of(cl, strided) is cl
    # the plain versions take any strides
    torch.testing.assert_close(bn.paired_sums(strided, strided),
                               bn.paired_sums_plain(strided.contiguous(), strided.contiguous()))
    with pytest.raises(ValueError, match="one shape"):
        bn.paired_sums(x, x[:1])
    with pytest.raises(ValueError, match=r"\[C\]"):
        bn.bn_affine(x, torch.ones(4), torch.ones(5))
    with pytest.raises(ValueError, match="come together"):
        bn.bn_affine(x, torch.ones(5), torch.ones(5), q=x)
    with pytest.raises(ValueError, match="unsupported device"):
        bn.paired_sums(x.to("meta"), x.to("meta"))
