"""The port's assignment path against mtlx on the CPU: IoU and IoA (the IoU
kernel's plain version) exactly equal to mtlx.geometry.box_ops; the
argmax matcher at both Faster R-CNN presets, target assignment and the
balanced sampler (with JAX's draws injected) exactly equal to mtlx.

Against the Pallas IoU kernel in interpret mode the port is within a few
ulp (rtol 1e-6; 4 ulp observed): jit compiles the kernel body, and XLA on the CPU fuses the areas' product
into the union's addition (a fused multiply-add), so jitted mtlx itself
differs from eager mtlx by an ulp in about 3% of the entries (ROADMAP.md
queue 3). The port, its CUDA kernel (built with --fmad=false) and eager
mtlx round every operation once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.assign import matcher as jmatcher
from mtlx.assign import samplers as jsamplers
from mtlx.assign import target_assigner as jta
from mtlx.geometry import box_ops as jbox
from mtlx.kernels import iou_pallas
from mtlx_torch.assign import matcher as tmatcher
from mtlx_torch.assign import samplers as tsamplers
from mtlx_torch.assign import target_assigner as tta
from mtlx_torch.geometry import box_ops as tbox
from mtlx_torch.kernels import iou_cuda


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rs, n, scale=64.0):
    """Boxes with zero-area rows, an identical pair and touching pairs."""
    c = rs.uniform(0, scale, (n, 2))
    hw = rs.uniform(1, scale / 2, (n, 2))
    b = np.concatenate([c - hw / 2, c + hw / 2], 1).astype(np.float32)
    b[0] = 0.0  # all-zero padding row
    b[1, 2:] = b[1, :2]  # zero area
    b[3] = b[2]  # identical
    b[5] = [b[4, 2], b[4, 1], b[4, 2] + 5, b[4, 3]]  # touches row 4's bottom edge
    return b


@pytest.mark.parametrize("n,m", [(7, 50), (100, 300), (1, 1)])
def test_iou_and_ioa_equal_mtlx_exactly(n, m):
    rs = np.random.RandomState(n + m)
    b1, b2 = _boxes(rs, max(n, 6))[:n], _boxes(rs, max(m, 6))[:m]
    np.testing.assert_array_equal(tbox.iou(_t(b1), _t(b2)).numpy(), np.asarray(jbox.iou(b1, b2)))
    np.testing.assert_array_equal(tbox.ioa(_t(b1), _t(b2)).numpy(), np.asarray(jbox.ioa(b1, b2)))
    # the Pallas kernel, run as mtlx's own tests run it
    want = np.asarray(iou_pallas.iou_matrix(jnp.asarray(b1), jnp.asarray(b2), interpret=True))
    got = iou_cuda.iou_matrix(_t(b1)[None], _t(b2)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got != want).mean() < 0.1


def test_iou_broadcasts_a_shared_side():
    rs = np.random.RandomState(0)
    gt = np.stack([_boxes(rs, 9) for _ in range(3)])  # [3, 9, 4]
    anchors = _boxes(rs, 40)  # [40, 4], shared
    got = tbox.iou(_t(gt), _t(anchors)).numpy()
    assert got.shape == (3, 9, 40)
    np.testing.assert_array_equal(got, np.asarray(jbox.iou(gt, anchors)))
    np.testing.assert_array_equal(iou_cuda.iou_matrix(_t(gt), _t(anchors)[None]).numpy(), got)


def _sim_case(seed):
    """A [G, A] IoU matrix with duplicate ground-truth rows (force-match
    ties), a padded row and a row whose best anchor is shared."""
    rs = np.random.RandomState(seed)
    anchors = _boxes(rs, 60)
    gt = _boxes(rs, 6)
    gt[2] = gt[3] = anchors[10]  # duplicates: both claim anchor 10
    gt[4] = anchors[20] + np.float32(0.5)
    mask = np.asarray([True, True, True, True, True, False])
    return gt, anchors, mask


@pytest.mark.parametrize("preset", ["proposal", "detection"])
@pytest.mark.parametrize("case", ["mixed", "all-padding"])
def test_matcher_equals_mtlx(preset, case):
    gt, anchors, mask = _sim_case(1)
    if case == "all-padding":
        mask = np.zeros_like(mask)
    jfn = jta.create_target_assigner("FasterRCNN", preset).matcher_fn
    tfn = tta.create_target_assigner("FasterRCNN", preset).matcher_fn
    sim = np.asarray(jbox.iou(gt, anchors))
    want = np.asarray(jfn(jnp.asarray(sim), row_mask=jnp.asarray(mask)))
    got = tfn(_t(sim), row_mask=_t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "all-padding":
        assert (got == -1).all()
    else:
        assert (got >= 0).any() and (got == -1).any()


def test_force_match_lowest_row_wins_ties():
    sim = np.zeros((4, 5), np.float32)
    sim[1, 3] = sim[2, 3] = 0.4  # rows 1 and 2 tie on column 3
    sim[0, 0] = 0.9
    sim[3, 3] = 0.1
    want = np.asarray(jmatcher.argmax_match(jnp.asarray(sim), jnp.ones(4, bool), 0.7, 0.3))
    got = tmatcher.argmax_match(_t(sim), torch.ones(4, dtype=torch.bool), 0.7, 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] == 1 and got[0] == 0


@pytest.mark.parametrize("preset", ["proposal", "detection"])
def test_assign_targets_and_weights(preset):
    gt, anchors, mask = _sim_case(2)
    k = 4
    labels = np.eye(k + 1, dtype=np.float32)[np.asarray([1, 2, 3, 3, 4, 0])]
    jres = jta.create_target_assigner("FasterRCNN", preset).assign(
        jnp.asarray(anchors), jnp.asarray(gt), gt_labels=jnp.asarray(labels),
        gt_mask=jnp.asarray(mask), unmatched_cls_target=jnp.eye(k + 1)[0])
    # batched on the port's side: two copies of the problem
    tres = tta.create_target_assigner("FasterRCNN", preset).assign(
        _t(anchors), _t(np.stack([gt, gt])), gt_labels=_t(np.stack([labels, labels])),
        gt_mask=_t(np.stack([mask, mask])), unmatched_cls_target=torch.eye(k + 1)[0])
    for field in jres._fields:
        want = np.asarray(getattr(jres, field))
        got = getattr(tres, field).numpy()
        for b in range(2):
            if field == "reg_targets":
                np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-6, err_msg=field)
            else:
                np.testing.assert_array_equal(got[b], want, err_msg=field)


@pytest.mark.parametrize("n,batch,frac", [(300, 64, 0.25), (2000, 256, 0.5), (40, 64, 0.25)])
def test_balanced_subsample_equals_mtlx_with_jax_draws(n, batch, frac):
    rs = np.random.RandomState(n)
    indicator = rs.uniform(size=(3, n)) < 0.8
    labels = rs.uniform(size=(3, n)) < 0.1
    keys = jax.random.split(jax.random.PRNGKey(n), 3)
    want, u_pos, u_neg = [], [], []
    for i, key in enumerate(keys):
        want.append(np.asarray(jsamplers.balanced_subsample(
            key, jnp.asarray(indicator[i]), jnp.asarray(labels[i]), batch, frac)))
        kp, kn = jax.random.split(key)
        u_pos.append(np.asarray(jax.random.uniform(kp, (n,))))
        u_neg.append(np.asarray(jax.random.uniform(kn, (n,))))
    got = tsamplers.balanced_subsample(_t(indicator), _t(labels), batch, frac,
                                       (_t(np.stack(u_pos)), _t(np.stack(u_neg))))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert (got.sum(-1) <= batch).all()


class _CudaLooking(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel would launch")

    def no_fallback(*a, **k):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(iou_cuda, "iou_matrix_plain", no_fallback)
    b = torch.zeros(1, 3, 4).as_subclass(_CudaLooking)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        iou_cuda.iou_matrix(b, b)
    assert iou_cuda.iou_matrix.launches == 0
