"""The port's greedy NMS against mtlx: the Pallas kernel in interpret mode,
the jnp greedy reference, and the multiclass / batched postprocess NMS.
Selections (indices, keep, classes, counts) must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.kernels import nms_pallas
from mtlx.ops import nms as jnms
from mtlx_torch.kernels import nms_cuda
from mtlx_torch.ops import nms as tnms


def _problem(seed, n, ties=True):
    """Clustered boxes (heavy overlap), scores on a coarse grid (ties), a
    few zero-area rows and ~15% invalid rows."""
    rs = np.random.RandomState(seed)
    centers = rs.uniform(0, 100, (max(n // 8, 1), 2))
    c = centers[rs.randint(0, len(centers), n)] + rs.normal(0, 3, (n, 2))
    hw = rs.uniform(4, 30, (n, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], 1).astype(np.float32)
    boxes[::11, 2] = boxes[::11, 0]  # zero height
    scores = rs.uniform(0, 1, n)
    if ties:
        scores = np.floor(scores * 16) / 16  # exact ties, exact zeros
    valid = rs.uniform(0, 1, n) > 0.15
    return boxes, scores.astype(np.float32), valid


CASES = [
    # n, max_out, iou, score threshold
    (40, 10, 0.5, float("-inf")),
    (200, 32, 0.7, 0.0),
    (64, 64, 0.3, 0.25),
    (150, 120, 0.6, 0.0),  # more slots than survivors: padding
]


@pytest.mark.parametrize("n,max_out,thr,score_thr", CASES)
def test_greedy_matches_pallas_and_jnp(n, max_out, thr, score_thr):
    boxes, scores, valid = _problem(n, n)
    got_idx, got_keep = tnms.non_max_suppression_padded(
        torch.from_numpy(boxes), torch.from_numpy(scores), max_out, thr, score_thr,
        valid_mask=torch.from_numpy(valid),
    )
    jargs = (jnp.asarray(boxes), jnp.asarray(scores), max_out)
    jkw = dict(iou_threshold=thr, score_threshold=score_thr, valid_mask=jnp.asarray(valid))
    pal_idx, pal_keep = nms_pallas.non_max_suppression_pallas(*jargs, interpret=True, **jkw)
    ref_idx, ref_keep = jnms.non_max_suppression_padded(*jargs, batched=False, **jkw)
    for idx, keep in ((pal_idx, pal_keep), (ref_idx, ref_keep)):
        np.testing.assert_array_equal(got_keep.numpy(), np.asarray(keep))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    assert got_keep.any()


def test_strict_score_threshold_drops_exact_zeros():
    boxes = torch.tensor([[0, 0, 10, 10], [50, 50, 60, 60], [80, 80, 90, 90]], dtype=torch.float32)
    scores = torch.tensor([0.0, 0.5, 0.0])
    idx, keep = tnms.non_max_suppression_padded(boxes, scores, 3, 0.5, score_threshold=0.0)
    assert idx.tolist() == [1, 0, 0] and keep.tolist() == [True, False, False]


def test_batched_problems_solve_independently():
    probs = [_problem(s, 90) for s in range(3)]
    b, s, v = (torch.from_numpy(np.stack(x)) for x in zip(*probs))
    idx, keep = tnms.batched_non_max_suppression(b, s, 20, 0.5, 0.0, valid_mask=v)
    for i, (bi, si, vi) in enumerate(probs):
        ref_idx, ref_keep = jnms.non_max_suppression_padded(
            jnp.asarray(bi), jnp.asarray(si), 20, iou_threshold=0.5, score_threshold=0.0,
            valid_mask=jnp.asarray(vi), batched=False,
        )
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref_keep))


def _multiclass_inputs(seed, n, k, q):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-5, 70, (n, 1, 2)) + rs.normal(0, 2, (n, q, 2))
    hw = rs.uniform(2, 25, (n, q, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], -1).astype(np.float32)
    boxes[3, :, 2] = boxes[3, :, 0]  # a zero-area box in every class
    boxes[7, -1] = [90.0, 90.0, 95.0, 95.0]  # clipped away to zero area
    scores = (np.floor(rs.uniform(0, 1, (n, k)) * 32) / 32).astype(np.float32)
    valid = rs.uniform(0, 1, n) > 0.1
    return boxes, scores, valid


MC_CASES = [
    # n, classes, q, per class, total, clip + change frame
    (30, 4, 4, 10, 25, True),
    (30, 4, 1, 10, 50, True),  # shared boxes; more slots than candidates
    (300, 20, 20, 100, 300, True),  # the postprocess shape (mtlx: fixed point)
    (1600, 9, 1, 100, 300, False),  # mtlx: class-parallel priority chunks
]


def _assert_same(got, want):
    np.testing.assert_array_equal(got.valid_mask.numpy(), np.asarray(want.valid_mask))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,k,q,per_class,total,clip", MC_CASES)
def test_multiclass_matches_mtlx(n, k, q, per_class, total, clip):
    boxes, scores, valid = _multiclass_inputs(n + k, n, k, q)
    window = np.asarray([0.0, 0.0, 64.0, 80.0], np.float32)
    kw = dict(score_threshold=0.0, iou_threshold=0.6, max_size_per_class=per_class,
              max_total_size=total, change_coordinate_frame=clip)
    got = tnms.multiclass_non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        clip_window=torch.from_numpy(window) if clip else None,
        valid_mask=torch.from_numpy(valid), **kw,
    )
    want = jnms.multiclass_non_max_suppression(
        jnp.asarray(boxes), jnp.asarray(scores),
        clip_window=jnp.asarray(window) if clip else None,
        valid_mask=jnp.asarray(valid), **kw,
    )
    _assert_same(got, want)
    assert int(got.num_valid) > 0


def test_batch_multiclass_matches_mtlx():
    inputs = [_multiclass_inputs(s, 40, 5, 5) for s in range(3)]
    boxes, scores, valid = (np.stack(x) for x in zip(*inputs))
    windows = np.asarray([[0, 0, 64, 80], [0, 0, 50, 50], [0, 0, 70, 60]], np.float32)
    kw = dict(score_threshold=0.0, iou_threshold=0.6, max_size_per_class=12,
              max_total_size=40, change_coordinate_frame=True)
    got = tnms.batch_multiclass_non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        clip_window=torch.from_numpy(windows), valid_mask=torch.from_numpy(valid), **kw,
    )
    want = jnms.batch_multiclass_non_max_suppression(
        jnp.asarray(boxes), jnp.asarray(scores), valid_mask=jnp.asarray(valid),
        clip_window=jnp.asarray(windows), **kw,
    )
    _assert_same(got, want)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: reaches the wrappers' CUDA
    branch on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel would launch")

    def no_fallback(*a, **k):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(nms_cuda, "non_max_suppression_plain", no_fallback)
    boxes, scores, valid = (torch.from_numpy(x) for x in _problem(0, 16))
    cuda = [t[None].as_subclass(_CudaLooking) for t in (boxes, scores, valid)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nms_cuda.non_max_suppression(*cuda, 4, 0.5)
    assert nms_cuda.non_max_suppression.launches == 0
