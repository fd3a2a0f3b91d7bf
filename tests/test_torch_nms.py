"""The port's greedy NMS against mtlx: the Pallas kernel in interpret mode,
the jnp greedy reference, and the multiclass / batched postprocess NMS.
Selections (indices, keep, classes, counts) must be exactly equal. The
second half renders the CUDA kernels' algorithm (rank by key, 64-bit
suppression mask, chunked scan) in numpy and holds it to the same."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.kernels import nms_pallas
from mtlx.ops import nms as jnms
from mtlx_torch.kernels import nms_cuda
from mtlx_torch.ops import nms as tnms


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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


# ---------------------------------------------------------------------------
# The algorithm of the CUDA kernels (csrc/nms.cu), rendered in numpy: priority
# rank from the packed 64-bit key, the 64-bit suppression mask of the ordered
# boxes, and the scan over chunks of 64 rows. The kernels themselves run only
# on a CUDA device; this holds their algorithm to the plain version and,
# through it, to mtlx.

_NEG = np.float32(-1e10)


def _packed_keys(scores, valid, score_thr):
    """Order-preserving score bits, then the complement of the index."""
    live = valid & (scores > score_thr) & (scores > _NEG / 2)
    s = np.where(live, scores, _NEG).astype(np.float32)
    s = np.where(s == 0, np.float32(0.0), s)  # -0.0 and +0.0 compare equal
    u = s.view(np.uint32).astype(np.uint64)
    bits = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    index = np.arange(len(scores), dtype=np.uint64)
    return (bits << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - index), live


def _decide(inter, u, thr):
    """`inter / u > thr` as the kernels decide it: without the division
    outside a guard band of 2^-20 around thr * u, by the division inside."""
    thr = np.float32(thr)
    if np.float32(1 / 1024) <= thr <= np.float32(1):
        lo = np.float32(float(thr) * (1 - 2.0 ** -20))
        hi = np.float32(float(thr) * (1 + 2.0 ** -20))
    else:
        lo, hi = np.float32(-np.inf), np.float32(np.inf)
    with np.errstate(over="ignore", invalid="ignore"):
        sure_over = inter > hi * u
        sure_not = inter < lo * u
        return np.where(sure_over, True, np.where(sure_not, False, inter / u > thr))


def _suppression_mask(boxes, thr):
    """[n, ceil(n / 64)] uint64: bit b of word w of row i is set when
    iou(i, 64 w + b) > thr and 64 w + b > i (float32, the plain version's
    operation order)."""
    n = len(boxes)
    ymin, xmin, ymax, xmax = (boxes[:, k].astype(np.float32) for k in range(4))
    area = (ymax - ymin) * (xmax - xmin)
    ih = np.maximum(np.float32(0), np.minimum(ymax[:, None], ymax[None]) -
                    np.maximum(ymin[:, None], ymin[None]))
    iw = np.maximum(np.float32(0), np.minimum(xmax[:, None], xmax[None]) -
                    np.maximum(xmin[:, None], xmin[None]))
    inter = ih * iw
    union = area[:, None] + area[None] - inter
    over = np.where(union > 0, _decide(inter, np.maximum(union, np.float32(1e-30)), thr),
                    np.float32(0) > np.float32(thr))
    over &= np.arange(n)[None] > np.arange(n)[:, None]
    words = -(-n // 64)
    padded = np.zeros((n, words * 64), bool)
    padded[:, :n] = over
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return (padded.reshape(n, words, 64) * weights).sum(-1, dtype=np.uint64)


def _rank_mask_scan(boxes, scores, valid, max_out, thr, score_thr):
    n = len(scores)
    keys, live = _packed_keys(scores, valid, score_thr)
    rank = (keys[None, :] > keys[:, None]).sum(1)  # rank[i] = #{j: key[j] > key[i]}
    assert sorted(rank) == list(range(n))  # the keys are unique
    order = np.empty(n, np.int64)
    order[rank] = np.arange(n)
    mask = _suppression_mask(boxes[order], thr)
    words = mask.shape[1]
    removed = [0] * words
    idx = np.zeros(max_out, np.int32)
    keep = np.zeros(max_out, bool)
    count = 0
    for c in range(words):
        rem, kept = removed[c], []
        for b in range(min(64, n - 64 * c)):
            row = 64 * c + b
            if not live[order[row]] or count == max_out:
                return idx, keep  # a dead row (they come last) or a full output
            if (rem >> b) & 1:
                continue
            idx[count], keep[count] = order[row], True
            count += 1
            kept.append(row)
            rem |= int(mask[row, c])  # the chunk's diagonal word, serially
        for w in range(c + 1, words):  # then the kept rows' words, all at once
            for row in kept:
                removed[w] |= int(mask[row, w])
    return idx, keep


def _kernel_algorithm_case(kind, n):
    boxes, scores, valid = _problem(n + len(kind), n, ties=kind != "unsorted")
    max_out, thr, score_thr = max(1, min(n, 100)), 0.5, 0.0
    if kind == "unsorted":  # continuous signed scores in random order, both zeros
        score_thr = float("-inf")
        scores = (scores - 0.5).astype(np.float32)
        scores[::7] = -0.0
        scores[3::7] = 0.0
    elif kind == "all-dead":
        valid = np.zeros(n, bool)
    elif kind == "few-live":  # fewer live rows than max_out
        valid &= np.arange(n) % 5 == 0
        max_out = n
    elif kind == "coarse-threshold":  # heavy suppression, a threshold past the guard band's range
        thr = 0.0005
    return boxes, scores, valid, max_out, thr, score_thr


@pytest.mark.parametrize("n", [1, 63, 64, 65, 301, 1917])
@pytest.mark.parametrize("kind", ["ties", "unsorted", "all-dead", "few-live", "coarse-threshold"])
def test_rank_mask_scan_equals_the_plain_version(kind, n):
    boxes, scores, valid, max_out, thr, score_thr = _kernel_algorithm_case(kind, n)
    got_idx, got_keep = _rank_mask_scan(boxes, scores, valid, max_out, thr, score_thr)
    ref_idx, ref_keep = nms_cuda.non_max_suppression_plain(
        torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
        torch.from_numpy(valid)[None], max_out, thr, score_thr)
    np.testing.assert_array_equal(got_keep, ref_keep[0].numpy())
    np.testing.assert_array_equal(got_idx, ref_idx[0].numpy())
    assert got_keep.any() == (valid & (scores > score_thr)).any()


@pytest.mark.parametrize("n", [65, 301])
@pytest.mark.parametrize("kind", ["ties", "unsorted", "few-live"])
def test_rank_mask_scan_equals_mtlx(kind, n):
    boxes, scores, valid, max_out, thr, score_thr = _kernel_algorithm_case(kind, n)
    got_idx, got_keep = _rank_mask_scan(boxes, scores, valid, max_out, thr, score_thr)
    jargs = (jnp.asarray(boxes), jnp.asarray(scores), max_out)
    jkw = dict(iou_threshold=thr, score_threshold=score_thr, valid_mask=jnp.asarray(valid))
    pal_idx, pal_keep = nms_pallas.non_max_suppression_pallas(*jargs, interpret=True, **jkw)
    ref_idx, ref_keep = jnms.non_max_suppression_padded(*jargs, batched=False, **jkw)
    for idx, keep in ((pal_idx, pal_keep), (ref_idx, ref_keep)):
        np.testing.assert_array_equal(got_keep, np.asarray(keep))
        np.testing.assert_array_equal(got_idx, np.asarray(idx))


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.6, 0.7, 1 / 1024, 1.0, 0.0005, 1.5])
def test_guard_band_decides_as_the_division(thr):
    """Around thr * u, ulp by ulp, and at the ends of the float range, the
    banded decision equals `inter / u > thr`."""
    rs = np.random.RandomState(int(thr * 1e4))
    u = np.concatenate([
        np.exp(rs.uniform(np.log(1e-30), np.log(1e30), 20000)),
        [1e-30, 1.2e-38 / thr * 1.0001 if thr < 1 else 1e-30, 3.0e38, 1.0, 6000.0 * 1000.0],
    ]).astype(np.float32)
    u = np.maximum(u, np.float32(1e-30))
    with np.errstate(over="ignore"):
        centre = np.float32(thr) * u
    cases = [centre]
    for _ in range(40):  # walk 40 ulp to each side of thr * u
        cases.append(np.nextafter(cases[-1], np.float32(np.inf)))
    down = centre
    for _ in range(40):
        down = np.nextafter(down, np.float32(0))
        cases.append(down)
    cases.append(u * np.float32(rs.uniform(0, 1)))
    for inter in cases:
        inter = inter.astype(np.float32)
        with np.errstate(over="ignore", invalid="ignore"):
            want = inter / u > np.float32(thr)
        np.testing.assert_array_equal(_decide(inter, u, thr), want)
