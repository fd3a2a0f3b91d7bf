"""The algorithms of the crop forward kernel and of the IoU kernel
(csrc/roi_crop.cu, csrc/iou.cu), rendered in numpy float32 (one rounding
per operation, as the kernels compiled without fused multiply-add) and held
to the plain versions and to mtlx. The kernels themselves run only on a
CUDA device.

Crop forward: a box's sample rows are tabled once, and each sample column
walks them in order, keeping the x-blends of the two source rows it read
last; a sample row whose lo or hi source row is one of them reads it no
more. Bit-equal to `crop_and_resize_plain` and to eager mtlx
`crop_and_resize`; within 1e-5 of the Pallas forward kernel in interpret
mode, which weights the two taps in another order (as test_torch_roi.py).

IoU: the division runs only where the intersection is not 0; elsewhere
the kernel writes the intersection itself. Equal to `iou_matrix_plain` and
to eager mtlx `box_ops.iou`, and, sign of zero included, to the same
rendering dividing every pair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.geometry import box_ops as jbox
from mtlx.ops import roi as jroi
from mtlx_torch.kernels import iou_cuda, roi_cuda
from test_torch_roi import _pallas_fwd


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


F32 = np.float32

# ---------------------------------------------------------------------------
# crop forward


def _sample_axis(c0, c1, size, i, limit):
    """csrc/roi_crop.cu sample_axis: (lo, hi, frac, in_range) of sample i."""
    lim1 = F32(limit - 1)
    if size > 1:
        step = (F32(c1) - F32(c0)) * lim1 / F32(size - 1)
        coord = F32(c0) * lim1 + step * F32(i)
    else:
        coord = F32(0.5) * (F32(c0) + F32(c1)) * lim1
    lo = np.floor(coord)
    lo_i = min(max(int(lo), 0), limit - 1)
    return lo_i, min(lo_i + 1, limit - 1), F32(coord - lo), bool(0.0 <= coord <= lim1)


def _row_reusing_crop(img, boxes, crop):
    """The forward kernel's walk. img [H, W, C] float32, boxes [N, 4] ->
    ([N, ch, cw, C] float32, source-row reads per (box, column))."""
    h, w, c = img.shape
    ch, cw = crop
    out = np.zeros((len(boxes), ch, cw, c), F32)
    reads = np.zeros((len(boxes), cw), int)
    for n, (y0, x0, y1, x1) in enumerate(boxes):
        # the block's table of sample rows: lo (-1 out of range), frac
        ytab = []
        for i in range(ch):
            lo, _, frac, inside = _sample_axis(y0, y1, ch, i, h)
            ytab.append((lo if inside else -1, frac))
        for x in range(cw):
            xlo, xhi, fx, x_in = _sample_axis(x0, x1, cw, x, w)
            cache = {}  # source row -> x-blend, the two read last

            def blend(r):
                if r in cache:
                    return cache[r]
                reads[n, x] += 1
                tl, tr = img[r, xlo], img[r, xhi]
                return tl + (tr - tl) * fx

            for i, (lo, fy) in enumerate(ytab):
                if lo < 0 or not x_in:
                    continue  # zeros, nothing read
                hi = min(lo + 1, h - 1)
                top = blend(lo)
                bottom = top if hi == lo else blend(hi)
                out[n, i, x] = top + (bottom - top) * fy
                cache = {lo: top, hi: bottom}
    return out, reads


def _crop_case(kind, h, w, c, n, crop, seed):
    rs = np.random.RandomState(seed)
    img = rs.normal(0, 1, (h, w, c)).astype(F32)
    corners = rs.uniform(-0.2, 1.2, (n, 4))
    boxes = np.concatenate([np.minimum(corners[:, :2], corners[:, 2:]),
                            np.maximum(corners[:, :2], corners[:, 2:])], 1)
    if kind == "shorter than a row":  # every sample row shares its source rows
        y0 = rs.uniform(0, 0.9, n)
        boxes[:, 0], boxes[:, 2] = y0, y0 + rs.uniform(0, 0.9 / (h - 1), n)
    elif kind == "wider than the map":  # samples fall out of range
        boxes[:, :2] = rs.uniform(-0.6, -0.1, (n, 2))
        boxes[:, 2:] = rs.uniform(1.1, 1.6, (n, 2))
    elif kind == "edges at 0 and 1":  # samples exactly on the first and last pixel
        boxes[:] = [0.0, 0.0, 1.0, 1.0]
        boxes[1::2, 2] = 0.5  # top edge on row 0, bottom inside
        boxes[2::3, 1] = 0.5  # right edge on the last column, left inside
    elif kind == "inverted":  # descending sample coordinates
        boxes = boxes[:, [2, 3, 0, 1]]
    return img, boxes.astype(F32)


CROP_KINDS = ["mixed", "shorter than a row", "wider than the map", "edges at 0 and 1", "inverted"]


@pytest.mark.parametrize("crop", [(1, 1), (4, 3), (7, 7)])
@pytest.mark.parametrize("kind", CROP_KINDS)
def test_row_reusing_crop_equals_the_plain_version_and_mtlx(kind, crop):
    h, w, c, n = 9, 11, 13, 6  # C not a multiple of 8 (nor of 4)
    img, boxes = _crop_case(kind, h, w, c, n, crop, len(kind) + sum(crop))
    got, reads = _row_reusing_crop(img, boxes, crop)
    plain = roi_cuda.crop_and_resize_plain(torch.from_numpy(img)[None],
                                           torch.from_numpy(boxes)[None], crop)[0].numpy()
    np.testing.assert_array_equal(got, plain)
    eager = np.asarray(jroi.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), crop))
    np.testing.assert_array_equal(got, eager)
    # sample coordinates are monotone in the sample index, so a column
    # reads each distinct source row of its box's taps once (or nothing,
    # out of range), where the four-tap form reads 2 per sample row
    for k, (y0, x0, y1, x1) in enumerate(boxes):
        rows = set()
        for i in range(crop[0]):
            lo, hi, _, inside = _sample_axis(y0, y1, crop[0], i, h)
            rows |= {lo, hi} if inside else set()
        x_in = [_sample_axis(x0, x1, crop[1], j, w)[3] for j in range(crop[1])]
        np.testing.assert_array_equal(reads[k], np.where(x_in, len(rows), 0))
    if kind == "shorter than a row":
        assert reads.max() <= 3 and reads.sum() > 0
    if kind == "wider than the map" and crop != (1, 1):  # a 1 x 1 crop samples the centre
        assert (got == 0).any() and (got != 0).any()
    if kind == "mixed" and crop == (7, 7):
        pallas = np.asarray(_pallas_fwd(img, boxes, crop))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


def test_row_reusing_crop_rounds_once_to_bfloat16():
    img, boxes = _crop_case("mixed", 10, 12, 16, 5, (7, 7), 3)
    img16 = torch.from_numpy(img).bfloat16()
    got, _ = _row_reusing_crop(img16.float().numpy(), boxes, (7, 7))
    plain = roi_cuda.crop_and_resize_plain(img16[None], torch.from_numpy(boxes)[None], (7, 7))[0]
    assert torch.equal(torch.from_numpy(got).bfloat16(), plain)


# ---------------------------------------------------------------------------
# IoU


def _iou_rows(b1, b2, divide_every_pair=False):
    """The IoU kernel's arithmetic, row by row: b1 [N, 4], b2 [M, 4]."""
    area2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    out = np.zeros((len(b1), len(b2)), F32)
    zero = F32(0)
    for i, (ymin1, xmin1, ymax1, xmax1) in enumerate(b1):
        area1 = (ymax1 - ymin1) * (xmax1 - xmin1)  # staged once a row
        ih = np.maximum(zero, np.minimum(ymax1, b2[:, 2]) - np.maximum(ymin1, b2[:, 0]))
        iw = np.maximum(zero, np.minimum(xmax1, b2[:, 3]) - np.maximum(xmin1, b2[:, 1]))
        inter = ih * iw
        uni = area1 + area2 - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            quotient = inter / np.maximum(uni, F32(1e-30))
        if not divide_every_pair:
            quotient = np.where(inter == 0, inter, quotient)  # skips the division
        out[i] = np.where(uni > 0, quotient, zero)
    return out


def _iou_case(seed, n, m):
    """Padding rows, zero-area and inverted boxes, edges that touch, a -0
    coordinate."""
    rs = np.random.RandomState(seed)

    def boxes(k):
        c = rs.uniform(0, 64, (k, 2))
        hw = rs.uniform(1, 24, (k, 2))
        return np.concatenate([c - hw / 2, c + hw / 2], 1).astype(F32)

    b1, b2 = boxes(n), boxes(m)
    b1[0] = b2[0] + 1.0  # overlaps column 0
    b1[n // 2:] = 0.0  # padding rows
    b1[1, 2:] = b1[1, :2]  # zero area
    b1[2] = b1[2, [2, 3, 0, 1]]  # inverted
    b1[3] = [b2[0, 2], b2[0, 1], b2[0, 2] + 5, b2[0, 3]]  # touches column 0's bottom edge
    b1[4] = [-0.0, 1.0, -0.0, 9.0]  # zero height at y = -0
    b2[1] = [0.0, 0.0, 6.0, 6.0]  # with column 1: min(ymax) - max(ymin) = -0 - 0
    b2[2, :2] = b2[2, 2:]  # zero area
    return b1, b2


@pytest.mark.parametrize("n,m", [(8, 7), (10, 64), (12, 301), (6, 3)])
def test_iou_skip_rule_equals_the_plain_version_and_mtlx(n, m):
    b1, b2 = _iou_case(n * m, n, m)  # M not a multiple of 4 but for 64
    got = _iou_rows(b1, b2)
    every = _iou_rows(b1, b2, divide_every_pair=True)
    np.testing.assert_array_equal(got, every)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(every))
    plain = iou_cuda.iou_matrix_plain(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    np.testing.assert_array_equal(got, plain)  # +0 == -0: max's sign of zero is not pinned
    np.testing.assert_array_equal(got, np.asarray(jbox.iou(b1, b2)))
    assert (got == 0).any() and (got > 0).any()
    assert np.signbit(got[4, 1])  # -0 / 36 is -0, and the skip writes -0
