"""mtlx_torch box_ops, the Faster R-CNN coder and the grid anchors against
mtlx at float32 (rtol 1e-6), degenerate and zero-area boxes included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.anchors import grid as jgrid
from mtlx.coders import box_coders as jcoders
from mtlx.geometry import box_ops as jbox
from mtlx_torch.anchors import grid as tgrid
from mtlx_torch.coders import box_coders as tcoders
from mtlx_torch.geometry import box_ops as tbox

RTOL = 1e-6


def _boxes(rs, n, scale=100.0):
    y = rs.uniform(-10, scale, n)
    x = rs.uniform(-10, scale, n)
    h = rs.uniform(0.5, scale / 2, n)
    w = rs.uniform(0.5, scale / 2, n)
    b = np.stack([y, x, y + h, x + w], 1).astype(np.float32)
    b[::5, 2] = b[::5, 0]  # zero height
    b[1::7] = 0.0  # all-zero padding rows
    b[2::9, 3] = b[2::9, 1] - 3.0  # inverted (negative width)
    return b


def _close(got, want):
    # the atol floor is RTOL of the largest magnitude: jnp.exp and
    # torch.exp may differ by one ulp, and a difference of corners near
    # zero turns that into a large relative error
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.nanmax(np.abs(want)))


@pytest.mark.parametrize("fn", ["area", "intersection", "iou", "clip", "change_frame"])
def test_box_ops_match_mtlx(fn):
    rs = np.random.RandomState(0)
    b1, b2 = _boxes(rs, 37), _boxes(rs, 23)
    window = np.asarray([5.0, -2.0, 80.0, 90.0], np.float32)
    t1, t2, tw = map(torch.from_numpy, (b1, b2, window))
    j1, j2, jw = map(jnp.asarray, (b1, b2, window))
    if fn == "area":
        _close(tbox.area(t1), jbox.area(j1))
    elif fn == "intersection":
        _close(tbox.intersection(t1, t2), jbox.intersection(j1, j2))
    elif fn == "iou":
        got = tbox.iou(t1, t2)
        _close(got, jbox.iou(j1, j2))
        assert (got[1::7] == 0).all()  # zero-area rows have IoU 0
    elif fn == "clip":
        _close(tbox.clip_to_window(t1, tw), jbox.clip_to_window(j1, jw))
    else:
        _close(tbox.change_coordinate_frame(t1, tw), jbox.change_coordinate_frame(j1, jw))


def test_faster_rcnn_coder_matches_mtlx():
    rs = np.random.RandomState(1)
    anchors = _boxes(rs, 64) + np.asarray([0, 0, 4, 4], np.float32)  # positive sizes
    boxes = _boxes(rs, 64) + np.asarray([0, 0, 2, 2], np.float32)
    codes = rs.normal(0, 1.5, (64, 4)).astype(np.float32)
    jc = jcoders.make_faster_rcnn_coder()
    tc = tcoders.make_faster_rcnn_coder()
    _close(tc.encode(torch.from_numpy(boxes), torch.from_numpy(anchors)),
           jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    _close(tc.decode(torch.from_numpy(codes), torch.from_numpy(anchors)),
           jc.decode(jnp.asarray(codes), jnp.asarray(anchors)))


@pytest.mark.parametrize("grid_hw,scales,aspects", [
    ((3, 5), (0.25, 0.5, 1.0, 2.0), (0.5, 1.0, 2.0)),
    ((4, 4), (0.5, 1.0), (1.0,)),
])
def test_grid_anchors_match_mtlx(grid_hw, scales, aspects):
    kw = dict(scales=scales, aspect_ratios=aspects, base_anchor_size=(256.0, 256.0),
              anchor_stride=(16.0, 16.0))
    got = tgrid.GridAnchorGenerator(**kw).generate(grid_hw)
    want = jgrid.GridAnchorGenerator(**kw).generate(grid_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
