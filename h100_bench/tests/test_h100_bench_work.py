"""The yardstick's counts: the train step's model operations against
PyTorch's own count of the port's step, and the kernels' byte counts
against a count made the long way."""

import itertools

import numpy as np
import pytest
import torch

from h100_bench import inputs, work


def test_train_step_flops_match_the_flop_counter(tiny_spec):
    """work.train_step_flops against FlopCounterMode over one of the
    port's train steps on the CPU (128x128, two images): within 3%; the
    counter leaves out the stem's input gradient and gives the pooled
    windows' contraction one backward product, which the 3x rule counts
    twice."""
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench import drive_train, weights
    from mtlx_torch.train import train_step as ts

    config = tiny_spec["config"]
    model, step_fn, tx, _ = drive_train.build_program(config, "cpu")
    shapes = {n: tuple(p.shape) for n, p in model.modules.named_parameters()}
    model.modules.load_state_dict(weights.make_weights(shapes, 3, "cpu"), strict=False)
    batch, draws = inputs.train_pool(tiny_spec["traffic"], config["model"], config["max_boxes"],
                                     3, "cpu")[0]
    state = ts.create_train_state(model, tx)
    with FlopCounterMode(display=False) as counter:
        step_fn(state, batch, draws=draws)
    counted = counter.get_total_flops()
    mine = work.train_step_flops(config["model"], 2, tuple(batch["image"].shape[1:3]),
                                 config["max_boxes"])
    assert mine == pytest.approx(counted, rel=0.03)


def test_crop_pixels_read_by_brute_force():
    g = torch.Generator().manual_seed(0)
    b, n, h, w, size = 2, 5, 23, 31, (7, 7)
    boxes = torch.rand(b, n, 4, generator=g) * 1.4 - 0.2
    boxes = torch.cat([torch.minimum(boxes[..., :2], boxes[..., 2:]),
                       torch.maximum(boxes[..., :2], boxes[..., 2:])], -1)
    want = 0
    for i in range(b):
        used = np.zeros((h, w), bool)
        for j in range(n):
            y1, x1, y2, x2 = boxes[i, j].tolist()
            ys = [y1 * (h - 1) + k * (y2 - y1) * (h - 1) / (size[0] - 1) for k in range(size[0])]
            xs = [x1 * (w - 1) + k * (x2 - x1) * (w - 1) / (size[1] - 1) for k in range(size[1])]
            for y, x in itertools.product(ys, xs):
                if 0 <= y <= h - 1 and 0 <= x <= w - 1:
                    y0, x0 = int(np.floor(y)), int(np.floor(x))
                    for yy, xx in itertools.product((y0, min(y0 + 1, h - 1)),
                                                    (x0, min(x0 + 1, w - 1))):
                        used[yy, xx] = True
        want += int(used.sum())
    assert work.crop_pixels_read(boxes, size, h, w) == want


def test_kernel_bytes():
    """Each input byte read once, each output byte written once."""
    # IoU [4, 100, 4] x [1, 3000, 4] -> [4, 100, 3000] float32
    assert work.iou_seconds((4, 100, 4), (1, 3000, 4)) == pytest.approx(max(
        (4 * 100 + 3000) * 16 + 4 * 100 * 3000 * 4, 0) / work.HBM_BYTES_PER_S)
    # the crop's backward: dout [2, 64, 14, 14, 1024] bf16 -> [2, 40, 64, 1024]
    nbytes = 2 * 64 * 196 * 1024 * 2 + 2 * 64 * 16 + 2 * 40 * 64 * 1024 * 2
    ops = 2 * 64 * 196 * 1024 * work.ROI_BWD_OPS_PER_ELEMENT
    assert work.crop_backward_seconds((2, 64, 14, 14, 1024), 2, (40, 64)) == pytest.approx(
        max(nbytes / work.HBM_BYTES_PER_S, ops / work.F32_FLOP_PER_S))
    # NMS: 2 problems of 6000, 300 out; one problem stops after 10 picks
    keep = torch.zeros(2, 300, dtype=torch.bool)
    keep[0] = True
    keep[1, :10] = True
    steps = 300 + 11
    assert work.nms_seconds((2, 6000), keep, 300) == pytest.approx(max(
        (2 * 6000 * 21 + 2 * 300 * 5) / work.HBM_BYTES_PER_S,
        steps * 6000 * work.NMS_OPS_PER_BOX_STEP / work.F32_FLOP_PER_S))


def test_same_work_every_seed(tiny_spec):
    """Seeds move pixels, boxes and order, not the sizes or box counts."""
    cfg = tiny_spec["config"]
    seen = []
    for seed in (1, 2**31 + 7):
        pool = inputs.train_pool(tiny_spec["traffic"], cfg["model"], cfg["max_boxes"], seed, "cpu")
        seen.append([(sorted(map(tuple, b["true_shape"].tolist())), tuple(b["image"].shape),
                      sorted(b["gt_mask"].sum(1).tolist())) for b, _ in pool])
    assert seen[0] == seen[1]
