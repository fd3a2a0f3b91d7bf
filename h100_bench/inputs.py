"""The general generator of traffic, which a window cycles through. A
serving mix (`kind` serve) is a pool of calls of decoded uint8 images on
the host (`serve_pool`); a training mix (`kind` train) a pool of batches
and of their random draws, made on the device from the seed. A traffic
file (traffic/<mix>.json) gives the parameters; of a training mix:

  batch_size, pool      images a step, batches in the pool
  groups                batch i takes group i % len(groups): true image
                        sizes (h, w) spaced evenly from the least to the
                        most of the `heights` and `widths` ranges, or equal shares of the
                        `resize_from` source sizes put through the
                        keep-aspect `resizer`
  boxes                 [least, most] ground-truth boxes an image, the
                        counts spaced evenly over the range

Every seed gets the same sizes and box counts, each batch in its own
order (the seed moves the pixels, the boxes and the order, not the
work).
  bucket_multiple       the bucket granularity the batch is padded to

Images are uint8 noise on their true extent, zero on the bucket's
padding; boxes lie inside the true extent (as chip_smoke.py's
`train_batch` draws them). The draws are the step's: the flip's
uniforms, the proposal and anchor samplers' uniforms."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from h100_bench.reference.serve import keep_aspect_target


def _bucket(extent: int, cap: int, multiple: int) -> int:
    return min(int(cap), -(-int(extent) // multiple) * multiple)


def _true_sizes(group: Dict, traffic: Dict, n: int, rs: np.random.Generator):
    if "resize_from" in group:
        r = traffic["resizer"]
        sizes = [keep_aspect_target(h, w, r["min_dimension"], r["max_dimension"])
                 for h, w in group["resize_from"]]
        picks = np.arange(n) % len(sizes)
        rs.shuffle(picks)
        return [sizes[i] for i in picks]
    hs, ws = (_spaced(group[k], n) for k in ("heights", "widths"))
    order = rs.permutation(n)
    return [(hs[i], ws[i]) for i in order]


def _spaced(bounds, n: int):
    """n whole numbers spaced evenly from bounds[0] to bounds[1]."""
    return [int(v) for v in np.round(np.linspace(bounds[0], bounds[1], n))]


def train_pool(traffic: Dict, model_cfg: Dict, max_boxes: int, seed: int,
               device) -> List[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """[(batch, draws)] * pool. batch: image [B, H, W, 3] uint8 on its
    bucket, true_shape [B, 2] int32, gt_boxes [B, G, 4] px, gt_classes
    [B, G] int32, gt_mask [B, G] bool; draws: aug_0 [B], proposal_pos /
    proposal_neg [B, first_stage_max_proposals], anchor_pos / anchor_neg
    [B, A]."""
    rs = np.random.default_rng(int(seed))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    b, k = traffic["batch_size"], model_cfg["num_classes"]
    canvas = model_cfg["canvas_size"]
    stride = model_cfg["feature_stride"]
    per_cell = len(model_cfg["anchor_scales"]) * len(model_cfg["anchor_aspect_ratios"])
    lo_boxes, hi_boxes = traffic["boxes"]
    pool = []
    for i in range(traffic["pool"]):
        sizes = _true_sizes(traffic["groups"][i % len(traffic["groups"])], traffic, b, rs)
        bh = _bucket(max(s[0] for s in sizes), canvas[0], traffic["bucket_multiple"])
        bw = _bucket(max(s[1] for s in sizes), canvas[1], traffic["bucket_multiple"])
        image = torch.randint(0, 256, (b, bh, bw, 3), generator=gen, device=device,
                              dtype=torch.uint8)
        boxes = np.zeros((b, max_boxes, 4), np.float32)
        classes = np.zeros((b, max_boxes), np.int32)
        mask = np.zeros((b, max_boxes), bool)
        counts = [int(c) for c in rs.permutation(_spaced((lo_boxes, min(hi_boxes, max_boxes)), b))]
        for j, (h, w) in enumerate(sizes):
            image[j, h:] = 0
            image[j, :, w:] = 0
            n = counts[j]
            y0, x0 = rs.uniform(0, h * 0.8, n), rs.uniform(0, w * 0.8, n)
            bh_, bw_ = rs.uniform(0.05, 0.5, n) * h, rs.uniform(0.05, 0.5, n) * w
            boxes[j, :n] = np.stack([y0, x0, np.minimum(y0 + bh_, h), np.minimum(x0 + bw_, w)], 1)
            classes[j, :n] = rs.integers(0, k, n)
            mask[j, :n] = True
        to = lambda a: torch.from_numpy(a).to(device)
        batch = {"image": image, "true_shape": to(np.asarray(sizes, np.int32)),
                 "gt_boxes": to(boxes), "gt_classes": to(classes), "gt_mask": to(mask)}
        anchors = -(-bh // stride) * -(-bw // stride) * per_cell
        u = lambda *shape: torch.rand(shape, generator=gen, device=device)
        p = model_cfg["first_stage_max_proposals"]
        draws = {"aug_0": u(b), "proposal_pos": u(b, p), "proposal_neg": u(b, p),
                 "anchor_pos": u(b, anchors), "anchor_neg": u(b, anchors)}
        pool.append((batch, draws))
    return pool


def serve_pool(traffic: Dict, seed: int) -> List[List[np.ndarray]]:
    """[call][image] decoded [H, W, 3] uint8 noise images on the host: each
    call `batch_size` images, the `sizes` in equal shares (the remainder
    to the first) in the seed's order."""
    rs = np.random.default_rng(int(seed))
    sizes = traffic["sizes"]
    b = traffic["batch_size"]
    calls = []
    for _ in range(traffic["pool"]):
        order = rs.permutation(np.arange(b) % len(sizes))
        calls.append([rs.integers(0, 256, (sizes[i][0], sizes[i][1], 3), dtype=np.uint8)
                      for i in order])
    return calls
