"""Smoke run of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain PyTorch version at the main path's shapes, serve
the flagship Faster R-CNN ResNet-50 through `InferenceModel`, train the
flagship MTL R50 for a few steps, and compare the card with the CPU on
the same request and on the same train step.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. the card: `nvidia-smi` name and power limit, torch and CUDA versions
  2. build every kernel from mtlx_torch/kernels/csrc (one nvcc each, in
     parallel), timed
  3. each kernel against its plain version on the card: greedy NMS at
     1 x 6000 -> 300 (IoU 0.7), 40 x 300 -> 100 (IoU 0.6) and 16 x 6000
     -> 300 (training), selections equal exactly; the ROI crop at
     40x64x1024 with 300 boxes -> 14x14 (and 16 images x 64 boxes),
     float32 within 1e-5 and bfloat16 within one bfloat16 ulp of the
     float32 result; the IoU matrix at 16 x 100 x 30720 (padded, zero-area,
     identical and touching boxes), bit-equal; the crop backward at
     16 x 64 boxes x 14x14x1024 -> 16x40x64x1024 in float32 (within 1e-4
     of each pixel's sum of term magnitudes: the atomics add in no fixed
     order) and bfloat16 (within one bfloat16 ulp of the float32 result
     plus that), and at crop size 1; each timed with CUDA events beside
     its plain version and, where one PyTorch call computes the same
     function, that call
  4. serve: the full-width flagship R50 (bfloat16, seeded random weights)
     answers 600x800, 800x600 and 600x1000 requests one at a time and a
     batch of two, through both kernels (their launch counts must rise)
  5. the same request in float32 on the card and on the CPU (TF32 off),
     stage by stage, with the tolerances printed beside the differences
  6. train: the full-width flagship MTL R50 (flagship_train_config,
     bfloat16 compute, float32 parameters, seeded weights, batch norm
     calibrated on the first batch) takes a warm-up and three timed steps
     on batches of 16 synthetic images (about 600x1000, bucket 640x1024,
     1-20 boxes each) through the flip, both stages, the three MTL losses,
     the clip and momentum; all four kernels must launch, every loss and
     gradient be finite, every head get a gradient and the parameters
     move; one step is profiled
  7. one train step of a resnet10 model (float32, 128x128, TF32 off) on
     the card and on the CPU with the same draws and the CPU's RPN
     proposals: losses (1e-4 relative), every parameter's gradient (L2 of
     the difference within 1e-3 of the L2, each element within 1e-2 of the
     tensor's largest magnitude), every update (L2 within 1e-3) and the
     parameters after the step (within 1e-2 of each tensor's largest
     magnitude)

The line before the last is one JSON object listing every kernel; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# operations per box and greedy step in the NMS kernel: the argmax key
# compare plus the IoU test (2 min, 2 max, 3 sub, 2 clamp, 1 mul, 2 add /
# sub, 1 div, 3 compares)
NMS_OPS_PER_BOX_STEP = 17
# operations per crop output element: three lerps (sub, mul, add)
ROI_OPS_PER_ELEMENT = 9


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------- phase 3


def nms_case(gen, p: int, n: int):
    """Boxes in tight clusters (heavy overlap), scores on a coarse grid
    (many exact ties), every 37th row zero-area, ~10% invalid rows."""
    centers = torch.rand(p, n // 20 + 1, 2, generator=gen) * torch.tensor([600.0, 1000.0])
    which = torch.randint(0, centers.shape[1], (p, n), generator=gen)
    c = torch.gather(centers, 1, which[..., None].expand(p, n, 2))
    c = c + torch.randn(p, n, 2, generator=gen) * 6.0
    hw = 20.0 + torch.rand(p, n, 2, generator=gen) * 120.0
    boxes = torch.cat([c - hw / 2, c + hw / 2], -1)
    boxes[:, ::37, 2:] = boxes[:, ::37, :2]
    scores = torch.floor(torch.rand(p, n, generator=gen) * 256.0) / 256.0
    valid = torch.rand(p, n, generator=gen) > 0.1
    return boxes.cuda(), scores.cuda(), valid.cuda()


def check_nms(gen, results):
    from mtlx_torch.kernels import nms_cuda

    rows = []
    # the served RPN, the served postprocess, the training step's RPN
    for p, n, k, thr in ((1, 6000, 300, 0.7), (40, 300, 100, 0.6), (16, 6000, 300, 0.7)):
        boxes, scores, valid = nms_case(gen, p, n)
        idx, keep = nms_cuda.non_max_suppression(boxes, scores, valid, k, thr, 0.0)
        ref_idx, ref_keep = nms_cuda.non_max_suppression_plain(boxes, scores, valid, k, thr, 0.0)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)):
            bad = int((idx != ref_idx).sum() + (keep != ref_keep).sum())
            raise AssertionError(f"NMS kernel differs from its plain version at "
                                 f"{p}x{n}->{k}: {bad} slots")
        picks = keep.sum(1)
        # work this run needs: every pick made plus the empty pick that ends
        # a problem's loop early, each one pass over the N boxes
        steps = int(torch.clamp(picks + 1, max=k).sum())
        t_bound, by = bound_ms(
            nbytes=p * n * (16 + 4 + 1) + p * k * (4 + 1),
            ops=steps * n * NMS_OPS_PER_BOX_STEP,
        )
        ms = cuda_ms(lambda: nms_cuda.non_max_suppression(boxes, scores, valid, k, thr, 0.0), 50)
        plain_ms = cuda_ms(
            lambda: nms_cuda.non_max_suppression_plain(boxes, scores, valid, k, thr, 0.0), 3
        )
        log(f"[nms] {p}x{n}->{k} iou {thr}: selections equal (exact), "
            f"{int(picks.sum())} picks; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {t_bound:.5f} ms ({by}), library null")
        rows.append(dict(shape=f"{p}x{n}->{k}", ms=ms, plain_ms=plain_ms,
                         bound_ms=t_bound, bound_by=by, max_abs_err=0.0))
    results["nms"] = rows


def check_roi(gen, results):
    from mtlx_torch.kernels import roi_cuda

    b, h, w, c, n, cs = 1, 40, 64, 1024, 300, 14
    feats = torch.randn(b, h, w, c, generator=gen).cuda()
    corners = torch.rand(b, n, 4, generator=gen) * 1.4 - 0.2  # some past [0, 1]
    boxes = torch.cat([torch.minimum(corners[..., :2], corners[..., 2:]),
                       torch.maximum(corners[..., :2], corners[..., 2:])], -1).cuda()
    # float32: the kernel against the plain version, atol 1e-5
    got = roi_cuda.crop_and_resize(feats, boxes, (cs, cs))
    ref = roi_cuda.crop_and_resize_plain(feats, boxes, (cs, cs))
    err32 = float((got - ref).abs().max())
    if err32 > 1e-5:
        raise AssertionError(f"ROI kernel float32 max abs err {err32} > 1e-5")
    # bfloat16 (the main path's type): within one bf16 ulp of the float32
    # crop of the same bf16 features
    fb = feats.bfloat16()
    got16 = roi_cuda.crop_and_resize(fb, boxes, (cs, cs))
    ref32 = roi_cuda.crop_and_resize_plain(fb.float(), boxes, (cs, cs))
    ref16 = roi_cuda.crop_and_resize_plain(fb, boxes, (cs, cs))
    ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(1e-30))) - 7)
    worst_ulps = float(((got16.float() - ref32).abs() / ulp).max())
    if worst_ulps > 1.0:
        raise AssertionError(f"ROI kernel bf16 off by {worst_ulps} ulp of the f32 crop")
    err16 = float((got16.float() - ref16.float()).abs().max())
    torch.cuda.synchronize()

    # yardstick: F.grid_sample (align_corners=True) on the same points
    from mtlx_torch.ops.roi import _sample_coords

    ys = _sample_coords(boxes[..., 0], boxes[..., 2], cs, h)  # [1, N, cs]
    xs = _sample_coords(boxes[..., 1], boxes[..., 3], cs, w)
    grid = torch.stack([
        (xs[..., None, :] / (w - 1) * 2 - 1).expand(b, n, cs, cs),
        (ys[..., :, None] / (h - 1) * 2 - 1).expand(b, n, cs, cs),
    ], -1).reshape(b, n * cs, cs, 2).bfloat16()
    img_nchw = fb.permute(0, 3, 1, 2)

    ms = cuda_ms(lambda: roi_cuda.crop_and_resize(fb, boxes, (cs, cs)), 50)
    plain_ms = cuda_ms(lambda: roi_cuda.crop_and_resize_plain(fb, boxes, (cs, cs)), 10)
    library_ms = cuda_ms(lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=True), 50)
    ms32 = cuda_ms(lambda: roi_cuda.crop_and_resize(feats, boxes, (cs, cs)), 50)
    elt = 2
    t_bound, by = bound_ms(
        nbytes=b * h * w * c * elt + b * n * 16 + b * n * cs * cs * c * elt,
        ops=b * n * cs * cs * c * ROI_OPS_PER_ELEMENT,
    )
    log(f"[roi] {b}x{h}x{w}x{c}, {n} boxes -> {cs}x{cs}: f32 max abs err {err32:.3g} "
        f"(tol 1e-5), bf16 worst {worst_ulps:.3f} ulp of f32 (tol 1 ulp), bf16 vs "
        f"plain {err16:.3g}; bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"grid_sample {library_ms:.4f} ms, bound {t_bound:.4f} ms ({by}); "
        f"f32 kernel {ms32:.4f} ms")
    results["roi_crop"] = dict(shape=f"{b}x{h}x{w}x{c}x{n}->{cs}x{cs} bf16", ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms, bound_ms=t_bound,
                               bound_by=by, max_abs_err=err16, f32_max_abs_err=err32)

    # the training step's second stage: 16 images, 64 sampled boxes each
    bt, nt = 16, 64
    ft = torch.randn(bt, h, w, c, generator=gen).cuda().bfloat16()
    ct = torch.rand(bt, nt, 4, generator=gen) * 1.4 - 0.2
    bxt = torch.cat([torch.minimum(ct[..., :2], ct[..., 2:]),
                     torch.maximum(ct[..., :2], ct[..., 2:])], -1).cuda()
    if not torch.equal(roi_cuda.crop_and_resize(ft, bxt, (cs, cs)),
                       roi_cuda.crop_and_resize_plain(ft, bxt, (cs, cs))):
        raise AssertionError("ROI kernel bf16 differs from its plain version at the training shape")
    ms_t = cuda_ms(lambda: roi_cuda.crop_and_resize(ft, bxt, (cs, cs)), 50)
    plain_t = cuda_ms(lambda: roi_cuda.crop_and_resize_plain(ft, bxt, (cs, cs)), 5)
    bound_t, by_t = bound_ms(
        nbytes=bt * h * w * c * elt + bt * nt * 16 + bt * nt * cs * cs * c * elt,
        ops=bt * nt * cs * cs * c * ROI_OPS_PER_ELEMENT,
    )
    log(f"[roi] {bt}x{h}x{w}x{c}, {nt} boxes each -> {cs}x{cs} (training): bf16 equal to the "
        f"plain version; kernel {ms_t:.4f} ms, plain {plain_t:.4f} ms, bound {bound_t:.4f} ms "
        f"({by_t})")
    results["roi_crop"]["other_shapes"] = [dict(
        shape=f"{bt}x{h}x{w}x{c}x{nt}->{cs}x{cs} bf16", ms=ms_t, plain_ms=plain_t,
        bound_ms=bound_t, bound_by=by_t, max_abs_err=0.0)]


def check_iou(gen, results):
    from mtlx_torch.anchors.grid import GridAnchorGenerator
    from mtlx_torch.geometry import box_ops
    from mtlx_torch.kernels import iou_cuda

    # the RPN assignment of the flagship at batch 16 on its 640x1024 bucket:
    # 100 padded ground-truth rows against the 40 x 64 x 12 clipped anchors
    gen_a = GridAnchorGenerator(scales=(0.25, 0.5, 1.0, 2.0), aspect_ratios=(0.5, 1.0, 2.0),
                                base_anchor_size=(256.0, 256.0), anchor_stride=(16.0, 16.0))
    anchors = box_ops.clip_to_window(gen_a.generate((40, 64)),
                                     torch.tensor([0.0, 0.0, 640.0, 1024.0]))
    b, g, a = 16, 100, anchors.shape[0]
    c = torch.rand(b, g, 2, generator=gen) * torch.tensor([640.0, 1024.0])
    hw = 8.0 + torch.rand(b, g, 2, generator=gen) * 400.0
    gt = torch.cat([c - hw / 2, c + hw / 2], -1)
    gt[:, 20:] = 0.0  # padding rows
    gt[:, 3, 2:] = gt[:, 3, :2]  # zero area
    gt[:, 4] = anchors[1000]  # identical to an anchor
    gt[:, 5] = torch.cat([anchors[2000, 2:3], anchors[2000, 1:2], anchors[2000, 2:3] + 50,
                          anchors[2000, 3:4]])  # touches an anchor's bottom edge
    gt, anchors = gt.cuda(), anchors.cuda().contiguous()
    got = iou_cuda.iou_matrix(gt, anchors[None])
    ref = iou_cuda.iou_matrix_plain(gt, anchors[None])
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        bad = int((got != ref).sum())
        raise AssertionError(f"IoU kernel differs from its plain version in {bad} entries")
    ms = cuda_ms(lambda: iou_cuda.iou_matrix(gt, anchors[None]), 50)
    plain_ms = cuda_ms(lambda: iou_cuda.iou_matrix_plain(gt, anchors[None]), 10)
    # each output: 2 min, 2 max, 2 sub, 2 clamp, 1 mul (inter), area1 (3),
    # union (2), compare, max, div
    t_bound, by = bound_ms(nbytes=b * g * 16 + a * 16 + b * g * a * 4, ops=b * g * a * 16)
    log(f"[iou] {b}x{g}x{a}: bit-equal to the plain version ({int((got > 0).sum())} "
        f"positive pairs); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {t_bound:.4f} ms "
        f"({by}), library null")
    results["iou"] = dict(shape=f"{b}x{g}x{a}", ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
                          bound_by=by, max_abs_err=0.0)


def _bwd_tolerance(roi_cuda, dout, boxes, hw):
    """Per pixel, 1e-4 of the sum of its terms' magnitudes (the plain
    backward of |dout|: the weights are non-negative)."""
    return 1e-4 * roi_cuda.crop_and_resize_backward_plain(dout.float().abs(), boxes, hw)


def check_roi_backward(gen, results):
    from mtlx_torch.kernels import roi_cuda

    # crop size 1 and boxes past [0, 1], float32, small
    fb = torch.randn(2, 7, 9, 16, generator=gen).cuda()
    corners = torch.rand(2, 5, 4, generator=gen) * 1.6 - 0.3
    bx = torch.cat([torch.minimum(corners[..., :2], corners[..., 2:]),
                    torch.maximum(corners[..., :2], corners[..., 2:])], -1).cuda()
    d1 = torch.randn(2, 5, 1, 1, 16, generator=gen).cuda()
    err1 = (roi_cuda.crop_and_resize_backward(d1, bx, (7, 9))
            - roi_cuda.crop_and_resize_backward_plain(d1, bx, (7, 9))).abs()
    if not bool((err1 <= _bwd_tolerance(roi_cuda, d1, bx, (7, 9))).all()):
        raise AssertionError(f"crop backward (crop size 1) off by {float(err1.max())}")

    # the main path: the second stage of the flagship at batch 16
    b, h, w, c, n, cs = 16, 40, 64, 1024, 64, 14
    corners = torch.rand(b, n, 4, generator=gen) * 1.4 - 0.2  # some past [0, 1]
    boxes = torch.cat([torch.minimum(corners[..., :2], corners[..., 2:]),
                       torch.maximum(corners[..., :2], corners[..., 2:])], -1).cuda()
    boxes[:, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0])  # clamped hi taps on the edges
    dout = torch.randn(b, n, cs, cs, c, generator=gen).cuda()
    tol = _bwd_tolerance(roi_cuda, dout, boxes, (h, w))
    got = roi_cuda.crop_and_resize_backward(dout, boxes, (h, w))
    ref = roi_cuda.crop_and_resize_backward_plain(dout, boxes, (h, w))
    err32 = (got - ref).abs()
    ratio32 = float((err32 / tol.clamp_min(1e-30)).max())
    if not bool((err32 <= tol).all()):
        raise AssertionError(f"crop backward float32 exceeds its tolerance ({ratio32:.3g}x)")
    d16 = dout.bfloat16()
    got16 = roi_cuda.crop_and_resize_backward(d16, boxes, (h, w))
    ref32 = roi_cuda.crop_and_resize_backward_plain(d16.float(), boxes, (h, w))
    ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(1e-30))) - 7)
    err16 = (got16.float() - ref32).abs()
    ratio16 = float((err16 / (ulp + tol)).max())
    # in ulp, where the sum does not cancel below its own float32 tolerance
    worst_ulps = float(torch.where(tol < ulp, err16 / ulp, 0.0).max())
    if ratio16 > 1.0:
        raise AssertionError(f"crop backward bf16 exceeds one ulp of the f32 result (+ tol): "
                             f"{ratio16:.3g}x")
    torch.cuda.synchronize()

    # yardstick: the d(input) of F.grid_sample (align_corners=True) on the
    # same points, its grad_input only
    from mtlx_torch.ops.roi import _sample_coords

    ys = _sample_coords(boxes[..., 0], boxes[..., 2], cs, h)
    xs = _sample_coords(boxes[..., 1], boxes[..., 3], cs, w)
    grid = torch.stack([
        (xs[..., None, :] / (w - 1) * 2 - 1).expand(b, n, cs, cs),
        (ys[..., :, None] / (h - 1) * 2 - 1).expand(b, n, cs, cs),
    ], -1).reshape(b, n * cs, cs, 2).bfloat16()
    feats_nchw = torch.zeros(b, h, w, c, dtype=torch.bfloat16, device="cuda").permute(0, 3, 1, 2)
    gout = d16.permute(0, 4, 1, 2, 3).reshape(b, c, n * cs, cs)

    ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward(d16, boxes, (h, w)), 20)
    plain_ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward_plain(d16, boxes, (h, w)), 3)
    library_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        gout, feats_nchw, grid, 0, 0, True, [True, False]), 20)
    ms32 = cuda_ms(lambda: roi_cuda.crop_and_resize_backward(dout, boxes, (h, w)), 20)
    # every dout element read once, d(features) written once; 4 taps of a
    # multiply (the weight) and an add per element
    t_bound, by = bound_ms(nbytes=b * n * cs * cs * c * 2 + b * n * 16 + b * h * w * c * 2,
                           ops=b * n * cs * cs * c * 8)
    log(f"[roi-bwd] dout {b}x{n}x{cs}x{cs}x{c} -> {b}x{h}x{w}x{c}: f32 max abs err "
        f"{float(err32.max()):.3g} ({ratio32:.3g} of its tolerance), bf16 at {ratio16:.3g} of "
        f"its tolerance (1 ulp of f32 + the f32 tolerance; {worst_ulps:.3f} ulp where the "
        f"sum does not cancel), crop size 1 ok; bf16 "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, grid_sampler_2d_backward "
        f"{library_ms:.4f} ms, bound {t_bound:.4f} ms ({by}); f32 kernel {ms32:.4f} ms")
    results["roi_crop_backward"] = dict(
        shape=f"{b}x{n}x{cs}x{cs}x{c}->{b}x{h}x{w}x{c} bf16", ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=t_bound, bound_by=by,
        max_abs_err=float((got16.float() - ref32).abs().max()),
        f32_max_abs_err=float(err32.max()))


# ---------------------------------------------------------------- phase 4


def request_images(rs):
    """Resized VOC-like requests: 600x800, 800x600, 600x1000 uint8 RGB."""
    return [rs.randint(0, 256, (hh, ww, 3)).astype(np.uint8)
            for hh, ww in ((600, 800), (800, 600), (600, 1000))]


def bucket_canvas(image):
    """The 128-bucketed canvas a single request computes on."""
    h, w = image.shape[:2]
    bh, bw = -(-h // 128) * 128, -(-w // 128) * 128
    canvas = np.zeros((1, bh, bw, 3), np.uint8)
    canvas[0, :h, :w] = image
    return torch.from_numpy(canvas).float(), torch.tensor([[h, w]], dtype=torch.int32)


def calibrate_batch_norm(model, image):
    """Set every frozen batch norm's mean and variance to those of its
    input on one request (backbone on the image, block4 on its ROI
    crops). With random weights this gives the unit-scale activations of
    a trained network, so class scores spread over the classes and the
    postprocess NMS has live candidates in every class."""
    x, ts = bucket_canvas(image)
    calibrate_batch_norm_on(model, x.to(model.device), ts.to(model.device))


def calibrate_batch_norm_on(model, images, true_shapes):
    """calibrate_batch_norm on a batch of canvas images [B, H, W, 3]."""
    from mtlx_torch.backbones.resnet import FrozenBatchNorm

    def hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        model.predict(model.preprocess(images.float()), true_shapes)
    finally:
        for h in handles:
            h.remove()


def stage_times(model, image, reps: int = 10):
    """Milliseconds per stage of one request: the span between CUDA events
    recorded around each stage, i.e. its kernels plus any idle gap while
    the host was still enqueueing them."""
    x, ts = bucket_canvas(image)
    x, ts = x.cuda(), ts.cuda()
    hw = tuple(x.shape[1:3])
    names = ["preprocess+backbone", "rpn head", "rpn postprocess (top-k, NMS)",
             "second stage (crop, block4, heads)", "postprocess (decode, NMS)"]
    totals = np.zeros(len(names))
    with torch.inference_mode():
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            feats = model.modules.backbone(model.preprocess(x))
            ev[1].record()
            obj, enc = model.modules.rpn(feats)
            ev[2].record()
            props, scores, keep = model._postprocess_rpn(obj, enc, ts, model.anchors_for(hw))
            ev[3].record()
            cls, box = model._predict_second_stage(feats, props, hw)
            ev[4].record()
            model.postprocess({"proposal_boxes": props, "proposal_mask": keep,
                               "proposal_scores": scores, "class_predictions": cls,
                               "refined_box_encodings": box}, ts)
            ev[5].record()
            ev[5].synchronize()
            if rep:  # the first pass warms up
                totals += [ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))]
    return dict(zip(names, (totals / reps).tolist()))


def profile_request(im, request):
    """Device time by kernel over one served request (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.predict_images(request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] one 600x800 request: wall {wall_ms:.2f} ms (profiler on), kernels "
        f"busy {busy:.2f} ms ({busy / wall_ms:.1%} of wall), {sum(r[1] for r in rows)} device operations")
    for ms, count, key in rows[:12]:
        log(f"[profile]   {ms:8.3f} ms  x{count:<4d} {key[:100]}")


def check_outputs(out, b):
    want = {"detection_boxes": (b, 300, 4), "detection_scores": (b, 300),
            "detection_classes": (b, 300), "num_detections": (b,)}
    for key, shape in want.items():
        arr = out[key]
        if arr.shape != shape:
            raise AssertionError(f"{key} shape {arr.shape}, want {shape}")
        if not np.isfinite(arr).all():
            raise AssertionError(f"{key} has non-finite values")


def phase_serve(seed: int, results):
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_config
    from mtlx_torch.export.exporter import InferenceModel
    from mtlx_torch.kernels import nms_cuda, roi_cuda

    cfg = flagship_config()  # bfloat16, as the pipeline config serves
    model = FasterRCNN(cfg, device="cuda")
    model.init_weights(torch.Generator().manual_seed(seed))
    im = InferenceModel(model, ("keep_aspect", {"min_dimension": 600, "max_dimension": 1024}),
                        device="cuda")
    images = request_images(np.random.RandomState(seed))
    calibrate_batch_norm(model, images[0])
    requests = [[a] for a in images] + [images[:2]]
    for req in requests:  # warm-up
        im.predict_images(req)
    torch.cuda.synchronize()

    nms_cuda.non_max_suppression.launches = 0
    roi_cuda.crop_and_resize.launches = 0
    outs, latencies = [], []
    for req in requests:
        t0 = time.perf_counter()
        out = im.predict_images(req)  # ends in a copy to the host
        latencies.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {"nms": nms_cuda.non_max_suppression.launches,
                "roi_crop": roi_cuda.crop_and_resize.launches}

    for req, out, sec in zip(requests, outs, latencies):
        shapes = "+".join(f"{a.shape[0]}x{a.shape[1]}" for a in req)
        log(f"[serve] {shapes}: {sec * 1e3:.2f} ms ({len(req) / sec:.2f} img/s), "
            f"num_detections {out['num_detections'].tolist()}")
        check_outputs(out, len(req))
    log(f"[serve] kernel launches while serving {len(images) + 2} images in "
        f"{len(requests)} requests: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    with torch.inference_mode():
        x = torch.from_numpy(images[0]).cuda()[None].float()
        pred = model.predict(model.preprocess(x), torch.tensor([[600, 800]], device="cuda"))
    kept = int(pred["proposal_mask"].sum())
    log(f"[serve] RPN kept {kept} proposals on a 600x800 image")
    if kept < 1:
        raise AssertionError("the RPN kept no proposal")
    results["launches"] = launches
    for name, ms in stage_times(model, images[0]).items():
        log(f"[stages] 600x800 on 640x896: {name}: {ms:.3f} ms")
    profile_request(im, requests[0])


# ---------------------------------------------------------------- phase 5


def _agreement(a: torch.Tensor, b: torch.Tensor, atol: float) -> float:
    """Share of slots (leading dims) whose last-axis values agree within atol."""
    return float(((a - b).abs() <= atol).all(-1).float().mean())


def phase_card_vs_cpu(seed: int):
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_config
    from mtlx_torch.export.exporter import InferenceModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[card-vs-cpu] float32, TF32 off for convolutions and matmuls")
    cfg = flagship_config(dtype=torch.float32)
    img = request_images(np.random.RandomState(seed))[0]
    gpu = FasterRCNN(cfg, device="cuda")
    gpu.init_weights(torch.Generator().manual_seed(seed))
    calibrate_batch_norm(gpu, img)
    cpu = FasterRCNN(cfg, device="cpu")
    cpu.modules.load_state_dict(gpu.modules.state_dict())
    resizer = ("keep_aspect", {"min_dimension": 600, "max_dimension": 1024})

    # the served request on both devices
    out_c = InferenceModel(cpu, resizer, device="cpu").predict_images([img])
    out_g = InferenceModel(gpu, resizer, device="cuda").predict_images([img])
    for out in (out_c, out_g):
        check_outputs(out, 1)

    # stage by stage on the 640x896 bucket
    x, ts = bucket_canvas(img)
    pc = cpu.predict(cpu.preprocess(x), ts)
    pg = gpu.predict(gpu.preprocess(x.cuda()), ts.cuda())

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))

    checks = []
    r = rel(pg["rpn_features"], pc["rpn_features"])
    checks.append(("rpn_features max rel diff", r, r <= 1e-3, "<= 1e-3"))
    r = rel(pg["rpn_objectness_logits"], pc["rpn_objectness_logits"])
    checks.append(("rpn objectness max rel diff", r, r <= 1e-3, "<= 1e-3"))
    # proposals from each side's own logits: ulp-level differences in exp
    # and convolution sums can reorder near-tied scores, which moves a few
    # greedy picks; the rest must agree
    agree = _agreement(pg["proposal_boxes"].cpu(), pc["proposal_boxes"], 1e-2)
    checks.append(("proposal slots equal within 1e-2 px", agree, agree >= 0.9, ">= 0.9"))
    # second stage on the CPU's proposals
    cls_g, _ = gpu._predict_second_stage(
        pg["rpn_features"], pc["proposal_boxes"].cuda(), (640, 896)
    )
    r = rel(cls_g, pc["class_predictions"])
    checks.append(("class_predictions (CPU proposals) max rel diff", r, r <= 1e-3, "<= 1e-3"))
    # postprocess on the CPU's stage outputs
    det_c = cpu.postprocess(pc, ts)
    det_g = gpu.postprocess({k: v.cuda() for k, v in pc.items()}, ts.cuda())
    same = ((det_g["detection_classes"].cpu() == det_c["detection_classes"])
            & ((det_g["detection_boxes"].cpu() - det_c["detection_boxes"]).abs() <= 1e-4).all(-1)
            & ((det_g["detection_scores"].cpu() - det_c["detection_scores"]).abs() <= 1e-5))
    agree = float(same.float().mean())
    checks.append(("detection slots equal (CPU stage outputs)", agree, agree >= 0.9, ">= 0.9"))
    # end to end through InferenceModel
    agree = float((np.abs(out_g["detection_boxes"] - out_c["detection_boxes"]) <= 1e-3)
                  .all(-1).mean())
    dmax = float(np.abs(out_g["detection_scores"] - out_c["detection_scores"]).max())
    log(f"[card-vs-cpu] end to end: num_detections card {out_g['num_detections'].tolist()} "
        f"cpu {out_c['num_detections'].tolist()}, detection boxes equal within 1e-3 in "
        f"{agree:.4f} of slots, max score diff {dmax:.3g}")
    checks.append(("end-to-end detection slots equal", agree, agree >= 0.5, ">= 0.5"))
    failed = []
    for name, value, ok, tol in checks:
        log(f"[card-vs-cpu] {name}: {value:.6g} (tolerance {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"card and CPU disagree: {failed}")


# ---------------------------------------------------------------- phase 6


def train_batch(rs, b: int, canvas=(640, 1024), max_gt: int = 100, sizes=((560, 640), (900, 1024))):
    """b synthetic images of about 600x1000 on their bucket canvas, each
    with 1-20 boxes inside its true extent (padded to max_gt), classes
    0..19."""
    images = np.zeros((b, canvas[0], canvas[1], 3), np.uint8)
    true_shape = np.zeros((b, 2), np.int32)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    classes = np.zeros((b, max_gt), np.int32)
    mask = np.zeros((b, max_gt), bool)
    for i in range(b):
        h = rs.randint(sizes[0][0], sizes[0][1] + 1)
        w = rs.randint(sizes[1][0], sizes[1][1] + 1)
        images[i, :h, :w] = rs.randint(0, 256, (h, w, 3))
        true_shape[i] = (h, w)
        k = rs.randint(1, min(20, max_gt) + 1)
        y0, x0 = rs.uniform(0, h * 0.8, k), rs.uniform(0, w * 0.8, k)
        bh = rs.uniform(0.05, 0.5, k) * h
        bw = rs.uniform(0.05, 0.5, k) * w
        boxes[i, :k] = np.stack([y0, x0, np.minimum(y0 + bh, h), np.minimum(x0 + bw, w)], 1)
        classes[i, :k] = rs.randint(0, 20, k)
        mask[i, :k] = True
    to = lambda a: torch.from_numpy(a).cuda()
    return {"image": to(images), "true_shape": to(true_shape), "gt_boxes": to(boxes),
            "gt_classes": to(classes), "gt_mask": to(mask)}


def kernel_counts():
    from mtlx_torch.kernels import iou_cuda, nms_cuda, roi_cuda

    return {"nms": nms_cuda.non_max_suppression.launches,
            "roi_crop": roi_cuda.crop_and_resize.launches,
            "roi_crop_backward": roi_cuda.crop_and_resize_backward.launches,
            "iou": iou_cuda.iou_matrix.launches}


def reset_kernel_counts():
    from mtlx_torch.kernels import iou_cuda, nms_cuda, roi_cuda

    nms_cuda.non_max_suppression.launches = 0
    roi_cuda.crop_and_resize.launches = 0
    roi_cuda.crop_and_resize_backward.launches = 0
    iou_cuda.iou_matrix.launches = 0


def profile_train_step(step_fn, state, batch, gen):
    """Device time by kernel over one train step (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[train-profile] one step at batch 16: wall {wall_ms:.2f} ms (profiler on), kernels "
        f"busy {busy:.2f} ms ({busy / wall_ms:.1%} of wall), "
        f"{sum(r[1] for r in rows)} device operations")
    for ms, count, key in rows[:15]:
        log(f"[train-profile]   {ms:8.3f} ms  x{count:<5d} {key[:100]}")
    return state


def phase_train(seed: int, results):
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.train import train as train_lib
    from mtlx_torch.train import train_step as ts

    cfg = flagship_train_config()  # bfloat16 compute, float32 parameters
    model = FasterRCNN(cfg, device="cuda")
    model.init_weights(torch.Generator().manual_seed(seed))
    params = dict(model.modules.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    rs = np.random.RandomState(seed)
    batches = [train_batch(rs, 16) for _ in range(2)]
    calibrate_batch_norm_on(model, batches[0]["image"], batches[0]["true_shape"])
    state = ts.create_train_state(model, ts.make_optimizer(learning_rate=0.003, momentum=0.9,
                                                           gradient_clipping_by_norm=10.0))
    step_fn = train_lib.make_step_fn(model, [("random_horizontal_flip", {})])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = {n: p.detach().clone() for n, p in params.items()}

    state, metrics = step_fn(state, batches[0], generator=gen)  # warm-up
    torch.cuda.synchronize()
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        counts = kernel_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[(i + 1) % 2], generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in metrics.items()}
        step_counts = {k: v - counts[k] for k, v in kernel_counts().items()}
        log(f"[train] step {state.step}: {times[-1] * 1e3:.2f} ms ({16 / times[-1]:.2f} img/s), "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{step_counts}; " + ", ".join(f"{k} {v:.5g}" for k, v in vals.items()))
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite training metrics: {bad}")
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] kernel launches over 3 steps: {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    for name, p in params.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"parameter {name} has no finite gradient")
    for head in ("rpn.", "box_predictor.", "fg_head.", "mo_head.", "cl_head."):
        if not any(float(p.grad.abs().max()) > 0 for n, p in params.items() if n.startswith(head)):
            raise AssertionError(f"the {head[:-1]} parameters got no gradient")
    moved = sum(not torch.equal(before[n], p.detach()) for n, p in params.items())
    log(f"[train] {moved} of {len(params)} parameter tensors changed")
    if moved == 0:
        raise AssertionError("no parameter changed")
    state = profile_train_step(step_fn, state, batches[0], gen)
    results["train"] = dict(step_ms=[t * 1e3 for t in times],
                            img_per_s=[16 / t for t in times], peak_bytes=peak)
    results["train_launches"] = launches


# ---------------------------------------------------------------- phase 7


def phase_train_card_vs_cpu(seed: int):
    import dataclasses

    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.train import train_step as ts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(flagship_train_config(torch.float32), backbone="resnet10",
                              canvas_size=(128, 128))
    cpu = FasterRCNN(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(seed))
    batch = train_batch(np.random.RandomState(seed + 1), 2, canvas=(128, 128), max_gt=8,
                        sizes=((96, 128), (100, 128)))
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    calibrate_batch_norm_on(cpu, batch_cpu["image"], batch_cpu["true_shape"])
    gpu = FasterRCNN(cfg, device="cuda")
    gpu.modules.load_state_dict(cpu.modules.state_dict())
    draws = ts.make_draws(cpu, 2, (128, 128), torch.Generator().manual_seed(seed))

    # the card takes the CPU's RPN proposals: ulp-level differences of the
    # two devices' convolution sums can reorder near-tied scores and move a
    # greedy pick, after which the second stages would see other boxes
    taken = {}
    run_cpu_proposals = cpu._proposals

    def cpu_proposals(*args, **kwargs):
        taken["out"] = run_cpu_proposals(*args, **kwargs)
        return taken["out"]

    cpu._proposals = cpu_proposals
    gpu._proposals = lambda *args, **kwargs: tuple(t.cuda() for t in taken["out"])

    out = {}
    for name, model, b, d in (("cpu", cpu, batch_cpu, draws),
                              ("card", gpu, batch, {k: v.cuda() for k, v in draws.items()})):
        state = ts.create_train_state(model, ts.make_optimizer(learning_rate=0.003))
        state, metrics = ts.make_train_step(model)(state, b, draws=d)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().cpu() for n, p in model.modules.named_parameters()},
                     dict(zip(state.opt_state.names, (t.cpu() for t in state.opt_state.trace))),
                     {n: p.detach().cpu() for n, p in model.modules.named_parameters()})
    (m_c, g_c, u_c, p_c), (m_g, g_g, u_g, p_g) = out["cpu"], out["card"]
    loss_rel = max(abs(m_g[k] - v) / max(abs(v), 1e-30) for k, v in m_c.items())

    def worst(card, cpu_side, metric):
        return max((metric(card[n] - t, t), n) for n, t in cpu_side.items())

    l2 = lambda d, t: float(d.norm() / t.norm().clamp_min(1e-30))
    peak = lambda d, t: float(d.abs().max() / t.abs().max().clamp_min(1e-30))
    grad_l2, grad_l2_at = worst(g_g, g_c, l2)
    grad_peak, grad_peak_at = worst(g_g, g_c, peak)
    upd_l2, upd_l2_at = worst(u_g, u_c, l2)
    par_peak, par_peak_at = worst(p_g, p_c, peak)
    # float32 sums taken in another order (cuDNN's algorithms, the crop
    # backward's atomics) err relative to the magnitudes of their terms, so
    # a gradient element that cancels can differ by more than its own size
    # suggests; the L2 difference of a tensor is what the update sees
    checks = [("losses and grad_norm, max rel diff", loss_rel, 1e-4),
              (f"gradients, L2 of the difference over L2 (worst {grad_l2_at})", grad_l2, 1e-3),
              (f"gradients, max diff over the largest magnitude (worst {grad_peak_at})",
               grad_peak, 1e-2),
              (f"updates (the clipped momentum traces), L2 of the difference over L2 "
               f"(worst {upd_l2_at})", upd_l2, 1e-3),
              # a zero-initialised bias is its first update after one step,
              # so its elements take the gradients' tolerance
              (f"parameters after the step, max diff over the largest magnitude "
               f"(worst {par_peak_at})", par_peak, 1e-2)]
    log(f"[train-card-vs-cpu] resnet10, float32, 128x128, TF32 off; card total_loss "
        f"{m_g['total_loss']:.6g}, cpu {m_c['total_loss']:.6g}")
    failed = []
    for name, value, tol in checks:
        ok = value <= tol
        log(f"[train-card-vs-cpu] {name}: {value:.3g} (tolerance {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"card and CPU training disagree: {failed}")


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    from mtlx_torch.kernels import build

    smi = phase_card()
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"[build] {seconds} (wall {time.perf_counter() - t0:.2f} s)")
    for name, text in build.build_logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: {'; '.join(regs)}")

    results = {}
    gen = torch.Generator().manual_seed(args.seed)
    check_nms(gen, results)
    check_roi(gen, results)
    check_iou(gen, results)
    check_roi_backward(gen, results)
    phase_serve(args.seed, results)
    phase_card_vs_cpu(args.seed)
    phase_train(args.seed, results)
    phase_train_card_vs_cpu(args.seed)

    nms_rpn = results["nms"][0]
    roi = results["roi_crop"]
    iou = results["iou"]
    bwd = results["roi_crop_backward"]
    train_launches = results["train_launches"]
    kernels = [
        dict(name="nms", route="cuda", source="mtlx_torch/kernels/csrc/nms.cu",
             replaces="mtlx/kernels/nms_pallas.py:118",
             launches=results["launches"]["nms"], max_abs_err=nms_rpn["max_abs_err"],
             ms=nms_rpn["ms"], plain_ms=nms_rpn["plain_ms"], bound_ms=nms_rpn["bound_ms"],
             bound_by=nms_rpn["bound_by"], library_ms=None, shape=nms_rpn["shape"],
             other_shapes=results["nms"][1:], train_launches=train_launches["nms"]),
        dict(name="roi_crop", route="cuda", source="mtlx_torch/kernels/csrc/roi_crop.cu",
             replaces="mtlx/kernels/roi_pallas.py:93",
             launches=results["launches"]["roi_crop"], max_abs_err=roi["max_abs_err"],
             ms=roi["ms"], plain_ms=roi["plain_ms"], bound_ms=roi["bound_ms"],
             bound_by=roi["bound_by"], library_ms=roi["library_ms"], shape=roi["shape"],
             other_shapes=roi["other_shapes"], train_launches=train_launches["roi_crop"]),
        dict(name="iou", route="cuda", source="mtlx_torch/kernels/csrc/iou.cu",
             replaces="mtlx/kernels/iou_pallas.py:56",
             launches=train_launches["iou"], max_abs_err=iou["max_abs_err"],
             ms=iou["ms"], plain_ms=iou["plain_ms"], bound_ms=iou["bound_ms"],
             bound_by=iou["bound_by"], library_ms=None, shape=iou["shape"]),
        dict(name="roi_crop_backward", route="cuda",
             source="mtlx_torch/kernels/csrc/roi_crop.cu",
             replaces="mtlx/kernels/roi_pallas.py:111",
             launches=train_launches["roi_crop_backward"], max_abs_err=bwd["max_abs_err"],
             ms=bwd["ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"],
             bound_by=bwd["bound_by"], library_ms=bwd["library_ms"], shape=bwd["shape"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
