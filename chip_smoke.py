"""Smoke run of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain PyTorch version at the main path's shapes, serve
the flagship Faster R-CNN ResNet-50 through `InferenceModel`, and compare
the card with the CPU on the same request.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. the card: `nvidia-smi` name and power limit, torch and CUDA versions
  2. build every kernel from mtlx_torch/kernels/csrc (one nvcc each, in
     parallel), timed
  3. each kernel against its plain version on the card: greedy NMS at
     1 x 6000 -> 300 (IoU 0.7) and 40 x 300 -> 100 (IoU 0.6), selections
     equal exactly; the ROI crop at 40x64x1024 with 300 boxes -> 14x14,
     float32 within 1e-5 and bfloat16 within one bfloat16 ulp of the
     float32 result; each timed with CUDA events beside its plain version
     and, where one PyTorch call computes the same function, that call
  4. serve: the full-width flagship R50 (bfloat16, seeded random weights)
     answers 600x800, 800x600 and 600x1000 requests one at a time and a
     batch of two, through both kernels (their launch counts must rise)
  5. the same request in float32 on the card and on the CPU (TF32 off),
     stage by stage, with the tolerances printed beside the differences

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
    for p, n, k, thr in ((1, 6000, 300, 0.7), (40, 300, 100, 0.6)):
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
    from mtlx_torch.backbones.resnet import FrozenBatchNorm

    def hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        x, ts = bucket_canvas(image)
        x, ts = x.to(model.device), ts.to(model.device)
        model.predict(model.preprocess(x), ts)
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
    phase_serve(args.seed, results)
    phase_card_vs_cpu(args.seed)

    nms_rpn = results["nms"][0]
    roi = results["roi_crop"]
    kernels = [
        dict(name="nms", route="cuda", source="mtlx_torch/kernels/csrc/nms.cu",
             replaces="mtlx/kernels/nms_pallas.py:118",
             launches=results["launches"]["nms"], max_abs_err=nms_rpn["max_abs_err"],
             ms=nms_rpn["ms"], plain_ms=nms_rpn["plain_ms"], bound_ms=nms_rpn["bound_ms"],
             bound_by=nms_rpn["bound_by"], library_ms=None, shape=nms_rpn["shape"],
             other_shapes=results["nms"][1:]),
        dict(name="roi_crop", route="cuda", source="mtlx_torch/kernels/csrc/roi_crop.cu",
             replaces="mtlx/kernels/roi_pallas.py:93",
             launches=results["launches"]["roi_crop"], max_abs_err=roi["max_abs_err"],
             ms=roi["ms"], plain_ms=roi["plain_ms"], bound_ms=roi["bound_ms"],
             bound_by=roi["bound_by"], library_ms=roi["library_ms"], shape=roi["shape"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
