"""One run of a serve cell: set-up, the measured window, then the
comparison with the reference.

Set-up builds the port's detection-only detector from the configuration's
pipeline text through the port's builders (as the exporter's
`InferenceModel.load` does), loads the seeded weights, calibrates the
frozen batch norm on the first call's images, and serves every call of the
pool once through `InferenceModel.predict_images` (which warms the
bucket's shapes). The window: one client, closed loop, each call from the
host's uint8 arrays to detections on the host, timed on the host's clock;
with `trace` its last TRACE_SECONDS run under torch.profiler.
A sample of the window's calls, drawn from the seed (and the first), keeps
what the port's `predict` made for it: the RPN's outputs, the proposals,
the second stage's outputs (read through an instance attribute). After the
window the port is freed and the reference judges each sampled call:

  rpn_l2              the start: the RPN's objectness logits and box
                      encodings against the float32 reference's on the
                      same resized images (relative L2, the worse of two)
  proposal_mismatch   proposals that the reference's top-k / NMS, run on
                      the port's own RPN outputs, does not reproduce
  second_l2           the second stage's class logits and box refinements
                      against the reference's on the port's proposals
  detection_mismatch  detections (boxes, scores, classes, counts) that the
                      reference's postprocess, run on the port's second-
                      stage outputs, does not reproduce exactly
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from h100_bench import calibrate, inputs, weights, work
from h100_bench.drive_train import _Traced, _dtype, _sync

NUMBERS = ("rpn_l2", "proposal_mismatch", "second_l2", "detection_mismatch")
KEPT = ("rpn_objectness_logits", "rpn_box_encodings", "proposal_boxes", "proposal_mask",
        "proposal_scores", "class_predictions", "refined_box_encodings")
# the sampled calls the reference judges, at most
MOST_SAMPLED = 12
SERVE_KERNELS = (("nms_cuda", "non_max_suppression", "nms"),
                 ("roi_cuda", "crop_and_resize", "roi_crop"))


def build_program(config: Dict, device):
    """(InferenceModel, resizer params) through the port's builders."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.export.exporter import InferenceModel

    pipeline = config_util.parse_pipeline_text("\n".join(config["pipeline"]))
    model = model_builder.build(pipeline.model, is_training=False, max_gt_boxes=config["max_boxes"],
                                dtype=_dtype(config["compute_dtype"]), device=device)
    kind, resizer = model_builder.resizer_params(model_builder.image_resizer(pipeline.model))
    im = InferenceModel(model, (kind, resizer), bucket_multiple=pipeline.bucketing.bucket_multiple,
                        device=device)
    return im, resizer


def run(spec: Dict, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, fault: Optional[Callable] = None) -> Dict:
    """The run's result (run.py prints it). `fault(predict) -> predict`
    breaks the served path underneath, for the tests of the comparison."""
    from h100_bench.reference.serve import resize_and_pad
    from mtlx_torch.train.train import kernel_launches

    t0 = time.perf_counter() if t0 is None else t0
    config, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    on_card = torch.device(device).type == "cuda"
    im = build_program(config, device)[0]
    model = im.model
    # the reference's resize, from the configuration (the port resizes by its own)
    resizer = config["model"]["image_resizer"]
    shapes = {n: tuple(p.shape) for n, p in model.modules.named_parameters()}
    model.modules.load_state_dict(weights.make_weights(shapes, seed, device), strict=False)
    pool = inputs.serve_pool(traffic, seed)
    canvas = tuple(model.cfg.canvas_size)
    multiple = traffic["bucket_multiple"]
    first = resize_and_pad(pool[0], resizer, canvas, multiple)[0]
    calibrate.calibrate(model.modules.backbone, model.modules.classifier_backbone,
                        model.preprocess, torch.from_numpy(first).to(device))
    predict = im.predict_images if fault is None else fault(im.predict_images)
    real_predict, kept, current = model.predict, {}, [None]

    def keeping(images, true_shapes, training=False):
        pred = real_predict(images, true_shapes, training=training)
        if current[0] is not None:
            kept[current[0]] = {k: pred[k] for k in KEPT}
        return pred

    model.predict = keeping
    for call in pool:
        predict(call)
    _sync(device)
    setup_s = time.perf_counter() - t0

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches0 = kernel_launches()
    traced = _Traced(SERVE_KERNELS, on_card) if trace else None
    draw = np.random.default_rng([int(seed), 1])
    share = traffic["sample_share"]
    latencies, outs, calls, images = [], {}, 0, 0
    w0 = time.perf_counter()
    while True:
        arrays = pool[calls % len(pool)]
        if traced is not None:
            traced.start_if_due(time.perf_counter() - w0, seconds)
        sampled = (calls == 0 or draw.random() < share) and len(outs) < MOST_SAMPLED
        current[0] = calls if sampled else None
        start = time.perf_counter()
        out = predict(arrays)
        end = time.perf_counter()
        latencies.append(end - start)
        if sampled:
            outs[calls] = out
        calls += 1
        images += len(arrays)
        if end - w0 >= seconds and (traced is None or traced.prof is not None):
            break
    _sync(device)
    window_s = time.perf_counter() - w0
    current[0] = None
    if traced is not None:
        traced = traced.stop()
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = sum(int(not np.isfinite(o["detection_scores"]).all()) for o in outs.values())
    hw = tuple(resize_and_pad(pool[0], resizer, canvas, multiple)[0].shape[1:3])
    run_info = {"calls": calls, "images": images, "window_s": window_s, "launches": launches,
                "latencies": latencies, "steps": calls,
                "model_flops": calls * work.serve_flops(config["model"], len(pool[0]), hw)}
    if traced is not None:
        run_info.update(traced)

    samples = [(pool[i % len(pool)], kept[i], outs[i]) for i in sorted(outs)]
    del im, model, pool, kept, outs, real_predict
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    values = follow(config, seed, device, resizer, canvas, samples, multiple=multiple)
    return {"correct": all(values[k] <= lim for k, lim in limits.items()) and failed == 0,
            "attempted": calls, "failed": failed, "setup_s": setup_s, "peak_bytes": peak,
            "reference_s": time.perf_counter() - r0,
            "run": run_info, "values": values,
            "compared": {k: (values[k], lim) for k, lim in limits.items()}}


def _l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


@torch.no_grad()
def follow(config: Dict, seed: int, device, resizer: Dict, canvas, samples,
           quantize=None, multiple: int = 128) -> Dict[str, float]:
    """The reference's judgement of the sampled calls: {NUMBERS}."""
    from h100_bench.reference import layers as ref_layers
    from h100_bench.reference.detector import Config, Detector
    from h100_bench.reference.resnet import preprocess_images
    from h100_bench.reference.serve import postprocess, resize_and_pad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = Detector(Config.from_dict(config["model"]), mtl=False).to(device).eval()
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    net.load_state_dict({**net.state_dict(), **weights.make_weights(shapes, seed, device)})
    ref_layers.set_quantize(net, quantize)
    first = resize_and_pad(samples[0][0], resizer, canvas, multiple)[0]
    calibrate.calibrate(net.backbone, net.classifier_backbone, preprocess_images,
                        torch.from_numpy(first).to(device))
    out = dict.fromkeys(NUMBERS, 0.0)
    for arrays, pred, served in samples:
        images, true = resize_and_pad(arrays, resizer, canvas, multiple)
        images = torch.from_numpy(images).to(device).float()
        true = torch.from_numpy(true).to(device)
        if pred["proposal_boxes"].shape[0] != images.shape[0]:
            # a call that served other rows than it was sent: nothing of
            # it is reproduced
            out["rpn_l2"] = out["second_l2"] = float("inf")
            out["proposal_mismatch"] += int(pred["proposal_mask"].numel())
            out["detection_mismatch"] += int(np.asarray(served["detection_scores"]).size)
            continue
        feats, obj, enc = net.rpn_outputs(images)
        out["rpn_l2"] = max(out["rpn_l2"], _l2(pred["rpn_objectness_logits"], obj),
                            _l2(pred["rpn_box_encodings"], enc))
        props, scores, keep = net.proposals(pred["rpn_objectness_logits"].float(),
                                            pred["rpn_box_encodings"].float(), true,
                                            tuple(images.shape[1:3]))
        differ = ((props != pred["proposal_boxes"]).any(-1) | (keep != pred["proposal_mask"])
                  | (scores != pred["proposal_scores"]))
        out["proposal_mismatch"] += int(differ.sum())
        cls, box = net.second_stage(feats, pred["proposal_boxes"].float())
        out["second_l2"] = max(out["second_l2"], _l2(pred["class_predictions"], cls),
                               _l2(pred["refined_box_encodings"], box))
        det = postprocess(net, pred["proposal_boxes"].float(), pred["proposal_mask"],
                          pred["class_predictions"].float(),
                          pred["refined_box_encodings"].float(), true)
        got = {k: torch.from_numpy(np.asarray(served[k])).to(device) for k in det}
        rows = ((got["detection_boxes"] != det["detection_boxes"]).any(-1)
                | (got["detection_scores"] != det["detection_scores"])
                | (got["detection_classes"] != det["detection_classes"]))
        out["detection_mismatch"] += int(rows.sum()) + int(
            (got["num_detections"] != det["num_detections"]).sum())
    return out
