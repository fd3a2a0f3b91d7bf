"""The readings that the comparison's limits are set from, on the card at
a cell's own size (not run by the benchmark's runs):

    python3 -m h100_bench.control --workload <cell> --seeds 11 12 13 \
        [--kinds sound control half_batch] [--seconds 30]

For each seed it prints one JSON line a kind: every number the cell's
comparison works out, and for a train cell the diagnostics beside them
(`diagnostics`). `sound` is the port itself, a whole run of the cell
(drive_train.run, a window of `--seconds`, the manifest's run_seconds by
default). The others are stand-ins put in the port's place and followed
by the float32 reference exactly as a run follows the port, over the
same three batches and, from the same sound run's state before its
compared window step, over that step:

  control     the reference itself, every convolution's and dense layer's
              operands rounded to float8 e4m3 with a scale a tensor (the
              precision below the configuration's bfloat16)
  half_batch  the float32 reference on the first half of each batch, the
              mean taken over it (a step that leaves rows out; train only)

A step that returns its state unchanged reads change_gap and
window_change_gap 1 by the measure, with no run."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from h100_bench import compare, drive_train, inputs, manifest, weights


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), the gradient passed straight through."""
    scale = 448.0 / t.detach().abs().amax().clamp_min(1e-12)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


def _norms(params, base, names):
    return dict(zip(names, drive_train._norms([params[n].detach() - base[n].to(params[n].device)
                                               for n in names])))


def stand_in(config, seed, device, first, snapshot, quantize=None, half=False):
    """A reference run in the port's place: the three set-up steps from the
    seed on `first`, then the window's step from the port's state before
    it. Returns (its record as drive_train.run keeps the port's, its RPN
    outputs and its sampled proposals of the three steps)."""
    run = drive_train.reference_run(config, seed, device, first[0][0], quantize)
    params, names = run.params(), run.names
    start = {n: p.detach().clone() for n, p in params.items()}

    def step(batch, draws):
        b = batch["image"].shape[0]
        if half:
            n = b // 2
            batch = {k: v[:n] for k, v in batch.items()}
            draws = {k: v[:n] for k, v in draws.items()}
        out = run.step(batch, draws)
        rpn, sampled = (out["obj"], out["enc"]), out["sampled"]
        if half:  # the follower sees the whole batches: pad the run's to them
            rpn = tuple(torch.cat([t, t])[:b] for t in rpn)
            sampled = tuple(torch.cat([t, t])[:b] for t in sampled)
        return out["terms"], rpn, sampled

    record, rpns, sampleds = {"terms": []}, [], []
    for i, (batch, draws) in enumerate(first):
        terms, rpn, sampled = step(batch, draws)
        record["terms"].append(terms)
        rpns.append(rpn)
        sampleds.append(sampled)
        if i == 0:
            record["grad_norms"] = dict(run.grad_norms)
            record["global_norm"] = run.global_norm
            record["change_first"] = _norms(params, start, names)
    record["change_norms"] = _norms(params, start, names)
    del start
    run.load(snapshot["params"], snapshot["trace"], snapshot["count"])
    terms, rpn, sampled = step(*snapshot["batch"])
    record["window"] = {"terms": terms, "change_norms": _norms(params, snapshot["params"], names),
                        "rpn": rpn, "sampled": sampled}
    return record, rpns, sampleds


def diagnostics(record: Dict, ref: Dict) -> Dict:
    """What a train cell does not compare, printed beside the numbers:
    the loss gaps of the three steps, the change gaps over the three
    (worst and median moved leaf, and the worst leaf's name), the median
    leaf's first-gradient gap, both sides' global norms and the
    reference's losses."""
    steps = [compare.loss_gap(got, want) for got, want in zip(record["terms"], ref["terms"])]
    names = compare.moved(ref["grad_norms"])
    change = compare.leaf_gaps(record["change_norms"], ref["change_norms"], names)
    grad = compare.leaf_gaps(record["grad_norms"], ref["grad_norms"], sorted(ref["grad_norms"]))
    first = compare.leaf_gaps(record["change_first"], ref["change_first"], names)
    return {"loss_gap": max(steps), "loss_gap_first": steps[0],
            "update_gap": float(change.max()), "update_gap_median": float(np.median(change)),
            "update_gap_leaf": names[int(change.argmax())],
            "change_gap_median": float(np.median(first)),
            "grad_gap_median": float(np.median(grad)),
            "global_norm": [record["global_norm"], ref["global_norm"]],
            "ref_loss": [t["total_loss"] for t in ref["terms"]],
            "window_ref_loss": ref["window"]["terms"]["total_loss"]}


def train_readings(spec: Dict, seed: int, seconds: float, device, kinds
                   ) -> Iterator[Tuple[str, Dict, Dict]]:
    """(kind, numbers, diagnostics) of one seed of a train cell."""
    config = spec["config"]
    sound = drive_train.run(spec, seed, seconds, False, device, keep=True)
    kept = sound.pop("kept")
    first, snapshot = kept["first"], kept["snapshot"]
    if "sound" in kinds:
        yield "sound", sound["values"], diagnostics(kept["record"], kept["ref"])
    del sound, kept
    for kind in kinds:
        if kind not in ("control", "half_batch"):
            continue
        record, rpn, sampled = stand_in(config, seed, device, first, snapshot,
                                        fp8 if kind == "control" else None,
                                        half=kind == "half_batch")
        ref = drive_train.follow(config, seed, device, first, rpn, sampled, snapshot,
                                 record["window"])
        yield kind, compare.numbers(record, ref), diagnostics(record, ref)
        del record, rpn, sampled, ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


@torch.no_grad()
def stand_in_serve(config, seed, device, traffic, resizer, canvas, quantize=None, calls=4):
    """The reference in the port's place on the pool's first `calls` calls:
    [(arrays, what its predict made, its served detections)] as
    drive_serve.run keeps them for the sampled calls."""
    from h100_bench import calibrate
    from h100_bench.reference import layers as ref_layers
    from h100_bench.reference.detector import Config, Detector
    from h100_bench.reference.resnet import preprocess_images
    from h100_bench.reference.serve import postprocess, resize_and_pad

    net = Detector(Config.from_dict(config["model"]), mtl=False).to(device).eval()
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    net.load_state_dict({**net.state_dict(), **weights.make_weights(shapes, seed, device)})
    pool = inputs.serve_pool(traffic, seed)
    multiple = traffic["bucket_multiple"]
    ref_layers.set_quantize(net, quantize)
    first = resize_and_pad(pool[0], resizer, canvas, multiple)[0]
    calibrate.calibrate(net.backbone, net.classifier_backbone, preprocess_images,
                        torch.from_numpy(first).to(device))
    samples = []
    for arrays in pool[:calls]:
        images, true = resize_and_pad(arrays, resizer, canvas, multiple)
        images = torch.from_numpy(images).to(device).float()
        true = torch.from_numpy(true).to(device)
        feats, obj, enc = net.rpn_outputs(images)
        props, scores, keep = net.proposals(obj, enc, true, tuple(images.shape[1:3]))
        cls, box = net.second_stage(feats, props)
        det = postprocess(net, props, keep, cls, box, true)
        pred = {"rpn_objectness_logits": obj, "rpn_box_encodings": enc,
                "proposal_boxes": props, "proposal_mask": keep, "proposal_scores": scores,
                "class_predictions": cls, "refined_box_encodings": box}
        samples.append((arrays, pred, {k: v.cpu().numpy() for k, v in det.items()}))
    return samples


def serve_readings(spec: Dict, seed: int, seconds: float, device, kinds
                   ) -> Iterator[Tuple[str, Dict, Dict]]:
    """(kind, numbers, {}) of one seed of a serve cell: the port (`sound`)
    and the control (the reference with float8 operands in its place)."""
    from h100_bench import drive_serve

    config = spec["config"]
    for kind in kinds:
        if kind == "sound":
            values = drive_serve.run(spec, seed, seconds, False, device)["values"]
        elif kind == "control":
            canvas = tuple(config["model"]["canvas_size"])
            resizer = config["model"]["image_resizer"]
            samples = stand_in_serve(config, seed, device, spec["traffic"], resizer, canvas, fp8)
            values = drive_serve.follow(config, seed, device, resizer, canvas, samples,
                                        multiple=spec["traffic"]["bucket_multiple"])
        else:
            continue
        yield kind, values, {}
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def readings(spec: Dict, seed: int, seconds: float, device, kinds):
    kind = spec["traffic"]["kind"]
    return (train_readings if kind == "train" else serve_readings)(spec, seed, seconds, device,
                                                                  kinds)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=["sound", "control", "half_batch"])
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    spec = manifest.load_cell(args.workload)
    seconds = args.seconds
    if seconds is None:
        with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
            seconds = float(json.load(f)["run_seconds"])
    for seed in args.seeds:
        for kind, values, diag in readings(spec, seed, seconds, "cuda", args.kinds):
            verdict = compare.verdict(values, spec["limits"])
            print(json.dumps({"reading": kind, "workload": args.workload, "seed": seed,
                              "correct": verdict, **values, "diagnostics": diag}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
