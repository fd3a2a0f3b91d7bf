"""Smoke run of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain PyTorch version at the main path's shapes, serve
the flagship Faster R-CNN ResNet-50 through `InferenceModel`, train the
flagship MTL R50 for a few steps, compare the card with the CPU on the
same request and on the same train step, train, resume, evaluate and
export the flagship from JPEG TFRecords through the port's CLIs, train
the 3-task MTL R50 from scratch on synthetic data until it detects, and
train, evaluate and serve the R101 3-task MTL on COCO-sized records
through `torch.distributed.run` with the COCO and OpenImages metrics, and
train, evaluate, export and serve R-FCN R101 and the Inception-v2 and
Inception-ResNet-v2 MTL Faster R-CNNs through the CLIs, and SSD
MobileNet-v1 and SSD Inception-v2 (300x300, VOC) through them too, and
the train CLI's input pipeline: host crop / pad geometry, the worker
loader, the bucket bound, the warm-up and the device-side SSD crops,
and the paper's MTL refine path with live batch norm, dropout and the
hard example miner through the CLIs, and TF checkpoints converted and
warm-started from, and the flagship as a Mask R-CNN through the CLIs,
and classifier pretraining warm-starting the flagship, the other
classification backbones and the dataset record writers, and spatial
partitioning of 2048x2048 images, the spatial and hybrid grids, the
space-to-depth stem, backbone remat and the Multibox preset, and the
export CLI's --saved_model program of the flagship and of SSD
MobileNet-v1, served from a fresh process under mtlx's three signatures.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --data_parallel 4    # on a machine with 4 cards

Phases (any failure exits non-zero):
  1. the card: `nvidia-smi` name and power limit, torch and CUDA versions
  2. build every kernel from mtlx_torch/kernels/csrc (one nvcc each, in
     parallel), timed
  3. each kernel against its plain version on the card: greedy NMS at
     1 x 6000 -> 300 (IoU 0.7), 40 x 300 -> 100 (IoU 0.6) and 16 x 6000
     -> 300 (training), selections equal exactly, and on an unsorted
     input, an all-dead problem, a problem with fewer live rows than
     max_out, N = 1917 and N = 301, in both forms of the kernels (the
     single launch and the banded pipeline) where N allows; the device
     time of the stages (rank, order, mask, scan), the time at 1 x 6000
     and 16 x 6000 on an input whose picks come from every band of rows
     (299 clusters), and the time of either form at small N; the ROI crop
     at 40x64x1024 with 300 boxes -> 14x14 (and 16 images x 64 boxes),
     float32 within 1e-5 and bfloat16 within one bfloat16 ulp of the
     float32 result, and both bit-equal to the plain version, also on
     edge-case boxes (shorter than a source row, wider than the map,
     edges on 0 and 1, inverted) at both shapes and at crops 1x1, 4x3,
     7x7 and 14x14 with 13 and 1020 channels; its taps read an output; the
     IoU matrix at 16 x 100 x 30720 (padded, zero-area, identical,
     touching, inverted boxes and a -0 coordinate), bit-equal, also on
     only padding rows, M = 30717, 301 and 1, and a shared first side;
     the crop backward at
     16 x 64 boxes x 14x14x1024 -> 16x40x64x1024 in float32 (within 1e-4
     of each pixel's sum of term magnitudes: the gather adds a pixel's
     terms in another order than the plain version) and bfloat16 (within
     one bfloat16 ulp of the float32 result plus that), at crop size 1,
     with boxes on integer pixel coordinates and on the whole canvas
     (more boxes than one batch of the kernel's sample tables), and twice
     on the same input with bit-equal results; each timed with CUDA
     events beside its plain version and, where one PyTorch call computes
     the same function, that call (the crop and the IoU also beside a fill
     of their output, the IoU also by the profiler's device time); then
     all four at the shapes phase 17's spatial step gives them, on inputs
     of their own: NMS 2 x 6000 -> 300, the crop of 2 x 128 x 128 x 1024
     bf16 with 64 boxes an image -> 14x14 and its backward, the IoU 2 x
     100 x 196608, each held to its plain version and timed beside its
     bound, plain version and library call
  4. serve: the full-width flagship R50 (bfloat16, seeded random weights)
     answers 600x800, 800x600 and 600x1000 requests one at a time and a
     batch of two, through both kernels (their launch counts must rise);
     how far into the priority order the RPN's NMS had to walk; the crop
     timed again on the features and boxes one request cropped
  5. the same request in float32 on the card and on the CPU (TF32 off),
     stage by stage, with the tolerances printed beside the differences
  6. train: the full-width flagship MTL R50 (flagship_train_config,
     bfloat16 compute, float32 parameters, seeded weights, batch norm
     calibrated on the first batch) takes a warm-up and three timed steps
     on batches of 16 synthetic images (about 600x1000, bucket 640x1024,
     1-20 boxes each) through the flip, both stages, the three MTL losses,
     the clip and momentum; all four kernels must launch, every loss and
     gradient be finite, every head get a gradient and the parameters
     move; one step is profiled; the crop and the three IoU launches timed
     again on the inputs the warm-up step gave them
  7. one train step of a resnet10 model (float32, 128x128, TF32 off) on
     the card and on the CPU with the same draws and the CPU's RPN
     proposals: losses (1e-4 relative), every parameter's gradient (L2 of
     the difference within 1e-3 of the L2, each element within 1e-2 of the
     tensor's largest magnitude), every update (L2 within 1e-3) and the
     parameters after the step (within 1e-2 of each tensor's largest
     magnitude)
  8. the CLIs: the port's JPEG codec built by its one rule (the kept
     libjpeg-turbo headers, Pillow's bundled libjpeg-turbo) and the
     embedded JPEG decoded to mtlx's pixels (sha256) at both targets, or
     the run fails; 64 TFRecords of noise images written as JPEG (quality
     90) at VOC's sizes, 500x375, 375x500 and 500x333 (1-20 boxes of VOC's
     20 classes each), which the flagship's keep-aspect resizer upsamples,
     and the flagship pipeline pointing at them; the host loader timed a
     batch of 16 of them and of 16 PNG records at their resizer targets; a
     port checkpoint of the CLI's own seeded init with batch norm
     calibrated on one batch, as the pipeline's fine_tune_checkpoint; the
     train CLI for 6 steps at batch 16 (checkpoints every 3), then again
     to step 8, which must resume from step 6 and traces step 7 with
     `--profile_from` (the trace must hold kernels); every step must
     launch NMS, the crop and its backward once and the IoU three times;
     the train CLI's event files must hold the losses and learning_rate
     of every logged step; the eval CLI once on the same records (a finite
     mAP, NMS and the crop launched); the export CLI, then
     InferenceModel.load on the card, whose detections must equal those
     of the in-memory model restored from the same checkpoint; one
     600x800 image served as pixels, as JPEG and PNG bytes and as a
     tf.Example: equal detections from the same decoded pixels, and the
     JPEG's pixels within a mean absolute difference of 2.0 of the PNG's
  9. learnability: `python -m mtlx_torch.tools.synthetic_e2e_check` in
     this process, fixed 128x128 and `--keep_aspect`, 300 steps each at
     batch 8 from scratch on 48 JPEG records of coloured rectangles; it
     prints the learning rate at updates 0, 30 and 299, the losses every
     50 steps, ms a step and the mAP@0.5, which must reach 0.5; every
     train step must launch NMS, the crop and its backward once and the
     IoU three times, every eval batch NMS twice and the crop once; then
     one recorded train step of the trained model holds each kernel to
     its plain version on the inputs this path gives it (the RPN NMS at
     8 x 576 -> 32, the crop of 8 x 16 sampled proposals on an 8x8 map and
     its backward, the IoU launches of the step's assignments)
 10. BASELINE config 5: 32 TFRecords of noise JPEGs at COCO's sizes
     (640x480, 480x640, 640x427, 427x640; 1-20 boxes over the 80 ids COCO
     uses, a tenth crowd, a tenth group-of) and the R101 COCO pipeline
     pointing at them (the port's copy of the COCO label map); a port
     checkpoint of the CLI's own seeded init with batch norm calibrated on
     one batch as its fine_tune_checkpoint; the train CLI for 6 steps at
     batch 16 through `python -m torch.distributed.run --nproc_per_node=1
     -m mtlx_torch.train.train --distributed` (NCCL): step ms, img/s,
     loader wait share, peak memory and launches from its own lines, each
     step launching NMS, the crop and its backward once and the IoU three
     times; the eval CLI on 16 records with the COCO, OpenImages and
     Pascal metrics (finite, NMS twice and the crop once a batch of 8);
     every kernel call of one eval batch against its plain version, the
     postprocess NMS at 8 x 90 problems of 300 -> 100 exactly, timed; the
     export CLI and one 640x480 request through the bundle; two ranks over
     gloo, both on cuda:0, each taking one float32 step (TF32 off) of the
     R101 model on its half of a global batch of 4 whose halves hold 21
     and 3 boxes: the ranks' parameters bitwise equal, the loss and the
     sum of |parameter| within 1e-4 relative of one rank on the whole
     batch; whether torchvision imports, and its NMS and box IoU timed
     where it does
 11. the rest of the two-stage family: configs/rfcn_resnet101_voc07,
     faster_rcnn_inception_v2_voc07 and
     faster_rcnn_inception_resnet_v2_mtl_coco, each unchanged but for its
     paths (a fine_tune_checkpoint of the CLI's own seeded init with batch
     norm calibrated on one batch), checkpoint interval (2) and eval size
     (16), on 32 noise JPEGs at VOC's sizes (COCO's for the last): the
     train CLI for 4 steps and a restart to 6, every step launching NMS
     once, the crop and its backward twice (R-FCN: the class and box
     maps) or once, and the IoU three times; the eval CLI with the
     config's metrics (finite; NMS twice and the crop twice or once a
     batch of 8); every kernel call of one train step and one eval batch
     against its plain version, one more step profiled, the step's crop
     and crop backward launches timed beside their bounds, plain
     versions and library calls (F.grid_sample and its d(input)), its NMS
     and IoU launches and the eval batch's NMS beside their bounds and
     plain versions; the
     export CLI and one request through the bundle; each
     Inception trunk's proposal and box classifier features in float32
     (TF32 off) on the card against the CPU within 1e-4 of the largest
     magnitude; R-FCN's two crop launches of the request (every bin of the
     class maps, 21 channels, and of the box maps, 80) timed beside their
     plain version, F.grid_sample and bound
 12. the single-shot family: configs/ssd_mobilenet_v1_voc and
     ssd_inception_v2_voc, each unchanged but for its paths, checkpoint
     interval (2) and eval size (16), on 32 noise JPEGs at VOC's sizes:
     the train CLI at batch 32 (live batch norm, RMSProp, the moving
     average of the weights, the flip and ssd_random_crop) for 4 steps and
     a restart to 6, every step launching the crop once (the window
     resample of the batch) and the IoU once (the batch's assignment), and
     no NMS or crop backward; the eval CLI (finite mAP; NMS once a batch of
     8, every class of every image); every kernel call of one train step
     and one eval batch against its plain version, those launches timed
     beside their bounds, plain versions and (for the crop) F.grid_sample,
     one more step profiled; the export CLI and one request through the
     bundle (NMS once); each SSD's trunk endpoints and head outputs in
     float32 (TF32 off, live batch norm) on the card against the CPU
     within 1e-4 of the largest magnitude; LiveBatchNorm at MobileNet's
     largest batch norm (32 x 64 x 150 x 150) in float32 against the CPU
     and in bfloat16 timed beside F.batch_norm with its bound; two gloo
     ranks on cuda:0 against one rank for one float32 SSD MobileNet step
     on a global batch of 4 (loss and sum of |parameter| within 1e-4
     relative). Phase 9 also runs the tool's SSD mode (MobileNet x 0.5,
     128x128, 300 steps, mAP@0.5 >= 0.3)
 13. the train CLI's input pipeline: the flagship pipeline (full width,
     batch 16, keep-aspect 600/1024) on 48 noise JPEGs at VOC's sizes with
     the flip, random_crop_image, random_pad_image, random_distort_color
     and random_black_patches, its paths the only other change (the crop
     and pad drawn on the host, the pixels resampled by
     batch_apply_host_window on the card, timed); the worker loader (4
     processes) against the in-process loader on the CLI's arguments for
     two epochs, every batch equal to the bit; the train CLI, each run in a
     process of its own, for 8 steps with --max_bucket_variants 4 alone and
     again with --grain_workers 4 --max_bucket_variants 4
     --precompile_buckets: the warm-up's shapes and seconds, step 1 and the
     steady steps, the loader wait share, peak memory, the crop launched
     once a step, and the first three steps' losses (from the event files) of the two runs
     within 1e-4 relative; then SSD MobileNet-v1 (300x300, batch 32) with
     the flip, ssd_random_crop_pad and ssd_random_crop_fixed_aspect_ratio
     through the train CLI for 2 steps (the crop launched twice and the
     IoU once a step), and one recorded step's kernel calls held to their
     plain versions, its crops timed

 14. the paper's MTL refine path: the flagship pipeline with `refine: true`
     (full width, batch 16, keep-aspect 600/1024, bf16 compute) on 32
     noise JPEGs at VOC's sizes from a calibrated warm start: the train
     CLI for 6 steps and a restart to 8 (launches a step as the
     flagship's: NMS 1, crop 1, crop backward 1, IoU 3), step ms, img/s
     and peak memory beside phase 8's flagship without refine; the eval
     CLI on 16 records (NMS 2 and crop 1 a batch of 8) with its 10
     `Detections_Left_Groundtruth_Right/<i>` image summaries and the
     equal `export-8-<i>.png` files; every kernel call of one refine
     train step and one refine eval batch against its plain version; the
     export CLI (the bundle holds the aux heads and `refine: true`) and a
     600x800 request as pixels, PNG / JPEG bytes and a tf.Example, its ms
     beside the flagship without refine; the same pipeline with live batch
     norm, dropout (keep 0.5) and the hard example miner (64, IoU 0.7,
     both losses) through the train CLI for 4 steps without a negatives
     cap (the miner's walk one more NMS launch a step) and with 3 (one
     more IoU launch), one recorded step of each held to the plain
     versions and the moving statistics' change after it; one refine
     request and one refine train step of a resnet10 model in float32
     (TF32 off) on the card against the CPU (phases 5 and 7's tolerances)

 15. checkpoint conversion and Mask R-CNN: a slim ResNet-50 classification
     checkpoint at full width written as V2 and as V1 and a TF OD API
     Faster R-CNN checkpoint with the flagship's heads as V2 (this file's
     writer, so the run needs no TensorFlow), each converted by `python -m
     mtlx_torch.tools.convert_checkpoint` and the flagship train CLI
     warm-started from its `.npz` for 2 steps (restored = converted,
     finite losses); then the flagship with predict_instance_masks, the
     readers' load_instance_masks and keypoints, eval_instance_masks and
     the COCO and Pascal mask metrics on 32 noise JPEGs at VOC's sizes with
     PNG instance masks and keypoints: train 4 steps and a restart to 6
     (launches a step: NMS 1, crop 2, crop backward 1, IoU 4), step ms and
     peak memory beside phase 8's; eval on 16 records (finite mask mAPs,
     NMS 2 and crop 1 a batch of 8); every kernel call of a recorded train
     step and eval batch against its plain version; the mask-target crop
     (B x 64 one-channel images, one box each, -> 14x14) timed beside its
     bound, plain version and F.grid_sample; export and a 600x800 request
     returning detection_masks; one resnet10 mask train step on the card
     against the CPU (phase 7's tolerances)

 16. classifier pretraining and the record writers: 64 noise JPEG records
     of slim's classification schema at ImageNet-like sizes (500x375,
     375x500); `python -m mtlx_torch.train.train_classifier` in a process
     of its own at 224x224, batch 64, 1000 classes for ResNet-50 (8 steps,
     `--export_backbone`) and MobileNet-v1 (4 steps): finite losses, step
     ms by CUDA events from step 2, the host's decode ms a batch, img/s and
     peak memory from its `[cls]` lines; tiny VOC, COCO and Pet devkits (16
     noise JPEGs each) through the three `create_*_tf_record` CLIs, every
     record decoded; the flagship train CLI warm-started from the
     ResNet-50 export (from_detection_checkpoint false) for 2 steps on the
     VOC records (restored = exported, the backbone and block4; launches a
     step NMS 1, crop 1, crop bwd 1, IoU 3), then the eval CLI on them
     (NMS 2, crop 1 a batch of 8); one float32 ResNet-50 classifier step
     (batch 4, TF32 off) on the card against the CPU (logits and moving
     statistics within 1e-4 of the largest magnitude, the loss within 1e-4
     relative, the gradients against the CPU's float64 ones within twice
     the CPU's own float32 error plus 1e-3); vgg_preprocess and
     inception_preprocess, train and eval, on 64 256x256 images: one crop
     launch a call, the card's result within 1e-5 of the CPU's, the crop
     at each call's boxes bit-equal to its plain version and timed beside
     its bound, plain version and F.grid_sample; Inception v1, v3, v4
     (299x299), VGG-16 and AlexNet at full width, their trunks' endpoints
     and logits in float32 on the card against the CPU within 1e-4 of the
     largest magnitude, and the bfloat16 classifier's forward timed at
     batch 32
 17. spatial partitioning and the last options: the full-width flagship
     MTL R50 (bf16 compute, f32 parameters, seeded weights, batch norm
     calibrated) on 2 synthetic images on a 2048x2048 canvas, one rank on
     the whole batch and then two gloo ranks on cuda:0 over (data=1,
     spatial=2), each with its half of every image's rows: a warm-up
     step (each rank's kernel calls held to their plain versions) and 3
     timed steps each, step ms and each rank's peak memory beside one
     rank's, launches NMS 1, crop 1, crop backward 1 and IoU 3 a step a
     rank; one float32 step (TF32 off) of the resnet10 MTL model at
     128x128 over the (data=2, spatial=2) grid, the hybrid (data_dcn=2,
     data=2) grid and four flat ranks, four gloo ranks on cuda:0: each
     grid's ranks bitwise equal, loss and sum of |parameter| within 1e-4
     relative of one rank on the whole batch; SpaceToDepthConv1 at 16 x
     640 x 1024 within 1e-5 of the plain stem's largest magnitude in f32,
     its bf16 forward + backward timed beside the plain stem's; the
     flagship at batch 16 with and without backbone_remat (step ms, peak
     memory) and an f32 resnet10 step's gradients with and without it
     (within 1e-6); SSD Inception-v2 at depth multiplier 0.5, card vs CPU
     as phase 12; the Multibox preset at 32 x 100 x 1917, the card's
     matches equal to the CPU's, ms a call
 18. the serving program: the flagship (R50, keep-aspect 600 / 1024, the
     1024x1024 canvas) and SSD MobileNet-v1 (300x300), each from a
     checkpoint of its seeded init with batch norm calibrated on the
     requests, through the export CLI with --saved_model (bf16 on the
     card): the export seconds and the .pt2 size; a fresh process that
     imports only the loader (no detector, builder, backbone or head)
     loads each program and serves 600x800 and 800x600 noise JPEGs at
     batch 1 and 2 through image_tensor (the host path's canvases),
     encoded_image_string and tf_example, with the kernels' plain
     versions refused: every result equal to the eager InferenceModel at
     the same canvas and dtype in classes and num_detections, boxes and
     scores within 1e-5 of the largest magnitude; each request launches
     NMS 2 and the crop 1 inside the flagship's program, NMS 1 inside
     SSD's; the load seconds, request ms on the host clock (ending in the
     copy to the host) beside eager's, and the kernels' device ms inside
     the program (profiler)

The line before the last is one JSON object listing every kernel; the
last line is `{"ok": true, "device": {...}}`.

With `--data_parallel N` it builds the kernels and runs only the
data-parallel check on N cards: the R101 COCO train CLI over NCCL for 6
steps at batch 16 at world size 1 and N (64 records of one size in a
fixed order; step ms, peak memory and launches of each), then N NCCL
ranks, one a card, of one float32 step held within 1e-6 of N gloo ranks
on cuda:0 (the same rows at the same batch size), and both printed
beside one rank on the whole batch. At N = 4 it also holds phase 17's
two grids, the (data=2, spatial=2) and the hybrid (data_dcn=2, data=2),
and four flat ranks over NCCL, rank r on cuda:r, within 1e-6 of the
same over gloo, and each within 1e-4 of one rank.
"""

from __future__ import annotations

import argparse
import json
import os
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


def nms_every_band_case(gen, p: int, n: int, clusters: int = 299):
    """Rows that are near copies of 299 disjoint boxes, in random order
    with continuous scores: one pick a cluster, each found early in the
    order, and then, one pick short of max_out = 300, the scan walks every
    band of rows to the last one and the whole mask is computed."""
    at = torch.arange(clusters)
    corner = torch.stack([at // 23, at % 23], -1).float() * 40.0
    proto = torch.cat([corner, corner + 20.0], -1)
    which = torch.randint(0, clusters, (p, n), generator=gen)
    boxes = proto[which] + torch.randn(p, n, 4, generator=gen) * 0.1
    scores = 0.05 + 0.9 * torch.rand(p, n, generator=gen)  # all past the threshold 0
    return boxes.cuda(), scores.cuda(), torch.ones(p, n, dtype=torch.bool).cuda()


def nms_rows_walked(scores, valid, score_threshold, idx, keep):
    """Per problem, how many rows of the priority order the scan visits:
    up to the last pick where every output slot is filled, else every live
    row."""
    n = scores.shape[1]
    live = valid & (scores > score_threshold) & (scores > -5e9)
    last = idx[:, -1:].long()
    s_last = scores.gather(1, last)
    col = torch.arange(n, device=scores.device)[None]
    ahead = live & ((scores > s_last) | ((scores == s_last) & (col <= last)))
    return torch.where(keep[:, -1], ahead.sum(1), live.sum(1))


def nms_band_of(rows: int) -> int:
    """The band of csrc/nms.cu that holds ordered row `rows` (counted from
    1): the first band is 16 chunks of 64 rows, each next one doubles."""
    band, chunks, end = 1, 16, 16 * 64
    while rows > end:
        band, chunks = band + 1, chunks * 2
        end += chunks * 64
    return band


def record_nms_calls(fn):
    """Run fn() with every call of the NMS wrapper recorded: returns
    [(P, N, max_out, rows walked per problem), ...]. For a reading outside
    the runs whose launches are counted."""
    from mtlx_torch.kernels import nms_cuda

    real = nms_cuda.non_max_suppression
    calls = []

    def recorder(boxes, scores, valid, max_out, iou_threshold=0.5,
                 score_threshold=float("-inf")):
        idx, keep = real(boxes, scores, valid, max_out, iou_threshold, score_threshold)
        rows = nms_rows_walked(scores, valid, score_threshold, idx, keep)
        calls.append((*scores.shape, max_out, rows.tolist()))
        return idx, keep

    recorder.launches = 0  # the wrapper counts on the module's name
    nms_cuda.non_max_suppression = recorder
    try:
        fn()
    finally:
        nms_cuda.non_max_suppression = real
    return calls


def log_nms_calls(tag: str, calls):
    out = []
    for p, n, max_out, rows in calls:
        log(f"[{tag}] NMS {p}x{n}->{max_out}: the scan walked {min(rows)}-{max(rows)} ordered "
            f"rows a problem, into band {nms_band_of(max(max(rows), 1))} of {nms_band_of(n)}")
        out.append(dict(shape=f"{p}x{n}->{max_out}", rows_walked_max=max(rows),
                        band=nms_band_of(max(max(rows), 1)), bands=nms_band_of(n)))
    return out


def record_calls(fn, module, name: str):
    """Run fn() with every call of module.<name> recorded: [(args,
    kwargs)], tensors detached and copied. For a reading outside the runs
    whose launches are counted."""
    real = getattr(module, name)
    calls = []

    def recorder(*args, **kwargs):
        calls.append((tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args),
                      kwargs))
        return real(*args, **kwargs)

    recorder.launches = 0  # the wrapper counts on the module's name
    setattr(module, name, recorder)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return calls


def profiled_kernels(fn, reps: int = 100):
    """[(kernel name, device ms a call, launches a call)] over reps calls
    of fn after a warm-up (torch.profiler). The mean launch times the
    launches a call makes, so an event the profiler dropped does not
    shorten the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            launches = max(1, round(e.count / reps))
            out.append((e.key, e.self_device_time_total / 1e3 / e.count * launches, launches))
    return out


def kernel_ms(fn, key: str):
    """Device milliseconds a call of fn in the kernels whose name holds
    `key`, or None where the profiler recorded none: a reading, not a
    check."""
    return sum(ms for name, ms, _ in profiled_kernels(fn) if key in name) or None


def time_nms(boxes, scores, valid, k, thr, name):
    """(ms per call from a tight host loop, plain ms, device ms per stage,
    their sum or None where the profiler recorded no NMS kernel)."""
    from mtlx_torch.kernels import nms_cuda

    call = lambda: nms_cuda.non_max_suppression(boxes, scores, valid, k, thr, 0.0)
    ms = cuda_ms(call, 200)
    plain_ms = cuda_ms(
        lambda: nms_cuda.non_max_suppression_plain(boxes, scores, valid, k, thr, 0.0), 3
    )
    stage_ms = nms_stage_times(call, name)
    device_ms = sum(v for s_, v in stage_ms.items() if not s_.endswith("_launches")) or None
    return ms, plain_ms, stage_ms, device_ms


def check_nms(gen, results):
    from mtlx_torch.kernels import nms_cuda

    def equal_to_plain(boxes, scores, valid, k, thr, name):
        idx, keep = nms_cuda.non_max_suppression(boxes, scores, valid, k, thr, 0.0)
        ref_idx, ref_keep = nms_cuda.non_max_suppression_plain(boxes, scores, valid, k, thr, 0.0)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)):
            bad = int((idx != ref_idx).sum() + (keep != ref_keep).sum())
            raise AssertionError(f"NMS kernels differ from their plain version at "
                                 f"{name}: {bad} slots")
        return idx, keep

    rows = []
    # the served RPN, the served postprocess, the training step's RPN
    for p, n, k, thr in ((1, 6000, 300, 0.7), (40, 300, 100, 0.6), (16, 6000, 300, 0.7)):
        shape = f"{p}x{n}->{k}"
        boxes, scores, valid = nms_case(gen, p, n)
        results.setdefault("nms_inputs", (boxes, scores, valid, k, thr))
        idx, keep = equal_to_plain(boxes, scores, valid, k, thr, shape)
        picks = keep.sum(1)
        # work this run needs: every pick made plus the empty pick that ends
        # a problem's loop early, each one pass over the N boxes
        steps = int(torch.clamp(picks + 1, max=k).sum())
        t_bound, by = bound_ms(
            nbytes=p * n * (16 + 4 + 1) + p * k * (4 + 1),
            ops=steps * n * NMS_OPS_PER_BOX_STEP,
        )
        walked = int(nms_rows_walked(scores, valid, 0.0, idx, keep).max())
        # ms is what a caller in a tight loop sees: at one problem the host's
        # time to make the call's launches, longer than the kernels' device_ms
        ms, plain_ms, stage_ms, device_ms = time_nms(boxes, scores, valid, k, thr, shape)
        log(f"[nms] {shape} iou {thr}: selections equal (exact), {int(picks.sum())} picks "
            f"from the first {walked} ordered rows (band {nms_band_of(walked)} of "
            f"{nms_band_of(n)}); {ms:.4f} ms a call from a tight host loop, plain "
            f"{plain_ms:.3f} ms, bound {t_bound:.5f} ms ({by}), library null")
        rows.append(dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                         max_abs_err=0.0, device_ms=device_ms, stage_ms=stage_ms,
                         rows_walked_max=walked))
    # the most a main-path shape can cost: picks from every band of rows
    for p, n, k, thr in ((1, 6000, 300, 0.7), (16, 6000, 300, 0.7)):
        shape = f"{p}x{n}->{k} every band"
        boxes, scores, valid = nms_every_band_case(gen, p, n)
        idx, keep = equal_to_plain(boxes, scores, valid, k, thr, shape)
        walked = int(nms_rows_walked(scores, valid, 0.0, idx, keep).min())
        if walked != n or int(keep.sum(1).max()) >= k:
            raise AssertionError(f"the {shape} case does not walk every row: {walked} rows, "
                                 f"{int(keep.sum())} picks")
        ms, plain_ms, stage_ms, device_ms = time_nms(boxes, scores, valid, k, thr, shape)
        log(f"[nms] {shape}: selections equal (exact), {int(keep.sum())} picks, all {n} rows "
            f"walked; {ms:.4f} ms a call from a tight host loop, plain {plain_ms:.3f} ms")
        rows[0 if p == 1 else 2]["every_band"] = dict(ms=ms, plain_ms=plain_ms,
                                                      device_ms=device_ms, stage_ms=stage_ms)
    results["nms"] = rows
    rows[1]["ms_by_form"] = time_nms_forms(gen)
    check_nms_cases(gen)


def time_nms_forms(gen, rounds: int = 3):
    """Why the wrapper picks the form by N: at the served postprocess's
    shapes and up to the forms' boundary, milliseconds per call from a
    tight host loop (what a caller sees) of the single launch and of the
    banded pipeline, in alternating rounds."""
    from mtlx_torch.kernels import nms_cuda

    forms = (("single launch", nms_cuda._FORM_SINGLE_LAUNCH), ("banded", nms_cuda._FORM_BANDED))
    out = {}
    for p, n in ((40, 300), (20, 300), (40, 512), (2, 512)):
        boxes, scores, valid = nms_case(gen, p, n)
        ms = {name: [] for name, _ in forms}
        for _ in range(rounds):
            for name, form in forms:
                ms[name].append(cuda_ms(
                    lambda: nms_cuda._dispatch(boxes, scores, valid, 100, 0.6, 0.0, form), 200))
        out[f"{p}x{n}->100"] = ms
        log(f"[nms] {p}x{n}->100 by form, ms a call from a tight host loop, {rounds} rounds: "
            + "; ".join(f"{name} " + " ".join(f"{v:.4f}" for v in vals)
                        for name, vals in ms.items()))
    return out


def nms_stage_times(fn, shape: str, reps: int = 100):
    """Mean device milliseconds per call of each NMS kernel: rank, order,
    mask and scan of the banded pipeline, or the single launch
    (torch.profiler, by kernel name). The profiler can lose
    the records of a short window, so an empty result is reported and not
    a failure: the stage times are a reading, not a check."""
    stages = {}
    for name, ms, launches in profiled_kernels(fn, reps):
        for stage in ("rank", "order", "mask", "scan", "nms_small"):
            if f"{stage}_kernel" in name:
                stages[stage] = stages.get(stage, 0.0) + ms
                stages[f"{stage}_launches"] = stages.get(f"{stage}_launches", 0) + launches
    log(f"[nms] {shape} stages (profiler, device ms per call): "
        + (", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in stages.items()) or "not measured (no kernel record)"))
    return stages


def check_nms_cases(gen):
    """Inputs that stress the order, the mask's ragged edge and the scan's
    end, in every form of the kernels that takes the N, each exactly equal
    to the plain version."""
    from mtlx_torch.kernels import nms_cuda

    def case(name, boxes, scores, valid, k, thr, score_thr):
        n = scores.shape[1]
        ref = nms_cuda.non_max_suppression_plain(boxes, scores, valid, k, thr, score_thr)
        forms = [("by N", nms_cuda._FORM_BY_N), ("banded", nms_cuda._FORM_BANDED)]
        if n <= nms_cuda.SMALL_MAX_BOXES:
            forms.append(("single launch", nms_cuda._FORM_SINGLE_LAUNCH))
        for form_name, form in forms:
            got = nms_cuda._dispatch(boxes, scores, valid, k, thr, score_thr, form)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                bad = int((got[0] != ref[0]).sum() + (got[1] != ref[1]).sum())
                raise AssertionError(f"NMS kernels ({form_name}) differ from their plain "
                                     f"version on {name}: {bad} slots")
        log(f"[nms] {name}: {tuple(scores.shape)} -> {k}, {int(ref[1].sum())} picks, equal "
            f"(exact) in forms {[f for f, _ in forms]}")

    # N not a multiple of 64 (SSD's 1917), N on both sides of the forms'
    # boundary and of the first band's end
    small = nms_cuda.SMALL_MAX_BOXES
    for p, n, k in ((3, 1917, 200), (5, 301, 100), (2, small, 100), (2, small + 1, 100),
                    (2, 1024, 100), (2, 1025, 100)):
        boxes, scores, valid = nms_case(gen, p, n)
        case(f"N={n}", boxes, scores, valid, k, 0.6, 0.0)
    # unsorted: continuous scores in random order, -0.0 and +0.0 among them,
    # no threshold, so every valid row is live
    boxes, scores, valid = nms_case(gen, 2, 6000)
    scores = torch.rand(2, 6000, generator=gen).cuda() - 0.5
    scores[:, 5] = -0.0
    scores[:, 9] = 0.0
    case("unsorted, signed scores", boxes, scores, valid, 300, 0.7, float("-inf"))
    # all dead: one problem invalid, one below the score threshold
    boxes, scores, valid = nms_case(gen, 2, 6000)
    valid[0] = False
    scores[1] = 0.0
    case("all dead", boxes, scores, valid, 300, 0.7, 0.0)
    boxes, scores, valid = nms_case(gen, 2, 300)
    valid[:] = False
    case("all dead, small", boxes, scores, valid, 100, 0.6, 0.0)
    # fewer live rows than max_out: the scan ends on the first dead row
    boxes, scores, valid = nms_case(gen, 2, 6000)
    valid = valid & (torch.rand(2, 6000, generator=gen).cuda() < 0.02)
    case("fewer live rows than max_out", boxes, scores, valid, 300, 0.7, 0.0)
    # nothing suppressed and max_out = N: the scan walks every band to the end
    boxes, scores, valid = nms_case(gen, 1, 2048)
    case("max_out = N, IoU 0.99", boxes, scores, torch.ones_like(valid), 2048, 0.99,
         float("-inf"))
    # one tight cluster: the first pick suppresses nearly every row, and the
    # scan still walks every band
    _, scores, valid = nms_case(gen, 1, 4000)
    boxes = (torch.tensor([100.0, 100.0, 160.0, 180.0])
             + torch.randn(1, 4000, 4, generator=gen)).cuda()
    case("one cluster", boxes, scores, valid, 300, 0.3, 0.0)


def crop_tap_reads(boxes, crop_size, h: int, w: int):
    """(taps the row-reusing walk reads, taps the four-tap form reads,
    sample points) of a crop, a tap being one pixel's channels: the walk
    reads the two taps of each distinct source row of a box once per
    in-range sample column, the four-tap form four taps per in-range
    sample point."""
    from mtlx_torch.kernels import roi_cuda

    (y_lo, y_hi, _, y_in), (_, _, _, x_in) = roi_cuda._sample_points(boxes, crop_size, h, w)
    used = torch.zeros(*boxes.shape[:2], h + 1, device=boxes.device)
    for rows in (y_lo, y_hi):  # out-of-range samples go to the spare row h
        used.scatter_(2, torch.where(y_in, rows, h), 1.0)
    distinct_rows = used[..., :h].sum(-1)
    cols_in, rows_in = x_in.sum(-1), y_in.sum(-1)
    walk = int((2 * distinct_rows * cols_in).sum())
    four = int((4 * rows_in * cols_in).sum())
    return walk, four, boxes.shape[0] * boxes.shape[1] * crop_size[0] * crop_size[1]


def crop_pixels_read(boxes, crop_size, h: int, w: int) -> int:
    """Distinct pixels a crop must read: per image, the union over its
    boxes of (rows under an in-range sample row) x (columns under an
    in-range sample column), each pixel counted once however many boxes
    sample it. A crop's bound reads these pixels' channels, not the map."""
    from mtlx_torch.kernels import roi_cuda

    (y_lo, y_hi, _, y_in), (x_lo, x_hi, _, x_in) = roi_cuda._sample_points(boxes, crop_size, h, w)

    def used(lo, hi, in_range, n):  # [B, N, n]: 1 where a box reads the row / column
        u = torch.zeros(*boxes.shape[:2], n + 1, device=boxes.device)
        for idx in (lo, hi):  # out-of-range samples go to the spare index n
            u.scatter_(2, torch.where(in_range, idx, n), 1.0)
        return u[..., :n]

    rows, cols = used(y_lo, y_hi, y_in, h), used(x_lo, x_hi, x_in, w)
    return int((torch.bmm(rows.transpose(1, 2), cols) > 0).sum())


def sample_grid(boxes, cs: int, h: int, w: int, dtype):
    """The crop's cs x cs sample points of each box as an F.grid_sample
    grid (align_corners=True): [B, N * cs, cs, 2]."""
    from mtlx_torch.ops.roi import _sample_coords

    b, n = boxes.shape[:2]
    ys = _sample_coords(boxes[..., 0], boxes[..., 2], cs, h)  # [B, N, cs]
    xs = _sample_coords(boxes[..., 1], boxes[..., 3], cs, w)
    return torch.stack([
        (xs[..., None, :] / (w - 1) * 2 - 1).expand(b, n, cs, cs),
        (ys[..., :, None] / (h - 1) * 2 - 1).expand(b, n, cs, cs),
    ], -1).reshape(b, n * cs, cs, 2).to(dtype)


def grid_sample_ms(features, boxes, cs: int) -> float:
    """The yardstick: F.grid_sample on the crop's sample points, NCHW
    view of the same features."""
    grid = sample_grid(boxes, cs, features.shape[1], features.shape[2], features.dtype)
    img_nchw = features.permute(0, 3, 1, 2)
    return cuda_ms(lambda: F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros",
                                         align_corners=True), 50)


def grid_sample_backward_ms(dout, boxes, hw) -> float:
    """The crop backward's yardstick: the d(input) of F.grid_sample
    (align_corners=True) on the crop's sample points, its grad_input only,
    in dout's dtype."""
    b, n, cs, _, c = dout.shape
    grid = sample_grid(boxes, cs, hw[0], hw[1], dout.dtype)
    feats_nchw = torch.zeros(b, hw[0], hw[1], c, dtype=dout.dtype,
                             device=dout.device).permute(0, 3, 1, 2)
    gout = dout.permute(0, 4, 1, 2, 3).reshape(b, c, n * cs, cs)
    return cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        gout, feats_nchw, grid, 0, 0, True, [True, False]), 20)


def time_crop(features, boxes, cs: int, tag: str, plain_reps: int = 10):
    """The crop kernel on these inputs: bit-equal to its plain version,
    timed beside its bound, its plain version, F.grid_sample, a fill of
    its output (the card's time to write those bytes alone) and its tap
    reads."""
    from mtlx_torch.kernels import roi_cuda

    b, h, w, c = features.shape
    n = boxes.shape[1]
    out = roi_cuda.crop_and_resize(features, boxes, (cs, cs))
    if not torch.equal(out, roi_cuda.crop_and_resize_plain(features, boxes, (cs, cs))):
        raise AssertionError(f"ROI kernel differs from its plain version at {tag}")
    ms = cuda_ms(lambda: roi_cuda.crop_and_resize(features, boxes, (cs, cs)), 50)
    plain_ms = cuda_ms(lambda: roi_cuda.crop_and_resize_plain(features, boxes, (cs, cs)),
                       plain_reps)
    library_ms = grid_sample_ms(features, boxes, cs)
    fill_ms = cuda_ms(lambda: out.zero_(), 50)
    elt = features.element_size()
    # the pixels under the sample points read once, the boxes read, the
    # output written
    pixels = crop_pixels_read(boxes, (cs, cs), h, w)
    t_bound, by = bound_ms(
        nbytes=pixels * c * elt + b * n * 16 + b * n * cs * cs * c * elt,
        ops=b * n * cs * cs * c * ROI_OPS_PER_ELEMENT,
    )
    walk, four, outputs = crop_tap_reads(boxes, (cs, cs), h, w)
    shape = f"{b}x{h}x{w}x{c}x{n}->{cs}x{cs} {str(features.dtype)[6:]}"
    log(f"[roi] {tag} {shape}: equal to the plain version; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, bound {t_bound:.4f} ms ({by}; "
        f"{pixels / (b * h * w):.3f} of the map's pixels read), "
        f"a fill of the output {fill_ms:.4f} ms; taps read {walk / outputs:.3f} an output "
        f"({walk * c * elt / 1e6:.1f} MB; four-tap form {four / outputs:.3f}, "
        f"{four * c * elt / 1e6:.1f} MB)")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=t_bound,
                bound_by=by, max_abs_err=0.0, fill_ms=fill_ms, pixels_read=pixels,
                taps_per_output=walk / outputs, four_tap_taps_per_output=four / outputs)


def random_boxes(gen, b: int, n: int):
    """Normalized boxes with corners uniform in [-0.2, 1.2]: some past the map."""
    corners = torch.rand(b, n, 4, generator=gen) * 1.4 - 0.2
    return torch.cat([torch.minimum(corners[..., :2], corners[..., 2:]),
                      torch.maximum(corners[..., :2], corners[..., 2:])], -1)


def check_roi(gen, results):
    from mtlx_torch.kernels import roi_cuda

    b, h, w, c, n, cs = 1, 40, 64, 1024, 300, 14
    feats = torch.randn(b, h, w, c, generator=gen).cuda()
    boxes = random_boxes(gen, b, n).cuda()
    # float32: the kernel against the plain version, atol 1e-5, and equal
    got = roi_cuda.crop_and_resize(feats, boxes, (cs, cs))
    ref = roi_cuda.crop_and_resize_plain(feats, boxes, (cs, cs))
    err32 = float((got - ref).abs().max())
    if err32 > 1e-5 or not torch.equal(got, ref):
        raise AssertionError(f"ROI kernel float32 max abs err {err32} (tolerance 1e-5, and equal)")
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
    log(f"[roi] {b}x{h}x{w}x{c}, {n} boxes -> {cs}x{cs}: f32 max abs err {err32:.3g} "
        f"(tol 1e-5), bf16 worst {worst_ulps:.3f} ulp of f32 (tol 1 ulp), bf16 vs "
        f"plain {err16:.3g}")
    results["roi_crop"] = time_crop(fb, boxes, cs, "serving, random boxes")
    results["roi_crop"].update(max_abs_err=err16, f32_max_abs_err=err32,
                               f32_ms=cuda_ms(lambda: roi_cuda.crop_and_resize(feats, boxes,
                                                                                 (cs, cs)), 50))
    log(f"[roi] f32 kernel {results['roi_crop']['f32_ms']:.4f} ms")

    # the training step's second stage: 16 images, 64 sampled boxes each
    bt, nt = 16, 64
    ft = torch.randn(bt, h, w, c, generator=gen).cuda().bfloat16()
    bxt = random_boxes(gen, bt, nt).cuda()
    results["roi_crop"]["other_shapes"] = [
        time_crop(ft, bxt, cs, "training, random boxes", plain_reps=5)]


def crop_edge_boxes(gen, b: int, n: int, h: int):
    """Boxes where the row-reusing crop could go wrong, a fifth of each
    kind: random, shorter than one source row (every sample row shares
    its source rows), wider than the map (samples out of range), edges
    exactly on 0.0 and 1.0 (samples on the first and last pixel, clamped
    hi taps), and inverted (descending sample coordinates)."""
    boxes = random_boxes(gen, b, n)
    y0 = torch.rand(b, n, generator=gen) * 0.9
    short = boxes.clone()
    short[..., 0], short[..., 2] = y0, y0 + torch.rand(b, n, generator=gen) * 0.9 / (h - 1)
    wide = torch.cat([-0.1 - 0.5 * torch.rand(b, n, 2, generator=gen),
                      1.1 + 0.5 * torch.rand(b, n, 2, generator=gen)], -1)
    edges = torch.tensor([0.0, 0.0, 1.0, 1.0]).repeat(b, n, 1)
    edges[:, 1::2, 2] = 0.5
    edges[:, 2::3, 1] = 0.5
    inverted = boxes[..., [2, 3, 0, 1]]
    kind = (torch.arange(n) % 5)[None, :, None]
    for k, other in enumerate((short, wide, edges, inverted), start=1):
        boxes = torch.where(kind == k, other, boxes)
    return boxes.contiguous()


def check_roi_cases(seed: int):
    """The crop on boxes and shapes where its walk could go wrong, bit-equal
    to the plain version in float32 and bfloat16: the main path's shapes
    with edge-case boxes, and crops 1x1, 4x3, 7x7 and 14x14 with channels
    that are not a multiple of 8."""
    from mtlx_torch.kernels import roi_cuda

    gen = torch.Generator().manual_seed(seed + 1)
    cases = [(1, 40, 64, 1024, 300, (14, 14)), (16, 40, 64, 1024, 64, (14, 14))]
    cases += [(2, 9, 11, c, 40, crop) for c in (13, 1020)
              for crop in ((1, 1), (4, 3), (7, 7), (14, 14))]
    for b, h, w, c, n, crop in cases:
        feats = torch.randn(b, h, w, c, generator=gen).cuda()
        boxes = crop_edge_boxes(gen, b, n, h).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            f = feats.to(dtype)
            if not torch.equal(roi_cuda.crop_and_resize(f, boxes, crop),
                               roi_cuda.crop_and_resize_plain(f, boxes, crop)):
                raise AssertionError(f"ROI kernel differs from its plain version on edge-case "
                                     f"boxes, {b}x{h}x{w}x{c} x {n} -> {crop} {dtype}")
    torch.cuda.synchronize()
    log(f"[roi] edge-case boxes (shorter than a source row, wider than the map, edges on 0 and 1, "
        f"inverted) at {len(cases)} shapes (1x40x64x1024 x 300 and 16x40x64x1024 x 64 -> 14x14; "
        f"C = 13 and 1020 -> 1x1, 4x3, 7x7, 14x14), float32 and bfloat16: equal to the plain "
        f"version")


def time_main_path_crops(tag: str, calls):
    """The crop kernel timed on the features and boxes a main-path run
    cropped (recorded by record_calls)."""
    rows = []
    for (features, boxes, crop_size), _ in calls:
        rows.append(time_crop(features, boxes, int(crop_size[0]), f"{tag}, main-path boxes",
                              plain_reps=5))
    return rows


def time_iou(b1, b2, tag: str):
    """The IoU kernel on these inputs: bit-equal to its plain version,
    timed from a tight host loop and by the profiler's device time, beside
    its bound, its plain version and a fill of its output."""
    from mtlx_torch.kernels import iou_cuda

    p, g, m = max(b1.shape[0], b2.shape[0]), b1.shape[1], b2.shape[1]
    got = iou_cuda.iou_matrix(b1, b2)
    ref = iou_cuda.iou_matrix_plain(b1, b2)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"IoU kernel differs from its plain version in "
                             f"{int((got != ref).sum())} entries at {tag}")
    call = lambda: iou_cuda.iou_matrix(b1, b2)
    ms = cuda_ms(call, 50)
    dev_ms = kernel_ms(call, "iou_kernel")
    plain_ms = cuda_ms(lambda: iou_cuda.iou_matrix_plain(b1, b2), 10)
    fill_ms = cuda_ms(lambda: got.zero_(), 50)
    # each output: 2 min, 2 max, 2 sub, 2 clamp, 1 mul (inter), area1 (3),
    # union (2), compare, max, div
    t_bound, by = bound_ms(nbytes=b1.numel() * 4 + b2.numel() * 4 + p * g * m * 4,
                           ops=p * g * m * 16)
    shape = f"{p}x{g}x{m}"
    log(f"[iou] {tag} {shape}: bit-equal to the plain version ({int((ref > 0).sum())} positive "
        f"pairs of {ref.numel()}); kernel {ms:.4f} ms a call from a tight host loop, device "
        f"{dev_ms if dev_ms is None else round(dev_ms, 5)} ms, plain {plain_ms:.4f} ms, bound "
        f"{t_bound:.5f} ms ({by}), a fill of the output {fill_ms:.4f} ms, library null")
    return dict(shape=shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=t_bound,
                bound_by=by, max_abs_err=0.0, fill_ms=fill_ms)


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
    gt[:, 6] = torch.tensor([-0.0, 10.0, -0.0, 90.0])  # zero height at y = -0
    gt[:, 7] = gt[:, 8, [2, 3, 0, 1]]  # inverted
    gt, anchors = gt.cuda(), anchors.cuda().contiguous()
    results["iou"] = time_iou(gt, anchors[None], "RPN assignment, synthetic boxes")
    results["iou_inputs"] = (gt, anchors[None].expand(b, a, 4))

    # only padding rows; M not a multiple of 4 (the kernel's float4 rows);
    # the shared side first; each side per problem
    cases = [("only padding rows", torch.zeros_like(gt), anchors[None]),
             ("M = 30717", gt, anchors[None, :-3].contiguous()),
             ("M = 301, per-image boxes", gt[:, :37].contiguous(), gt[:, :1].repeat(1, 301, 1)
              + torch.randn(b, 301, 4, generator=gen).cuda() * 20),
             ("shared first side", anchors[None, :997].contiguous(), gt),
             ("M = 1", gt, anchors[None, 5:6].contiguous())]
    for name, b1, b2 in cases:
        got, ref = iou_cuda.iou_matrix(b1, b2), iou_cuda.iou_matrix_plain(b1, b2)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"IoU kernel differs from its plain version on {name}: "
                                 f"{int((got != ref).sum())} entries")
    log(f"[iou] {', '.join(n for n, _, _ in cases)}: bit-equal to the plain version")


def time_main_path_ious(calls):
    """The IoU kernel timed on the boxes a training step's assignments
    compared (recorded by record_calls), the largest launch first."""
    calls = sorted(calls, key=lambda call: -max(call[0][0].shape[0], call[0][1].shape[0])
                   * call[0][0].shape[1] * call[0][1].shape[1])
    return [time_iou(b1, b2, "training step, main-path boxes") for (b1, b2), _ in calls]


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

    # boxes whose samples fall on integer pixel coordinates (fraction 0:
    # the hi tap has weight 0) and boxes on the whole canvas (the last
    # sample's hi tap is clamped), 200 a image: two batches of the
    # kernel's sample tables; float32 and bfloat16
    hi_, wi_, ci_, ni_, cs_ = 40, 64, 64, 200, 14
    y0 = torch.randint(0, hi_ - cs_ + 1, (2, ni_), generator=gen).float()
    x0 = torch.randint(0, wi_ - cs_ + 1, (2, ni_), generator=gen).float()
    bxi = torch.stack([y0 / (hi_ - 1), x0 / (wi_ - 1), (y0 + cs_ - 1) / (hi_ - 1),
                       (x0 + cs_ - 1) / (wi_ - 1)], -1)
    bxi[:, ::7] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    bxi = bxi.cuda()
    di = torch.randn(2, ni_, cs_, cs_, ci_, generator=gen).cuda()
    toli = _bwd_tolerance(roi_cuda, di, bxi, (hi_, wi_))
    erri = (roi_cuda.crop_and_resize_backward(di, bxi, (hi_, wi_))
            - roi_cuda.crop_and_resize_backward_plain(di, bxi, (hi_, wi_))).abs()
    ratio_i = float((erri / toli.clamp_min(1e-30)).max())
    if not bool((erri <= toli).all()):
        raise AssertionError(f"crop backward (integer coordinates, whole canvas) exceeds its "
                             f"tolerance ({ratio_i:.3g}x)")
    di16 = di.bfloat16()
    refi = roi_cuda.crop_and_resize_backward_plain(di16.float(), bxi, (hi_, wi_))
    ulpi = torch.exp2(torch.floor(torch.log2(refi.abs().clamp_min(1e-30))) - 7)
    erri16 = (roi_cuda.crop_and_resize_backward(di16, bxi, (hi_, wi_)).float() - refi).abs()
    ratio_i16 = float((erri16 / (ulpi + toli)).max())
    if ratio_i16 > 1.0:
        raise AssertionError(f"crop backward bf16 (integer coordinates, whole canvas) exceeds "
                             f"one ulp of the f32 result (+ tol): {ratio_i16:.3g}x")
    log(f"[roi-bwd] integer coordinates and whole-canvas boxes, 2 x {ni_} boxes -> "
        f"{hi_}x{wi_}x{ci_}: f32 at {ratio_i:.3g} of its tolerance, bf16 at {ratio_i16:.3g}")

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
    # a pixel's terms are added in a fixed order: two runs, the same bits
    for name, d, first in (("float32", dout, got), ("bfloat16", d16, got16)):
        if not torch.equal(roi_cuda.crop_and_resize_backward(d, boxes, (h, w)), first):
            raise AssertionError(f"crop backward {name} differs between two runs on one input")
    torch.cuda.synchronize()
    # what the gather reads: a sample's dout run once for every pixel it
    # feeds with a non-zero weight (up to 2 x 2), mostly from L2
    (_, _, y_frac, y_in), (_, _, x_frac, x_in) = roi_cuda._sample_points(boxes, (cs, cs), h, w)
    taps_y = y_in * (1 + (y_frac != 0))  # [B, N, cs]
    taps_x = x_in * (1 + (x_frac != 0))
    tap_reads = int((taps_y[..., :, None] * taps_x[..., None, :]).sum())
    read_mb = tap_reads * c * 2 / 1e6

    ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward(d16, boxes, (h, w)), 20)
    plain_ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward_plain(d16, boxes, (h, w)), 3)
    library_ms = grid_sample_backward_ms(d16, boxes, (h, w))
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
        f"{library_ms:.4f} ms, bound {t_bound:.4f} ms ({by}); f32 kernel {ms32:.4f} ms; two "
        f"runs bit-equal (f32 and bf16); the bf16 gather reads {read_mb:.1f} MB of dout "
        f"({tap_reads} sample-pixel pairs x {c} channels) for {b * n * cs * cs * c * 2 / 1e6:.1f} "
        f"MB of dout and writes {b * h * w * c * 2 / 1e6:.1f} MB once, no scratch")
    results["roi_crop_backward"] = dict(
        shape=f"{b}x{n}x{cs}x{cs}x{c}->{b}x{h}x{w}x{c} bf16", ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=t_bound, bound_by=by,
        max_abs_err=float((got16.float() - ref32).abs().max()),
        f32_max_abs_err=float(err32.max()), f32_ms=ms32, dout_read_mb=read_mb)


def time_crop_backward(dout, boxes, hw, tag: str):
    """The crop backward kernel on bf16 dout: within one bf16 ulp of the
    float32 plain result plus 1e-4 of each pixel's sum of term magnitudes,
    timed beside its plain version, grid_sampler_2d_backward and its bound."""
    from mtlx_torch.kernels import roi_cuda

    b, n, cs, _, c = dout.shape
    got = roi_cuda.crop_and_resize_backward(dout, boxes, hw)
    ref = roi_cuda.crop_and_resize_backward_plain(dout.float(), boxes, hw)
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    err = (got.float() - ref).abs()
    ratio = float((err / (ulp + _bwd_tolerance(roi_cuda, dout, boxes, hw))).max())
    if ratio > 1.0:
        raise AssertionError(f"crop backward at {tag} exceeds its tolerance: {ratio:.3g}x")
    ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward(dout, boxes, hw), 20)
    plain_ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward_plain(dout, boxes, hw), 3)
    library_ms = grid_sample_backward_ms(dout, boxes, hw)
    t_bound, by = bound_ms(nbytes=b * n * cs * cs * c * 2 + b * n * 16 + b * hw[0] * hw[1] * c * 2,
                           ops=b * n * cs * cs * c * 8)
    shape = f"{b}x{n}x{cs}x{cs}x{c}->{b}x{hw[0]}x{hw[1]}x{c} bf16"
    log(f"[roi-bwd] {tag} {shape}: within {ratio:.3g} of its tolerance; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, grid_sampler_2d_backward {library_ms:.4f} ms, bound "
        f"{t_bound:.4f} ms ({by})")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=t_bound,
                bound_by=by, max_abs_err=float(err.max()))


def time_spatial_shapes(seed: int, results):
    """The four kernels at the shapes phase 17's spatial step gives them,
    on inputs of their own: NMS 2 x 6000 -> 300 (IoU 0.7), the crop of
    2 x 128 x 128 x 1024 bf16 with 64 boxes an image -> 14x14, its
    backward, and the IoU of 2 x 100 ground truth boxes against the 196608
    anchors of a 128x128 map; each held to its plain version."""
    from mtlx_torch.kernels import nms_cuda

    gen = torch.Generator().manual_seed(seed + 40)
    p, n, k, thr = 2, 6000, 300, 0.7
    boxes, scores, valid = nms_case(gen, p, n)
    idx, keep = nms_cuda.non_max_suppression(boxes, scores, valid, k, thr, 0.0)
    ref_idx, ref_keep = nms_cuda.non_max_suppression_plain(boxes, scores, valid, k, thr, 0.0)
    if not (torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)):
        raise AssertionError("NMS kernels differ from their plain version at 2x6000->300")
    steps = int(torch.clamp(keep.sum(1) + 1, max=k).sum())
    t_bound, by = bound_ms(nbytes=p * n * (16 + 4 + 1) + p * k * (4 + 1),
                           ops=steps * n * NMS_OPS_PER_BOX_STEP)
    ms, plain_ms, stage_ms, device_ms = time_nms(boxes, scores, valid, k, thr, "2x6000->300")
    log(f"[nms] spatial step 2x6000->300 iou {thr}: selections equal (exact), "
        f"{int(keep.sum())} picks; {ms:.4f} ms a call from a tight host loop, device "
        f"{device_ms} ms, plain {plain_ms:.3f} ms, bound {t_bound:.5f} ms ({by}), library null")
    nms = dict(shape="2x6000->300", ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
               max_abs_err=0.0, device_ms=device_ms, stage_ms=stage_ms)
    b, h, w, c, n, cs = 2, 128, 128, 1024, 64, 14
    feats = torch.randn(b, h, w, c, generator=gen).cuda().bfloat16()
    boxes = random_boxes(gen, b, n).cuda()
    crop = time_crop(feats, boxes, cs, "spatial step", plain_reps=3)
    dout = torch.randn(b, n, cs, cs, c, generator=gen).cuda().bfloat16()
    backward = time_crop_backward(dout, boxes, (h, w), "spatial step")
    iou = time_iou(random_boxes(gen, b, 100).cuda(), random_boxes(gen, 1, h * w * 12).cuda(),
                   "spatial step")
    results["spatial_shapes"] = dict(nms=nms, roi_crop=crop, roi_crop_backward=backward,
                                     iou=iou)


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
            cls, box, _ = model._predict_second_stage(feats, props, hw)
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


def check_outputs(out, b, k: int = 300):
    want = {"detection_boxes": (b, k, 4), "detection_scores": (b, k),
            "detection_classes": (b, k), "num_detections": (b,)}
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
    def predict_one():
        with torch.inference_mode():
            x = torch.from_numpy(images[0]).cuda()[None].float()
            return model.predict(model.preprocess(x), torch.tensor([[600, 800]], device="cuda"))

    pred = {}
    results["serve_nms_calls"] = log_nms_calls(
        "serve", record_nms_calls(lambda: pred.update(predict_one())))
    results["serve_crop_calls"] = time_main_path_crops(
        "serving", record_calls(predict_one, roi_cuda, "crop_and_resize"))
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
    cls_g, _, _ = gpu._predict_second_stage(
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
    from mtlx_torch.train.train import kernel_launches

    return kernel_launches()


def reset_kernel_counts():
    from mtlx_torch.train.train import set_kernel_launches

    set_kernel_launches(dict.fromkeys(kernel_counts(), 0))


def profile_train_step(step_fn, state, batch, gen):
    """Device time by kernel over one train step (torch.profiler); returns
    the state after it and (wall ms, kernel-busy ms, the largest kernels)."""
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
    log(f"[train-profile] one step at batch {batch['image'].shape[0]}: wall {wall_ms:.2f} ms "
        f"(profiler on), kernels "
        f"busy {busy:.2f} ms ({busy / wall_ms:.1%} of wall), "
        f"{sum(r[1] for r in rows)} device operations")
    for ms, count, key in rows[:15]:
        log(f"[train-profile]   {ms:8.3f} ms  x{count:<5d} {key[:100]}")
    return state, dict(wall_ms=wall_ms, busy_ms=busy, operations=sum(r[1] for r in rows),
                       top=[(key[:80], ms, count) for ms, count, key in rows[:5]],
                       by_kernel={key: (ms, count) for ms, count, key in rows})


def phase_train(seed: int, results):
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.kernels import iou_cuda, roi_cuda
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

    def warm_up():
        nonlocal state
        state, _ = step_fn(state, batches[0], generator=gen)

    crop_calls, iou_calls = [], []

    def warm_up_recorded():  # the crop's and the IoU's inputs too
        iou_calls.extend(record_calls(
            lambda: crop_calls.extend(record_calls(warm_up, roi_cuda, "crop_and_resize")),
            iou_cuda, "iou_matrix"))

    results["train_nms_calls"] = log_nms_calls("train", record_nms_calls(warm_up_recorded))
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
    state, _ = profile_train_step(step_fn, state, batches[0], gen)
    results["train_crop_calls"] = time_main_path_crops("training", crop_calls)
    results["train_iou_calls"] = time_main_path_ious(iou_calls)
    results["train"] = dict(step_ms=[t * 1e3 for t in times],
                            img_per_s=[16 / t for t in times], peak_bytes=peak)
    results["train_launches"] = launches


# ---------------------------------------------------------------- phase 7


def phase_train_card_vs_cpu(seed: int, refine: bool = False, masks: bool = False):
    """One resnet10 train step of the MTL model (with `refine`, on the MTL
    refine path; with `masks`, with the mask head and its loss on
    instance masks made from the boxes) on the card and on the CPU."""
    import dataclasses

    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.train import train_step as ts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_train_config(torch.float32)
    cfg = dataclasses.replace(cfg, backbone="resnet10", canvas_size=(128, 128),
                              mtl=dataclasses.replace(cfg.mtl, refine=refine),
                              predict_instance_masks=masks)
    cpu = FasterRCNN(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(seed))
    batch = train_batch(np.random.RandomState(seed + 1), 2, canvas=(128, 128), max_gt=8,
                        sizes=((96, 128), (100, 128)))
    if masks:  # at stride 8: each box's cells, ragged
        rs = np.random.RandomState(seed + 3)
        raster = (rs.uniform(size=(2, 8, 16, 16)) < 0.1).astype(np.uint8)
        for i, j in zip(*np.nonzero(batch["gt_mask"].cpu().numpy())):
            y0, x0, y1, x1 = np.minimum(batch["gt_boxes"][i, j].cpu().numpy() // 8, 15).astype(int)
            raster[i, j, y0:y1 + 1, x0:x1 + 1] = rs.uniform(size=(y1 - y0 + 1, x1 - x0 + 1)) < 0.9
        batch["gt_instance_masks"] = torch.from_numpy(raster).cuda()
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

    # on the refine path the multi-object and closeness heads' ReLUs see
    # every proposal: their inputs on both devices are kept, to find those
    # within float32 rounding of 0 that switch sides between the devices
    heads = ("mo_head", "cl_head") if refine else ()
    hidden = {}
    for name, model in (("cpu", cpu), ("card", gpu)):
        for head in heads:
            getattr(model.modules, head).fc.register_forward_hook(
                lambda mod, args, y, key=(name, head): hidden.setdefault(key, []).append(
                    y.detach().float().cpu().reshape(-1, y.shape[-1])))

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
    # a hidden unit whose ReLU input switches sides on some row routes that
    # row's gradient on one device only: its fc row and bias element are
    # left out of the elementwise checks (not of the L2 ones)
    kinks = {}
    for head in heads:
        z_c, z_g = torch.cat(hidden[("cpu", head)]), torch.cat(hidden[("card", head)])
        flips = ((z_c > 0) != (z_g > 0)).nonzero().tolist()
        if flips:
            kinks[head] = sorted({j for _, j in flips})
            log(f"[train-card-vs-cpu] {head} ReLU inputs that switch sides between the devices "
                f"(row, unit, CPU, card): "
                f"{[(r, j, float(z_c[r, j]), float(z_g[r, j])) for r, j in flips]}")
        if any(abs(float(z_c[r, j])) > 1e-5 for r, j in flips):
            raise AssertionError(f"{head}: a ReLU input away from 0 switches sides: {flips}")

    def elementwise(diff, n):
        head = n.split(".")[0]
        if head in kinks and n.startswith(f"{head}.fc."):
            diff = diff.clone()
            diff[kinks[head]] = 0.0
        return diff

    def worst(card, cpu_side, metric):
        return max((metric(card[n] - t, t), n) for n, t in cpu_side.items())

    l2 = lambda d, t: float(d.norm() / t.norm().clamp_min(1e-30))
    peak = lambda d, t: float(d.abs().max() / t.abs().max().clamp_min(1e-30))
    grad_l2, grad_l2_at = worst(g_g, g_c, l2)
    grad_peak, grad_peak_at = max((peak(elementwise(g_g[n] - t, n), t), n)
                                  for n, t in g_c.items())
    upd_l2, upd_l2_at = worst(u_g, u_c, l2)
    par_peak, par_peak_at = max((peak(elementwise(p_g[n] - t, n), t), n)
                                for n, t in p_c.items())
    # float32 sums taken in another order (cuDNN's algorithms, the crop
    # backward's per-pixel gather) err relative to the magnitudes of their terms, so
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
    log(f"[train-card-vs-cpu] resnet10{' refine' if refine else ''}{' masks' if masks else ''}"
        f", float32, 128x128, TF32 "
        f"off; card total_loss "
        f"{m_g['total_loss']:.6g}, cpu {m_c['total_loss']:.6g}")
    failed = []
    for name, value, tol in checks:
        ok = value <= tol
        log(f"[train-card-vs-cpu] {name}: {value:.3g} (tolerance {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"card and CPU training disagree: {failed}")


# ---------------------------------------------------------------- phase 8

VOC_NAMES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair",
             "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
             "sheep", "sofa", "train", "tvmonitor")
FLAGSHIP_CONFIG = "configs/faster_rcnn_resnet50_mtl_voc0712.config"
# a 48x64 JPEG made with PIL (quality 85), and the sha256 of the pixels
# mtlx's native codec decodes from it: onto 30x40 (DCT-scaled, half-pixel
# centers) and onto 60x80 (TF1 resize convention)
JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8LCwkMEQ8SEhEPERETFhwXExQa"
    "FRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUFBQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
    "Hh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh7/wAARCAAwAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
    "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAk"
    "M2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKT"
    "lJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
    "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdh"
    "cRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
    "anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD5PtbTcgznPKthMcfrj/61alpZEKEbcMEYwgyePr17/j+WrHZB"
    "ZwiqRuyCWBGc85/l+laFnZpNw7BRkHnljj046f5zW9FXsY4PMVczoLFgR5kYzn7u4beBz2/znHatO108grgoqgn5"
    "c/d47/j6V0eg6XDMJ3ntzIAoxyRkZPzDp+Va0Wm2Dlm+zIrALsyDznnpnnpSq55h8LUdOaba7W7ep+pZHkuNxuFh"
    "iacoqLva7fR27Pt3OYtrGbglWXcSPu5BwO5zxxWtBZBIc5YHJVmwfxPP49PatpbKzRhiHagPylnIAPfP+e3WrtlY"
    "hgisqcnbncQSccc/5xgV7OU5rRzBy9mmuW17pa3+b7Ht1aNbLnH2rTv28reS7mVaWGdwjAZgOAp7fh9en4e1advY"
    "MQF3oNoH3QR+fGRxWrb6arqcB9zEFyACevY5+nA7ita0sySq7MsvDAjv6j0/Svp6LZ7ODzGyT3PH7OwZ+GJckBgw"
    "OBjNalnZq7Z+bY4+YIemcevfpz7e9bNpZ/wyJnBxznHv1Ht/nitK3smwFJQhmAwT09/fJ/ya/PcO+iP47wWY67mR"
    "Yw+TAZCrMxAJBBGcen09f/1Vaf8AeRlFWPYxz9/jnHQ4/DNaNzplxJGgjQNuB/jzjIx3/PHvTU0LVMosdt8wHPzL"
    "nORnox6/4V89mmGr1MVKUINrTZPsj+n+CM+y6GRUKdbEQjNc105RTXvy3Td9tjN2NvQbFCdArclQeDnOQPX/APVX"
    "ZWemhQw8tAcEKeR6nORmsG18Na65xDYFyQSfnUAAdAATjPX1r0ez091JBgJ2/KWUEjORnjtx2r6PhXD16DqqpFxv"
    "y7q3fuZ8X5vhasqPsKsZ/Ffladvh3tfzMy0sQoCyBgwbA3ctg9xxx9T/AEq7BYoIXl3Dg5J6Djndj8+a2rWyCODM"
    "cKo3NnjHr6cYqrOzThYYhmDgEj5TIR744HT/AD09riDifDZDh/a1NZy+GPd/ol1fy3OLLMVKo99OrOAs9OcjeyI2"
    "9gASvXPA5+oH59q1LGyVZGkGUK5OME5yePp+la0GmRgZUK+Acj0PPPp2q/bafKCvljDjCtggbvoM+4/Gvn6Dv1P4"
    "4weY67mdaWJVmEiRnGONoODwM/1rSjsX3LuXDR5ABPPU5I/LH+c1rWlkY54yo2DHA4456A//AFq0bSzBIjlQKA3O"
    "3qevH6/nXqYd9T6zB5g0k7mVBpgcqChXaDkg9G4z7dcc/wD1zWvFZBAzqFBUbhnjHr/IVp2VgsC5KkKmfmPUYHP+"
    "cVUud1wPLiy0IG5z0DtnAPPQcf1+nDxBxNhchwvtanvTfwxXV/ou7/Vo+yyzFSqysnojKvAJx9mgysan77N9488H"
    "PbjpS22nsQvQ5cnd3IPBx9OfwrbgsJXYkg4ByEGMH0P14Ht/KtKHTSFE+3c6A4P5g/Wv58x2bYrNcVLFYqXNJ/cv"
    "Jdl/W9z9Gy/HKEVGJ//Z"
)
JPEG_SHA256 = {
    (30, 40, False): "312e89f5a7fa03cda49476ddd0069d4901a4ff61ad03d998a5a3dac125b4fcf3",
    (60, 80, True): "3ce81bc1635cbc705f2851065fec695e35b361762a702b69680fac6262366cd1",
}


# VOC's image sizes (height, width): 500x375, 375x500 and 500x333 (w x h)
VOC_SIZES = ((375, 500), (500, 375), (333, 500))
# what the flagship's keep-aspect resizer {600, 1024} makes of them
VOC_TARGETS = ((600, 800), (800, 600), (600, 901))


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_records(path: str, rs, n: int, fmt: str, sizes) -> str:
    """n TFRecords of uint8 noise images of the given (height, width)
    sizes in turn, as JPEG (quality 90) or PNG, 1-20 boxes each of VOC
    classes."""
    from mtlx_torch.data import imgcodec, tfrecord
    from mtlx_torch.data.example_decoder import build_example

    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            h, wd = sizes[i % len(sizes)]
            image = rs.randint(0, 256, (h, wd, 3)).astype(np.uint8)
            k = rs.randint(1, 21)
            y0, x0 = rs.uniform(0, 0.8, k), rs.uniform(0, 0.8, k)
            boxes = np.stack([y0, x0, np.minimum(y0 + rs.uniform(0.05, 0.5, k), 1.0),
                              np.minimum(x0 + rs.uniform(0.05, 0.5, k), 1.0)], 1)
            labels = rs.randint(1, 21, k)
            encoded = encode_jpeg(image) if fmt == "jpeg" else imgcodec.encode_png(image)
            w.write(build_example(encoded, fmt.encode(), h, wd, f"noise{i}.{fmt}",
                                  boxes, labels, [VOC_NAMES[c - 1] for c in labels],
                                  difficult=(rs.uniform(size=k) < 0.1).astype(int)))
    return path


def cli_pipeline(record: str, label_map: str, fine_tune: str, save_every: int = 3) -> str:
    """The flagship pipeline text with its input paths, label map,
    fine_tune_checkpoint and (unless save_every is None) checkpoint
    interval replaced."""
    with open(FLAGSHIP_CONFIG) as f:
        text = f.read()
    replace = [('"/data/voc/pascal_train_voc0712.record"', json.dumps(record)),
               ('"/data/voc/pascal_test_voc07.record"', json.dumps(record)),
               ('"/data/voc/pascal_label_map.pbtxt"', json.dumps(label_map)),
               ('fine_tune_checkpoint: ""', f"fine_tune_checkpoint: {json.dumps(fine_tune)}")]
    if save_every is not None:
        replace.append(("save_checkpoints_steps: 2000", f"save_checkpoints_steps: {save_every}"))
    for old, new in replace:
        if old not in text:
            raise AssertionError(f"{FLAGSHIP_CONFIG} no longer holds {old}")
        text = text.replace(old, new)
    return text


def run_cli(main, argv):
    """Run a CLI's main in this process (so the kernel counters see its
    launches), echo its output and return it with the value main returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return out, value


def train_log_lines(out: str):
    return [json.loads(ln[len("[train] "):]) for ln in out.splitlines()
            if ln.startswith("[train] {")]


def check_jpeg_on_card():
    """Build the port's JPEG codec by its one rule and hold the embedded
    JPEG's pixels to mtlx's (sha256) at both targets; any failure to
    build, load or match fails the run. Also says what the machine holds:
    Pillow's JPEG support and bundled library, and nvJPEG's header."""
    import base64
    import glob
    import hashlib

    import PIL
    import PIL.features

    from mtlx_torch.data import imgcodec
    from mtlx_torch.kernels import build

    t0 = time.perf_counter()
    imgcodec._codec()
    turbo = PIL.features.version_feature("libjpeg_turbo")
    log(f"[jpeg] Pillow {PIL.__version__}: jpg {PIL.features.check('jpg')} (libjpeg "
        f"{PIL.features.version('jpg')}, libjpeg-turbo {turbo}); "
        f"the codec links {build.pillow_libjpeg()}, built and loaded in "
        f"{time.perf_counter() - t0:.2f} s; nvjpeg.h under /usr/local/cuda/include: "
        f"{bool(glob.glob('/usr/local/cuda/include/nvjpeg.h'))}")
    jpg = base64.b64decode("".join(JPEG_B64))
    for (th, tw, tf1), want in JPEG_SHA256.items():
        got = hashlib.sha256(imgcodec.decode_jpeg(jpg, th, tw, tf1).tobytes()).hexdigest()
        if got != want:
            raise AssertionError(f"JPEG decode onto {th}x{tw} (tf1 {tf1}) differs from mtlx's")
    log(f"[jpeg] the port's decode of the embedded JPEG equals mtlx's pixels at "
        f"{len(JPEG_SHA256)} targets (sha256)")
    return "equal"


def loader_ms(record: str, canvas, passes: int = 2, **dataset_kw):
    """ms a batch of 16 of the host loader over a record file (read,
    decode, canvas, packing; decode_threads 2, as the train CLI and
    `time_steps_without_loader`), one pass after another; dataset_kw go to
    the DetectionDataset (instance masks, keypoints)."""
    from mtlx_torch.data.loader import DetectionDataset, batches

    out = []
    for _ in range(passes):
        ds = DetectionDataset([record], canvas,
                              ("keep_aspect", {"min_dimension": 600, "max_dimension": 1024}),
                              **dataset_kw)
        t0 = time.perf_counter()
        n = sum(1 for _ in batches(ds, 16, seed=0, epochs=1, pack_images=True,
                                   decode_threads=2))
        out.append((time.perf_counter() - t0) * 1e3 / n)
        ds.close()
    return out


def time_steps_without_loader(model, record: str, seed: int, tag: str = "cli", **dataset_kw):
    """ms a train step on the batches of the records' first epoch (the
    CLI's bucket shapes), loaded to the card before the clock starts:
    alone, and while a thread reads, decodes and collates more batches on
    the host as the CLI's prefetch thread does (but copies nothing to the
    card). The train CLI's step minus these is what its loader and the
    rest of its loop cost. dataset_kw go to the DetectionDataset
    (instance masks, keypoints); the batches carry what it loads."""
    import threading

    from mtlx_torch.data.loader import DetectionDataset, batches
    from mtlx_torch.train import train as train_lib
    from mtlx_torch.train import train_step as ts

    def dataset():
        return DetectionDataset([record], model.cfg.canvas_size,
                                ("keep_aspect", {"min_dimension": 600, "max_dimension": 1024}),
                                **dataset_kw)

    ds = dataset()
    keep = ("image", "true_shape", "gt_boxes", "gt_classes", "gt_mask", "gt_instance_masks",
            "gt_keypoints")
    t0 = time.perf_counter()
    host = list(batches(ds, 16, seed=seed, epochs=1, pack_images=True, decode_threads=2))
    host_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    device_batches = [{k: torch.from_numpy(b[k]).cuda() for k in keep if k in b} for b in host]
    del host
    ds.close()
    state = ts.create_train_state(model, ts.make_optimizer(learning_rate=0.003, momentum=0.9,
                                                           gradient_clipping_by_norm=10.0))
    step_fn = train_lib.make_step_fn(model, [("random_horizontal_flip", {})])
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def one_pass():
        nonlocal state
        times = []
        for b in device_batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b, generator=gen)
            [float(v) for v in metrics.values()]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    one_pass()  # the bucket shapes' first steps
    alone = one_pass()
    stop = threading.Event()
    host_batches = [0]

    def read():
        ds2 = dataset()
        for _ in batches(ds2, 16, seed=seed + 1, pack_images=True, decode_threads=2):
            host_batches[0] += 1
            if stop.is_set():
                break
        ds2.close()

    reader = threading.Thread(target=read)
    reader.start()
    try:
        with_reader = one_pass()
    finally:
        stop.set()
        reader.join()
    shapes = [tuple(b["image"].shape[1:3]) for b in device_batches]
    log(f"[{tag}] the host loader alone: {host_ms:.2f} ms a batch of 16 (read, decode, "
        f"collate; {len(device_batches)} batches)")
    log(f"[{tag}] train step on pre-loaded batches of the records (buckets {shapes}): alone "
        f"{', '.join(f'{t:.2f}' for t in alone)} ms; while a host thread read "
        f"{host_batches[0]} batches: {', '.join(f'{t:.2f}' for t in with_reader)} ms")
    return dict(shapes=shapes, alone_ms=alone, with_host_reader_ms=with_reader,
                host_ms_per_batch=host_ms)


def request_picture(rs, h: int, w: int) -> np.ndarray:
    """An image with smooth gradients and six flat rectangles: what JPEG
    keeps well, so JPEG and PNG inputs of it are comparable."""
    yy, xx = np.mgrid[0:h, 0:w]
    image = np.stack([yy * 200 // h + 20, xx * 200 // w + 20,
                      (yy + xx) * 100 // (h + w) + 60], -1).astype(np.uint8)
    for _ in range(6):
        y0, x0 = rs.randint(0, h - 100), rs.randint(0, w - 100)
        image[y0:y0 + rs.randint(40, 200), x0:x0 + rs.randint(40, 250)] = rs.randint(0, 256, 3)
    return image


def matched_share(a, b, k: int = 20) -> float:
    """The share of a's k best detections that b has too: the same class
    and IoU >= 0.5 with one of b's detections."""
    from mtlx_torch.geometry import np_box_ops

    na, nb = int(a["num_detections"][0]), int(b["num_detections"][0])
    top = np.argsort(-a["detection_scores"][0][:na], kind="stable")[:k]
    if not len(top) or not nb:
        return float(len(top) == 0)
    iou = np_box_ops.iou(a["detection_boxes"][0][top], b["detection_boxes"][0][:nb])
    same = a["detection_classes"][0][top][:, None] == b["detection_classes"][0][:nb][None]
    return float(((iou >= 0.5) & same).any(1).mean())


def check_serving_inputs(served, image, want):
    """Serve one 600x800 image (at its resizer target) as pixels, as PNG and
    JPEG bytes and as a tf.Example of the JPEG: detections from the same
    decoded pixels must be equal, and the JPEG's pixels within a mean
    absolute difference of 2.0 of the image's."""
    from mtlx_torch.data import imgcodec
    from mtlx_torch.data.example_decoder import build_example

    h, w = image.shape[:2]
    png, jpg = imgcodec.encode_png(image), encode_jpeg(image)
    example = build_example(jpg, b"jpeg", h, w, "request.jpg", np.zeros((0, 4)), [], [])
    decoded = imgcodec.decode_jpeg(jpg, h, w)
    via_pixels = served.predict_images([decoded])
    timings = {}

    def timed(name, fn, arg):
        fn(arg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(arg)
        timings[name] = (time.perf_counter() - t0) * 1e3
        return out

    cases = {"png bytes": (timed("predict_encoded_images png", served.predict_encoded_images,
                                 [png]), want),
             "jpeg bytes": (timed("predict_encoded_images jpeg", served.predict_encoded_images,
                                  [jpg]), via_pixels),
             "tf.Example": (timed("predict_tf_examples", served.predict_tf_examples, [example]),
                            via_pixels)}
    timed("predict_images", served.predict_images, [image])
    for name, (got, ref) in cases.items():
        if not all(np.array_equal(got[k], ref[k]) for k in ref):
            raise AssertionError(f"serving the {name} differs from predict_images on the same "
                                 "decoded pixels")
    diff = np.abs(decoded.astype(np.int32) - image.astype(np.int32))
    share = matched_share(want, via_pixels)
    log(f"[cli] one 600x800 image served as pixels, PNG bytes, JPEG bytes and a tf.Example: "
        f"equal detections from the same decoded pixels; the JPEG (quality 90, {len(jpg)} "
        f"bytes) decodes within {diff.mean():.4f} mean, {int(diff.max())} max of the PNG's "
        f"pixels; detections {int(want['num_detections'][0])} (PNG) and "
        f"{int(via_pixels['num_detections'][0])} (JPEG), {share:.2f} of the PNG's 20 best "
        f"matched in the JPEG's (same class, IoU >= 0.5); ms a request "
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()))
    if not diff.mean() <= 2.0:
        raise AssertionError(f"the JPEG decodes {diff.mean():.3f} from the image's pixels on "
                             "average (tolerance 2.0)")
    return dict(jpeg_mean_abs=float(diff.mean()), jpeg_max_abs=int(diff.max()),
                matched_share=share, request_ms=timings)


def check_train_events(train_dir: str, lines):
    """The train CLI's event files must hold every logged step's losses,
    grad_norm and learning_rate: the printed values (rounded to 4
    decimals) and learning_rate exactly, as float32."""
    import glob

    from mtlx_torch.utils.summary_writer import read_events

    paths = sorted(glob.glob(os.path.join(train_dir, "events.out.tfevents.*")))
    scalars = {}
    for path in paths:
        for event in read_events(path):
            for tag, value in event.get("values", []):
                scalars[(event["step"], tag)] = value
    for line in lines:
        step = line["step"]
        for key, value in line.items():
            if key.startswith("Loss/") or key in ("total_loss", "grad_norm"):
                got = scalars.get((step, key))
                if got is None or abs(got - value) > 5e-5 + 1e-6 * abs(value):
                    raise AssertionError(f"event files: {key} at step {step} is {got}, the "
                                         f"line printed {value}")
        if scalars.get((step, "learning_rate")) != float(np.float32(line["learning_rate"])):
            raise AssertionError(f"event files: learning_rate at step {step} is "
                                 f"{scalars.get((step, 'learning_rate'))}")
    log(f"[cli] {len(paths)} event files hold the losses, grad_norm and learning_rate of all "
        f"{len(lines)} logged steps ({len(scalars)} scalars)")


def check_profile_trace(train_dir: str, step: int):
    """The `--profile_from` trace must exist and hold the card's kernels."""
    path = os.path.join(train_dir, "profile", f"trace_to_step_{step}.json")
    with open(path) as f:
        trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    log(f"[cli] --profile_from trace {os.path.basename(path)}: {len(kernels)} kernels, "
        f"{busy:.2f} ms of kernel time, {os.path.getsize(path) / 2**20:.1f} MiB")
    if not kernels:
        raise AssertionError(f"the profiler trace {path} holds no kernel")


def record_kernel_inputs(fn):
    """Run fn() with the inputs of every call of the four kernel wrappers
    recorded (record_calls): {kernel: [(args, kwargs)]}. For a reading
    outside the runs whose launches are counted."""
    from mtlx_torch.kernels import iou_cuda, nms_cuda, roi_cuda

    targets = [("nms", nms_cuda, "non_max_suppression"),
               ("roi_crop", roi_cuda, "crop_and_resize"),
               ("roi_crop_backward", roi_cuda, "crop_and_resize_backward"),
               ("iou", iou_cuda, "iou_matrix")]
    calls = {}

    def run(i):
        if i == len(targets):
            return fn()
        name, module, attr = targets[i]
        calls[name] = record_calls(lambda: run(i + 1), module, attr)

    run(0)
    return calls


def check_kernels_on(calls, tag: str):
    """Each recorded kernel call against its plain version on the same
    inputs: NMS selections and the crop and IoU bit-equal, the crop
    backward within its stated tolerance."""
    from mtlx_torch.kernels import iou_cuda, nms_cuda, roi_cuda

    shapes = {}
    for args, kw in calls["nms"]:
        got = nms_cuda.non_max_suppression(*args, **kw)
        ref = nms_cuda.non_max_suppression_plain(*args, **kw)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"NMS differs from its plain version at {tag}")
        shapes.setdefault("nms", []).append(f"{'x'.join(map(str, args[1].shape))}->{args[3]}")
    for args, _ in calls["roi_crop"]:
        features, boxes, crop_size = args[:3]  # extrapolation 0 (the wrapper raises otherwise)
        got = roi_cuda.crop_and_resize(features, boxes, crop_size)
        if not torch.equal(got, roi_cuda.crop_and_resize_plain(features, boxes, crop_size)):
            raise AssertionError(f"the crop differs from its plain version at {tag}")
        shapes.setdefault("roi_crop", []).append(
            f"{'x'.join(map(str, features.shape))}x{boxes.shape[1]}->{crop_size[0]}x"
            f"{crop_size[1]} {str(features.dtype)[6:]}")
    for (dout, boxes, hw), _ in calls["roi_crop_backward"]:
        # phase 3's tolerance: 1e-4 of each pixel's sum of term magnitudes,
        # and in bfloat16 one bfloat16 ulp of the float32 result on top
        ref = roi_cuda.crop_and_resize_backward_plain(dout.float(), boxes, hw)
        err = (roi_cuda.crop_and_resize_backward(dout, boxes, hw).float() - ref).abs()
        tol = _bwd_tolerance(roi_cuda, dout, boxes, hw)
        if dout.dtype == torch.bfloat16:
            tol = tol + torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
        if not bool((err <= tol).all()):
            raise AssertionError(f"the crop backward is off by {float(err.max())} at {tag}")
        shapes.setdefault("roi_crop_backward", []).append(
            f"{'x'.join(map(str, dout.shape))}->{hw[0]}x{hw[1]} {str(dout.dtype)[6:]}")
    for (b1, b2), _ in calls["iou"]:
        if not torch.equal(iou_cuda.iou_matrix(b1, b2), iou_cuda.iou_matrix_plain(b1, b2)):
            raise AssertionError(f"the IoU differs from its plain version at {tag}")
        shapes.setdefault("iou", []).append(f"{b1.shape[0]}x{b1.shape[1]}x{b2.shape[1]}")
    torch.cuda.synchronize()
    log(f"[check] {tag}: every recorded kernel call equals its plain version: {shapes}")
    return shapes


def train_step_calls(pipeline: str, train_dir: str, seed: int):
    """One train step of the latest checkpoint in train_dir on one batch of
    the pipeline's records, with every kernel call's inputs recorded.
    Returns (calls, step_fn, state, batch, generator): what the step ran
    on, for a caller that takes another."""
    from mtlx_torch.builders import model_builder, optimizer_builder, preprocessor_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.loader import DetectionDataset, batches
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_lib
    from mtlx_torch.train import train_step as ts

    configs = config_util.get_configs_from_pipeline_file(pipeline)
    train_config = configs["train_config"]
    model = model_builder.build(configs["model"], is_training=True,
                                max_gt_boxes=train_config.max_number_of_boxes or 100,
                                device="cuda")
    tx, _, _ = optimizer_builder.build(train_config.optimizer, train_config)
    state = ckpt_lib.CheckpointManager(train_dir).restore(ts.create_train_state(model, tx))
    reader = configs["train_input_config"]
    dataset = DetectionDataset(
        list(reader.tf_record_input_reader.input_path),
        model.cfg.canvas_size,
        model_builder.resizer_params(model_builder.image_resizer(configs["model"])),
        max_boxes=model.cfg.max_gt_boxes,
        load_instance_masks=reader.load_instance_masks and model.cfg.predict_instance_masks,
        num_keypoints=reader.num_keypoints)
    batch = next(batches(dataset, train_config.batch_size, seed=seed, pack_images=True))
    dataset.close()
    keep = ("image", "true_shape", "gt_boxes", "gt_classes", "gt_mask", "gt_instance_masks",
            "gt_keypoints")
    batch = {k: torch.from_numpy(batch[k]).cuda() for k in keep if k in batch}
    step_fn = train_lib.make_step_fn(
        model, preprocessor_builder.build(train_config.data_augmentation_options))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = record_kernel_inputs(lambda: step_fn(state, batch, generator=gen))
    return calls, step_fn, state, batch, gen


def phase_learnability(seed: int, results):
    """The learnability tool, Faster R-CNN fixed and keep-aspect and SSD
    fixed, 300 steps each on the card in this process; each mAP@0.5 must
    reach the tool's bar (0.5 for Faster R-CNN, 0.3 for SSD, as mtlx's
    tool), and each run must launch every kernel as its steps and eval
    batches call for."""
    import shutil
    import tempfile

    from mtlx_torch.tools import synthetic_e2e_check as tool

    runs = {}
    # 300 steps at batch 8, and 24 eval images in 3 batches of 8: Faster
    # R-CNN runs NMS once a step and twice an eval batch, crops once each and
    # assigns three times a step; SSD assigns once a step and runs NMS once
    # an eval batch
    frcnn = {"nms": 300 + 2 * 3, "roi_crop": 300 + 3, "roi_crop_backward": 300, "iou": 3 * 300}
    ssd = {"nms": 3, "roi_crop": 0, "roi_crop_backward": 0, "iou": 300}
    for tag, extra, want, bar in (("fixed", [], frcnn, 0.5),
                                  ("keep_aspect", ["--keep_aspect"], frcnn, 0.5),
                                  ("ssd", ["--model", "ssd"], ssd, 0.3)):
        work = tempfile.mkdtemp(prefix=f"mtlx_learn_{tag}_")
        try:
            reset_kernel_counts()
            t0 = time.perf_counter()
            out, metrics = run_cli(tool.main, ["--workdir", work, *extra])
            wall = time.perf_counter() - t0
            counts = kernel_counts()
            lines = train_log_lines(out)
            if counts != want:
                raise AssertionError(f"learnability {tag}: launches {counts}, want {want}")
            lr_line = next(ln for ln in out.splitlines()
                           if ln.startswith("[synthetic-e2e] learning rate"))
            ms = [8 / ln["images_per_sec"] * 1e3 for ln in lines if ln["step"] > 1]
            losses = {ln["step"]: {k: v for k, v in ln.items()
                                   if k.startswith("Loss/") or k == "total_loss"}
                      for ln in lines}
            mean_ap = metrics["Precision/mAP@0.5IOU"]
            log(f"[learn] {tag}: mAP@0.5 {mean_ap:.4f} after 300 steps (bar {bar}), "
                f"{lr_line.split('] ', 1)[1]}; ms a step over each 50 "
                f"{', '.join(f'{t:.2f}' for t in ms)}; total_loss by step "
                f"{ {s: l['total_loss'] for s, l in losses.items()} }; launches {counts}; "
                f"{wall:.1f} s (records, both CLIs)")
            calls = train_step_calls(os.path.join(work, "pipeline.config"),
                                     os.path.join(work, "train"), seed)[0]
            shapes = check_kernels_on(calls, tag)
            runs[tag] = dict(map=mean_ap, ms_per_step=ms, losses=losses, launches=counts,
                             lr=lr_line, wall_s=wall, shapes=shapes,
                             eval_img_per_s=metrics["eval/images_per_sec"])
        finally:
            shutil.rmtree(work, ignore_errors=True)
    results["learnability"] = runs


def phase_cli(seed: int, results):
    """Train, resume, evaluate and export the flagship from TFRecords
    through the port's CLIs, in this process."""
    import shutil
    import tempfile

    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.loader import DetectionDataset, batches
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_cli
    from mtlx_torch.train import train_step as ts

    jpeg = check_jpeg_on_card()
    work = tempfile.mkdtemp(prefix="mtlx_cli_")
    try:
        t0 = time.perf_counter()
        record = write_records(os.path.join(work, "voc_noise.record"),
                               np.random.RandomState(seed + 8), 64, "jpeg", VOC_SIZES)
        png_record = write_records(os.path.join(work, "voc_noise_png.record"),
                                   np.random.RandomState(seed + 10), 16, "png", VOC_TARGETS)
        label_map = os.path.join(work, "label_map.pbtxt")
        with open(label_map, "w") as f:
            f.writelines(f"item {{ id: {i + 1} name: '{n}' }}\n" for i, n in enumerate(VOC_NAMES))
        fine_tune = os.path.join(work, "warm_start")
        pipeline = os.path.join(work, "pipeline.config")
        with open(pipeline, "w") as f:
            f.write(cli_pipeline(record, label_map, fine_tune))
        log(f"[cli] wrote 64 JPEG records at VOC's sizes ({os.path.getsize(record) / 2**20:.1f} "
            f"MiB), 16 PNG records at their resizer targets "
            f"({os.path.getsize(png_record) / 2**20:.1f} MiB) and the pipeline in "
            f"{time.perf_counter() - t0:.2f} s")

        # the warm start: the CLI's own init (same seed), batch norm
        # calibrated on one batch of the records
        configs = config_util.get_configs_from_pipeline_file(pipeline)
        model = model_builder.build(configs["model"], is_training=True, device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        dataset = DetectionDataset([record], model.cfg.canvas_size,
                                   model_builder.resizer_params(
                                       model_builder.image_resizer(configs["model"])))
        first = next(batches(dataset, 16, seed=seed, pack_images=True))
        dataset.close()
        calibrate_batch_norm_on(model, torch.from_numpy(first["image"]).cuda(),
                                torch.from_numpy(first["true_shape"]).cuda())
        manager = ckpt_lib.CheckpointManager(fine_tune)
        manager.save(0, ts.create_train_state(model, ts.make_optimizer()))
        manager.wait()
        results["cli_steps_without_loader"] = time_steps_without_loader(model, record, seed)
        png_ms = loader_ms(png_record, model.cfg.canvas_size)
        log(f"[cli] the host loader on 16 PNG records at their resizer targets, pass after "
            f"pass: {', '.join(f'{t:.2f}' for t in png_ms)} ms a batch of 16")
        del model, manager
        torch.cuda.empty_cache()

        train_dir = os.path.join(work, "train")
        runs = {}
        for tag, steps, extra in (("first", 6, []),
                                  ("resumed", 8, ["--profile_from", "6", "--profile_steps", "1"])):
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, _ = run_cli(train_cli.main, ["--pipeline_config_path", pipeline,
                                              "--train_dir", train_dir, "--num_steps", str(steps),
                                              "--log_every", "1", "--seed", str(seed), *extra])
            runs[tag] = dict(out=out, wall=time.perf_counter() - t0, counts=kernel_counts(),
                             peak=torch.cuda.max_memory_allocated(), lines=train_log_lines(out))
        first_run, resumed = runs["first"], runs["resumed"]
        if "warm start: " not in first_run["out"]:
            raise AssertionError("the first train run did not warm-start")
        if "resumed from step 6" not in resumed["out"] or \
                "[train] done at step 8" not in resumed["out"]:
            raise AssertionError("the second train run did not resume from step 6 and stop at 8")
        steps_taken = {"first": 6, "resumed": 2}
        per_step = {"nms": 1, "roi_crop": 1, "roi_crop_backward": 1, "iou": 3}
        for tag, run in runs.items():
            n = steps_taken[tag]
            got = {k: v / n for k, v in run["counts"].items()}
            log(f"[cli] train {tag} run: {n} steps in {run['wall']:.2f} s (CLI wall, build and "
                f"checkpoints included), launches {run['counts']} = {got} a step, peak memory "
                f"{run['peak'] / 2**30:.2f} GiB")
            if got != per_step:
                raise AssertionError(f"train CLI launches a step {got}, want {per_step}")
            for line in run["lines"]:
                bad = [k for k, v in line.items() if not np.isfinite(v)]
                if bad:
                    raise AssertionError(f"non-finite train metrics at step {line['step']}: {bad}")
        lines = first_run["lines"] + resumed["lines"]
        for line in lines:
            ips = line["images_per_sec"]
            log(f"[cli] step {line['step']}: {16 / ips * 1e3:.2f} ms ({ips:.2f} img/s), "
                f"loader wait share {line['loader_wait_share']:.4f}, total_loss "
                f"{line['total_loss']:.5g}")
        check_train_events(train_dir, lines)
        check_profile_trace(train_dir, 7)

        eval_dir = os.path.join(work, "eval")
        reset_kernel_counts()
        out, metrics = run_cli(eval_cli.main, ["--pipeline_config_path", pipeline,
                                               "--checkpoint_dir", train_dir,
                                               "--eval_dir", eval_dir, "--run_once"])
        eval_counts = kernel_counts()
        mean_ap = metrics["Precision/mAP@0.5IOU"]
        eval_ips = metrics["eval/images_per_sec"]
        log(f"[cli] eval at step 8: mAP@0.5 {mean_ap:.6g}, {eval_ips:.2f} img/s, launches "
            f"{eval_counts} over 8 batches of 8")
        if "[eval] step 8: " not in out or not np.isfinite(mean_ap):
            raise AssertionError(f"the eval CLI gave no finite mAP (mAP {mean_ap})")
        if eval_counts["nms"] < 8 or eval_counts["roi_crop"] < 8:
            raise AssertionError(f"the eval CLI did not launch NMS and the crop: {eval_counts}")

        export_dir = os.path.join(work, "export")
        t0 = time.perf_counter()
        out, _ = run_cli(exporter.main, ["--pipeline_config_path", pipeline,
                                         "--trained_checkpoint_dir", train_dir,
                                         "--output_directory", export_dir])
        export_s = time.perf_counter() - t0
        with open(os.path.join(export_dir, exporter.METADATA_FILE)) as f:
            metadata = json.load(f)
        if metadata["step"] != 8:
            raise AssertionError(f"the export CLI exported step {metadata['step']}, not 8")
        t0 = time.perf_counter()
        served = InferenceModel.load(export_dir)
        load_s = time.perf_counter() - t0
        configs = config_util.get_configs_from_pipeline_file(pipeline)
        in_memory = model_builder.build(configs["model"], is_training=False, device="cuda")
        ckpt_lib.CheckpointManager(train_dir).restore(ts.TrainState(0, in_memory, None, None),
                                                      params_only=True)
        in_memory = InferenceModel(in_memory, served.resizer, device="cuda")
        image = request_picture(np.random.RandomState(seed + 9), 600, 800)
        t0 = time.perf_counter()
        a = served.predict_images([image])
        first_request_ms = (time.perf_counter() - t0) * 1e3
        b = in_memory.predict_images([image])
        same = all(np.array_equal(a[k], b[k]) for k in a)
        log(f"[cli] export CLI {export_s:.2f} s (metadata {metadata}), InferenceModel.load on "
            f"the card {load_s:.2f} s, its first request {first_request_ms:.2f} ms; it served "
            f"{int(a['num_detections'][0])} detections, equal to the in-memory model's: {same}")
        if not same:
            raise AssertionError("the exported model's detections differ from the in-memory model's")
        check_outputs(a, 1)
        serving = check_serving_inputs(served, image, a)
        results["cli"] = dict(
            train_step_ms=[16 / ln["images_per_sec"] * 1e3 for ln in lines],
            train_img_per_s=[ln["images_per_sec"] for ln in lines],
            loader_wait_share=[ln["loader_wait_share"] for ln in lines],
            train_peak_bytes=max(r["peak"] for r in runs.values()),
            train_launches_per_step={k: v / 6 for k, v in first_run["counts"].items()},
            eval_map=mean_ap, eval_img_per_s=eval_ips,
            eval_launches_per_batch={k: v / 8 for k, v in eval_counts.items()},
            jpeg=jpeg, png_loader_ms=png_ms, export_s=export_s,
            load_s=load_s, serving=serving)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 10

COCO_CONFIG = "configs/faster_rcnn_resnet101_mtl_coco.config"
COCO_LABEL_MAP = "mtlx_torch/data/label_maps/mscoco_label_map.pbtxt"
# COCO's common image sizes (height, width): 640x480, 480x640, 640x427
# and 427x640 (w x h)
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (640, 427))
REPO = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def repo_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def coco_categories():
    from mtlx_torch.utils import label_map_util

    return list(label_map_util.create_category_index_from_labelmap(
        os.path.join(REPO, COCO_LABEL_MAP)).values())


def write_coco_records(path: str, rs, n: int, sizes=COCO_SIZES) -> str:
    """n TFRecords of uint8 noise JPEGs (quality 90) at the given sizes in
    turn (COCO's by default), 1-20 boxes each over the 80 ids COCO uses; a tenth of the boxes
    crowd (difficult, as COCO's iscrowd reaches the loader) and a tenth
    group-of."""
    from mtlx_torch.data import tfrecord
    from mtlx_torch.data.example_decoder import build_example

    cats = coco_categories()
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            h, wd = sizes[i % len(sizes)]
            image = rs.randint(0, 256, (h, wd, 3)).astype(np.uint8)
            k = rs.randint(1, 21)
            y0, x0 = rs.uniform(0, 0.8, k), rs.uniform(0, 0.8, k)
            boxes = np.stack([y0, x0, np.minimum(y0 + rs.uniform(0.05, 0.5, k), 1.0),
                              np.minimum(x0 + rs.uniform(0.05, 0.5, k), 1.0)], 1)
            picked = [cats[j] for j in rs.randint(0, len(cats), k)]
            w.write(build_example(encode_jpeg(image), b"jpeg", h, wd, f"coco{i}.jpg", boxes,
                                  [c["id"] for c in picked], [c["name"] for c in picked],
                                  difficult=(rs.uniform(size=k) < 0.1).astype(int),
                                  group_of=(rs.uniform(size=k) < 0.1).astype(int)))
    return path


def coco_pipeline(record: str, fine_tune: str) -> str:
    """The R101 COCO pipeline text with its input paths, label map,
    fine_tune_checkpoint, checkpoint interval and eval size replaced, and
    the OpenImages and Pascal metrics beside the COCO ones."""
    with open(os.path.join(REPO, COCO_CONFIG)) as f:
        text = f.read()
    label_map = os.path.join(REPO, COCO_LABEL_MAP)
    for old, new in (('"/data/coco/coco_train.record"', json.dumps(record)),
                     ('"/data/coco/coco_val.record"', json.dumps(record)),
                     ('"/data/coco/mscoco_label_map.pbtxt"', json.dumps(label_map)),
                     ('fine_tune_checkpoint: ""', f"fine_tune_checkpoint: {json.dumps(fine_tune)}"),
                     ("save_checkpoints_steps: 2000", "save_checkpoints_steps: 3"),
                     ("num_examples: 5000", "num_examples: 16"),
                     ('metrics_set: "coco_detection_metrics"',
                      'metrics_set: "coco_detection_metrics"\n'
                      '  metrics_set: "open_images_V2_detection_metrics"\n'
                      '  metrics_set: "pascal_voc_detection_metrics"')):
        if old not in text:
            raise AssertionError(f"{COCO_CONFIG} no longer holds {old}")
        text = text.replace(old, new)
    return text


def run_distributed_train(pipeline: str, train_dir: str, steps: int, seed: int,
                          nproc: int = 1, extra=()):
    """The train CLI under `torch.distributed.run --nproc_per_node=nproc`
    with `--distributed` (NCCL, rank r on cuda:r); echoes and returns its
    output and wall seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={nproc}",
           "--master_addr=127.0.0.1", f"--master_port={free_port()}",
           "-m", "mtlx_torch.train.train", "--distributed", "--pipeline_config_path", pipeline,
           "--train_dir", train_dir, "--num_steps", str(steps), "--log_every", "1",
           "--seed", str(seed), *extra]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO,
                         env=repo_env())
    wall = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        log(f"  | {line}")
    if run.returncode != 0:
        raise AssertionError(f"the distributed train CLI exited {run.returncode}:\n"
                             f"{run.stderr[-4000:]}")
    return run.stdout, wall


def time_library_calls(results):
    """torchvision's NMS and box IoU on phase 3's main-path inputs, where
    the machine has torchvision; None where it has not."""
    try:
        import torchvision
    except ImportError as e:
        log(f"[coco] torchvision: not on this machine ({e}); no single torch call computes "
            "greedy NMS with max_out or the pairwise IoU, so the library column stays null")
        return None
    boxes, scores, valid, k, thr = results["nms_inputs"]
    b, s = boxes[0][valid[0]], scores[0][valid[0]]
    nms_ms = cuda_ms(lambda: torchvision.ops.nms(b, s, thr)[:k], 200)
    b1, b2 = results["iou_inputs"]
    iou_ms = cuda_ms(lambda: [torchvision.ops.box_iou(x, y) for x, y in zip(b1, b2)], 20)
    log(f"[coco] torchvision {torchvision.__version__}: ops.nms at {tuple(s.shape)} -> {k} "
        f"{nms_ms:.4f} ms, ops.box_iou over {b1.shape[0]} problems {iou_ms:.4f} ms")
    return dict(version=torchvision.__version__, nms_ms=nms_ms, box_iou_loop_ms=iou_ms)


# one rank of the rank check: the R101 COCO model in float32 (TF32 off)
# with the weights the parent wrote, one step on its rows of the global
# batch on the device and over the backend named by argv[3:5]; saves its
# parameters, metrics and the second stage's sampled proposals
_RANK_STEP = r"""
import sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from mtlx_torch.builders import model_builder
from mtlx_torch.config import config_util
from mtlx_torch.parallel import distributed
from mtlx_torch.train import train_step as ts

data = torch.load(sys.argv[1], weights_only=False)
device, replicas = distributed.init_process_group(sys.argv[3], backend=sys.argv[4])
configs = config_util.get_configs_from_pipeline_file(data["config"])
model = model_builder.build(configs["model"], is_training=True, dtype=torch.float32,
                            device=device)
model.modules.load_state_dict(data["weights"])
state = ts.create_train_state(model, ts.make_optimizer(learning_rate=data["lr"]))
batch = {k: replicas.rows(v).to(device) for k, v in data["batch"].items()}
gen = torch.Generator(device=device).manual_seed(data["seed"])
image = batch["image"]
draws = ts.rank_rows(ts.make_draws(model, ts.global_rows(image.shape[0], replicas),
                                   tuple(image.shape[1:3]), gen,
                                   num_gt=batch["gt_boxes"].shape[1]), replicas)
gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"].long(),
      "mask": batch["gt_mask"]}
with torch.no_grad():  # SSD samples no proposals
    proposals = model.predict_train(model.preprocess(image.float()), batch["true_shape"], gt,
                                    draws).get("proposal_boxes", torch.zeros(0))
state, metrics = ts.make_train_step(model, replicas=replicas)(state, batch, draws=draws)
torch.save({"metrics": {k: v.cpu() for k, v in metrics.items()},
            "params": {k: v.detach().cpu() for k, v in model.modules.state_dict().items()},
            "proposals": proposals.cpu()},
           f"{sys.argv[2]}.{replicas.rank}")
distributed.destroy_process_group()
"""


def run_ranks(script: str, args, world: int, backend: str, out: str):
    """Run `script` in `world` processes with argv [*args, out, device,
    backend] (over gloo all on cuda:0, since NCCL refuses two ranks on one
    card; over NCCL rank r on cuda:r); returns each rank's saved results
    (out.<rank>) and the wall seconds."""
    device = "cuda:0" if backend == "gloo" else "cuda"
    port = free_port()
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        env = dict(repo_env(), RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, *args, out, device, backend], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError(f"a rank over {backend} failed:\n"
                             + "\n".join(text[-3000:] for text in logs))
    return [torch.load(f"{out}.{r}") for r in range(world)], wall


def same_params(ranks, tag: str, key: str = "params") -> None:
    """Raise unless every rank's parameters equal rank 0's bit for bit."""
    for other in ranks[1:]:
        for name, value in ranks[0][key].items():
            if not torch.equal(value, other[key][name]):
                raise AssertionError(f"{tag}: the ranks' {name} differ")


def spawn_ranks(work: str, data: str, world: int, backend: str):
    """_RANK_STEP in `world` processes (run_ranks); the ranks' parameters
    must be bitwise equal."""
    ranks, wall = run_ranks(_RANK_STEP, [data], world, backend,
                            os.path.join(work, f"ranks_{backend}_out.pt"))
    same_params(ranks, f"{world} ranks over {backend}")
    return ranks, wall


def compare_steps(tag: str, got, want, tol):
    """Hold one step's total_loss and sum of |parameter| (`got`, rank 0's)
    within `tol` relative of `want`'s (None: only printed); logs every
    loss term and the largest difference of a sampled second-stage
    proposal's coordinates (pixels) between the two."""
    loss = [float(got["metrics"]["total_loss"]), float(want["metrics"]["total_loss"])]
    checksum = [sum(float(v.double().abs().sum()) for v in r["params"].values())
                for r in (got, want)]
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in (loss, checksum)]
    terms = {k: (float(got["metrics"][k]), float(v)) for k, v in want["metrics"].items()
             if k.startswith("Loss/")}
    diff = (got["proposals"] - want["proposals"]).abs()
    moved = float(diff.max()) if diff.numel() else 0.0
    log(f"[ranks] {tag}: total_loss {loss[0]:.7g} vs {loss[1]:.7g} (rel {rel[0]:.3g}), sum "
        f"|param| {checksum[0]:.10g} vs {checksum[1]:.10g} (rel {rel[1]:.3g}), tolerance "
        f"{tol if tol is not None else 'none (printed only)'}; sampled proposals differ by up "
        f"to {moved:.3g} px; terms {terms}")
    if tol is not None and max(rel) > tol:
        raise AssertionError(f"{tag}: off by {rel} (loss, checksum), tolerance {tol}")
    return dict(loss=loss, checksum=checksum, rel=rel, proposals_max_abs_px=moved)


def check_ranks_on_cards(work: str, seed: int, world: int = 2, backend: str = "gloo"):
    """`world` ranks each take one float32 step (TF32 off) of the R101
    COCO model on their 2 rows of a global batch of 2 x world (256x384
    bucket) whose ranks hold different counts of boxes; their parameters
    must be bitwise equal. At world size 2 over gloo (both on cuda:0) the
    loss and the sum of |parameter| must be within 1e-4 relative of one
    rank's step on the whole batch. Over NCCL (rank r on cuda:r) they
    must be within 1e-6 relative of the same ranks over gloo, with the
    same sampled proposals: both compute the same rows at the same batch
    size and differ only in the all-reduce's order of addition. Above
    world size 2 the one-rank step is printed beside them, not held: at
    a batch of 8 float32 rounding of the whole batch's convolutions
    moved its loss by 3.7e-4 relative in the first four-card call, in the
    box classifier's classification term (PERF.md)."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.train import train_step as ts

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        config = os.path.join(REPO, COCO_CONFIG)
        configs = config_util.get_configs_from_pipeline_file(config)
        model = model_builder.build(configs["model"], is_training=True, dtype=torch.float32,
                                    device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        batch = train_batch(np.random.RandomState(seed + 12), 2 * world, canvas=(256, 384),
                            sizes=((200, 256), (260, 384)))
        batch["gt_classes"] = batch["gt_classes"] * 4  # COCO's ids, 0..76
        # rank 0's rows hold 21 boxes, rank 1's 3, and so on in turn
        for i in range(2 * world):
            k = (12, 9, 2, 1)[i % 4]
            batch["gt_mask"][i, k:] = False
            batch["gt_mask"][i, :k] = True
        calibrate_batch_norm_on(model, batch["image"], batch["true_shape"])
        weights = {k: v.detach().cpu() for k, v in model.modules.state_dict().items()}
        lr, step_seed = 0.003, seed + 13
        data = os.path.join(work, "ranks.pt")
        torch.save({"config": config, "weights": weights, "lr": lr, "seed": step_seed,
                    "batch": {k: v.cpu() for k, v in batch.items()}}, data)

        # one rank on the whole batch, with the same draws
        state = ts.create_train_state(model, ts.make_optimizer(learning_rate=lr))
        gen = torch.Generator(device="cuda").manual_seed(step_seed)
        image = batch["image"]
        draws = ts.make_draws(model, image.shape[0], tuple(image.shape[1:3]), gen,
                              num_gt=batch["gt_boxes"].shape[1])
        gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"].long(),
              "mask": batch["gt_mask"]}
        with torch.no_grad():
            proposals = model.predict_train(model.preprocess(image.float()), batch["true_shape"],
                                            gt, draws)["proposal_boxes"]
        state, metrics = ts.make_train_step(model)(state, batch, draws=draws)
        one = {"metrics": metrics, "proposals": proposals.cpu(),
               "params": {k: v.detach().cpu() for k, v in model.modules.state_dict().items()}}
        del model, state
        torch.cuda.empty_cache()
        # each rank's proposals are its rows of the global batch's
        rows = lambda ranks: torch.cat([r["proposals"] for r in ranks])

        gloo, wall = spawn_ranks(work, data, world, "gloo")
        log(f"[ranks] {world} ranks over gloo on cuda:0 ({wall:.1f} s): parameters bitwise equal "
            "across ranks")
        out = {"gloo_vs_one": compare_steps(f"{world} gloo ranks vs one rank",
                                            dict(gloo[0], proposals=rows(gloo)), one,
                                            1e-4 if world == 2 else None),
               "gloo_wall_s": wall}
        if backend == "nccl":
            nccl, wall = spawn_ranks(work, data, world, "nccl")
            log(f"[ranks] {world} ranks over NCCL, rank r on cuda:r ({wall:.1f} s): parameters "
                "bitwise equal across ranks")
            out["nccl_vs_one"] = compare_steps(f"{world} NCCL ranks vs one rank",
                                               dict(nccl[0], proposals=rows(nccl)), one,
                                               1e-4 if world == 2 else None)
            out["nccl_vs_gloo"] = compare_steps(f"{world} NCCL ranks vs {world} gloo ranks",
                                                dict(nccl[0], proposals=rows(nccl)),
                                                dict(gloo[0], proposals=rows(gloo)), 1e-6)
            if out["nccl_vs_gloo"]["proposals_max_abs_px"]:
                raise AssertionError("NCCL and gloo ranks sampled other proposals")
            out["nccl_wall_s"] = wall
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def eval_batch_calls(pipeline: str, train_dir: str):
    """One eval batch of 8 records through the eval CLI's detect on the
    trained checkpoint, with every kernel call's inputs recorded."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.loader import DetectionDataset, pack_batch_images
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train_step as ts

    configs = config_util.get_configs_from_pipeline_file(pipeline)
    model = model_builder.build(configs["model"], is_training=False, device="cuda")
    ckpt_lib.CheckpointManager(train_dir).restore(ts.TrainState(0, model, None, None),
                                                  params_only=True)
    dataset = DetectionDataset(
        list(configs["eval_input_config"].tf_record_input_reader.input_path),
        model.cfg.canvas_size,
        model_builder.resizer_params(model_builder.image_resizer(configs["model"])))
    samples = dataset.get_batch(list(range(8)), decode_threads=2)
    dataset.close()
    shapes = np.stack([s["true_shape"] for s in samples])
    images = pack_batch_images(np.stack([s["image"] for s in samples]), shapes)
    return record_kernel_inputs(lambda: eval_cli.detect(model, images, shapes))


def coco_workdir(work: str, seed: int, n: int, sizes=COCO_SIZES) -> str:
    """n COCO-like JPEG records, the R101 COCO pipeline pointing at them,
    and its fine_tune_checkpoint: the CLI's own init (same seed) with
    batch norm calibrated on one batch of the records. Returns the
    pipeline's path."""
    t0 = time.perf_counter()
    record = write_coco_records(os.path.join(work, "coco_noise.record"),
                                np.random.RandomState(seed + 11), n, sizes)
    fine_tune = os.path.join(work, "warm_start")
    pipeline = os.path.join(work, "pipeline.config")
    with open(pipeline, "w") as f:
        f.write(coco_pipeline(record, fine_tune))
    log(f"[coco] wrote {n} JPEG records at {sizes} "
        f"({os.path.getsize(record) / 2**20:.1f} MiB) and the R101 COCO pipeline in "
        f"{time.perf_counter() - t0:.2f} s")
    write_warm_start(pipeline, record, fine_tune, seed)  # the config's batch: 16
    return pipeline


def check_distributed_train(pipeline: str, train_dir: str, seed: int, nproc: int = 1,
                            extra=()):
    """6 steps at batch 16 of the train CLI over NCCL with nproc ranks:
    finite metrics, and each step launching NMS, the crop and its
    backward once and the IoU three times on rank 0. Returns its [train]
    lines, its summary and the launches a step."""
    out, wall = run_distributed_train(pipeline, train_dir, 6, seed, nproc, extra)
    if f"world size {nproc} over nccl" not in out or "[train] done at step 6" not in out:
        raise AssertionError(f"the train CLI did not run 6 steps over NCCL at world size {nproc}")
    summary = json.loads(out.split("[train] summary ", 1)[1].splitlines()[0])
    per_step = {k: v / 6 for k, v in summary["kernel_launches"].items()}
    want = {"nms": 1, "roi_crop": 1, "roi_crop_backward": 1, "iou": 3}
    lines = train_log_lines(out)
    for line in lines:
        bad = [k for k, v in line.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite train metrics at step {line['step']}: {bad}")
        ips = line["images_per_sec"]
        log(f"[coco] {nproc} rank(s), step {line['step']}: {16 / ips * 1e3:.2f} ms ({ips:.2f} "
            f"img/s), loader wait share {line['loader_wait_share']:.4f}, total_loss "
            f"{line['total_loss']:.7g}")
    log(f"[coco] train CLI over NCCL at world size {nproc}: 6 steps at batch 16 in {wall:.2f} s "
        f"(launcher, build and checkpoints included), peak memory on rank 0 "
        f"{summary['peak_memory_gib']:.2f} GiB, launches on rank 0 {summary['kernel_launches']} "
        f"= {per_step} a step")
    if per_step != want:
        raise AssertionError(f"R101 train CLI launches a step {per_step}, want {want}")
    return lines, summary, per_step


def phase_data_parallel(seed: int, world: int, results):
    """`--data_parallel N` (N cards): the R101 COCO train CLI over NCCL at
    world size 1 and N in one call, on 64 records of one size (one
    bucket) in a fixed order, so both take the same 16 records a step
    (rank r's are records r, r + N, ...: the rows come in another order,
    so the flip draws fall on other images); then N NCCL ranks, one a
    card, of one float32 step against N gloo ranks and one rank
    (check_ranks_on_cards); at N = 4 also the (data=2, spatial=2) and
    (data_dcn=2, data=2) grids and four flat ranks over NCCL against the
    same over gloo and one rank (check_grids_on_cards)."""
    import shutil
    import tempfile

    if torch.cuda.device_count() < world:
        raise AssertionError(f"--data_parallel {world} needs {world} cards, "
                             f"this machine has {torch.cuda.device_count()}")
    work = tempfile.mkdtemp(prefix="mtlx_dp_")
    try:
        pipeline = coco_workdir(work, seed, 64, sizes=((480, 640),))
        runs = {}
        for nproc in (1, world):
            lines, summary, per_step = check_distributed_train(
                pipeline, os.path.join(work, f"train{nproc}"), seed, nproc, ["--deterministic"])
            runs[nproc] = dict(step_ms=[16 / ln["images_per_sec"] * 1e3 for ln in lines],
                               total_loss=[ln["total_loss"] for ln in lines],
                               peak_memory_gib=summary["peak_memory_gib"],
                               launches_per_step=per_step)
        results["data_parallel"] = dict(runs=runs,
                                        ranks=check_ranks_on_cards(work, seed, world, "nccl"),
                                        grids=check_grids_on_cards(work, seed, ("gloo", "nccl"))
                                        if world == 4 else None)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_coco(seed: int, results):
    """BASELINE config 5: the R101 3-task MTL on COCO-sized JPEG records,
    trained through `torch.distributed.run --nproc_per_node=1 ...
    --distributed` (NCCL), evaluated through the eval CLI with the COCO,
    OpenImages and Pascal metrics, exported and served; then two ranks of
    one float32 step on the card over gloo against one rank."""
    import shutil
    import tempfile

    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel
    from mtlx_torch.train import checkpoints as ckpt_lib

    work = tempfile.mkdtemp(prefix="mtlx_coco_")
    try:
        pipeline = coco_workdir(work, seed, 32)
        train_dir = os.path.join(work, "train")
        lines, summary, per_step = check_distributed_train(pipeline, train_dir, seed)
        if ckpt_lib.CheckpointManager(train_dir).all_steps() != [3, 6]:
            raise AssertionError("the distributed train CLI wrote other checkpoints than 3, 6")

        eval_dir = os.path.join(work, "eval")
        reset_kernel_counts()
        out, metrics = run_cli(eval_cli.main, ["--pipeline_config_path", pipeline,
                                               "--checkpoint_dir", train_dir,
                                               "--eval_dir", eval_dir, "--run_once"])
        eval_counts = kernel_counts()
        eval_per_batch = {k: v / 2 for k, v in eval_counts.items()}
        keys = ("DetectionBoxes_Precision/mAP", "DetectionBoxes_Precision/mAP@.50IOU",
                "DetectionBoxes_Precision/mAP@.75IOU", "DetectionBoxes_Recall/AR@1",
                "DetectionBoxes_Recall/AR@10", "DetectionBoxes_Recall/AR@100",
                "OpenImagesV2_Precision/mAP@0.5IOU", "Precision/mAP@0.5IOU")
        shown = {k: metrics[k] for k in keys}
        log(f"[coco] eval at step 6 ({len(metrics)} metrics): {shown}; "
            f"{metrics['eval/images_per_sec']:.2f} img/s; launches {eval_counts} = "
            f"{eval_per_batch} a batch of 8")
        bad = [k for k in keys if not np.isfinite(metrics[k])]
        if "[eval] step 6: " not in out or bad:
            raise AssertionError(f"the eval CLI gave non-finite metrics {bad}")
        if eval_per_batch != {"nms": 2, "roi_crop": 1, "roi_crop_backward": 0, "iou": 0}:
            raise AssertionError(f"eval launches a batch {eval_per_batch}")

        # every kernel call of one eval batch against its plain version;
        # the postprocess's 8 x 90 problems of 300 -> 100 timed
        calls = eval_batch_calls(pipeline, train_dir)
        shapes = check_kernels_on(calls, "R101 COCO eval batch")
        # the postprocess passes all six arguments by position
        postprocess_nms = time_recorded_nms(
            next(args for args, _ in calls["nms"] if args[1].shape[0] == 8 * 90),
            "R101 COCO postprocess")

        export_dir = os.path.join(work, "export")
        t0 = time.perf_counter()
        run_cli(exporter.main, ["--pipeline_config_path", pipeline,
                                "--trained_checkpoint_dir", train_dir,
                                "--output_directory", export_dir])
        export_s = time.perf_counter() - t0
        served = InferenceModel.load(export_dir)
        image = request_picture(np.random.RandomState(seed + 14), 480, 640)
        served.predict_images([image])  # warm-up
        t0 = time.perf_counter()
        det = served.predict_images([image])
        request_ms = (time.perf_counter() - t0) * 1e3
        check_outputs(det, 1)
        n_det = int(det["num_detections"][0])
        classes = det["detection_classes"][0][:n_det]
        log(f"[coco] export CLI {export_s:.2f} s; one 640x480 request served in "
            f"{request_ms:.2f} ms: {n_det} detections over classes "
            f"{int(classes.min()) if n_det else '-'}..{int(classes.max()) if n_det else '-'}")
        if n_det and (classes.min() < 1 or classes.max() > 90):
            raise AssertionError(f"served classes outside COCO's 1..90: {classes}")

        two_ranks = check_ranks_on_cards(work, seed)
        results["coco"] = dict(
            train_step_ms=[16 / ln["images_per_sec"] * 1e3 for ln in lines],
            train_img_per_s=[ln["images_per_sec"] for ln in lines],
            loader_wait_share=[ln["loader_wait_share"] for ln in lines],
            peak_memory_gib=summary["peak_memory_gib"], train_launches_per_step=per_step,
            eval_metrics=shown, eval_img_per_s=metrics["eval/images_per_sec"],
            eval_launches_per_batch=eval_per_batch, eval_shapes=shapes,
            postprocess_nms=postprocess_nms,
            export_s=export_s, request_ms=request_ms, two_ranks=two_ranks,
            library=time_library_calls(results))
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 11

# the rest of the two-stage family: (config, image sizes of its dataset,
# the train CLI's launches a step, the eval CLI's launches a batch)
_TRUNK_LAUNCHES = ({"nms": 1, "roi_crop": 1, "roi_crop_backward": 1, "iou": 3},
                   {"nms": 2, "roi_crop": 1, "roi_crop_backward": 0, "iou": 0})
_RFCN_LAUNCHES = ({"nms": 1, "roi_crop": 2, "roi_crop_backward": 2, "iou": 3},
                  {"nms": 2, "roi_crop": 2, "roi_crop_backward": 0, "iou": 0})
TWO_STAGE = (
    ("rfcn_resnet101_voc07", "voc") + _RFCN_LAUNCHES,
    ("faster_rcnn_inception_v2_voc07", "voc") + _TRUNK_LAUNCHES,
    ("faster_rcnn_inception_resnet_v2_mtl_coco", "coco") + _TRUNK_LAUNCHES,
)
TWO_STAGE_STEPS = (4, 6)  # the first run, then the restart to step 6


def two_stage_pipeline(name: str, record: str, label_map: str, fine_tune: str) -> str:
    """configs/<name>.config with only its paths (records, label map, a
    fine_tune_checkpoint), its checkpoint interval (2) and its eval size
    (16) changed."""
    path = os.path.join(REPO, "configs", f"{name}.config")
    with open(path) as f:
        text = f.read()
    data = "voc" if "voc" in name else "coco"
    reps = [(f'"/data/{data}/{old}"', json.dumps(new)) for old, new in (
        ("pascal_train_voc0712.record", record), ("pascal_train_voc07.record", record),
        ("pascal_test_voc07.record", record), ("coco_train.record", record),
        ("coco_val.record", record), ("pascal_label_map.pbtxt", label_map),
        ("mscoco_label_map.pbtxt", label_map))]
    reps += [("num_examples: 4952", "num_examples: 16"), ("num_examples: 5000", "num_examples: 16"),
             ("save_checkpoints_steps: 2000\n", ""), ('fine_tune_checkpoint: ""\n', "")]
    for old, new in reps:
        text = text.replace(old, new)
    for gone in ('"/data/voc/', '"/data/coco/', "num_examples: 4952", "num_examples: 5000", "fine_tune_checkpoint:",
                 "save_checkpoints_steps:"):
        if gone in text:
            raise AssertionError(f"{path}: {gone!r} left after the replacements")
    return text.replace("train_config: {", "train_config: {\n  save_checkpoints_steps: 2\n"
                        f"  fine_tune_checkpoint: {json.dumps(fine_tune)}", 1)


def two_stage_workdir(work: str, name: str, data: str, seed: int, n: int = 32) -> str:
    """n JPEG records at the dataset's sizes, the label map, the pipeline
    and its fine_tune_checkpoint: the CLI's own init (same seed) with
    batch norm calibrated on one batch of the records. Returns the
    pipeline's path."""
    rs = np.random.RandomState(seed + 15)
    record = os.path.join(work, f"{data}_noise.record")
    if data == "voc":
        write_records(record, rs, n, "jpeg", VOC_SIZES)
        label_map = os.path.join(work, "voc_label_map.pbtxt")
        with open(label_map, "w") as f:
            f.writelines(f"item {{ id: {i + 1} name: '{v}' }}\n" for i, v in enumerate(VOC_NAMES))
    else:
        write_coco_records(record, rs, n)
        label_map = os.path.join(REPO, COCO_LABEL_MAP)
    fine_tune = os.path.join(work, "warm_start")
    pipeline = os.path.join(work, "pipeline.config")
    with open(pipeline, "w") as f:
        f.write(two_stage_pipeline(name, record, label_map, fine_tune))
    write_warm_start(pipeline, record, fine_tune, seed)
    return pipeline


def calibrated_model(pipeline: str, record: str, seed: int):
    """The pipeline's training model on the card with the train CLI's own
    init (same seed) and batch norm calibrated on one batch of the records."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.loader import DetectionDataset, batches

    configs = config_util.get_configs_from_pipeline_file(pipeline)
    model = model_builder.build(configs["model"], is_training=True, device="cuda")
    model.init_weights(torch.Generator().manual_seed(seed))
    dataset = DetectionDataset([record], model.cfg.canvas_size, model_builder.resizer_params(
        model_builder.image_resizer(configs["model"])))
    first = next(batches(dataset, configs["train_config"].batch_size, seed=seed, pack_images=True))
    dataset.close()
    calibrate_batch_norm_on(model, torch.from_numpy(first["image"]).cuda(),
                            torch.from_numpy(first["true_shape"]).cuda())
    return model


def write_warm_start(pipeline: str, record: str, fine_tune: str, seed: int) -> None:
    """The pipeline's fine_tune_checkpoint: `calibrated_model`, as step 0
    of a port checkpoint directory."""
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train_step as ts

    model = calibrated_model(pipeline, record, seed)
    manager = ckpt_lib.CheckpointManager(fine_tune)
    manager.save(0, ts.create_train_state(model, ts.make_optimizer()))
    manager.wait()
    del model, manager
    torch.cuda.empty_cache()


def trunk_card_vs_cpu(name: str, seed: int):
    """One float32 forward (TF32 off) of the config's proposal and box
    classifier features on the card and on the CPU with the same seeded
    weights: a 600x800 request on its 640x896 bucket, and 16 crops of the
    second stage's size. Returns the largest difference over the largest
    magnitude of each; fails above 1e-4."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        configs = config_util.get_configs_from_pipeline_file(
            os.path.join(REPO, "configs", f"{name}.config"))
        gpu = model_builder.build(configs["model"], is_training=False, dtype=torch.float32,
                                  device="cuda")
        gpu.init_weights(torch.Generator().manual_seed(seed))
        cpu = model_builder.build(configs["model"], is_training=False, dtype=torch.float32,
                                  device="cpu")
        cpu.modules.load_state_dict(gpu.modules.state_dict())
        image = np.zeros((1, 640, 896, 3), np.float32)
        image[0, :600, :800] = request_picture(np.random.RandomState(seed + 16), 600, 800)
        x = cpu.preprocess(torch.from_numpy(image))
        cs = gpu.cfg.initial_crop_size
        pool = gpu.cfg.maxpool_stride if gpu.cfg.maxpool_kernel_size > 1 else 1
        width = gpu.modules.backbone.out_channels
        rs = np.random.RandomState(seed + 17)
        crops = torch.from_numpy(rs.normal(0, 1, (16, cs // pool, cs // pool, width))
                                 .astype(np.float32))
        out = {}
        for part, inp in (("backbone", x), ("classifier_backbone", crops)):
            with torch.no_grad():
                want = getattr(cpu.modules, part)(inp)
                got = getattr(gpu.modules, part)(inp.cuda()).cpu()
            rel = float((got - want).abs().max() / want.abs().max())
            out[part] = dict(shape=list(want.shape), rel=rel)
            if not rel <= 1e-4:
                raise AssertionError(f"{name} {part}: card and CPU differ by {rel} of the "
                                     "largest magnitude (tolerance 1e-4)")
        log(f"[two-stage] {name}: float32 card vs CPU, TF32 off: " + ", ".join(
            f"{k} {v['shape']} within {v['rel']:.3g} of the largest magnitude"
            for k, v in out.items()))
        del gpu, cpu
        torch.cuda.empty_cache()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def time_ps_crop(calls):
    """The R-FCN serving request's two crop launches (class maps, box
    maps: every bin of the image in one launch) timed beside their plain
    version and F.grid_sample on the same points, with the bound of each."""
    from mtlx_torch.kernels import roi_cuda

    out = []
    for (features, boxes, crop_size), _ in calls:
        run_k = lambda: roi_cuda.crop_and_resize(features, boxes, crop_size)
        run_p = lambda: roi_cuda.crop_and_resize_plain(features, boxes, crop_size)
        if not torch.equal(run_k(), run_p()):
            raise AssertionError("the PS crop launch differs from its plain version")
        ms, plain_ms = cuda_ms(run_k, 200), cuda_ms(run_p, 20)
        library_ms = grid_sample_ms(features, boxes, int(crop_size[0]))
        b, h, w, c = features.shape
        n = boxes.shape[1]
        outputs = b * n * crop_size[0] * crop_size[1] * c
        pixels = crop_pixels_read(boxes, tuple(int(v) for v in crop_size), h, w)
        nbytes = pixels * c * 4 + boxes.numel() * 4 + outputs * 4
        bound, by = bound_ms(nbytes, outputs * ROI_OPS_PER_ELEMENT)
        out.append(dict(shape=f"{b}x{h}x{w}x{c}x{n}->{crop_size[0]}x{crop_size[1]} float32",
                        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                        bound_by=by, vector_path=c % 4 == 0))
        log(f"[ps-crop] {out[-1]['shape']} ({'float4' if c % 4 == 0 else 'scalar'} path): "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")
    return out


def time_train_crops(calls, tag: str):
    """The crop forward and backward launches of a recorded train step,
    each timed beside its bound, its plain version and the library call
    (F.grid_sample forward, through time_crop, and its d(input))."""
    from mtlx_torch.kernels import roi_cuda

    rows = [time_crop(features, boxes, int(crop_size[0]), f"{tag} train step", plain_reps=3)
            for (features, boxes, crop_size), _ in calls["roi_crop"]]
    for (dout, boxes, hw), _ in calls["roi_crop_backward"]:
        b, n, ch, cw, c = dout.shape
        elt = dout.element_size()
        ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward(dout, boxes, hw), 20)
        plain_ms = cuda_ms(lambda: roi_cuda.crop_and_resize_backward_plain(dout, boxes, hw), 3)
        library_ms = grid_sample_backward_ms(dout, boxes, hw)
        # every dout element read once, d(features) written once; 4 taps of
        # a multiply and an add per element
        t_bound, by = bound_ms(nbytes=dout.numel() * elt + boxes.numel() * 4
                               + b * hw[0] * hw[1] * c * elt, ops=dout.numel() * 8)
        shape = f"{b}x{n}x{ch}x{cw}x{c}->{hw[0]}x{hw[1]} {str(dout.dtype)[6:]}"
        log(f"[roi-bwd] {tag} train step {shape}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"grid_sampler_2d_backward {library_ms:.4f} ms, bound {t_bound:.4f} ms ({by})")
        rows.append(dict(shape=shape, backward=True, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=t_bound, bound_by=by))
    return rows


def run_two_stage(name: str, data: str, train_want, eval_want, seed: int):
    """One config through the CLIs on the card: train (first run and a
    restart), eval, export and a request through the bundle; one train
    step and one eval batch recorded and held to the plain versions."""
    import shutil
    import tempfile

    from mtlx_torch.config import config_util
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel
    from mtlx_torch.kernels import roi_cuda
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_cli

    work = tempfile.mkdtemp(prefix="mtlx_two_stage_")
    try:
        t0 = time.perf_counter()
        pipeline = two_stage_workdir(work, name, data, seed)
        setup_s = time.perf_counter() - t0
        train_dir = os.path.join(work, "train")
        runs = []
        for steps in TWO_STAGE_STEPS:
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, _ = run_cli(train_cli.main, ["--pipeline_config_path", pipeline, "--train_dir",
                                              train_dir, "--num_steps", str(steps),
                                              "--log_every", "1", "--seed", str(seed)])
            runs.append(dict(out=out, wall=time.perf_counter() - t0, counts=kernel_counts(),
                             peak=torch.cuda.max_memory_allocated(), lines=train_log_lines(out)))
        first, again = runs
        if "warm start: " not in first["out"]:
            raise AssertionError(f"{name}: the first train run did not warm-start")
        if f"resumed from step {TWO_STAGE_STEPS[0]}" not in again["out"] or \
                f"[train] done at step {TWO_STAGE_STEPS[1]}" not in again["out"]:
            raise AssertionError(f"{name}: the restart did not resume and finish")
        if ckpt_lib.CheckpointManager(train_dir).all_steps() != [2, 4, 6]:
            raise AssertionError(f"{name}: checkpoints {ckpt_lib.CheckpointManager(train_dir).all_steps()}")
        per_step = {}
        for run, n in zip(runs, (TWO_STAGE_STEPS[0], TWO_STAGE_STEPS[1] - TWO_STAGE_STEPS[0])):
            per_step = {k: v / n for k, v in run["counts"].items()}
            if per_step != train_want:
                raise AssertionError(f"{name}: train launches a step {per_step}, want {train_want}")
            for line in run["lines"]:
                bad = [k for k, v in line.items() if not np.isfinite(v)]
                if bad:
                    raise AssertionError(f"{name}: non-finite train metrics at step "
                                         f"{line['step']}: {bad}")
        lines = first["lines"] + again["lines"]
        bs = config_util.get_configs_from_pipeline_file(pipeline)["train_config"].batch_size
        step_ms = [bs / ln["images_per_sec"] * 1e3 for ln in lines]
        peak_gib = max(r["peak"] for r in runs) / 2**30
        log(f"[two-stage] {name}: train {TWO_STAGE_STEPS[0]} steps + restart to "
            f"{TWO_STAGE_STEPS[1]} at batch {bs} ({first['wall']:.2f} + {again['wall']:.2f} s "
            f"CLI wall); step ms {[round(t, 2) for t in step_ms]}; img/s "
            f"{[round(ln['images_per_sec'], 2) for ln in lines]}; loader wait share "
            f"{[round(ln['loader_wait_share'], 4) for ln in lines]}; peak {peak_gib:.2f} GiB; "
            f"launches a step {per_step}; total_loss "
            f"{[round(ln['total_loss'], 5) for ln in lines]}")

        eval_dir = os.path.join(work, "eval")
        reset_kernel_counts()
        out, metrics = run_cli(eval_cli.main, ["--pipeline_config_path", pipeline,
                                               "--checkpoint_dir", train_dir,
                                               "--eval_dir", eval_dir, "--run_once"])
        eval_per_batch = {k: v / 2 for k, v in kernel_counts().items()}
        keys = [k for k in ("Precision/mAP@0.5IOU", "DetectionBoxes_Precision/mAP",
                            "DetectionBoxes_Precision/mAP@.50IOU") if k in metrics]
        shown = {k: metrics[k] for k in keys}
        log(f"[two-stage] {name}: eval at step {TWO_STAGE_STEPS[1]} on 16 records: {shown}; "
            f"{metrics['eval/images_per_sec']:.2f} img/s; launches a batch of 8 {eval_per_batch}")
        if not keys or not all(np.isfinite(v) for v in shown.values()):
            raise AssertionError(f"{name}: the eval CLI gave no finite metrics: {shown}")
        if eval_per_batch != eval_want:
            raise AssertionError(f"{name}: eval launches a batch {eval_per_batch}, want {eval_want}")

        calls, step_fn, state, batch, gen = train_step_calls(pipeline, train_dir, seed)
        _, profile = profile_train_step(step_fn, state, batch, gen)
        del step_fn, state, batch
        torch.cuda.empty_cache()
        shapes = {"train": check_kernels_on(calls, f"{name} train step"),
                  "eval": check_kernels_on(eval_batch_calls(pipeline, train_dir),
                                           f"{name} eval batch")}
        crop_times = time_train_crops(calls, name)
        eval_calls = eval_batch_calls(pipeline, train_dir)
        nms_iou_times = {
            "nms": [time_recorded_nms(args, f"{name} {part}") for part, recorded in
                    (("train step", calls), ("eval batch", eval_calls))
                    for args, _ in recorded["nms"]],
            "iou": [time_iou(b1, b2, f"{name} train step") for (b1, b2), _ in calls["iou"]]}
        del calls, eval_calls
        torch.cuda.empty_cache()

        export_dir = os.path.join(work, "export")
        t0 = time.perf_counter()
        run_cli(exporter.main, ["--pipeline_config_path", pipeline, "--trained_checkpoint_dir",
                                train_dir, "--output_directory", export_dir])
        export_s = time.perf_counter() - t0
        served = InferenceModel.load(export_dir)
        h, w = (480, 640) if data == "coco" else (375, 500)
        image = request_picture(np.random.RandomState(seed + 18), h, w)
        served.predict_images([image])  # warm-up
        t0 = time.perf_counter()
        crops = record_calls(lambda: served.predict_images([image]), roi_cuda, "crop_and_resize")
        request_ms = (time.perf_counter() - t0) * 1e3
        det = served.predict_images([image])
        k = served.model.cfg.second_stage_max_total_detections
        check_outputs(det, 1, k)
        n_det = int(det["num_detections"][0])
        classes = det["detection_classes"][0][:n_det]
        top = 90 if data == "coco" else 20
        log(f"[two-stage] {name}: export CLI {export_s:.2f} s; one {w}x{h} request through the "
            f"bundle ({request_ms:.2f} ms with its crop inputs recorded): {n_det} detections "
            f"over classes {int(classes.min()) if n_det else '-'}..{int(classes.max()) if n_det else '-'}")
        if n_det and (classes.min() < 1 or classes.max() > top):
            raise AssertionError(f"{name}: served classes outside 1..{top}: {classes}")
        result = dict(step_ms=step_ms, img_per_s=[ln["images_per_sec"] for ln in lines],
                      loader_wait_share=[ln["loader_wait_share"] for ln in lines],
                      peak_memory_gib=peak_gib, batch_size=bs, setup_s=setup_s,
                      train_launches_per_step=per_step, eval_metrics=shown,
                      eval_img_per_s=metrics["eval/images_per_sec"],
                      eval_launches_per_batch=eval_per_batch, shapes=shapes,
                      train_crop_times=crop_times, nms_iou_times=nms_iou_times,
                      train_profile=profile, export_s=export_s,
                      request_ms=request_ms, detections=n_det)
        if name.startswith("rfcn"):
            result["ps_crop"] = time_ps_crop(crops)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_two_stage(seed: int, results):
    """R-FCN R101 and the Inception-v2 and Inception-ResNet-v2 Faster
    R-CNNs: each trunk's float32 forward on the card against the CPU,
    then each config through the train, eval and export CLIs and a
    request through its bundle."""
    out = {}
    for name, data, train_want, eval_want in TWO_STAGE:
        t0 = time.perf_counter()
        r = run_two_stage(name, data, train_want, eval_want, seed)
        if "inception" in name:
            r["card_vs_cpu"] = trunk_card_vs_cpu(name, seed)
        r["wall_s"] = time.perf_counter() - t0
        log(f"[two-stage] {name}: {r['wall_s']:.1f} s")
        out[name] = r
    results["two_stage"] = out


# ---------------------------------------------------------------- phase 12

# the single-shot family: (config, the train CLI's launches a step, the eval
# CLI's launches a batch of 8). A step crops once (ssd_random_crop's window
# resample of the batch) and compares boxes once (the whole batch's ground
# truth against the 1917 anchors); an eval batch runs NMS once (every class
# of every image).
SSD_CONFIGS = (
    ("ssd_mobilenet_v1_voc", {"nms": 0, "roi_crop": 1, "roi_crop_backward": 0, "iou": 1},
     {"nms": 1, "roi_crop": 0, "roi_crop_backward": 0, "iou": 0}),
    ("ssd_inception_v2_voc", {"nms": 0, "roi_crop": 1, "roi_crop_backward": 0, "iou": 1},
     {"nms": 1, "roi_crop": 0, "roi_crop_backward": 0, "iou": 0}),
)
SSD_STEPS = (4, 6)  # the first run, then the restart to step 6
# operations an element of the live batch norm's forward and backward: the
# paired sums (a square and two adds), the folded affine (a multiply-add),
# the backward's paired sums (a multiply and two adds) and its affine (two
# multiply-adds and an add)
LIVE_BN_OPS_PER_ELEMENT = 12


def ssd_pipeline(name: str, record: str, label_map: str) -> str:
    """configs/<name>.config with only its paths (records, label map), its
    checkpoint interval (2) and its eval size (16) changed."""
    path = os.path.join(REPO, "configs", f"{name}.config")
    with open(path) as f:
        text = f.read()
    for old, new in (('"/data/voc/pascal_train_voc0712.record"', json.dumps(record)),
                     ('"/data/voc/pascal_test_voc07.record"', json.dumps(record)),
                     ('"/data/voc/pascal_label_map.pbtxt"', json.dumps(label_map)),
                     ("num_examples: 4952", "num_examples: 16")):
        if old not in text:
            raise AssertionError(f"{path} no longer holds {old}")
        text = text.replace(old, new)
    return text.replace("train_config: {", "train_config: {\n  save_checkpoints_steps: 2", 1)


def time_recorded_nms(args, tag: str):
    """A recorded NMS call: equal to its plain version, timed beside its
    plain version and its bound (every pick made plus the empty pick that
    ends a problem early, each a pass over the N boxes)."""
    from mtlx_torch.kernels import nms_cuda

    boxes, scores, valid, k, thr, score_thr = args[:6]
    run_k = lambda: nms_cuda.non_max_suppression(boxes, scores, valid, k, thr, score_thr)
    run_p = lambda: nms_cuda.non_max_suppression_plain(boxes, scores, valid, k, thr, score_thr)
    got, ref = run_k(), run_p()
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"NMS differs from its plain version at {tag}")
    p, n = scores.shape
    picks = got[1].sum(1)
    steps = int(torch.clamp(picks + 1, max=k).sum())
    t_bound, by = bound_ms(nbytes=p * n * (16 + 4 + 1) + p * k * (4 + 1),
                           ops=steps * n * NMS_OPS_PER_BOX_STEP)
    ms, plain_ms = cuda_ms(run_k, 100), cuda_ms(run_p, 3)
    shape = f"{p}x{n}->{k}"
    log(f"[nms] {tag} {shape} (IoU {thr}): equal to its plain version; {int(picks.sum())} picks "
        f"from {int(valid.sum())} live rows; {ms:.4f} ms a call, plain {plain_ms:.3f} ms, "
        f"bound {t_bound:.5f} ms ({by}), library null")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                max_abs_err=0.0, picks=int(picks.sum()))


def ssd_card_vs_cpu(name: str, seed: int, depth_multiplier=None):
    """One float32 training-mode forward (TF32 off, live batch norm on the
    batch's statistics) of the config's SSD (at another depth_multiplier
    where one is given) on the card and on the CPU with the same seeded
    weights, two 300x300 pictures: the trunk's two endpoints and the
    heads' class and box outputs within 1e-4 of the largest magnitude of
    each."""
    import dataclasses

    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.detector.ssd import SSD

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        configs = config_util.get_configs_from_pipeline_file(
            os.path.join(REPO, "configs", f"{name}.config"))
        gpu = model_builder.build(configs["model"], is_training=True, dtype=torch.float32,
                                  device="cuda")
        if depth_multiplier is not None:
            gpu = SSD(dataclasses.replace(gpu.cfg, depth_multiplier=depth_multiplier), "cuda")
            name = f"{name} x {depth_multiplier}"
        gpu.init_weights(torch.Generator().manual_seed(seed))
        cpu = SSD(gpu.cfg, device="cpu")
        cpu.modules.load_state_dict(gpu.modules.state_dict())
        rs = np.random.RandomState(seed + 19)
        images = np.stack([request_picture(rs, 300, 300) for _ in range(2)]).astype(np.float32)
        x = cpu.preprocess(torch.from_numpy(images))
        out = {}
        with torch.no_grad():
            for model in (gpu, cpu):
                model.modules.train()
            want_ends = cpu.modules.backbone(x)
            got_ends = gpu.modules.backbone(x.cuda())
            want = cpu.modules(x)[:2]
            got = gpu.modules(x.cuda())[:2]
        for part, g, w in (("endpoint_16", got_ends[0], want_ends[0]),
                           ("endpoint_32", got_ends[1], want_ends[1]),
                           ("class_predictions", got[0], want[0]),
                           ("box_encodings", got[1], want[1])):
            rel = float((g.cpu() - w).abs().max() / w.abs().max())
            out[part] = dict(shape=list(w.shape), rel=rel)
            if not rel <= 1e-4:
                raise AssertionError(f"{name} {part}: card and CPU differ by {rel} of the "
                                     "largest magnitude (tolerance 1e-4)")
        log(f"[ssd] {name}: float32 card vs CPU, TF32 off, live batch norm: " + ", ".join(
            f"{k} {v['shape']} within {v['rel']:.3g} of the largest magnitude"
            for k, v in out.items()))
        del gpu, cpu
        torch.cuda.empty_cache()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def live_batch_norm_on_card(seed: int):
    """LiveBatchNorm at SSD MobileNet's largest batch norm (conv1_pw_bn:
    32 x 64 x 150 x 150, channels-last as the model lays it out): in
    float32 its output, input and parameter gradients and moving
    statistics on the card within 1e-4 of the largest magnitude of the
    same function on the CPU; in bfloat16 its forward and backward timed
    beside F.batch_norm's (cuDNN) on the same tensors, with their bound."""
    from mtlx_torch.backbones.resnet import LiveBatchNorm

    gen = torch.Generator().manual_seed(seed + 20)
    shape = (32, 64, 150, 150)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5)
    dy = torch.randn(shape, generator=gen)
    ws = dict(scale=torch.rand(64, generator=gen) + 0.5, bias=torch.randn(64, generator=gen),
              mean=torch.randn(64, generator=gen) * 0.1, var=torch.rand(64, generator=gen) + 0.5)

    def run(device, dtype):
        bn = LiveBatchNorm(64, momentum=0.9997, epsilon=1e-3).to(device)
        bn.load_state_dict(ws)
        xx = x.to(device, dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
        y = bn(xx)
        y.backward(dy.to(device, dtype).contiguous(memory_format=torch.channels_last))
        bn.commit()
        return bn, xx, y

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, want = run("cuda", torch.float32), run("cpu", torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = {}
    for tag, g, w in (("y", got[2], want[2]), ("dx", got[1].grad, want[1].grad),
                      ("dscale", got[0].scale.grad, want[0].scale.grad),
                      ("dbias", got[0].bias.grad, want[0].bias.grad),
                      ("mean", got[0].mean, want[0].mean), ("var", got[0].var, want[0].var)):
        errs[tag] = float((g.detach().cpu() - w.detach()).abs().max() / w.abs().max())
        if not errs[tag] <= 1e-4:
            raise AssertionError(f"LiveBatchNorm {tag}: card and CPU differ by {errs[tag]} of "
                                 "the largest magnitude (tolerance 1e-4)")
    del got, want

    xb = x.cuda().to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dyb = dy.cuda().to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bn = LiveBatchNorm(64, momentum=0.9997, epsilon=1e-3).cuda().train()
    xr = xb.detach().requires_grad_()

    def live():
        bn(xr).backward(dyb)

    weight = torch.ones(64, device="cuda", requires_grad=True)
    bias = torch.zeros(64, device="cuda", requires_grad=True)
    running = torch.zeros(64, device="cuda"), torch.ones(64, device="cuda")

    def library():
        F.batch_norm(xr, *running, weight, bias, training=True, momentum=0.0003,
                     eps=1e-3).backward(dyb)

    # in turns: library, live, live, library
    lib = [cuda_ms(library, 20)]
    ms = [cuda_ms(live, 20), cuda_ms(live, 20)]
    lib.append(cuda_ms(library, 20))
    n = xb.numel()
    t_bound, by = bound_ms(nbytes=5 * n * 2, ops=n * LIVE_BN_OPS_PER_ELEMENT)
    row = dict(name="live_batch_norm", shape="x".join(map(str, shape)) + " bfloat16 channels-last",
               ms=min(ms), ms_runs=ms, library_ms=min(lib), library_runs=lib, bound_ms=t_bound,
               bound_by=by, card_vs_cpu_f32=errs)
    log(f"[live-bn] {row['shape']}: float32 card vs CPU within {max(errs.values()):.3g} of the "
        f"largest magnitude ({errs}); forward + backward {ms[0]:.4f} / {ms[1]:.4f} ms, "
        f"F.batch_norm {lib[0]:.4f} / {lib[1]:.4f} ms, bound {t_bound:.4f} ms ({by})")
    return row


def check_ssd_ranks(work: str, seed: int):
    """Two ranks over gloo, both on cuda:0, each take one float32 step
    (TF32 off) of SSD MobileNet on its 2 rows of a global batch of 4
    (300x300, ssd_random_crop off), with live batch norm summing its
    statistics over the ranks: their parameters bitwise equal, the loss and
    the sum of |parameter| (moving statistics included) within 1e-4
    relative of one rank's step on the whole batch."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.train import train_step as ts

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        config = os.path.join(REPO, "configs", "ssd_mobilenet_v1_voc.config")
        configs = config_util.get_configs_from_pipeline_file(config)
        model = model_builder.build(configs["model"], is_training=True, dtype=torch.float32,
                                    device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        batch = train_batch(np.random.RandomState(seed + 21), 4, canvas=(300, 300),
                            sizes=((300, 300), (300, 300)))
        for i, k in enumerate((12, 9, 2, 1)):  # the ranks' rows hold 21 and 3 boxes
            batch["gt_mask"][i, k:] = False
        weights = {k: v.detach().cpu() for k, v in model.modules.state_dict().items()}
        lr = 0.003
        data = os.path.join(work, "ssd_ranks.pt")
        torch.save({"config": config, "weights": weights, "lr": lr, "seed": seed,
                    "batch": {k: v.cpu() for k, v in batch.items()}}, data)
        state = ts.create_train_state(model, ts.make_optimizer(learning_rate=lr))
        state, metrics = ts.make_train_step(model)(state, batch)
        one = {"metrics": metrics, "proposals": torch.zeros(0),
               "params": {k: v.detach().cpu() for k, v in model.modules.state_dict().items()}}
        del model, state
        torch.cuda.empty_cache()
        gloo, wall = spawn_ranks(work, data, 2, "gloo")
        log(f"[ssd-ranks] 2 ranks over gloo on cuda:0 ({wall:.1f} s): parameters and moving "
            "statistics bitwise equal across ranks")
        return dict(compare_steps("SSD MobileNet: 2 gloo ranks vs one rank", gloo[0], one, 1e-4),
                    wall_s=wall)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run_ssd(name: str, train_want, eval_want, seed: int):
    """One SSD config through the CLIs on the card: 32 noise JPEGs at VOC's
    sizes, train (first run and a restart) at the config's batch of 32
    with ssd_random_crop, eval on 16 records, export and a request through
    the bundle; one train step and one eval batch recorded, held to the
    plain versions and their launches timed."""
    import shutil
    import tempfile

    from mtlx_torch.builders import preprocessor_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_cli

    work = tempfile.mkdtemp(prefix="mtlx_ssd_")
    try:
        rs = np.random.RandomState(seed + 22)
        record = write_records(os.path.join(work, "voc_noise.record"), rs, 32, "jpeg", VOC_SIZES)
        label_map = os.path.join(work, "voc_label_map.pbtxt")
        with open(label_map, "w") as f:
            f.writelines(f"item {{ id: {i + 1} name: '{v}' }}\n" for i, v in enumerate(VOC_NAMES))
        pipeline = os.path.join(work, "pipeline.config")
        with open(pipeline, "w") as f:
            f.write(ssd_pipeline(name, record, label_map))
        train_config = config_util.get_configs_from_pipeline_file(pipeline)["train_config"]
        bs = train_config.batch_size
        options = [n for n, _ in preprocessor_builder.build(
            train_config.data_augmentation_options)]
        if bs != 32 or options != ["random_horizontal_flip", "ssd_random_crop"]:
            raise AssertionError(f"{name}: batch {bs}, options {options}")
        train_dir = os.path.join(work, "train")
        runs = []
        for steps in SSD_STEPS:
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, _ = run_cli(train_cli.main, ["--pipeline_config_path", pipeline, "--train_dir",
                                              train_dir, "--num_steps", str(steps),
                                              "--log_every", "1", "--seed", str(seed)])
            runs.append(dict(out=out, wall=time.perf_counter() - t0, counts=kernel_counts(),
                             peak=torch.cuda.max_memory_allocated(), lines=train_log_lines(out)))
        first, again = runs
        if f"resumed from step {SSD_STEPS[0]}" not in again["out"] or \
                f"[train] done at step {SSD_STEPS[1]}" not in again["out"]:
            raise AssertionError(f"{name}: the restart did not resume and finish")
        if ckpt_lib.CheckpointManager(train_dir).all_steps() != [2, 4, 6]:
            raise AssertionError(f"{name}: checkpoints {ckpt_lib.CheckpointManager(train_dir).all_steps()}")
        per_step = {}
        for run, n in zip(runs, (SSD_STEPS[0], SSD_STEPS[1] - SSD_STEPS[0])):
            per_step = {k: v / n for k, v in run["counts"].items()}
            if per_step != train_want:
                raise AssertionError(f"{name}: train launches a step {per_step}, want {train_want}")
            for line in run["lines"]:
                bad = [k for k, v in line.items() if not np.isfinite(v)]
                if bad:
                    raise AssertionError(f"{name}: non-finite train metrics at step "
                                         f"{line['step']}: {bad}")
        ckpt = ckpt_lib.load_checkpoint(ckpt_lib.checkpoint_path(train_dir, SSD_STEPS[1]))
        if "ema" not in ckpt or "opt_nu" not in ckpt:
            raise AssertionError(f"{name}: the checkpoint lacks the moving average or RMSProp's "
                                 "second moment")
        lines = first["lines"] + again["lines"]
        step_ms = [bs / ln["images_per_sec"] * 1e3 for ln in lines]
        peak_gib = max(r["peak"] for r in runs) / 2**30
        log(f"[ssd] {name}: train {SSD_STEPS[0]} steps + restart to {SSD_STEPS[1]} at batch "
            f"{bs} ({first['wall']:.2f} + {again['wall']:.2f} s CLI wall); step ms "
            f"{[round(t, 2) for t in step_ms]}; img/s "
            f"{[round(ln['images_per_sec'], 2) for ln in lines]}; loader wait share "
            f"{[round(ln['loader_wait_share'], 4) for ln in lines]}; peak {peak_gib:.2f} GiB; "
            f"launches a step {per_step}; total_loss "
            f"{[round(ln['total_loss'], 5) for ln in lines]}")

        reset_kernel_counts()
        out, metrics = run_cli(eval_cli.main, ["--pipeline_config_path", pipeline,
                                               "--checkpoint_dir", train_dir, "--eval_dir",
                                               os.path.join(work, "eval"), "--run_once"])
        eval_per_batch = {k: v / 2 for k, v in kernel_counts().items()}
        shown = {"Precision/mAP@0.5IOU": metrics["Precision/mAP@0.5IOU"]}
        log(f"[ssd] {name}: eval at step {SSD_STEPS[1]} on 16 records: {shown}; "
            f"{metrics['eval/images_per_sec']:.2f} img/s; launches a batch of 8 {eval_per_batch}")
        if not np.isfinite(shown["Precision/mAP@0.5IOU"]):
            raise AssertionError(f"{name}: the eval CLI gave no finite mAP: {shown}")
        if eval_per_batch != eval_want:
            raise AssertionError(f"{name}: eval launches a batch {eval_per_batch}, want {eval_want}")

        calls, step_fn, state, batch, gen = train_step_calls(pipeline, train_dir, seed)
        _, profile = profile_train_step(step_fn, state, batch, gen)
        del step_fn, state, batch
        torch.cuda.empty_cache()
        eval_calls = eval_batch_calls(pipeline, train_dir)
        shapes = {"train": check_kernels_on(calls, f"{name} train step"),
                  "eval": check_kernels_on(eval_calls, f"{name} eval batch")}
        timed = {
            "roi_crop": [time_crop(f, b, int(cs[0]), f"{name} ssd_random_crop", plain_reps=3)
                         for (f, b, cs), _ in calls["roi_crop"]],
            "iou": [time_iou(b1, b2, f"{name} assignment") for (b1, b2), _ in calls["iou"]],
            "nms": [time_recorded_nms(args, f"{name} postprocess") for args, _ in eval_calls["nms"]],
        }
        del calls, eval_calls
        torch.cuda.empty_cache()

        export_dir = os.path.join(work, "export")
        t0 = time.perf_counter()
        run_cli(exporter.main, ["--pipeline_config_path", pipeline, "--trained_checkpoint_dir",
                                train_dir, "--output_directory", export_dir])
        export_s = time.perf_counter() - t0
        served = InferenceModel.load(export_dir)
        image = request_picture(np.random.RandomState(seed + 23), 375, 500)
        served.predict_images([image])  # warm-up
        reset_kernel_counts()
        t0 = time.perf_counter()
        det = served.predict_images([image])
        request_ms = (time.perf_counter() - t0) * 1e3
        if kernel_counts()["nms"] != 1:
            raise AssertionError(f"{name}: a request launched NMS {kernel_counts()['nms']} times")
        check_outputs(det, 1, 100)
        n_det = int(det["num_detections"][0])
        classes = det["detection_classes"][0][:n_det]
        log(f"[ssd] {name}: export CLI {export_s:.2f} s; one 500x375 request through the bundle "
            f"in {request_ms:.2f} ms: {n_det} detections over classes "
            f"{int(classes.min()) if n_det else '-'}..{int(classes.max()) if n_det else '-'}")
        if n_det and (classes.min() < 1 or classes.max() > 20):
            raise AssertionError(f"{name}: served classes outside 1..20: {classes}")
        return dict(step_ms=step_ms, img_per_s=[ln["images_per_sec"] for ln in lines],
                    loader_wait_share=[ln["loader_wait_share"] for ln in lines],
                    peak_memory_gib=peak_gib, batch_size=bs,
                    train_launches_per_step=per_step, eval_metrics=shown,
                    eval_img_per_s=metrics["eval/images_per_sec"],
                    eval_launches_per_batch=eval_per_batch, shapes=shapes, timed=timed,
                    train_profile=profile, export_s=export_s, request_ms=request_ms,
                    detections=n_det)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_ssd(seed: int, results):
    """SSD MobileNet-v1 and SSD Inception-v2 (300x300, VOC) through the
    train, eval and export CLIs and a request; each trunk and head in
    float32 on the card against the CPU; LiveBatchNorm on the card against
    the CPU and timed beside F.batch_norm; two gloo ranks against one."""
    import shutil
    import tempfile

    out = {}
    for name, train_want, eval_want in SSD_CONFIGS:
        t0 = time.perf_counter()
        r = run_ssd(name, train_want, eval_want, seed)
        r["card_vs_cpu"] = ssd_card_vs_cpu(name, seed)
        r["wall_s"] = time.perf_counter() - t0
        log(f"[ssd] {name}: {r['wall_s']:.1f} s")
        out[name] = r
    out["live_batch_norm"] = live_batch_norm_on_card(seed)
    work = tempfile.mkdtemp(prefix="mtlx_ssd_ranks_")
    try:
        out["two_ranks"] = check_ssd_ranks(work, seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    results["ssd"] = out


# ---------------------------------------------------------------- phase 13

# the flagship's options in phase 13: the crop / pad chain its keep-aspect
# resizer moves to the host, and the photometric options on the card
PIPELINE_OPTIONS = ("random_horizontal_flip", "random_crop_image", "random_pad_image",
                    "random_distort_color", "random_black_patches")
PIPELINE_FLAGS = ["--grain_workers", "4", "--max_bucket_variants", "4", "--precompile_buckets"]
PIPELINE_STEPS = 8
# two runs of one step on the card (phases 7 and 10): 1e-4 relative
PIPELINE_LOSS_TOL = 1e-4
SSD_PIPELINE_OPTIONS = ("random_horizontal_flip", "ssd_random_crop_pad",
                        "ssd_random_crop_fixed_aspect_ratio")


def with_options(text: str, old: str, options) -> str:
    """A pipeline text with its augmentation block `old` replaced by the
    named options, each with its proto defaults."""
    if old not in text:
        raise AssertionError(f"the pipeline no longer holds {old!r}")
    return text.replace(old, "".join(f"  data_augmentation_options {{ {n} {{}} }}\n"
                                     for n in options))


def calibrated_warm_start(pipeline: str, record: str, fine_tune: str, seed: int) -> None:
    """The pipeline's fine_tune_checkpoint: the CLI's own init (same seed)
    with batch norm calibrated on one batch of the records."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.loader import DetectionDataset, batches
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train_step as ts

    configs = config_util.get_configs_from_pipeline_file(pipeline)
    model = model_builder.build(configs["model"], is_training=True, device="cuda")
    model.init_weights(torch.Generator().manual_seed(seed))
    dataset = DetectionDataset([record], model.cfg.canvas_size, model_builder.resizer_params(
        model_builder.image_resizer(configs["model"])))
    first = next(batches(dataset, configs["train_config"].batch_size, seed=seed,
                         pack_images=True))
    dataset.close()
    calibrate_batch_norm_on(model, torch.from_numpy(first["image"]).cuda(),
                            torch.from_numpy(first["true_shape"]).cuda())
    manager = ckpt_lib.CheckpointManager(fine_tune)
    manager.save(0, ts.create_train_state(model, ts.make_optimizer()))
    manager.wait()
    del model, manager
    torch.cuda.empty_cache()


def train_scalars(train_dir: str):
    """{(step, tag): value} of the train CLI's event files, as written (the
    printed lines round to four decimals)."""
    from mtlx_torch.utils.summary_writer import read_events

    out = {}
    for name in sorted(os.listdir(train_dir)):
        if "tfevents" in name:
            for event in read_events(os.path.join(train_dir, name)):
                for tag, value in event.get("values", []):
                    out[(event["step"], tag)] = value
    return out


def check_worker_loader(pipeline: str, seed: int):
    """The worker loader (4 processes) against the in-process loader on
    the CLI's arguments for two epochs: every batch equal to the bit.
    Returns the seconds a batch of each and the first batch."""
    from mtlx_torch.builders import model_builder, preprocessor_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.grain_loader import make_grain_loader
    from mtlx_torch.data.host_geometry import HostGeometry, split_host_geometry
    from mtlx_torch.data.loader import DetectionDataset, batches
    from mtlx_torch.utils.bucketing import resolve_bucketing

    configs = config_util.get_configs_from_pipeline_file(pipeline)
    resizer = model_builder.resizer_params(model_builder.image_resizer(configs["model"]))
    canvas = model_builder.build_config(configs["model"], is_training=True).canvas_size
    host_ops, _ = split_host_geometry(preprocessor_builder.build(
        configs["train_config"].data_augmentation_options), resizer)
    multiple, _ = resolve_bucketing(configs["bucketing"])
    dataset = DetectionDataset(list(configs["train_input_config"].tf_record_input_reader
                                    .input_path), canvas, resizer)
    kw = dict(shuffle=True, seed=seed, pack_images=True, bucket_multiple=multiple,
              host_geometry=HostGeometry(host_ops, resizer[1]["min_dimension"],
                                         resizer[1]["max_dimension"], canvas),
              max_bucket_variants=4, decode_threads=2)
    bs = configs["train_config"].batch_size
    try:
        t0 = time.perf_counter()
        want = list(batches(dataset, bs, epochs=2, **kw))
        t1 = time.perf_counter()
        loader = make_grain_loader(dataset, bs, worker_count=4, num_epochs=2, **kw)
        got = list(loader)
        t2 = time.perf_counter()
        loader.close()
    finally:
        dataset.close()
    if len(got) != len(want) or not want:
        raise AssertionError(f"the worker loader gave {len(got)} batches, in-process {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w):
            raise AssertionError(f"batch {i}: fields {sorted(g)} vs {sorted(w)}")
        for k, v in w.items():
            same = g[k] == v if k == "source_id" else (g[k].dtype == v.dtype
                                                        and np.array_equal(g[k], v))
            if not same:
                raise AssertionError(f"batch {i}: the worker loader's {k} differs")
    shapes = sorted({tuple(b["image"].shape[1:3]) for b in want})
    log(f"[pipeline] the worker loader's {len(got)} batches (2 epochs) equal the in-process "
        f"loader's to the bit; in-process {(t1 - t0) / len(want):.3f} s a batch of {bs}, 4 "
        f"workers {(t2 - t1) / len(got):.3f} s a batch with their start; buckets {shapes}")
    return dict(batches=len(got), in_process_s=(t1 - t0) / len(want),
                workers_s=(t2 - t1) / len(got), buckets=shapes), want[0]


def time_host_window(batch):
    """batch_apply_host_window on one loader batch on the card, timed."""
    from mtlx_torch.data import preprocessor as prep

    t = {k: torch.from_numpy(batch[k]).cuda() for k in
         ("image", "true_shape", "aug_window", "aug_src_shape", "aug_pad_color", "aug_content")}
    image = t["image"].float()
    args = (t["true_shape"], t["aug_window"], t["aug_src_shape"], t["aug_pad_color"],
            t["aug_content"])
    out = prep.batch_apply_host_window(image, *args)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("batch_apply_host_window gave non-finite pixels")
    ms = cuda_ms(lambda: prep.batch_apply_host_window(image, *args), 20)
    t_bound, by = bound_ms(nbytes=2 * image.numel() * 4, ops=image.numel() * 4 * 3)
    shape = "x".join(map(str, image.shape))
    log(f"[pipeline] batch_apply_host_window at {shape} float32 (plain PyTorch): {ms:.4f} ms, "
        f"bound {t_bound:.4f} ms ({by})")
    return dict(shape=shape, ms=ms, bound_ms=t_bound, bound_by=by)


def run_pipeline_cli(pipeline: str, train_dir: str, flags, seed: int, steps: int,
                     own_process: bool = False):
    """One train CLI run: its lines, launches, peak memory, event-file
    scalars and output. In this process (launches counted from 0 before
    it), or with own_process in a process of its own, as a user runs it
    (cuDNN and the allocator start cold; launches and peak memory from its
    `[train] summary` line)."""
    from mtlx_torch.train import train as train_cli

    argv = ["--pipeline_config_path", pipeline, "--train_dir", train_dir, "--num_steps",
            str(steps), "--log_every", "1", "--seed", str(seed)] + list(flags)
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if own_process:
        run = subprocess.run([sys.executable, "-m", "mtlx_torch.train.train"] + argv,
                             capture_output=True, text=True, timeout=600, cwd=REPO,
                             env=repo_env())
        out = run.stdout
        for line in out.splitlines():
            log(f"  | {line}")
        if run.returncode != 0:
            raise AssertionError(f"the train CLI exited {run.returncode}:\n{run.stderr[-4000:]}")
        summary = json.loads(out.split("[train] summary ", 1)[1].splitlines()[0])
        counts, peak = summary["kernel_launches"], summary["peak_memory_gib"] * 2**30
    else:
        out, _ = run_cli(train_cli.main, argv)
        counts, peak = kernel_counts(), torch.cuda.max_memory_allocated()
    lines = train_log_lines(out)
    if [ln["step"] for ln in lines] != list(range(1, steps + 1)):
        raise AssertionError(f"the train CLI logged steps {[ln['step'] for ln in lines]}")
    for line in lines:
        bad = [k for k, v in line.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite train metrics at step {line['step']}: {bad}")
    return dict(out=out, lines=lines, counts=counts, wall=time.perf_counter() - t0, peak=peak,
                scalars=train_scalars(train_dir))


def step_ms(line, batch_size: int):
    """(wall ms of a logged step, its ms outside the loader wait)."""
    wall = batch_size / line["images_per_sec"] * 1e3
    return wall, wall * (1.0 - line["loader_wait_share"])


def pipeline_flagship(work: str, seed: int):
    """The flagship at full width through the train CLI with the crop / pad
    chain on the host and the photometric options on the card: with
    --grain_workers 4 --max_bucket_variants 4 --precompile_buckets, and
    with the in-process loader and no warm-up; their first three steps'
    losses must agree, and the worker loader's batches equal the
    in-process loader's."""
    import re

    record = write_records(os.path.join(work, "voc_noise.record"),
                           np.random.RandomState(seed + 30), 48, "jpeg", VOC_SIZES)
    label_map = os.path.join(work, "label_map.pbtxt")
    with open(label_map, "w") as f:
        f.writelines(f"item {{ id: {i + 1} name: '{n}' }}\n" for i, n in enumerate(VOC_NAMES))
    fine_tune = os.path.join(work, "warm_start")
    pipeline = os.path.join(work, "pipeline.config")
    with open(pipeline, "w") as f:
        f.write(with_options(cli_pipeline(record, label_map, fine_tune, save_every=None),
                             "  data_augmentation_options { random_horizontal_flip {} }\n",
                             PIPELINE_OPTIONS))
    calibrated_warm_start(pipeline, record, fine_tune, seed)
    loader, first = check_worker_loader(pipeline, seed)
    window = time_host_window(first)

    runs = {}
    for tag, flags in (("plain", ["--max_bucket_variants", "4"]), ("flags", PIPELINE_FLAGS)):
        runs[tag] = run_pipeline_cli(pipeline, os.path.join(work, tag), flags, seed,
                                     PIPELINE_STEPS, own_process=True)
    flagged, plain = runs["flags"], runs["plain"]
    if "host-side crop / pad geometry: ['random_crop_image', 'random_pad_image']" \
            not in flagged["out"]:
        raise AssertionError("the train CLI did not move the crop / pad chain to the host")
    warm = re.search(r"warmed up (\d+) bucket shapes (\[.*\]) in ([0-9.]+) s", flagged["out"])
    if warm is None:
        raise AssertionError("the train CLI printed no warm-up line")
    warm_shapes, warm_s = warm.group(2), float(warm.group(3))
    # the first three steps with and without the warm-up
    diffs = {}
    for (step, tag), value in plain["scalars"].items():
        if step <= 3 and (tag.startswith("Loss/") or tag == "total_loss"):
            other = flagged["scalars"][(step, tag)]
            diffs[(step, tag)] = abs(other - value) / max(abs(value), 1e-30)
    worst = max(diffs.items(), key=lambda kv: kv[1])
    log(f"[pipeline] flagship losses of steps 1-3 with and without the warm-up: largest "
        f"relative difference {worst[1]:.3g} ({worst[0][1]} at step {worst[0][0]}), "
        f"tolerance {PIPELINE_LOSS_TOL}")
    if worst[1] > PIPELINE_LOSS_TOL:
        raise AssertionError(f"the warm-up moved {worst[0]} by {worst[1]} relative")
    bs = 16
    summary = {}
    for tag, run in runs.items():
        per_step = {k: v / PIPELINE_STEPS for k, v in run["counts"].items()}
        times = [step_ms(ln, bs) for ln in run["lines"]]
        summary[tag] = dict(
            step1_wall_ms=times[0][0], step1_ms_without_wait=times[0][1],
            steady_ms=[t for t, _ in times[1:]],
            loader_wait_share=[ln["loader_wait_share"] for ln in run["lines"][1:]],
            peak_memory_gib=run["peak"] / 2**30, launches_per_step=per_step,
            cli_wall_s=run["wall"])
        log(f"[pipeline] flagship {tag} ({' '.join(PIPELINE_FLAGS) if tag == 'flags' else '--max_bucket_variants 4'}): "
            f"step 1 {times[0][0]:.1f} ms ({times[0][1]:.1f} outside the loader wait); steps "
            f"2-{PIPELINE_STEPS} {[round(t, 2) for t, _ in times[1:]]} ms, loader wait share "
            f"{summary[tag]['loader_wait_share']}; peak {run['peak'] / 2**30:.2f} GiB; launches "
            f"a step {per_step}; CLI wall {run['wall']:.2f} s")
        if per_step["roi_crop"] != 1:
            raise AssertionError(f"flagship {tag}: crop launches a step {per_step}")
    log(f"[pipeline] the warm-up: {warm.group(1)} shapes {warm_shapes} in {warm_s:.2f} s")
    return dict(loader=loader, host_window=window, warm_up_shapes=warm_shapes,
                warm_up_s=warm_s, loss_max_rel_diff=worst[1], runs=summary)


def pipeline_ssd(work: str, seed: int):
    """SSD MobileNet-v1 (300x300, batch 32) with ssd_random_crop_pad and
    ssd_random_crop_fixed_aspect_ratio on the card: the train CLI for two
    steps (the crop launched once an option a step), then one recorded
    step's kernel calls held to their plain versions, the crops timed."""
    record = write_records(os.path.join(work, "ssd_noise.record"),
                           np.random.RandomState(seed + 31), 32, "jpeg", VOC_SIZES)
    label_map = os.path.join(work, "voc_label_map.pbtxt")
    with open(label_map, "w") as f:
        f.writelines(f"item {{ id: {i + 1} name: '{v}' }}\n" for i, v in enumerate(VOC_NAMES))
    pipeline = os.path.join(work, "ssd.config")
    text = ssd_pipeline("ssd_mobilenet_v1_voc", record, label_map)
    text = with_options(text, "  data_augmentation_options { random_horizontal_flip {} }\n"
                              "  data_augmentation_options {\n    ssd_random_crop { }\n  }\n",
                        SSD_PIPELINE_OPTIONS)
    with open(pipeline, "w") as f:
        f.write(text)
    train_dir = os.path.join(work, "ssd_train")
    run = run_pipeline_cli(pipeline, train_dir, [], seed, 2)
    per_step = {k: v / 2 for k, v in run["counts"].items()}
    want = {"nms": 0, "roi_crop": 2, "roi_crop_backward": 0, "iou": 1}
    if per_step != want:
        raise AssertionError(f"SSD with the two crops: launches a step {per_step}, want {want}")
    calls, *_ = train_step_calls(pipeline, train_dir, seed)
    shapes = check_kernels_on(calls, "SSD step with ssd_random_crop_pad and "
                                     "ssd_random_crop_fixed_aspect_ratio")
    timed = [time_crop(f, b, int(cs[0]), f"SSD {name}", plain_reps=3)
             for ((f, b, cs), _), name in zip(calls["roi_crop"], SSD_PIPELINE_OPTIONS[1:])]
    times = [step_ms(ln, 32)[0] for ln in run["lines"]]
    log(f"[pipeline] SSD MobileNet-v1 with {SSD_PIPELINE_OPTIONS[1:]}: steps {[round(t, 2) for t in times]} "
        f"ms at batch 32, peak {run['peak'] / 2**30:.2f} GiB, launches a step {per_step}")
    return dict(launches_per_step=per_step, shapes=shapes, timed=timed, step_ms=times,
                peak_memory_gib=run["peak"] / 2**30)


def phase_pipeline(seed: int, results):
    """The train CLI's input pipeline: the flagship's host crop / pad
    geometry, worker loader, bucket bound and warm-up; SSD's device-side
    crop-and-pad and fixed-aspect crops."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="mtlx_pipeline_")
    t0 = time.perf_counter()
    try:
        out = {"flagship": pipeline_flagship(work, seed)}
        torch.cuda.empty_cache()
        out["ssd"] = pipeline_ssd(work, seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[pipeline] phase 13: {out['wall_s']:.1f} s")
    results["pipeline"] = out


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 14

# the refine flagship's launches (a train step, an eval batch of 8): the
# flagship's, refine adds none
REFINE_LAUNCHES = ({"nms": 1, "roi_crop": 1, "roi_crop_backward": 1, "iou": 3},
                   {"nms": 2, "roi_crop": 1, "roi_crop_backward": 0, "iou": 0})
REFINE_STEPS = (6, 8)  # the first run, then the restart to step 8
# the training options' launches a step by the miner's negatives cap: its
# walk is one NMS launch without a cap, one IoU launch with one
OPTION_LAUNCHES = {0: {"nms": 2, "roi_crop": 1, "roi_crop_backward": 1, "iou": 3},
                   3: {"nms": 1, "roi_crop": 1, "roi_crop_backward": 1, "iou": 4}}
OPTION_STEPS = 4


def refine_pipeline(record: str, label_map: str, fine_tune: str, viz_dir: str,
                    cap=None) -> str:
    """The flagship pipeline with `refine: true` in its mtl block, its
    paths replaced, eval on 16 records with its visualizations exported to
    viz_dir; with `cap` (the miner's max_negatives_per_positive, 0 for
    none) also live batch norm, second-stage dropout (keep 0.5) and the
    hard example miner (64 examples, IoU 0.7, both losses)."""
    text = cli_pipeline(record, label_map, fine_tune)
    reps = [("      edgemask_loss_weight: 0.5\n",
             "      edgemask_loss_weight: 0.5\n      refine: true\n"),
            ("  num_examples: 4952\n",
             f"  num_examples: 16\n  visualization_export_dir: {json.dumps(viz_dir)}\n")]
    if cap is not None:
        miner = ("    hard_example_miner {\n      num_hard_examples: 64\n      iou_threshold: 0.7\n"
                 "      loss_type: BOTH\n"
                 + (f"      max_negatives_per_positive: {cap}\n" if cap else "") + "    }\n")
        reps += [("      first_stage_features_stride: 16\n",
                  "      first_stage_features_stride: 16\n      batch_norm_trainable: true\n"),
                 ("        use_dropout: false\n        dropout_keep_probability: 1.0\n",
                  "        use_dropout: true\n        dropout_keep_probability: 0.5\n"),
                 ("    second_stage_localization_loss_weight: 2.0\n",
                  "    second_stage_localization_loss_weight: 2.0\n" + miner)]
    for old, new in reps:
        if old not in text:
            raise AssertionError(f"{FLAGSHIP_CONFIG} no longer holds {old!r}")
        text = text.replace(old, new, 1)
    return text


def train_cli_runs(pipeline: str, train_dir: str, steps_list, seed: int, tag: str, want,
                   flags_list=None):
    """The train CLI in this process for each step count in turn (with the
    run's own extra flags from flags_list), each run's launches a step
    held to `want`; returns the runs (output, wall, counts, peak memory,
    [train] lines)."""
    from mtlx_torch.train import train as train_cli

    runs, done = [], 0
    for i, steps in enumerate(steps_list):
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, _ = run_cli(train_cli.main, ["--pipeline_config_path", pipeline, "--train_dir",
                                          train_dir, "--num_steps", str(steps), "--log_every",
                                          "1", "--seed", str(seed)]
                         + list(flags_list[i] if flags_list else []))
        run = dict(out=out, wall=time.perf_counter() - t0, counts=kernel_counts(),
                   peak=torch.cuda.max_memory_allocated(), lines=train_log_lines(out))
        per_step = {k: v / (steps - done) for k, v in run["counts"].items()}
        if per_step != want:
            raise AssertionError(f"{tag}: train launches a step {per_step}, want {want}")
        for line in run["lines"]:
            bad = [k for k, v in line.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"{tag}: non-finite train metrics at step {line['step']}: "
                                     f"{bad}")
        if f"[train] done at step {steps}" not in out:
            raise AssertionError(f"{tag}: the train CLI did not finish at step {steps}")
        runs.append(run)
        done = steps
    if "warm start: " not in runs[0]["out"]:
        raise AssertionError(f"{tag}: the first train run did not warm-start")
    return runs


def check_visualizations(eval_dir: str, viz_dir: str, step: int, n: int = 10):
    """The eval CLI's `Detections_Left_Groundtruth_Right/<i>` image
    summaries (n of them, at step) and the equal `export-<step>-<i>.png`
    files; returns their shapes."""
    import glob

    from mtlx_torch.data import imgcodec
    from mtlx_torch.utils.summary_writer import read_events

    images = {}
    for path in sorted(glob.glob(os.path.join(eval_dir, "events.out.tfevents.*"))):
        for event in read_events(path):
            for tag, value in event.get("values", []):
                if isinstance(value, tuple):
                    images[tag] = (event["step"], imgcodec.decode_png(value[2]))
    want = [f"Detections_Left_Groundtruth_Right/{i}" for i in range(n)]
    if sorted(images) != sorted(want) or any(s != step for s, _ in images.values()):
        raise AssertionError(f"the eval event file holds image summaries {sorted(images)}, want "
                             f"{want} at step {step}")
    names = sorted(os.listdir(viz_dir))
    if names != sorted(f"export-{step}-{i}.png" for i in range(n)):
        raise AssertionError(f"visualization_export_dir holds {names}")
    shapes = []
    for i in range(n):
        with open(os.path.join(viz_dir, f"export-{step}-{i}.png"), "rb") as f:
            png = imgcodec.decode_png(f.read())
        if not np.array_equal(png, images[want[i]][1]):
            raise AssertionError(f"export-{step}-{i}.png differs from its image summary")
        shapes.append(tuple(png.shape))
    log(f"[refine] the eval CLI wrote {n} image summaries Detections_Left_Groundtruth_Right/<i> "
        f"at step {step} and {n} equal PNGs (detections left, groundtruth right): {shapes}")
    return shapes


def serve_ms(served, image, reps: int = 10):
    """Host ms of one request of `image` (after one warm-up), each ending
    in the copy to the host: the sorted samples."""
    served.predict_images([image])
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        served.predict_images([image])
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def moving_stats_change(model, warm_start: str):
    """How far one training step moved the live batch norms' moving
    statistics from the warm start: the largest change over the largest
    value, per trunk, and how many of the trunk's buffers moved."""
    from mtlx_torch.train import checkpoints as ckpt_lib

    before = ckpt_lib.load_checkpoint(ckpt_lib.checkpoint_path(warm_start, 0))["buffers"]
    out = {}
    for trunk in ("backbone.", "classifier_backbone."):
        rel, moved, total = 0.0, 0, 0
        for name, buf in model.modules.named_buffers():
            if name.startswith(trunk) and name.endswith((".mean", ".var")):
                b = before[name].to(buf.device)
                total += 1
                moved += not torch.equal(buf, b)
                rel = max(rel, float((buf - b).abs().max() / b.abs().max().clamp_min(1e-30)))
        out[trunk[:-1]] = dict(max_rel_change=rel, moved=moved, buffers=total)
    return out


def profile_refine_against_flagship(work: str, record: str, label_map: str, pipeline: str,
                                    fine_tune: str, seed: int):
    """One profiled train step of the refine pipeline and one of the same
    pipeline without refine (its own calibrated warm start), on the same
    first batch, each after an unprofiled step at that shape; prints the
    kernels whose device time refine changes most."""
    plain, plain_warm = os.path.join(work, "pipeline_plain.config"), os.path.join(work, "warm_plain")
    with open(plain, "w") as f:
        f.write(cli_pipeline(record, label_map, plain_warm))
    write_warm_start(plain, record, plain_warm, seed)
    profiles = {}
    for tag, (pipe, ckpt) in (("refine", (pipeline, fine_tune)),
                              ("without refine", (plain, plain_warm))):
        _, step_fn, state, batch, gen = train_step_calls(pipe, ckpt, seed)
        _, profiles[tag] = profile_train_step(step_fn, state, batch, gen)
        del step_fn, state, batch
        torch.cuda.empty_cache()
    a, b = profiles["refine"]["by_kernel"], profiles["without refine"]["by_kernel"]
    delta = sorted(((a.get(k, (0.0, 0))[0] - b.get(k, (0.0, 0))[0], k) for k in set(a) | set(b)),
                   reverse=True)
    log(f"[refine] one profiled step on the same batch: refine kernels busy "
        f"{profiles['refine']['busy_ms']:.2f} ms of {profiles['refine']['wall_ms']:.2f} ms, "
        f"without refine {profiles['without refine']['busy_ms']:.2f} of "
        f"{profiles['without refine']['wall_ms']:.2f} ms; the kernels refine adds most to "
        f"(ms, launches with / without): " + "; ".join(
            f"{k[:70]} {d:+.3f} ({a.get(k, (0, 0))[1]}/{b.get(k, (0, 0))[1]})"
            for d, k in delta[:8]))
    return profiles


def time_miner(calls, config, cap: int, seed: int, tag: str):
    """The miner's one launch in a recorded step (the NMS of 16 problems of
    64 without a negatives cap, the IoU of 16 x 64 x 64 with one), timed
    beside its plain version and bound, and the whole
    hard_example_mining_mask on those boxes with uniform losses."""
    from mtlx_torch.losses import losses as loss_lib

    if cap == 0:
        args = next(a for a, _ in calls["nms"] if a[1].shape[1] == config.num_hard_examples)
        boxes, launch = args[0], time_recorded_nms(args, f"{tag} miner")
    else:
        b1, b2 = next(a for a, _ in calls["iou"] if a[0].shape[1] == a[1].shape[1] == 64)
        boxes, launch = b1, time_iou(b1, b2, f"{tag} miner")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cls, loc = torch.rand((2,) + boxes.shape[:2], generator=gen, device="cuda")
    match = torch.where(torch.rand(boxes.shape[:2], generator=gen, device="cuda") < 0.25, 0, -1)
    ms = cuda_ms(lambda: loss_lib.hard_example_mining_mask(cls, loc, boxes, match, config), 20)
    log(f"[refine] {tag}: hard_example_mining_mask of {boxes.shape[0]} x {boxes.shape[1]} ROIs "
        f"{ms:.4f} ms a call (CUDA events over a host loop)")
    return dict(launch=launch, mask_ms=ms)


def refine_card_vs_cpu(seed: int):
    """One refine request and one refine train step of a resnet10 model in
    float32 (TF32 off) on the card and on the CPU, with phases 5 and 7's
    tolerances."""
    import dataclasses

    from mtlx_torch.detector.faster_rcnn import FasterRCNN, MTLConfig, flagship_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(flagship_config(torch.float32), backbone="resnet10",
                              canvas_size=(128, 128),
                              mtl=MTLConfig(multiobject=True, closeness=True, refine=True))
    cpu = FasterRCNN(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(seed))
    batch = train_batch(np.random.RandomState(seed + 2), 2, canvas=(128, 128), max_gt=8,
                        sizes=((96, 128), (100, 128)))
    x, ts = batch["image"].float().cpu(), batch["true_shape"].cpu()
    calibrate_batch_norm_on(cpu, x, ts)
    gpu = FasterRCNN(cfg, device="cuda")
    gpu.modules.load_state_dict(cpu.modules.state_dict())
    pc = cpu.predict(cpu.preprocess(x), ts)
    pg = gpu.predict(gpu.preprocess(x.cuda()), ts.cuda())

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))

    # the second stage (the refine vectors of the 300 proposals joined on)
    # on the CPU's proposals, as phase 5 takes them
    cls_g, box_g, _ = gpu._predict_second_stage(pg["rpn_features"],
                                                pc["proposal_boxes"].cuda(), (128, 128))
    checks = [("refine rpn_features max rel diff", rel(pg["rpn_features"], pc["rpn_features"]),
               1e-3),
              ("refine class_predictions (CPU proposals) max rel diff",
               rel(cls_g, pc["class_predictions"]), 1e-3),
              ("refine box refinements (CPU proposals) max rel diff",
               rel(box_g, pc["refined_box_encodings"]), 1e-3)]
    failed = []
    for name, value, tol in checks:
        ok = value <= tol
        log(f"[refine-card-vs-cpu] {name}: {value:.3g} (tolerance {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"card and CPU disagree on the refine request: {failed}")
    phase_train_card_vs_cpu(seed, refine=True)


def phase_refine(seed: int, results):
    """The paper's MTL refine path on the flagship at full width through
    the CLIs (train, restart, eval with its visualizations, export, a
    request beside the flagship without refine), the training options
    (live batch norm, dropout, the hard example miner without and with a
    negatives cap) through the train CLI, every kernel call of a recorded
    refine step, refine eval batch and options step held to the plain
    versions, and a resnet10 refine model on the card against the CPU."""
    import shutil
    import tempfile

    from mtlx_torch.config import config_util
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_config
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mtlx_refine_")
    try:
        record = write_records(os.path.join(work, "voc_noise.record"),
                               np.random.RandomState(seed + 21), 32, "jpeg", VOC_SIZES)
        label_map = os.path.join(work, "label_map.pbtxt")
        with open(label_map, "w") as f:
            f.writelines(f"item {{ id: {i + 1} name: '{n}' }}\n" for i, n in enumerate(VOC_NAMES))
        fine_tune, viz_dir = os.path.join(work, "warm_start"), os.path.join(work, "viz")
        pipelines = {}
        for cap in (None, 0, 3):
            pipelines[cap] = os.path.join(work, f"pipeline_{cap}.config")
            with open(pipelines[cap], "w") as f:
                f.write(refine_pipeline(record, label_map, fine_tune, viz_dir, cap))
        pipeline = pipelines[None]
        write_warm_start(pipeline, record, fine_tune, seed)
        setup_s = time.perf_counter() - t_phase

        # the refine flagship: train, restart, eval, export, serve
        train_dir = os.path.join(work, "train")
        runs = train_cli_runs(pipeline, train_dir, REFINE_STEPS, seed, "refine",
                              REFINE_LAUNCHES[0])
        if f"resumed from step {REFINE_STEPS[0]}" not in runs[1]["out"]:
            raise AssertionError("refine: the restart did not resume")
        lines = runs[0]["lines"] + runs[1]["lines"]
        step_ms = [16 / ln["images_per_sec"] * 1e3 for ln in lines]
        peak_gib = max(r["peak"] for r in runs) / 2**30
        log(f"[refine] train {REFINE_STEPS[0]} steps + restart to {REFINE_STEPS[1]} at batch 16 "
            f"({runs[0]['wall']:.2f} + {runs[1]['wall']:.2f} s CLI wall); step ms "
            f"{[round(t, 2) for t in step_ms]}; img/s "
            f"{[round(ln['images_per_sec'], 2) for ln in lines]}; peak {peak_gib:.2f} GiB; "
            f"launches a step {REFINE_LAUNCHES[0]}; total_loss "
            f"{[round(ln['total_loss'], 5) for ln in lines]}")
        flagship = results.get("cli")
        if flagship is not None:
            log(f"[refine] beside it, the same pipeline without refine (phase 8, this run, 64 "
                f"records): step ms {[round(t, 2) for t in flagship['train_step_ms']]}; img/s "
                f"{[round(v, 2) for v in flagship['train_img_per_s']]}; peak "
                f"{flagship['train_peak_bytes'] / 2**30:.2f} GiB; eval "
                f"{flagship['eval_img_per_s']:.2f} img/s")

        eval_dir = os.path.join(work, "eval")
        reset_kernel_counts()
        out, metrics = run_cli(eval_cli.main, ["--pipeline_config_path", pipeline,
                                               "--checkpoint_dir", train_dir,
                                               "--eval_dir", eval_dir, "--run_once"])
        eval_per_batch = {k: v / 2 for k, v in kernel_counts().items()}
        mean_ap, eval_ips = metrics["Precision/mAP@0.5IOU"], metrics["eval/images_per_sec"]
        log(f"[refine] eval at step {REFINE_STEPS[1]} on 16 records: mAP@0.5 {mean_ap:.6g}, "
            f"{eval_ips:.2f} img/s, launches a batch of 8 {eval_per_batch}")
        if not np.isfinite(mean_ap) or eval_per_batch != REFINE_LAUNCHES[1]:
            raise AssertionError(f"refine eval: mAP {mean_ap}, launches {eval_per_batch}")
        viz_shapes = check_visualizations(eval_dir, viz_dir, REFINE_STEPS[1])

        calls = train_step_calls(pipeline, train_dir, seed)[0]
        shapes = {"train": check_kernels_on(calls, "refine train step"),
                  "eval": check_kernels_on(eval_batch_calls(pipeline, train_dir),
                                           "refine eval batch")}
        del calls
        torch.cuda.empty_cache()
        profiles = profile_refine_against_flagship(work, record, label_map, pipeline, fine_tune,
                                                   seed)

        export_dir = os.path.join(work, "export")
        run_cli(exporter.main, ["--pipeline_config_path", pipeline, "--trained_checkpoint_dir",
                                train_dir, "--output_directory", export_dir])
        served = InferenceModel.load(export_dir)
        state = served.model.modules.state_dict()
        heads = sorted({k.split(".")[0] for k in state if k.split(".")[0].endswith("_head")})
        width = served.model.modules.box_predictor.in_features
        refine_text = config_util.parse_pipeline_text(served.pipeline_text).model.faster_rcnn.mtl
        if not (served.model.modules.refines and refine_text.refine and width == 4096
                and heads == ["cl_head", "fg_head", "mo_head"]):
            raise AssertionError(f"the refine bundle: refines {served.model.modules.refines}, "
                                 f"pipeline refine {refine_text.refine}, heads {heads}, "
                                 f"predictor width {width}")
        image = request_picture(np.random.RandomState(seed + 22), 600, 800)
        det = served.predict_images([image])
        check_outputs(det, 1)
        serving = check_serving_inputs(served, image, det)
        plain = FasterRCNN(flagship_config(), device="cuda")
        plain.init_weights(torch.Generator().manual_seed(seed))
        calibrate_batch_norm(plain, image)
        plain = InferenceModel(plain, served.resizer, device="cuda")
        request = {"refine": serve_ms(served, image), "without refine": serve_ms(plain, image)}
        del plain
        log(f"[refine] one 600x800 request through the refine bundle (heads {heads}, box "
            f"predictor {width} wide): {int(det['num_detections'][0])} detections; ms a request "
            f"(10, sorted) with refine {[round(t, 2) for t in request['refine']]}, the flagship "
            f"without refine {[round(t, 2) for t in request['without refine']]}")

        # the training options
        options = {}
        for cap in (0, 3):
            tag = f"options cap {cap}"
            orun = train_cli_runs(pipelines[cap], os.path.join(work, f"train_{cap}"),
                                  (OPTION_STEPS,), seed, tag, OPTION_LAUNCHES[cap])[0]
            ocalls, _, ostate, _, _ = train_step_calls(pipelines[cap], fine_tune, seed)
            oshapes = check_kernels_on(ocalls, f"{tag} step")
            stats = moving_stats_change(ostate.model, fine_tune)
            miner = time_miner(ocalls, ostate.model.cfg.hard_example_miner, cap, seed, tag)
            del ocalls, ostate
            torch.cuda.empty_cache()
            if not all(v["moved"] for v in stats.values()):
                raise AssertionError(f"{tag}: a trunk's live batch norms did not move: {stats}")
            oms = [16 / ln["images_per_sec"] * 1e3 for ln in orun["lines"]]
            log(f"[refine] {tag} (live batch norm, dropout 0.5, the miner): {OPTION_STEPS} steps "
                f"({orun['wall']:.2f} s CLI wall); step ms {[round(t, 2) for t in oms]}; peak "
                f"{orun['peak'] / 2**30:.2f} GiB; launches a step {OPTION_LAUNCHES[cap]}; "
                f"moving statistics after one step from the warm start {stats}")
            options[cap] = dict(step_ms=oms, peak_memory_gib=orun["peak"] / 2**30,
                                launches_per_step=OPTION_LAUNCHES[cap], shapes=oshapes,
                                moving_stats=stats, miner=miner)

        t0 = time.perf_counter()
        refine_card_vs_cpu(seed)
        cvc_s = time.perf_counter() - t0
        wall = time.perf_counter() - t_phase
        log(f"[refine] phase 14: {wall:.1f} s (setup {setup_s:.1f} s, card vs CPU {cvc_s:.1f} s)")
        results["refine"] = dict(
            step_ms=step_ms, img_per_s=[ln["images_per_sec"] for ln in lines],
            peak_memory_gib=peak_gib, train_launches_per_step=REFINE_LAUNCHES[0],
            eval_map=mean_ap, eval_img_per_s=eval_ips, eval_launches_per_batch=eval_per_batch,
            visualizations=viz_shapes, shapes=shapes, request_ms=request, serving=serving,
            profiles={k: {f: v for f, v in p.items() if f != "by_kernel"}
                      for k, p in profiles.items()},
            options=options, wall_s=wall)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 15
#
# A small writer of TF checkpoints, V1 (one table file) and V2 (an index
# table and one data shard), so that the conversion check needs no
# TensorFlow. tests/test_torch_checkpoint_convert.py holds what it writes
# to tf.train.load_checkpoint.

_TF_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.int32): 3, np.dtype(np.int64): 9}


def _varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _int_field(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _shape_proto(shape) -> bytes:
    return b"".join(_field(2, _int_field(1, int(d))) for d in shape)


def _table(entries, block_type: int = 0) -> bytes:
    """A LevelDB table of the sorted (key, value) entries: a data block
    each entry (as TF's 4 KiB blocks hold each large value alone, so a
    lookup reads one tensor's block), an empty metaindex, the index and
    the footer; block_type is the type byte every block gets (0 is
    uncompressed; only the readers' refusal of another is tested)."""
    from mtlx_torch.tools.tf_checkpoint import TABLE_MAGIC, masked_crc32c

    out = bytearray()

    def block(items) -> bytes:
        body, restarts = bytearray(), []
        for key, value in items:
            restarts.append(len(body))
            body += _varint(0) + _varint(len(key)) + _varint(len(value)) + key + value
        restarts = restarts or [0]
        return bytes(body) + b"".join(int(r).to_bytes(4, "little") for r in restarts) \
            + len(restarts).to_bytes(4, "little")

    def put(body: bytes):
        offset = len(out)
        trailer = bytes([block_type])
        out.extend(body + trailer + masked_crc32c(body + trailer).to_bytes(4, "little"))
        return _varint(offset) + _varint(len(body))

    handles = [(key, put(block([(key, value)]))) for key, value in sorted(entries)]
    meta = put(block([]))
    index = put(block(handles))
    footer = meta + index
    out.extend(footer + bytes(40 - len(footer)) + TABLE_MAGIC)
    return bytes(out)


def _ordered_string(name: bytes) -> bytes:
    """OrderedCode's string: 0x00 -> 00 ff, 0xff -> ff 00, ended by 00 01."""
    escape = {0x00: b"\x00\xff", 0xFF: b"\xff\x00"}
    return b"".join(escape.get(c, bytes([c])) for c in name) + b"\x00\x01"


def write_tf_checkpoint(prefix: str, tensors, version: int = 2, block_type: int = 0) -> None:
    """Write `tensors` (name -> float32 / int32 / int64 array) as TF does:
    version 2 as `<prefix>.index` + `<prefix>.data-00000-of-00001`,
    version 1 as the one table file `prefix` (each tensor one full slice,
    its values packed in the TensorProto's *_val field), with a
    `checkpoint` file beside it naming the prefix."""
    from mtlx_torch.tools.tf_checkpoint import masked_crc32c

    arrays = {n: np.require(v, requirements="C") for n, v in sorted(tensors.items())}
    versions = _int_field(1, 1)  # VersionDef producer 1
    if version == 2:
        entries, data = [], bytearray()
        for name, a in arrays.items():
            raw = a.astype(a.dtype.newbyteorder("<")).tobytes()
            entry = (_int_field(1, _TF_DTYPES[a.dtype]) + _field(2, _shape_proto(a.shape))
                     + _int_field(4, len(data)) + _int_field(5, len(raw))
                     + _varint(6 << 3 | 5) + masked_crc32c(raw).to_bytes(4, "little"))
            entries.append((name.encode(), entry))
            data += raw
        header = _int_field(1, 1) + _field(3, versions)  # num_shards 1, little-endian
        with open(prefix + ".index", "wb") as f:
            f.write(_table([(b"", header)] + entries, block_type))
        with open(prefix + ".data-00000-of-00001", "wb") as f:
            f.write(bytes(data))
    else:
        metas, entries = [], []
        for name, a in arrays.items():
            full = b"".join(_field(1, b"") for _ in a.shape)  # an extent a dim, no length
            metas.append(_field(1, _field(1, name.encode()) + _field(2, _shape_proto(a.shape))
                                + _int_field(3, _TF_DTYPES[a.dtype]) + _field(4, full)))
            if a.dtype == np.float32:
                values = _field(5, a.astype("<f4").tobytes())
            else:  # int_val (7) / int64_val (10), packed varints
                values = _field(7 if a.dtype == np.int32 else 10,
                                b"".join(_varint(int(v)) for v in a.reshape(-1)))
            key = (b"\x00" + _ordered_string(name.encode())
                   + (bytes([1, a.ndim]) if a.ndim else b"\x00") + b"\x80\x7f" * a.ndim)
            saved = _field(1, name.encode()) + _field(2, full) + _field(3, values)
            entries.append((key, _field(2, saved)))
        meta = _field(1, b"".join(metas) + _field(2, versions))
        with open(prefix, "wb") as f:
            f.write(_table([(b"", meta)] + entries, block_type))
    with open(os.path.join(os.path.dirname(prefix), "checkpoint"), "w") as f:
        f.write(f'model_checkpoint_path: "{os.path.basename(prefix)}"\n')


_RESNET_UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def slim_resnet_vars(rs, depth: int = 50, heads=None):
    """Name -> float32 value of a slim resnet_v1_{depth} classification
    checkpoint at full width (its logits and the optimizer's slots
    included, which the converter skips); with `heads` =
    (num_classes, anchors a location, rpn depth) a TF OD API Faster
    R-CNN's first and second stage heads too."""
    out = {}
    prefix = f"resnet_v1_{depth}"

    def conv_bn(scope, shape):
        c = shape[-1]
        out[f"{scope}/weights"] = rs.normal(0, (2.0 / np.prod(shape[:3])) ** 0.5,
                                            shape).astype(np.float32)
        out[f"{scope}/BatchNorm/gamma"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
        out[f"{scope}/BatchNorm/beta"] = rs.normal(0, 0.1, c).astype(np.float32)
        out[f"{scope}/BatchNorm/moving_mean"] = rs.normal(0, 0.1, c).astype(np.float32)
        out[f"{scope}/BatchNorm/moving_variance"] = rs.uniform(0.5, 1.5, c).astype(np.float32)

    conv_bn(f"{prefix}/conv1", (7, 7, 3, 64))
    cin = 64
    for b, (n, d) in enumerate(zip(_RESNET_UNITS[depth], (256, 512, 1024, 2048)), start=1):
        for u in range(1, n + 1):
            base = f"{prefix}/block{b}/unit_{u}/bottleneck_v1"
            unit_in = cin if u == 1 else d
            conv_bn(f"{base}/conv1", (1, 1, unit_in, d // 4))
            conv_bn(f"{base}/conv2", (3, 3, d // 4, d // 4))
            conv_bn(f"{base}/conv3", (1, 1, d // 4, d))
            if u == 1:
                conv_bn(f"{base}/shortcut", (1, 1, unit_in, d))
        cin = d
    out[f"{prefix}/logits/weights"] = rs.normal(0, 0.01, (1, 1, 2048, 1000)).astype(np.float32)
    out[f"{prefix}/logits/biases"] = np.zeros(1000, np.float32)
    out[f"{prefix}/conv1/weights/Momentum"] = np.zeros((7, 7, 3, 64), np.float32)
    out["global_step"] = np.asarray(1000, np.int64)
    if heads is not None:
        k, a, depth_rpn = heads
        for scope, shape in (("Conv", (3, 3, 1024, depth_rpn)),
                             ("FirstStageBoxPredictor/ClassPredictor", (1, 1, depth_rpn, 2 * a)),
                             ("FirstStageBoxPredictor/BoxEncodingPredictor",
                              (1, 1, depth_rpn, 4 * a)),
                             ("SecondStageBoxPredictor/ClassPredictor", (2048, k + 1)),
                             ("SecondStageBoxPredictor/BoxEncodingPredictor", (2048, 4 * k))):
            out[f"{scope}/weights"] = rs.normal(0, 0.01, shape).astype(np.float32)
            out[f"{scope}/biases"] = rs.normal(0, 0.01, shape[-1]).astype(np.float32)
    return out



# the mask flagship's launches: a train step (the mask loss adds a crop of
# the matched ground-truth masks and an IoU launch), an eval batch of 8
MASK_LAUNCHES = ({"nms": 1, "roi_crop": 2, "roi_crop_backward": 1, "iou": 4},
                 {"nms": 2, "roi_crop": 1, "roi_crop_backward": 0, "iou": 0})
# the first run (the in-process loader), then the restart to step 8 fed by
# 4 loader worker processes, the masks in their shared memory
MASK_STEPS = (4, 8)
MASK_RUN_FLAGS = ([], ["--grain_workers", "4"])
MASK_METRICS = ("coco_mask_metrics", "pascal_voc_instance_segmentation_metrics")
NUM_KEYPOINTS = 3
CONVERSION_STEPS = 2


def write_mask_records(path: str, rs, n: int, sizes=VOC_SIZES) -> str:
    """n TFRecords of noise JPEGs (quality 90) at the given sizes, 1-20
    boxes each of VOC classes, each with a PNG instance mask (an ellipse
    filling its box, its edge ragged) and NUM_KEYPOINTS keypoints inside it."""
    from mtlx_torch.data import tfrecord
    from mtlx_torch.data.example_decoder import build_example

    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            h, wd = sizes[i % len(sizes)]
            image = rs.randint(0, 256, (h, wd, 3)).astype(np.uint8)
            k = rs.randint(1, 21)
            y0, x0 = rs.uniform(0, 0.8, k), rs.uniform(0, 0.8, k)
            boxes = np.stack([y0, x0, np.minimum(y0 + rs.uniform(0.05, 0.5, k), 1.0),
                              np.minimum(x0 + rs.uniform(0.05, 0.5, k), 1.0)], 1)
            yy, xx = np.mgrid[0:h, 0:wd]
            masks = []
            for b in boxes:
                cy, cx = (b[0] + b[2]) / 2 * h, (b[1] + b[3]) / 2 * wd
                ry, rx = max((b[2] - b[0]) / 2 * h, 1.0), max((b[3] - b[1]) / 2 * wd, 1.0)
                inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= rs.uniform(0.8, 1.0)
                masks.append(inside & (rs.uniform(size=(h, wd)) < 0.97))
            keypoints = (boxes[:, None, :2] + rs.uniform(0, 1, (k, NUM_KEYPOINTS, 2))
                         * (boxes[:, None, 2:] - boxes[:, None, :2]))
            labels = rs.randint(1, 21, k)
            w.write(build_example(encode_jpeg(image), b"jpeg", h, wd, f"mask{i}.jpeg", boxes,
                                  labels, [VOC_NAMES[c - 1] for c in labels],
                                  instance_masks=masks, keypoints=keypoints))
    return path


def mask_pipeline(record: str, label_map: str, fine_tune: str) -> str:
    """The flagship pipeline as a published TF OD API Mask R-CNN config sets
    it: predict_instance_masks in its mask_rcnn_box_predictor,
    load_instance_masks (and the records' keypoints) in both readers,
    eval_instance_masks and the COCO and Pascal mask metrics; its paths,
    checkpoint interval (2) and eval size (16) the only other changes."""
    text = cli_pipeline(record, label_map, fine_tune, save_every=2)
    reader = f"  load_instance_masks: true\n  num_keypoints: {NUM_KEYPOINTS}\n"
    reps = [("        use_dropout: false\n",
             "        use_dropout: false\n        predict_instance_masks: true\n"),
            ("train_input_reader: {\n", "train_input_reader: {\n" + reader),
            ("eval_input_reader: {\n", "eval_input_reader: {\n" + reader),
            ('  num_examples: 4952\n  metrics_set: "pascal_voc_metrics"\n',
             "  num_examples: 16\n" + "".join(f'  metrics_set: "{m}"\n' for m in MASK_METRICS)
             + "  eval_instance_masks: true\n")]
    for old, new in reps:
        if old not in text:
            raise AssertionError(f"{FLAGSHIP_CONFIG} no longer holds {old!r}")
        text = text.replace(old, new, 1)
    return text


def check_conversion(work: str, record: str, label_map: str, seed: int):
    """Slim ResNet-50 classification checkpoints at full width written as
    V2 and as V1, and a TF OD API Faster R-CNN checkpoint (the flagship's
    heads) as V2, each converted by `python -m
    mtlx_torch.tools.convert_checkpoint` in a process of its own and the
    flagship train CLI warm-started from the `.npz` for CONVERSION_STEPS
    steps: the tensors restored must be the tensors converted, the losses
    finite."""
    from mtlx_torch.train import train as train_cli

    rs = np.random.RandomState(seed + 31)
    slim = slim_resnet_vars(rs)
    checkpoints = {"slim_resnet_v1_50 (V2)": (slim, 2, "classification"),
                   "slim_resnet_v1_50 (V1)": (slim, 1, "classification"),
                   "TF OD API faster_rcnn_resnet50 (V2)": (
                       slim_resnet_vars(rs, heads=(20, 12, 512)), 2, "detection")}
    out = {}
    for i, (tag, (values, version, kind)) in enumerate(checkpoints.items()):
        d = os.path.join(work, f"tf_{i}")
        os.makedirs(d)
        prefix = os.path.join(d, "model.ckpt")
        t0 = time.perf_counter()
        write_tf_checkpoint(prefix, values, version)
        write_s = time.perf_counter() - t0
        npz = os.path.join(d, "converted.npz")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mtlx_torch.tools.convert_checkpoint",
                               "--tf_checkpoint", prefix, "--type", kind, "--output", npz],
                              cwd=REPO, env=repo_env(), capture_output=True, text=True,
                              timeout=300)
        convert_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"convert_checkpoint failed on {tag}:\n{proc.stderr[-3000:]}")
        line = proc.stdout.splitlines()[0]
        converted, unmapped = (int(v) for v in
                               line.split("converted ")[1].split(" unmapped")[0]
                               .replace(" tensors (", " ").split())
        pipeline = os.path.join(d, "pipeline.config")
        text = cli_pipeline(record, label_map, npz, save_every=None)
        if kind == "detection":
            text = text.replace("from_detection_checkpoint: false",
                                "from_detection_checkpoint: true")
        with open(pipeline, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        run, _ = run_cli(train_cli.main, ["--pipeline_config_path", pipeline, "--train_dir",
                                          os.path.join(d, "train"), "--num_steps",
                                          str(CONVERSION_STEPS), "--log_every", "1",
                                          "--seed", str(seed)])
        train_s = time.perf_counter() - t0
        warm = next(ln for ln in run.splitlines() if "[train] warm start: " in ln)
        restored, skipped = (int(v) for v in warm.split("warm start: ")[1]
                             .replace(" restored,", "").replace(" skipped", "").split())
        lines = train_log_lines(run)
        losses = [ln["total_loss"] for ln in lines]
        log(f"[convert] {tag}: {len(values)} TF tensors written in {write_s:.2f} s, "
            f"`{line}` in {convert_s:.2f} s (its own process); the flagship train CLI "
            f"warm-started: {restored} tensors restored of {converted} converted "
            f"({skipped} of the model's left at init), {len(lines)} steps in {train_s:.2f} s, "
            f"total_loss {[round(v, 5) for v in losses]}")
        if restored != converted or len(lines) != CONVERSION_STEPS \
                or not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"{tag}: restored {restored} of {converted} converted, "
                                 f"losses {losses}")
        out[tag] = dict(tensors=len(values), converted=converted, unmapped=unmapped,
                        restored=restored, skipped=skipped, write_s=write_s,
                        convert_s=convert_s, train_s=train_s, total_loss=losses)
        torch.cuda.empty_cache()
    return out


def phase_masks(seed: int, results):
    """Checkpoint conversion (check_conversion), then the flagship as a
    Mask R-CNN through the CLIs on records with instance masks and
    keypoints: train and restart with exact launches a step, eval with the
    COCO and Pascal mask metrics, every kernel call of a recorded train
    step and eval batch held to its plain version, the mask-target crop
    timed, export and a 600x800 request returning detection_masks; and a
    resnet10 mask train step on the card against the CPU."""
    import shutil
    import tempfile

    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mtlx_masks_")
    try:
        record = write_mask_records(os.path.join(work, "voc_masks.record"),
                                    np.random.RandomState(seed + 30), 32)
        label_map = os.path.join(work, "label_map.pbtxt")
        with open(label_map, "w") as f:
            f.writelines(f"item {{ id: {i + 1} name: '{n}' }}\n" for i, n in enumerate(VOC_NAMES))
        records_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        conversion = check_conversion(work, record, label_map, seed)
        conversion_s = time.perf_counter() - t0

        fine_tune = os.path.join(work, "warm_start")
        pipeline = os.path.join(work, "pipeline.config")
        with open(pipeline, "w") as f:
            f.write(mask_pipeline(record, label_map, fine_tune))
        write_warm_start(pipeline, record, fine_tune, seed)
        train_dir = os.path.join(work, "train")
        runs = train_cli_runs(pipeline, train_dir, MASK_STEPS, seed, "masks", MASK_LAUNCHES[0],
                              MASK_RUN_FLAGS)
        if f"resumed from step {MASK_STEPS[0]}" not in runs[1]["out"]:
            raise AssertionError("masks: the restart did not resume")
        lines = runs[0]["lines"] + runs[1]["lines"]
        if not all("Loss/BoxClassifierLoss/mask_loss" in ln for ln in lines):
            raise AssertionError("masks: a step logged no mask loss")
        step_ms = [16 / ln["images_per_sec"] * 1e3 for ln in lines]
        peak_gib = max(r["peak"] for r in runs) / 2**30
        log(f"[masks] train {MASK_STEPS[0]} steps (in-process loader) + restart to "
            f"{MASK_STEPS[1]} ({' '.join(MASK_RUN_FLAGS[1])}) at batch 16 "
            f"({runs[0]['wall']:.2f} + {runs[1]['wall']:.2f} s CLI wall); step ms "
            f"{[round(t, 2) for t in step_ms]}; peak {peak_gib:.2f} GiB; launches a step "
            f"{MASK_LAUNCHES[0]}; mask_loss "
            f"{[round(ln['Loss/BoxClassifierLoss/mask_loss'], 5) for ln in lines]}; total_loss "
            f"{[round(ln['total_loss'], 5) for ln in lines]}")
        wait = [ln["loader_wait_share"] for ln in lines]
        loader = {"masks and keypoints": loader_ms(record, (1024, 1024), load_instance_masks=True,
                                                   num_keypoints=NUM_KEYPOINTS),
                  "boxes only": loader_ms(record, (1024, 1024))}
        log(f"[masks] loader wait share {[round(v, 4) for v in wait]}; the host loader's ms a "
            f"batch of 16 of these records (2 passes) with masks and keypoints "
            f"{[round(t, 2) for t in loader['masks and keypoints']]}, without "
            f"{[round(t, 2) for t in loader['boxes only']]}")
        flagship = results.get("cli")
        if flagship is not None:
            log(f"[masks] beside it, the flagship without masks (phase 8, this run, 64 "
                f"records): step ms {[round(t, 2) for t in flagship['train_step_ms']]}; peak "
                f"{flagship['train_peak_bytes'] / 2**30:.2f} GiB")
        # what the mask head costs the model: the mask flagship and the
        # flagship on the same pre-loaded batches of these records
        flagship_pipeline = os.path.join(work, "flagship.config")
        with open(flagship_pipeline, "w") as f:
            f.write(cli_pipeline(record, label_map, fine_tune, save_every=2))
        alone = {}
        for tag, path, kw in (("masks", pipeline, dict(load_instance_masks=True,
                                                       num_keypoints=NUM_KEYPOINTS)),
                              ("flagship", flagship_pipeline, {})):
            torch.cuda.empty_cache()
            model = calibrated_model(path, record, seed)
            torch.cuda.reset_peak_memory_stats()
            alone[tag] = time_steps_without_loader(model, record, seed, f"masks, {tag}", **kw)
            alone[tag]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            del model
        torch.cuda.empty_cache()
        med = {tag: float(np.median(r["alone_ms"])) for tag, r in alone.items()}
        log(f"[masks] on the same pre-loaded batches (no loader): median step "
            f"{med['masks']:.2f} ms with the mask head, {med['flagship']:.2f} ms without, "
            f"+{med['masks'] - med['flagship']:.2f} ms; peak {alone['masks']['peak_gib']:.2f} "
            f"against {alone['flagship']['peak_gib']:.2f} GiB")

        reset_kernel_counts()
        out, metrics = run_cli(eval_cli.main, ["--pipeline_config_path", pipeline,
                                               "--checkpoint_dir", train_dir, "--eval_dir",
                                               os.path.join(work, "eval"), "--run_once"])
        eval_per_batch = {k: v / 2 for k, v in kernel_counts().items()}
        mask_map = metrics["DetectionMasks_Precision/mAP"]
        pascal_map = metrics["PascalMasks_Precision/mAP@0.5IOU"]
        log(f"[masks] eval at step {MASK_STEPS[1]} on 16 records: DetectionMasks mAP "
            f"{mask_map:.6g}, PascalMasks mAP@0.5 {pascal_map:.6g}, "
            f"{metrics['eval/images_per_sec']:.2f} img/s, launches a batch of 8 {eval_per_batch}")
        if not (np.isfinite(mask_map) and np.isfinite(pascal_map)) \
                or eval_per_batch != MASK_LAUNCHES[1]:
            raise AssertionError(f"mask eval: mAP {mask_map} / {pascal_map}, launches "
                                 f"{eval_per_batch}")

        calls = train_step_calls(pipeline, train_dir, seed)[0]
        shapes = {"train": check_kernels_on(calls, "mask train step"),
                  "eval": check_kernels_on(eval_batch_calls(pipeline, train_dir),
                                           "mask eval batch")}
        (features, boxes, crop_size), _ = next(c for c in calls["roi_crop"]
                                               if c[0][0].shape[-1] == 1)
        target_crop = time_crop(features, boxes, int(crop_size[0]), "mask targets")
        del calls
        torch.cuda.empty_cache()

        export_dir = os.path.join(work, "export")
        run_cli(exporter.main, ["--pipeline_config_path", pipeline, "--trained_checkpoint_dir",
                                train_dir, "--output_directory", export_dir])
        served = InferenceModel.load(export_dir)
        image = request_picture(np.random.RandomState(seed + 32), 600, 800)
        det = served.predict_images([image])
        check_outputs(det, 1)
        masks = det.get("detection_masks")
        n = int(det["num_detections"][0])
        if masks is None or masks.shape != (1, 300, 14, 14) or not np.isfinite(masks).all() \
                or masks.min() < 0 or masks.max() > 1:
            raise AssertionError(f"the mask bundle's request: detection_masks "
                                 f"{None if masks is None else masks.shape}")
        request_ms = serve_ms(served, image)
        log(f"[masks] one 600x800 request through the mask bundle: {n} detections, "
            f"detection_masks {masks.shape} in [{masks.min():.3g}, {masks.max():.3g}]; ms a "
            f"request (10, sorted) {[round(t, 2) for t in request_ms]}")
        del served

        t0 = time.perf_counter()
        phase_train_card_vs_cpu(seed, masks=True)
        cvc_s = time.perf_counter() - t0
        wall = time.perf_counter() - t_phase
        log(f"[masks] phase 15: {wall:.1f} s (records {records_s:.1f} s, conversion "
            f"{conversion_s:.1f} s, card vs CPU {cvc_s:.1f} s)")
        results["masks"] = dict(
            conversion=conversion, step_ms=step_ms, peak_memory_gib=peak_gib,
            loader_wait_share=wait, loader_ms=loader, steps_without_loader=alone,
            train_launches_per_step=MASK_LAUNCHES[0], eval_launches_per_batch=eval_per_batch,
            eval_mask_map=mask_map, eval_pascal_mask_map=pascal_map, shapes=shapes,
            target_crop=target_crop, request_ms=request_ms, wall_s=wall)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 16

CLASSIFIER_RUNS = (("resnet50", 8), ("mobilenet_v1", 4))  # --model, steps
CLASSIFIER_BATCH = 64
CLASSIFIER_RECORDS = 64
# ImageNet-like (height, width): 500x375 and 375x500 (w x h)
IMAGENET_SIZES = ((375, 500), (500, 375))
WARM_START_STEPS = 2
DEVKIT_IMAGES = 16
CROP_IMAGES, CROP_SIDE, CROP_OUT = 64, 256, 224
# card against CPU, float32 with TF32 off: the trunks' outputs within
# 1e-4 of the largest magnitude (phases 11-12), the classifier step's
# loss within 1e-4 relative and its gradients and updates within 1e-3
# (L2 of the difference over L2) as phase 7's
TRUNK_TOL = 1e-4
BACKBONE_FORWARD_BATCH = 32
# name, module, classifier, image side (slim's for Inception v3 / v4)
BACKBONES = (("inception_v1", "inception_v1", "InceptionV1Classifier", 224),
             ("inception_v3", "inception_v3", "InceptionV3Classifier", 299),
             ("inception_v4", "inception_v4", "InceptionV4Classifier", 299),
             ("vgg16", "vgg", "VGG16Classifier", 224),
             ("alexnet", "alexnet", "AlexNetClassifier", 224))


def write_classification_records(path: str, rs, n: int, num_classes: int = 1000) -> str:
    """n TFRecords of slim's classification schema (`image/encoded`, a
    noise JPEG of quality 90 at ImageNet-like sizes in turn, and
    `image/class/label`)."""
    from mtlx_torch.data import tfrecord
    from mtlx_torch.data.example_decoder import (bytes_feature, int64_list_feature,
                                                 serialize_example)

    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            h, wd = IMAGENET_SIZES[i % len(IMAGENET_SIZES)]
            image = rs.randint(0, 256, (h, wd, 3)).astype(np.uint8)
            w.write(serialize_example({
                "image/encoded": bytes_feature(encode_jpeg(image)),
                "image/format": bytes_feature(b"jpeg"),
                "image/class/label": int64_list_feature([rs.randint(num_classes)])}))
    return path


def run_classifier_cli(model: str, steps: int, record: str, work: str, export=None):
    """`python -m mtlx_torch.train.train_classifier` at full width (224x224,
    batch 64, 1000 classes) in a process of its own; returns its [cls]
    lines, summary and wall seconds."""
    argv = [sys.executable, "-m", "mtlx_torch.train.train_classifier", "--model", model,
            "--train_record", record, "--train_dir", os.path.join(work, f"cls_{model}"),
            "--num_classes", "1000", "--image_size", "224", "--batch_size",
            str(CLASSIFIER_BATCH), "--num_steps", str(steps), "--log_every", "1"]
    if export:
        argv += ["--export_backbone", export]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, env=repo_env(), capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"train_classifier {model} failed:\n{proc.stderr[-3000:]}")
    lines = [json.loads(ln[len("[cls] "):]) for ln in proc.stdout.splitlines()
             if ln.startswith("[cls] {")]
    summary = json.loads(next(ln for ln in proc.stdout.splitlines()
                              if ln.startswith("[cls] summary "))[len("[cls] summary "):])
    if [ln["step"] for ln in lines] != list(range(1, steps + 1)) \
            or not all(np.isfinite(ln["loss"]) for ln in lines) \
            or len(summary["step_ms"]) != steps or "[cls] done" not in proc.stdout:
        raise AssertionError(f"train_classifier {model}: lines {lines}")
    exported = None
    if export:
        marker = f"exported backbone warm-start checkpoint to {export} ("
        line = next(ln for ln in proc.stdout.splitlines() if marker in ln)
        exported = int(line.split(marker)[1].split()[0])
    steady = summary["step_ms"][1:]
    log(f"[classifier] {model} CLI, {steps} steps at batch {CLASSIFIER_BATCH}, 224x224, 1000 "
        f"classes ({wall:.2f} s wall, its own process): step ms from step 2 (CUDA events) "
        f"{[round(t, 2) for t in steady]} (median {np.median(steady):.2f}, "
        f"{CLASSIFIER_BATCH / np.median(steady) * 1e3:.1f} img/s on the device), step 1 "
        f"{summary['step_ms'][0]:.2f}; host decode ms a batch "
        f"{[round(t, 1) for t in summary['decode_ms']]}; CLI img/s "
        f"{lines[-1]['images_per_sec']}; peak {summary['peak_memory_bytes'] / 2**30:.2f} GiB; "
        f"loss {[ln['loss'] for ln in lines]}")
    return dict(lines=lines, step_ms=summary["step_ms"], decode_ms=summary["decode_ms"],
                median_step_ms=float(np.median(steady)),
                device_images_per_sec=CLASSIFIER_BATCH / float(np.median(steady)) * 1e3,
                cli_images_per_sec=lines[-1]["images_per_sec"],
                peak_memory_bytes=summary["peak_memory_bytes"], wall_s=wall,
                exported_tensors=exported)


def _voc_xml(filename: str, h: int, w: int, objects) -> str:
    parts = [f"<annotation><filename>{filename}</filename><size><width>{w}</width>"
             f"<height>{h}</height><depth>3</depth></size>"]
    for name, (y0, x0, y1, x1), difficult in objects:
        parts.append(f"<object><name>{name}</name><pose>Unspecified</pose>"
                     f"<truncated>0</truncated><difficult>{difficult}</difficult><bndbox>"
                     f"<xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax>"
                     f"</bndbox></object>")
    return "".join(parts) + "</annotation>"


def _pixel_boxes(rs, h: int, w: int, k: int):
    y0, x0 = rs.randint(0, int(h * 0.7), k), rs.randint(0, int(w * 0.7), k)
    return [(a, b, min(a + rs.randint(20, h // 2), h - 1), min(b + rs.randint(20, w // 2), w - 1))
            for a, b in zip(y0, x0)]


def write_devkits(work: str, rs, n: int = DEVKIT_IMAGES):
    """Tiny VOC, COCO and Pet devkits of n noise JPEGs each (VOC's sizes;
    COCO's for COCO), with 1-5 objects an image, a tenth difficult (VOC,
    Pet) or crowd (COCO)."""
    from mtlx_torch.data.pet import PET_CLASSES

    voc = os.path.join(work, "VOCdevkit", "VOC2007")
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        os.makedirs(os.path.join(voc, sub))
    ids = []
    for i in range(n):
        h, w = VOC_SIZES[i % len(VOC_SIZES)]
        ids.append(f"{i:06d}")
        with open(os.path.join(voc, "JPEGImages", f"{ids[-1]}.jpg"), "wb") as f:
            f.write(encode_jpeg(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)))
        objects = [(VOC_NAMES[rs.randint(20)], box, int(rs.uniform() < 0.1))
                   for box in _pixel_boxes(rs, h, w, rs.randint(1, 6))]
        with open(os.path.join(voc, "Annotations", f"{ids[-1]}.xml"), "w") as f:
            f.write(_voc_xml(f"{ids[-1]}.jpg", h, w, objects))
    with open(os.path.join(voc, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("".join(f"{e}\n" for e in ids))

    coco = os.path.join(work, "coco")
    os.makedirs(os.path.join(coco, "images"))
    cats = coco_categories()
    images, anns = [], []
    for i in range(n):
        h, w = COCO_SIZES[i % len(COCO_SIZES)]
        images.append({"id": i + 1, "file_name": f"{i:012d}.jpg", "height": h, "width": w})
        with open(os.path.join(coco, "images", images[-1]["file_name"]), "wb") as f:
            f.write(encode_jpeg(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)))
        for y0, x0, y1, x1 in _pixel_boxes(rs, h, w, rs.randint(1, 6)):
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": cats[rs.randint(len(cats))]["id"],
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "iscrowd": int(rs.uniform() < 0.1)})
    coco_json = os.path.join(coco, "instances.json")
    with open(coco_json, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c["id"], "name": c["name"]} for c in cats]}, f)

    pet = os.path.join(work, "pet")
    for sub in ("images", "annotations/xmls"):
        os.makedirs(os.path.join(pet, sub))
    ids = []
    for i in range(n):
        breed = PET_CLASSES[rs.randint(len(PET_CLASSES))]
        ids.append(f"{breed}_{i + 1}")
        h, w = VOC_SIZES[i % len(VOC_SIZES)]
        with open(os.path.join(pet, "images", f"{ids[-1]}.jpg"), "wb") as f:
            f.write(encode_jpeg(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)))
        kind = "cat" if breed[0].isupper() else "dog"
        with open(os.path.join(pet, "annotations", "xmls", f"{ids[-1]}.xml"), "w") as f:
            f.write(_voc_xml(f"{ids[-1]}.jpg", h, w, [(kind, _pixel_boxes(rs, h, w, 1)[0], 0)]))
    with open(os.path.join(pet, "annotations", "trainval.txt"), "w") as f:
        f.write("".join(f"{e} 1 1 1\n" for e in ids))
    return os.path.join(work, "VOCdevkit"), (coco_json, os.path.join(coco, "images")), pet


def run_record_tools(work: str, seed: int):
    """The three `mtlx_torch.tools.create_*_tf_record` CLIs (their `main`) on
    tiny devkits; every record decodes through the port's reader. Returns
    the VOC record and label map paths."""
    import importlib

    from mtlx_torch.data.example_decoder import decode_example
    from mtlx_torch.data.tfrecord import read_records

    voc, (coco_json, coco_images), pet = write_devkits(work, np.random.RandomState(seed + 40))
    out = {name: os.path.join(work, f"{name}.record") for name in ("voc", "coco", "pet")}
    label_map = os.path.join(work, "pascal_label_map.pbtxt")
    commands = {
        "voc": ["mtlx_torch.tools.create_pascal_tf_record", "--data_dir", voc, "--set",
                "trainval", "--year", "VOC2007", "--write_label_map", label_map],
        "coco": ["mtlx_torch.tools.create_coco_tf_record", "--annotations_file", coco_json,
                 "--image_dir", coco_images],
        "pet": ["mtlx_torch.tools.create_pet_tf_record", "--data_dir", pet, "--set",
                "trainval"]}
    result = {}
    for name, argv in commands.items():
        t0 = time.perf_counter()
        printed, count = run_cli(importlib.import_module(argv[0]).main,
                                 argv[1:] + ["--output_path", out[name]])
        wall = time.perf_counter() - t0
        records = list(read_records(out[name], verify_crc=True))
        objects = sum(len(decode_example(r, decode_image=False)["groundtruth_classes"])
                      for r in records)
        log(f"[classifier] {argv[0]}: `{printed.strip()}` in {wall:.2f} s; {len(records)} "
            f"records, {objects} objects, all decoded")
        if len(records) != DEVKIT_IMAGES or count != DEVKIT_IMAGES:
            raise AssertionError(f"{argv[0]}: {len(records)} records, want {DEVKIT_IMAGES}")
        result[name] = dict(records=len(records), objects=objects, wall_s=wall)
    return out["voc"], label_map, result


def warm_start_and_eval(work: str, record: str, label_map: str, export: str, exported: int,
                        seed: int):
    """The flagship train CLI warm-started from the classifier's exported
    backbone (from_detection_checkpoint false) for WARM_START_STEPS steps on
    the VOC writer's records, then the eval CLI once on them."""
    from mtlx_torch.eval import eval as eval_cli

    pipeline = os.path.join(work, "warm_start.config")
    with open(pipeline, "w") as f:
        f.write(cli_pipeline(record, label_map, export, save_every=None))
    train_dir = os.path.join(work, "warm_train")
    want = {"nms": 1, "roi_crop": 1, "roi_crop_backward": 1, "iou": 3}
    run = train_cli_runs(pipeline, train_dir, [WARM_START_STEPS], seed, "classifier warm start",
                         want)[0]
    warm = next(ln for ln in run["out"].splitlines() if "[train] warm start: " in ln)
    restored, skipped = (int(v) for v in warm.split("warm start: ")[1]
                         .replace(" restored,", "").replace(" skipped", "").split())
    log(f"[classifier] the flagship train CLI warm-started from the exported ResNet-50 "
        f"classifier: {restored} tensors restored (the backbone and block4: {exported} "
        f"exported), {skipped} skipped; {WARM_START_STEPS} steps on the VOC writer's "
        f"{DEVKIT_IMAGES} records, launches a step {want}; total_loss "
        f"{[round(ln['total_loss'], 5) for ln in run['lines']]}")
    if restored != exported:
        raise AssertionError(f"warm start restored {restored} of {exported} exported tensors")
    reset_kernel_counts()
    out, metrics = run_cli(eval_cli.main, ["--pipeline_config_path", pipeline, "--checkpoint_dir",
                                           train_dir, "--eval_dir", os.path.join(work, "eval"),
                                           "--run_once"])
    per_batch = {k: v / 2 for k, v in kernel_counts().items()}
    voc_map = metrics["Precision/mAP@0.5IOU"]
    log(f"[classifier] eval on the {DEVKIT_IMAGES} VOC writer records: mAP@0.5 {voc_map:.6g}, "
        f"launches a batch of 8 {per_batch}")
    if not np.isfinite(voc_map) or per_batch != {"nms": 2, "roi_crop": 1,
                                                 "roi_crop_backward": 0, "iou": 0}:
        raise AssertionError(f"warm-start eval: mAP {voc_map}, launches {per_batch}")
    return dict(restored=restored, skipped=skipped, exported=exported,
                total_loss=[ln["total_loss"] for ln in run["lines"]],
                train_launches_per_step=want, eval_launches_per_batch=per_batch, eval_map=voc_map)


def classifier_step_card_vs_cpu(seed: int):
    """One float32 ResNet-50 classifier step (live batch norm, TF32 off) on
    a batch of 4 224x224 images on the card and on the CPU, from the same
    seeded weights: logits, loss and the moving statistics against the
    CPU's, the gradients against the CPU's float64 ones."""
    from mtlx_torch.backbones import resnet
    from mtlx_torch.train import train_classifier as tcls
    from mtlx_torch.train import train_step as ts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(seed + 41)
    images = torch.from_numpy(rs.uniform(0, 255, (4, 224, 224, 3)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 1000, 4))
    side = {}
    for dev in ("cpu", "cuda"):
        net = resnet.ResNetClassifier(50, 1000, dtype=torch.float32)
        tcls.init_weights(net, torch.Generator().manual_seed(seed))
        net.to(dev)
        model = tcls.Classifier(net, resnet.preprocess_images)
        state = ts.create_train_state(model, tcls.make_optimizer(0.1, 1000))
        with torch.no_grad():
            logits = net.train()(resnet.preprocess_images(images.to(dev)))
        for norm in resnet.live_batch_norms(net):
            norm.batch_stats = None
        state, loss, _ = tcls.make_classifier_step(model)(state, images.to(dev), labels.to(dev))
        side[dev] = dict(logits=logits.cpu(), loss=loss.item(),
                         grads={k: p.grad.cpu() for k, p in net.named_parameters()},
                         stats={k: b.cpu() for k, b in net.named_buffers()})
    # the same gradients on the CPU in float64
    net = resnet.ResNetClassifier(50, 1000, dtype=torch.float32)
    tcls.init_weights(net, torch.Generator().manual_seed(seed))
    net.double()
    for m in net.modules():
        for attr in ("compute_dtype", "dtype"):
            if isinstance(getattr(m, attr, None), torch.dtype):
                setattr(m, attr, torch.float64)
    tcls.softmax_cross_entropy(net.train()(resnet.preprocess_images(images.double())),
                               labels).mean().backward()
    g64 = {k: p.grad for k, p in net.named_parameters()}
    c, g = side["cpu"], side["cuda"]
    l2 = lambda d, t: float(d.norm() / t.norm().clamp_min(1e-30))
    peak = lambda d, t: float(d.abs().max() / t.abs().max().clamp_min(1e-30))
    cat = lambda d: torch.cat([t.double().flatten() for t in d.values()])
    logit_err = peak(g["logits"] - c["logits"], c["logits"])
    stat_err = max(peak(g["stats"][k] - t, t) for k, t in c["stats"].items())
    card_l2, cpu_l2 = (l2(cat(side[d]["grads"]) - cat(g64), cat(g64)) for d in ("cuda", "cpu"))
    worst = max((l2(g["grads"][k] - t, t), k) for k, t in c["grads"].items())
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    # live batch norm takes mtlx's variance, E[x^2] - E[x]^2 in float32,
    # whose cancellation at seeded random weights leaves float32 gradients
    # percents from float64 ones on any device: the card's gradients (the
    # update at step 1) are held to float64 within twice the CPU's own
    # float32 error plus 1e-3 (L2, all tensors together)
    log(f"[classifier] card vs CPU gradients: L2 of the difference over L2 against the CPU's "
        f"float64 ones, card {card_l2:.3g}, CPU float32 {cpu_l2:.3g}; card against CPU, the "
        f"worst tensor {worst[0]:.3g} at {worst[1]}")
    checks = [("logits, max diff over the largest magnitude", logit_err, TRUNK_TOL),
              ("loss, relative diff", loss_rel, 1e-4),
              ("gradients against float64, L2 of the difference over L2", card_l2,
               2 * cpu_l2 + 1e-3),
              ("moving statistics, max diff over the largest magnitude", stat_err, TRUNK_TOL)]
    log(f"[classifier] card vs CPU: one float32 ResNet-50 classifier step, batch 4, 224x224, "
        f"TF32 off; loss card {g['loss']:.6g}, cpu {c['loss']:.6g}")
    failed = []
    for name, value, tol in checks:
        log(f"[classifier] card vs CPU {name}: {value:.3g} (tolerance {tol}) "
            f"{'ok' if value <= tol else 'FAIL'}")
        if value > tol:
            failed.append(name)
    if failed:
        raise AssertionError(f"classifier step, card and CPU disagree: {failed}")
    return {name: value for name, value, _ in checks}


def classification_crops(seed: int):
    """vgg_preprocess and inception_preprocess on 64 noise images of 256x256,
    train and eval: one crop launch a call, the result on the card within
    1e-5 of the CPU's; the crop kernel on each call's boxes bit-equal to
    its plain version and timed (`time_crop`)."""
    from mtlx_torch.data import classification_preprocessing as cp

    rs = np.random.RandomState(seed + 42)
    images = torch.from_numpy(rs.uniform(0, 255, (CROP_IMAGES, CROP_SIDE, CROP_SIDE, 3))
                              .astype(np.float32))
    draws = cp.make_draws(CROP_IMAGES, torch.Generator().manual_seed(seed))
    gpu_images = images.cuda()
    gpu_draws = {k: v.cuda() for k, v in draws.items()}
    out = {}
    for style, fn, min_area in (("vgg", cp.vgg_preprocess, 0.5),
                                ("inception", cp.inception_preprocess, 0.08)):
        for training in (True, False):
            tag = f"{style} {'train' if training else 'eval'}"
            reset_kernel_counts()
            got = fn(gpu_images, gpu_draws if training else None, (CROP_OUT, CROP_OUT), training)
            torch.cuda.synchronize()
            launches = kernel_counts()["roi_crop"]
            want = fn(images, draws if training else None, (CROP_OUT, CROP_OUT), training)
            err = float((got.cpu() - want).abs().max() / want.abs().max())
            log(f"[classification-crop] {tag}: {launches} crop launch, the card's result within "
                f"{err:.3g} of the CPU's (tolerance 1e-5)")
            if launches != 1 or err > 1e-5:
                raise AssertionError(f"{tag}: {launches} crop launches, card vs CPU {err}")
            out[tag] = dict(launches=launches, card_vs_cpu=err)
    boxes = {"vgg train": cp.random_crop_boxes(gpu_draws, CROP_SIDE, CROP_SIDE, min_area=0.5),
             "inception train": cp.random_crop_boxes(gpu_draws, CROP_SIDE, CROP_SIDE),
             "eval": torch.tensor([0.0625, 0.0625, 0.9375, 0.9375], device="cuda")
             .expand(CROP_IMAGES, 4)}
    timed = {tag: time_crop(gpu_images, b[:, None].contiguous(), CROP_OUT,
                            f"classification crop, {tag}")
             for tag, b in boxes.items()}
    return dict(calls=out, timed=timed)


def backbones_on_card(seed: int):
    """Inception v1 / v3 / v4, VGG-16 and AlexNet at full width: Features
    and Classifier in float32 (TF32 off) on the card against the CPU on 2
    images, within TRUNK_TOL of the largest magnitude; the bfloat16
    classifier's forward timed at batch 32."""
    import importlib

    from mtlx_torch.train.train_classifier import init_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, module, cls, side in BACKBONES:
        make = getattr(importlib.import_module(f"mtlx_torch.backbones.{module}"), cls)
        kw = {"image_size": side} if name in ("vgg16", "alexnet") else {}
        net = make(1000, torch.float32, **kw).eval()
        init_weights(net, torch.Generator().manual_seed(seed))
        trunk = net.features if hasattr(net, "features") else net.body
        x = torch.from_numpy(np.random.RandomState(seed + 43).normal(0, 1, (2, side, side, 3))
                             .astype(np.float32))
        with torch.no_grad():
            want = [*map(torch.Tensor.clone, _as_list(trunk(x))), net(x)]
            net.cuda()
            got = [t.cpu() for t in [*_as_list(trunk(x.cuda())), net(x.cuda())]]
        errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        net16 = make(1000, torch.bfloat16, **kw).eval()
        net16.load_state_dict(net.state_dict())
        net16.cuda().to(memory_format=torch.channels_last)
        x16 = torch.randn(BACKBONE_FORWARD_BATCH, side, side, 3, device="cuda")
        with torch.no_grad():
            ms = cuda_ms(lambda: net16(x16), 10)
        params = sum(p.numel() for p in net.parameters())
        log(f"[backbones] {name} ({params / 1e6:.2f} M parameters) at {side}x{side}: card vs CPU "
            f"float32 (trunk endpoints, logits) max diff over the largest magnitude "
            f"{[f'{e:.3g}' for e in errs]} (tolerance {TRUNK_TOL}); bfloat16 forward at batch "
            f"{BACKBONE_FORWARD_BATCH} {ms:.3f} ms ({BACKBONE_FORWARD_BATCH / ms * 1e3:.1f} img/s)")
        if max(errs) > TRUNK_TOL:
            raise AssertionError(f"{name}: card and CPU disagree, {errs}")
        out[name] = dict(side=side, params=params, card_vs_cpu=errs, bf16_forward_ms=ms)
        del net, net16
        torch.cuda.empty_cache()
    return out


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def phase_classifier(seed: int, results):
    """Classifier pretraining and the record writers: the ResNet-50 and
    MobileNet-v1 classifier CLIs at full width, the ResNet-50 export
    warm-starting the flagship train CLI (from_detection_checkpoint false)
    on the VOC record writer's records, then the eval CLI; one classifier
    step on the card against the CPU; the classification crop; the five
    other classification backbones on the card against the CPU."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mtlx_classifier_")
    try:
        record = write_classification_records(os.path.join(work, "imagenet.record"),
                                              np.random.RandomState(seed + 44),
                                              CLASSIFIER_RECORDS)
        export = os.path.join(work, "r50_backbone.pt")
        records_s = time.perf_counter() - t_phase
        clis = {model: run_classifier_cli(model, steps, record, work,
                                          export if model == "resnet50" else None)
                for model, steps in CLASSIFIER_RUNS}
        voc_record, label_map, tools = run_record_tools(work, seed)
        t0 = time.perf_counter()
        warm = warm_start_and_eval(work, voc_record, label_map, export,
                                   clis["resnet50"]["exported_tensors"], seed)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step_check = classifier_step_card_vs_cpu(seed)
        step_check_s = time.perf_counter() - t0
        crops = classification_crops(seed)
        t0 = time.perf_counter()
        backbones = backbones_on_card(seed)
        backbones_s = time.perf_counter() - t0
        wall = time.perf_counter() - t_phase
        log(f"[classifier] phase 16: {wall:.1f} s (records {records_s:.1f} s, classifier CLIs "
            f"{sum(c['wall_s'] for c in clis.values()):.1f} s, record tools "
            f"{sum(t['wall_s'] for t in tools.values()):.1f} s, warm start and eval "
            f"{warm_s:.1f} s, card vs CPU {step_check_s:.1f} s, backbones {backbones_s:.1f} s)")
        results["classifier"] = dict(clis=clis, record_tools=tools, warm_start=warm,
                                     card_vs_cpu=step_check, crops=crops, backbones=backbones,
                                     wall_s=wall)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 17


SPATIAL_CANVAS = (2048, 2048)  # the large-image case spatial partitioning is for
SPATIAL_BATCH = 2
SPATIAL_STEPS = 3
SPATIAL_LAUNCHES = {"nms": 1, "roi_crop": 1, "roi_crop_backward": 1, "iou": 3}
GRID_CANVAS = (128, 128)

# one rank of phase 17's grids. "flagship": the full-width MTL R50 over
# (data=1, spatial=world), a warm-up step whose kernel calls are held to
# their plain versions, then SPATIAL_STEPS timed steps (ms, peak memory,
# launches a step); "grids": one float32 resnet10 step (TF32 off) over
# (data=2, spatial=2), over the hybrid (data_dcn=2, data=2) grid and over
# four flat ranks, with the draws of the global batch
_SPATIAL_RANK = r"""
import sys
import time
import torch
import chip_smoke as cs
from mtlx_torch.detector.faster_rcnn import FasterRCNN
from mtlx_torch.parallel import distributed, spatial
from mtlx_torch.train import train_step as ts

mode, data_path, out, device, backend = sys.argv[1:6]
data = torch.load(data_path, weights_only=False)
if mode == "grids":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
device, replicas = distributed.init_process_group(device, backend=backend)


def setup(mesh):
    model = FasterRCNN(data["cfg"], device=device)
    model.modules.load_state_dict(data["weights"])
    state = ts.create_train_state(model, ts.make_optimizer(learning_rate=data["lr"]))
    if isinstance(mesh, spatial.SpatialMesh):
        step = spatial.make_spatial_train_step(model, mesh)
        batch = spatial.shard_batch_spatial(mesh, data["batch"])
    else:
        step = ts.make_train_step(model, replicas=mesh)
        batch = {k: mesh.rows(v) for k, v in data["batch"].items()}
    return model, state, step, {k: v.to(device) for k, v in batch.items()}


result = {}
if mode == "flagship":
    model, state, step, batch = setup(spatial.create_spatial_mesh(1, replicas.world_size))
    gen = torch.Generator(device=device).manual_seed(data["seed"])
    warm = {}

    def warm_up():
        warm["state"], warm["metrics"] = step(state, batch, generator=gen)

    calls = cs.record_kernel_inputs(warm_up)
    state = warm["state"]
    result["shapes"] = cs.check_kernels_on(calls, f"spatial rank {replicas.rank}")
    torch.cuda.synchronize()
    cs.reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    result["step_ms"], result["launches"], result["total_loss"] = [], [], []
    for _ in range(data["steps"]):
        counts = cs.kernel_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        result["step_ms"].append((time.perf_counter() - t0) * 1e3)
        result["launches"].append({k: v - counts[k] for k, v in cs.kernel_counts().items()})
        result["total_loss"].append(float(metrics["total_loss"]))
    result["peak_bytes"] = torch.cuda.max_memory_allocated()
    result["image_slab"] = list(batch["image"].shape)
else:
    grids = {"spatial": spatial.create_spatial_mesh(2, 2),
             "hybrid": distributed.create_hybrid_mesh(num_slices=2), "flat": replicas}
    for name, mesh in grids.items():
        model, state, step, batch = setup(mesh)
        draws = {k: mesh.rows(v).to(device) for k, v in data["draws"].items()}
        state, metrics = step(state, batch, draws=draws)
        result[name] = {"metrics": {k: v.cpu() for k, v in metrics.items()},
                        "params": {k: v.detach().cpu()
                                   for k, v in model.modules.state_dict().items()}}
torch.save(result, f"{out}.{replicas.rank}")
distributed.destroy_process_group()
"""


def timed_steps(step, state, batch, gen, steps: int):
    """A warm-up step, then `steps` timed ones: (ms of each, peak bytes,
    launches a step, the state after)."""
    state, _ = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(metrics["total_loss"])):
            raise AssertionError(f"a non-finite loss: {metrics}")
    launches = {k: v / steps for k, v in kernel_counts().items()}
    return times, torch.cuda.max_memory_allocated(), launches, state


def spatial_flagship(work: str, seed: int):
    """The full-width MTL R50 (bf16 compute, f32 parameters) on a batch of
    SPATIAL_BATCH synthetic images on a SPATIAL_CANVAS canvas: one rank on
    the whole batch, then two gloo ranks on cuda:0 over (data=1,
    spatial=2), each with half of every image's rows; step ms, each rank's
    peak memory and its launches a step (SPATIAL_LAUNCHES)."""
    import dataclasses

    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.train import train_step as ts

    cfg = dataclasses.replace(flagship_train_config(), canvas_size=SPATIAL_CANVAS)
    model = FasterRCNN(cfg, device="cuda")
    model.init_weights(torch.Generator().manual_seed(seed))
    h, w = SPATIAL_CANVAS
    batch = train_batch(np.random.RandomState(seed + 17), SPATIAL_BATCH, canvas=SPATIAL_CANVAS,
                        sizes=((h * 7 // 8, h), (w * 7 // 8, w)))
    calibrate_batch_norm_on(model, batch["image"], batch["true_shape"])
    lr, step_seed = 0.003, seed + 18
    data = os.path.join(work, "spatial_flagship.pt")
    torch.save({"cfg": cfg, "lr": lr, "seed": step_seed, "steps": SPATIAL_STEPS,
                "weights": {k: v.detach().cpu() for k, v in model.modules.state_dict().items()},
                "batch": {k: v.cpu() for k, v in batch.items()}}, data)
    state = ts.create_train_state(model, ts.make_optimizer(learning_rate=lr))
    gen = torch.Generator(device="cuda").manual_seed(step_seed)
    one_ms, one_peak, one_launches, _ = timed_steps(ts.make_train_step(model), state, batch,
                                                    gen, SPATIAL_STEPS)
    log(f"[spatial] one rank, the whole batch of {SPATIAL_BATCH} at {h}x{w}: steps "
        f"{', '.join(f'{t:.2f}' for t in one_ms)} ms, peak memory {one_peak / 2**30:.2f} GiB, "
        f"launches a step {one_launches}")
    del model, state, batch
    torch.cuda.empty_cache()
    ranks, wall = run_ranks(_SPATIAL_RANK, ["flagship", data], 2, "gloo",
                            os.path.join(work, "spatial_flagship_out.pt"))
    for r, out in enumerate(ranks):
        log(f"[spatial] rank {r} of (data=1, spatial=2) over gloo on cuda:0, its slab "
            f"{out['image_slab']}: steps {', '.join(f'{t:.2f}' for t in out['step_ms'])} ms, "
            f"peak memory {out['peak_bytes'] / 2**30:.2f} GiB ({out['peak_bytes'] / one_peak:.3f} "
            f"of one rank's), launches a step {out['launches']}, total_loss {out['total_loss']}")
        if any(launches != SPATIAL_LAUNCHES for launches in out["launches"]):
            raise AssertionError(f"spatial rank {r} launched {out['launches']} a step, want "
                                 f"{SPATIAL_LAUNCHES}")
        if not all(np.isfinite(out["total_loss"])):
            raise AssertionError(f"spatial rank {r}: non-finite losses {out['total_loss']}")
    if ranks[0]["total_loss"] != ranks[1]["total_loss"]:
        raise AssertionError("the spatial ranks' losses differ")
    log(f"[spatial] two ranks ({wall:.1f} s with their start): every recorded kernel call of "
        f"each rank's warm-up equals its plain version: {ranks[0]['shapes']}")
    return dict(one_rank=dict(step_ms=one_ms, peak_bytes=one_peak, launches=one_launches),
                ranks=ranks, wall_s=wall)


def grid_steps(work: str, data: str, backend: str):
    """_SPATIAL_RANK's "grids" on four ranks over `backend`; every grid's
    ranks bitwise equal."""
    ranks, wall = run_ranks(_SPATIAL_RANK, ["grids", data], 4, backend,
                            os.path.join(work, f"grids_{backend}_out.pt"))
    for grid in ("spatial", "hybrid", "flat"):
        same_params([r[grid] for r in ranks], f"the {grid} grid over {backend}")
    log(f"[spatial] the (data=2, spatial=2), (data_dcn=2, data=2) and flat grids over "
        f"{backend} ({wall:.1f} s): each grid's ranks' parameters bitwise equal")
    return ranks[0], wall


def step_rel(got, want):
    """(loss, sum of |parameter|) of `got` relative to `want`'s."""
    loss = [float(got["metrics"]["total_loss"]), float(want["metrics"]["total_loss"])]
    checksum = [sum(float(v.double().abs().sum()) for v in r["params"].values())
                for r in (got, want)]
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in (loss, checksum)]


def check_grids_on_cards(work: str, seed: int, backends=("gloo",)):
    """One float32 step (TF32 off) of the resnet10 MTL model at 128x128 on
    a global batch of 4 over the (data=2, spatial=2), (data_dcn=2, data=2)
    and flat four-rank grids, each over gloo on cuda:0 (and NCCL, rank r on
    cuda:r, where named): the ranks bitwise equal, the loss and the sum of
    |parameter| within 1e-4 relative of one rank on the whole batch, and
    NCCL within 1e-6 of gloo."""
    import dataclasses

    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.train import train_step as ts

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = dataclasses.replace(flagship_train_config(torch.float32), backbone="resnet10",
                                  canvas_size=GRID_CANVAS)
        model = FasterRCNN(cfg, device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        batch = train_batch(np.random.RandomState(seed + 20), 4, canvas=GRID_CANVAS, max_gt=8,
                            sizes=((96, 128), (100, 128)))
        calibrate_batch_norm_on(model, batch["image"], batch["true_shape"])
        draws = ts.make_draws(model, 4, GRID_CANVAS,
                              torch.Generator(device="cuda").manual_seed(seed + 21), num_gt=8)
        lr = 0.01
        data = os.path.join(work, "grids.pt")
        torch.save({"cfg": cfg, "lr": lr, "draws": {k: v.cpu() for k, v in draws.items()},
                    "weights": {k: v.detach().cpu() for k, v in model.modules.state_dict().items()},
                    "batch": {k: v.cpu() for k, v in batch.items()}}, data)
        state = ts.create_train_state(model, ts.make_optimizer(learning_rate=lr))
        _, metrics = ts.make_train_step(model)(state, batch, draws=draws)
        one = {"metrics": {k: v.cpu() for k, v in metrics.items()},
               "params": {k: v.detach().cpu() for k, v in model.modules.state_dict().items()}}
        del model, state
        torch.cuda.empty_cache()
        out, runs = {}, {}
        for backend in backends:
            runs[backend], wall = grid_steps(work, data, backend)
            out[f"{backend}_wall_s"] = wall
            for grid, got in runs[backend].items():
                rel = step_rel(got, one)
                out[f"{grid}_{backend}_vs_one"] = rel
                log(f"[spatial] {grid} grid over {backend} vs one rank: total_loss and sum "
                    f"|param| within {rel[0]:.3g} and {rel[1]:.3g} relative (tolerance 1e-4)")
                if max(rel) > 1e-4:
                    raise AssertionError(f"the {grid} grid over {backend} is off one rank by "
                                         f"{rel}")
        if "nccl" in runs:
            for grid, got in runs["nccl"].items():
                rel = step_rel(got, runs["gloo"][grid])
                out[f"{grid}_nccl_vs_gloo"] = rel
                log(f"[spatial] {grid} grid over NCCL vs gloo: within {rel[0]:.3g} and "
                    f"{rel[1]:.3g} relative (tolerance 1e-6)")
                if max(rel) > 1e-6:
                    raise AssertionError(f"the {grid} grid over NCCL is off gloo by {rel}")
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def space_to_depth_on_card(seed: int):
    """SpaceToDepthConv1 at the flagship's 640x1024 bucket, batch 16: in
    float32 (TF32 off) within 1e-5 of the largest magnitude of the plain
    stem; the bf16 forward + backward of both timed (CUDA events)."""
    from mtlx_torch.backbones.resnet import SpaceToDepthConv1
    from mtlx_torch.layers import Conv2d

    gen = torch.Generator().manual_seed(seed + 22)
    x = torch.randn(16, 3, 640, 1024, generator=gen).cuda()
    weight = torch.randn(64, 3, 7, 7, generator=gen) * 0.08
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        stems = {}
        for dtype in (torch.float32, torch.bfloat16):
            plain = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dtype)
            s2d = SpaceToDepthConv1(64, compute_dtype=dtype)
            for m in (plain, s2d):
                m.weight.data.copy_(weight)
                m.cuda().to(memory_format=torch.channels_last)
            stems[dtype] = plain, s2d
        with torch.no_grad():
            want = stems[torch.float32][0](x)
            got = stems[torch.float32][1](x)
        rel = float((got - want).abs().max() / want.abs().max())
        if not rel <= 1e-5:
            raise AssertionError(f"SpaceToDepthConv1 is off the plain stem by {rel} of the "
                                 "largest magnitude (tolerance 1e-5)")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    xc = x.to(memory_format=torch.channels_last)
    dout = torch.randn(want.shape, generator=gen).cuda().to(torch.bfloat16)
    ms = {}
    for name, stem in zip(("plain", "space_to_depth"), stems[torch.bfloat16]):
        def fwd_bwd(stem=stem):
            stem.weight.grad = None
            stem(xc).backward(dout)
        ms[name] = cuda_ms(fwd_bwd, 20)
    log(f"[spatial] SpaceToDepthConv1 at 16 x 640 x 1024: f32 within {rel:.3g} of the plain "
        f"stem's largest magnitude; bf16 forward + backward {ms['space_to_depth']:.4f} ms, the "
        f"plain stem {ms['plain']:.4f} ms")
    del stems
    torch.cuda.empty_cache()
    return dict(f32_rel=rel, bf16_fwd_bwd_ms=ms)


def remat_on_card(seed: int):
    """backbone_remat: the flagship at batch 16 (640x1024, bf16) with and
    without it, a warm-up and two timed steps each (ms, peak memory); and
    one float32 resnet10 step (TF32 off, cuDNN deterministic) with and
    without it on the same batch and draws: the gradients within 1e-6 of
    each tensor's largest magnitude."""
    import dataclasses

    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.train import train_step as ts

    out = {}
    batch = train_batch(np.random.RandomState(seed + 23), 16)
    for remat in (False, True):
        model = FasterRCNN(dataclasses.replace(flagship_train_config(), backbone_remat=remat),
                           device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        calibrate_batch_norm_on(model, batch["image"], batch["true_shape"])
        state = ts.create_train_state(model, ts.make_optimizer(learning_rate=0.003))
        gen = torch.Generator(device="cuda").manual_seed(seed + 24)
        times, peak, _, _ = timed_steps(ts.make_train_step(model), state, batch, gen, 2)
        out["remat" if remat else "plain"] = dict(step_ms=times, peak_bytes=peak)
        del model, state
        torch.cuda.empty_cache()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        small = train_batch(np.random.RandomState(seed + 25), 2, canvas=GRID_CANVAS, max_gt=8,
                            sizes=((96, 128), (100, 128)))
        grads = {}
        for remat in (False, True):
            cfg = dataclasses.replace(flagship_train_config(torch.float32), backbone="resnet10",
                                      canvas_size=GRID_CANVAS, backbone_remat=remat)
            model = FasterRCNN(cfg, device="cuda")
            model.init_weights(torch.Generator().manual_seed(seed))
            calibrate_batch_norm_on(model, small["image"], small["true_shape"])
            draws = ts.make_draws(model, 2, GRID_CANVAS,
                                  torch.Generator(device="cuda").manual_seed(seed + 26), num_gt=8)
            state = ts.create_train_state(model, ts.make_optimizer(learning_rate=0.01))
            ts.make_train_step(model)(state, small, draws=draws)
            grads[remat] = {n: p.grad.detach().clone() for n, p in model.modules.named_parameters()}
        worst = max(float((grads[True][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                    for n, g in grads[False].items())
        bitwise = sum(torch.equal(grads[True][n], g) for n, g in grads[False].items())
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    log(f"[spatial] backbone_remat, flagship at batch 16: steps "
        f"{', '.join(f'{t:.2f}' for t in out['remat']['step_ms'])} ms and peak "
        f"{out['remat']['peak_bytes'] / 2**30:.2f} GiB with it, "
        f"{', '.join(f'{t:.2f}' for t in out['plain']['step_ms'])} ms and "
        f"{out['plain']['peak_bytes'] / 2**30:.2f} GiB without; f32 resnet10 gradients with "
        f"and without within {worst:.3g} of each tensor's largest magnitude, {bitwise} of "
        f"{len(grads[False])} bitwise equal")
    if worst > 1e-6:
        raise AssertionError(f"remat's gradients are off by {worst} (tolerance 1e-6)")
    out["f32_grad_rel"], out["f32_bitwise"] = worst, bitwise
    return out


def multibox_on_card(seed: int):
    """The Multibox preset at SSD's shape: 32 images x 100 ground-truth
    boxes (1-100 valid) against the 1917 anchors of a 300x300 SSD; the
    matches on the card equal the CPU's exactly, ms a call."""
    from mtlx_torch.anchors.multi_grid import create_ssd_anchors
    from mtlx_torch.assign.target_assigner import create_target_assigner
    from mtlx_torch.detector.ssd import SSD

    anchors = create_ssd_anchors().generate(SSD._feature_shapes((300, 300), 6))
    rs = np.random.RandomState(seed + 27)
    corners = np.sort(rs.uniform(0, 1, (32, 100, 2, 2)), axis=-1)
    gt = torch.from_numpy(corners.reshape(32, 100, 4)[..., [0, 2, 1, 3]].astype(np.float32))
    mask = torch.from_numpy(np.arange(100)[None] < rs.randint(1, 101, (32, 1)))
    assigner = create_target_assigner("Multibox")
    want = assigner.assign(anchors, gt, gt_mask=mask)
    args = anchors.cuda(), gt.cuda()
    got = assigner.assign(*args, gt_mask=mask.cuda())
    if not torch.equal(got.match.cpu(), want.match):
        raise AssertionError("the Multibox matches on the card differ from the CPU's")
    ms = cuda_ms(lambda: assigner.assign(*args, gt_mask=mask.cuda()), 5)
    log(f"[spatial] Multibox preset at 32 x 100 x {anchors.shape[0]}: the matches equal the "
        f"CPU's ({int((got.match >= 0).sum())} matched), {ms:.3f} ms a call")
    return dict(anchors=anchors.shape[0], matched=int((got.match >= 0).sum()), ms=ms)


def phase_spatial(seed: int, results):
    """Spatial partitioning at full width, the spatial and hybrid grids
    against one rank, SpaceToDepthConv1, backbone remat, SSD Inception-v2
    at depth multiplier 0.5 and the Multibox preset."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mtlx_spatial_")
    try:
        out = {"flagship": spatial_flagship(work, seed),
               "grids": check_grids_on_cards(work, seed),
               "space_to_depth": space_to_depth_on_card(seed),
               "remat": remat_on_card(seed),
               "ssd_inception_v2_half": ssd_card_vs_cpu("ssd_inception_v2_voc", seed, 0.5),
               "multibox": multibox_on_card(seed)}
        out["wall_s"] = time.perf_counter() - t_phase
        log(f"[spatial] phase 17: {out['wall_s']:.1f} s")
        results["spatial"] = out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 18

# the configs exported with --saved_model, and the launches each request
# makes inside the program
SAVED_MODEL_CONFIGS = (("flagship", FLAGSHIP_CONFIG, {"nms": 2, "roi_crop": 1}),
                       ("ssd_mobilenet_v1_voc", "configs/ssd_mobilenet_v1_voc.config",
                        {"nms": 1, "roi_crop": 0}))
SAVED_MODEL_SIZES = ((600, 800), (800, 600))
SAVED_MODEL_SIGNATURES = ("image_tensor", "encoded_image_string", "tf_example")
SAVED_MODEL_TOL = 1e-5
SAVED_MODEL_REPS = 3

# NMS's kernels (the single launch, and the banded pipeline's four) and the
# crop forward's, by the names the profiler records
SAVED_MODEL_KERNELS = {"nms": ("nms_small_kernel", "rank_kernel", "order_kernel", "mask_kernel",
                               "scan_kernel"),
                       "roi_crop": ("roi_crop_fwd_kernel",)}

# a fresh process that imports only the loader. It is started first: it
# imports and loads each program as the phase writes it, then waits for
# `go` (everything else done) and serves each at batch 1 and 2 through the
# three signatures with the kernels' plain versions refused, counting each
# request's launches, timing the requests (host clock, ending in the copy
# to the host) and profiling the kernels inside the program
_SERVE_PROGRAMS = r"""
import json, os, sys, time
t0 = time.perf_counter()
from mtlx_torch.export import saved_model
import_s = time.perf_counter() - t0
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

work, names, reps = sys.argv[1], sys.argv[2].split(","), int(sys.argv[3])
kernels = json.loads(sys.argv[4])

def wait_for(path):
    while not os.path.exists(path):
        if os.path.exists(f"{work}/failed"):
            sys.exit("the phase failed before serving")
        time.sleep(0.05)

def launches():
    from mtlx_torch.kernels import iou_cuda, nms_cuda, roi_cuda

    return {"nms": nms_cuda.non_max_suppression.launches,
            "roi_crop": roi_cuda.crop_and_resize.launches,
            "roi_crop_backward": roi_cuda.crop_and_resize_backward.launches,
            "iou": iou_cuda.iou_matrix.launches}

programs, report = {}, {"import_s": import_s}
for name in names:
    wait_for(f"{work}/{name}/saved_model/ready")
    t0 = time.perf_counter()
    programs[name] = saved_model.load_saved_model(f"{work}/{name}/saved_model")
    report[name] = {"load_s": time.perf_counter() - t0}
wait_for(f"{work}/go")
from mtlx_torch.kernels import iou_cuda, nms_cuda, roi_cuda

def refuse(*args, **kwargs):
    raise AssertionError("a plain version ran inside the program on the card")

nms_cuda.non_max_suppression_plain = roi_cuda.crop_and_resize_plain = refuse
roi_cuda.crop_and_resize_backward_plain = iou_cuda.iou_matrix_plain = refuse
for name, sm in programs.items():
    data = np.load(f"{work}/{name}_requests.npz", allow_pickle=True)
    r = dict(report[name], ms={}, launches={}, first_ms={})
    out = {}
    for b in (1, 2):
        args = {"image_tensor": (data["canvas"][:b], data["shape"][:b]),
                "encoded_image_string": (list(data["blobs"][:b]),),
                "tf_example": (list(data["examples"][:b]),)}
        for sig, a in args.items():
            times, counts = [], []
            for _ in range(reps + 1):
                before = launches()
                t0 = time.perf_counter()
                got = sm.signatures[sig](*a)
                times.append((time.perf_counter() - t0) * 1e3)
                after = launches()
                counts.append({k: after[k] - before[k] for k in after})
            r["first_ms"][f"{sig}/{b}"] = times[0]
            r["ms"][f"{sig}/{b}"] = times[1:]
            r["launches"][f"{sig}/{b}"] = counts
            out.update({f"{sig}/{b}/{k}": v for k, v in got.items()})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            sm.signatures["image_tensor"](data["canvas"][:1], data["shape"][:1])
        torch.cuda.synchronize()
    r["kernel_ms"] = {k: sum(e.self_device_time_total for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA
                             and any(n in e.key for n in names_)) / 1e4
                      for k, names_ in kernels.items()}
    r["meta"] = sm.meta
    report[name] = r
    np.savez(f"{work}/{name}_served.npz", **out)
report["modules"] = sorted(m for m in sys.modules if m.startswith("mtlx_torch"))
print(json.dumps(report))
"""


def saved_model_requests(rs, resizer, canvas):
    """The phase's requests: noise JPEGs at SAVED_MODEL_SIZES, their
    tf.Examples, and the canvases the host path makes of them."""
    from mtlx_torch.data.example_decoder import build_example
    from mtlx_torch.export import saved_model

    blobs = [encode_jpeg(rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
             for h, w in SAVED_MODEL_SIZES]
    examples = [build_example(b, b"jpeg", h, w, f"request{i}.jpg", np.zeros((0, 4)), [], [])
                for i, (b, (h, w)) in enumerate(zip(blobs, SAVED_MODEL_SIZES))]
    canvases, shapes = zip(*(saved_model.canvas_of(saved_model.decode_image(b), resizer, canvas)
                             for b in blobs))
    objects = lambda xs: np.array(xs + [None], object)[:-1]
    return dict(blobs=objects(blobs), examples=objects(examples), canvas=np.stack(canvases),
                shape=np.stack(shapes))


def export_program(work: str, name: str, config: str, seed: int):
    """One config through the export CLI with --saved_model from a
    checkpoint of its seeded init with batch norm calibrated on the
    phase's requests, and the eager InferenceModel's results and request
    ms on the same canvases at the program's dtype."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.export import exporter
    from mtlx_torch.export.exporter import InferenceModel
    from mtlx_torch.export.saved_model import PROGRAM_FILE
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train_step as ts

    configs = config_util.get_configs_from_pipeline_file(os.path.join(REPO, config))
    resizer = model_builder.resizer_params(model_builder.image_resizer(configs["model"]))
    model = model_builder.build(configs["model"], is_training=True, device="cuda")
    model.init_weights(torch.Generator().manual_seed(seed))
    canvas = tuple(model.cfg.canvas_size)
    requests = saved_model_requests(np.random.RandomState(seed + 30), resizer, canvas)
    np.savez(os.path.join(work, f"{name}_requests.npz"), **requests)
    calibrate_batch_norm_on(model, torch.from_numpy(requests["canvas"]).cuda(),
                            torch.from_numpy(requests["shape"]).cuda())
    train_dir, out_dir = os.path.join(work, f"{name}_train"), os.path.join(work, name)
    manager = ckpt_lib.CheckpointManager(train_dir)
    manager.save(1, ts.create_train_state(model, ts.make_optimizer()))
    manager.wait()
    del model, manager
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_cli(exporter.main, ["--pipeline_config_path", os.path.join(REPO, config),
                            "--trained_checkpoint_dir", train_dir, "--output_directory", out_dir,
                            "--saved_model"])
    export_s = time.perf_counter() - t0
    program = os.path.join(out_dir, "saved_model", PROGRAM_FILE)
    open(os.path.join(out_dir, "saved_model", "ready"), "w").close()

    eager = InferenceModel.load(out_dir, device="cuda", dtype=torch.bfloat16)  # as the program
    want, eager_ms = {}, {}
    for b in (1, 2):
        times = []
        for _ in range(SAVED_MODEL_REPS + 1):
            t0 = time.perf_counter()
            out = eager._postprocess_output(eager._serve(requests["canvas"][:b],
                                                         requests["shape"][:b]))
            times.append((time.perf_counter() - t0) * 1e3)
        want[b], eager_ms[b] = out, times[1:]
    del eager
    torch.cuda.empty_cache()
    return dict(export_s=export_s, size_mb=os.path.getsize(program) / 2**20, canvas=canvas,
                want=want, eager_ms=eager_ms)


def check_served(name: str, exported, served, launches, want_launches):
    """The fresh process's results against the eager InferenceModel, and
    its launches a request; the worst box or score difference over the
    largest magnitude."""
    worst = 0.0
    for sig in SAVED_MODEL_SIGNATURES:
        for b in (1, 2):
            got = {k.split("/")[-1]: v for k, v in served.items() if k.startswith(f"{sig}/{b}/")}
            w = exported["want"][b]
            for key in ("detection_classes", "num_detections"):
                if not np.array_equal(got[key], w[key].astype(np.float32)):
                    raise AssertionError(f"{name} {sig} batch {b}: {key} differs from eager")
            for key in ("detection_boxes", "detection_scores"):
                scale = max(float(np.abs(w[key]).max()), 1e-30)
                err = float(np.abs(got[key] - w[key]).max()) / scale
                worst = max(worst, err)
                if not err <= SAVED_MODEL_TOL:
                    raise AssertionError(f"{name} {sig} batch {b}: {key} off eager by {err:.3g} "
                                         f"of the largest magnitude (tolerance {SAVED_MODEL_TOL})")
            for count in launches[f"{sig}/{b}"]:
                made = {k: count[k] for k in want_launches}
                if made != want_launches or count["roi_crop_backward"] or count["iou"]:
                    raise AssertionError(f"{name} {sig} batch {b}: a request launched {count}, "
                                         f"want {want_launches}")
    return worst


def phase_saved_model(seed: int, results, smi: str):
    """The export CLI's --saved_model for the flagship and SSD MobileNet-v1,
    both programs served from one fresh process through mtlx's three
    signatures and held to the eager InferenceModel."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mtlx_saved_model_")
    names = [name for name, _, _ in SAVED_MODEL_CONFIGS]
    server_out = open(os.path.join(work, "server.out"), "w+")
    server_err = open(os.path.join(work, "server.err"), "w+")
    server = subprocess.Popen(
        [sys.executable, "-c", _SERVE_PROGRAMS, work, ",".join(names), str(SAVED_MODEL_REPS),
         json.dumps(SAVED_MODEL_KERNELS)],
        stdout=server_out, stderr=server_err, text=True, env=repo_env(), cwd=REPO)
    try:
        exported = {name: export_program(work, name, config, seed)
                    for name, config, _ in SAVED_MODEL_CONFIGS}
        open(os.path.join(work, "go"), "w").close()
        server.wait(timeout=600)
        server_out.seek(0)
        server_err.seek(0)
        if server.returncode != 0:
            raise AssertionError(f"the serving process failed:\n{server_err.read()[-4000:]}")
        report = json.loads(server_out.read().strip().splitlines()[-1])
        loaded = [m for m in report["modules"]
                  if m.split(".")[1:2] in (["detector"], ["builders"], ["backbones"], ["heads"])]
        if loaded:
            raise AssertionError(f"the serving process imported model code: {loaded}")
        out = {}
        for name, _, want_launches in SAVED_MODEL_CONFIGS:
            e, r = exported[name], report[name]
            served = dict(np.load(os.path.join(work, f"{name}_served.npz")))
            worst = check_served(name, e, served, r["launches"], want_launches)
            num = [int(n) for n in e["want"][2]["num_detections"]]
            log(f"[saved_model] {name} ({smi}): export CLI with --saved_model "
                f"{e['export_s']:.1f} s, model.pt2 {e['size_mb']:.1f} MiB, canvas "
                f"{e['canvas'][0]}x{e['canvas'][1]} {r['meta']['dtype']}; the fresh process "
                f"loaded it in {r['load_s']:.2f} s (beside the phase's other work) after "
                f"importing the loader in {report['import_s']:.2f} s, no model code imported")
            log(f"[saved_model] {name}: every signature at batch 1 and 2 equal to the eager "
                f"InferenceModel in classes and num_detections ({num} at batch 2), boxes and "
                f"scores within {worst:.3g} of the largest magnitude (tolerance "
                f"{SAVED_MODEL_TOL}); each request launched {want_launches} inside the "
                f"program, no plain version ran")
            for b in (1, 2):
                ms = ", ".join(f"{sig} {' '.join(f'{t:.2f}' for t in r['ms'][f'{sig}/{b}'])}"
                               for sig in SAVED_MODEL_SIGNATURES)
                log(f"[saved_model] {name} batch {b} ({smi}): request ms on the host clock, "
                    f"ending in the copy to the host: {ms}; the first image_tensor call "
                    f"{r['first_ms'][f'image_tensor/{b}']:.2f}; eager InferenceModel at the "
                    f"canvas {' '.join(f'{t:.2f}' for t in e['eager_ms'][b])}")
            log(f"[saved_model] {name} ({smi}): device ms a batch-1 request in the "
                f"program's kernels (profiler): {r['kernel_ms']}")
            out[name] = dict(export_s=e["export_s"], size_mb=e["size_mb"],
                             import_s=report["import_s"], load_s=r["load_s"], ms=r["ms"],
                             first_ms=r["first_ms"], eager_ms=e["eager_ms"], max_rel_err=worst,
                             launches_per_request=want_launches, kernel_ms=r["kernel_ms"],
                             num_detections=num)
        out["wall_s"] = time.perf_counter() - t_phase
        log(f"[saved_model] phase 18: {out['wall_s']:.1f} s")
        results["saved_model"] = out
    finally:
        if server.poll() is None:
            open(os.path.join(work, "failed"), "w").close()
            try:
                server.wait(timeout=30)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait()
        server_out.close()
        server_err.close()
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="N > 1: only build the kernels and hold the R101 COCO train CLI over "
                        "NCCL at world size N to world size 1, and the spatial and hybrid "
                        "grids over NCCL to gloo (needs N cards, N = 4 for the grids)")
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
    if args.data_parallel > 1:
        phase_data_parallel(args.seed, args.data_parallel, results)
        print(smi)
        print(json.dumps({"data_parallel": results["data_parallel"]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    gen = torch.Generator().manual_seed(args.seed)
    check_nms(gen, results)
    check_roi(gen, results)
    check_roi_cases(args.seed)
    check_iou(gen, results)
    check_roi_backward(gen, results)
    time_spatial_shapes(args.seed, results)
    phase_serve(args.seed, results)
    phase_card_vs_cpu(args.seed)
    phase_train(args.seed, results)
    phase_train_card_vs_cpu(args.seed)
    phase_cli(args.seed, results)
    phase_learnability(args.seed, results)
    phase_coco(args.seed, results)
    phase_two_stage(args.seed, results)
    phase_ssd(args.seed, results)
    phase_pipeline(args.seed, results)
    phase_refine(args.seed, results)
    phase_masks(args.seed, results)
    phase_classifier(args.seed, results)
    phase_spatial(args.seed, results)
    phase_saved_model(args.seed, results, smi)

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
             device_ms=nms_rpn["device_ms"], stage_ms=nms_rpn["stage_ms"],
             rows_walked_max=nms_rpn["rows_walked_max"], every_band=nms_rpn["every_band"],
             other_shapes=results["nms"][1:], train_launches=train_launches["nms"],
             main_path_calls=results["serve_nms_calls"] + results["train_nms_calls"]),
        dict(name="roi_crop", route="cuda", source="mtlx_torch/kernels/csrc/roi_crop.cu",
             replaces="mtlx/kernels/roi_pallas.py:93",
             launches=results["launches"]["roi_crop"], max_abs_err=roi["max_abs_err"],
             ms=roi["ms"], plain_ms=roi["plain_ms"], bound_ms=roi["bound_ms"],
             bound_by=roi["bound_by"], library_ms=roi["library_ms"], shape=roi["shape"],
             f32_ms=roi["f32_ms"], fill_ms=roi["fill_ms"],
             taps_per_output=roi["taps_per_output"], other_shapes=roi["other_shapes"],
             train_launches=train_launches["roi_crop"],
             main_path_calls=results["serve_crop_calls"] + results["train_crop_calls"]),
        dict(name="iou", route="cuda", source="mtlx_torch/kernels/csrc/iou.cu",
             replaces="mtlx/kernels/iou_pallas.py:56",
             launches=train_launches["iou"], max_abs_err=iou["max_abs_err"],
             ms=iou["ms"], plain_ms=iou["plain_ms"], bound_ms=iou["bound_ms"],
             bound_by=iou["bound_by"], library_ms=None, shape=iou["shape"],
             device_ms=iou["device_ms"], fill_ms=iou["fill_ms"],
             other_shapes=results["train_iou_calls"][1:],
             main_path_calls=results["train_iou_calls"]),
        dict(name="roi_crop_backward", route="cuda",
             source="mtlx_torch/kernels/csrc/roi_crop.cu",
             replaces="mtlx/kernels/roi_pallas.py:111",
             launches=train_launches["roi_crop_backward"], max_abs_err=bwd["max_abs_err"],
             ms=bwd["ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"],
             bound_by=bwd["bound_by"], library_ms=bwd["library_ms"], shape=bwd["shape"],
             f32_ms=bwd["f32_ms"],
             dout_read_mb=bwd["dout_read_mb"]),
    ]
    cli = results["cli"]
    coco = results["coco"]
    for k in kernels:
        k["cli_train_launches_per_step"] = cli["train_launches_per_step"][k["name"]]
        k["cli_eval_launches_per_batch"] = cli["eval_launches_per_batch"][k["name"]]
        k["learnability_launches"] = {tag: run["launches"][k["name"]]
                                      for tag, run in results["learnability"].items()}
        k["learnability_shapes"] = results["learnability"]["fixed"]["shapes"][k["name"]]
        k["coco_train_launches_per_step"] = coco["train_launches_per_step"][k["name"]]
        k["coco_eval_launches_per_batch"] = coco["eval_launches_per_batch"][k["name"]]
        k["coco_eval_shapes"] = coco["eval_shapes"].get(k["name"], [])
    for k in kernels:
        for name, r in results["two_stage"].items():
            k.setdefault("two_stage_train_launches_per_step", {})[name] = \
                r["train_launches_per_step"][k["name"]]
            k.setdefault("two_stage_eval_launches_per_batch", {})[name] = \
                r["eval_launches_per_batch"][k["name"]]
            k.setdefault("two_stage_shapes", {})[name] = {
                part: r["shapes"][part].get(k["name"], []) for part in ("train", "eval")}
    kernels[1]["rfcn_ps_crop"] = results["two_stage"]["rfcn_resnet101_voc07"]["ps_crop"]
    for k in (kernels[0], kernels[2]):
        k["two_stage_timed"] = {name: r["nms_iou_times"][k["name"]]
                                for name, r in results["two_stage"].items()}
    for k in (kernels[1], kernels[3]):
        k["two_stage_train_ms"] = {
            name: [row for row in r["train_crop_times"]
                   if row.get("backward", False) == (k["name"] == "roi_crop_backward")]
            for name, r in results["two_stage"].items()}
    ssd = results["ssd"]
    for k in kernels:
        for name, _, _ in SSD_CONFIGS:
            r = ssd[name]
            k.setdefault("ssd_train_launches_per_step", {})[name] = \
                r["train_launches_per_step"][k["name"]]
            k.setdefault("ssd_eval_launches_per_batch", {})[name] = \
                r["eval_launches_per_batch"][k["name"]]
            k.setdefault("ssd_shapes", {})[name] = {
                part: r["shapes"][part].get(k["name"], []) for part in ("train", "eval")}
            k.setdefault("ssd_timed", {})[name] = r["timed"].get(k["name"], [])
    pipeline = results["pipeline"]
    for k in kernels:
        k["pipeline_train_launches_per_step"] = {
            "flagship": pipeline["flagship"]["runs"]["flags"]["launches_per_step"][k["name"]],
            "ssd_mobilenet_v1_voc": pipeline["ssd"]["launches_per_step"][k["name"]]}
        k["pipeline_ssd_shapes"] = pipeline["ssd"]["shapes"].get(k["name"], [])
    kernels[1]["pipeline_ssd_timed"] = pipeline["ssd"]["timed"]
    refine = results["refine"]
    for k in kernels:
        k["refine_train_launches_per_step"] = refine["train_launches_per_step"][k["name"]]
        k["refine_eval_launches_per_batch"] = refine["eval_launches_per_batch"][k["name"]]
        k["refine_options_launches_per_step"] = {
            f"miner cap {cap}": r["launches_per_step"][k["name"]]
            for cap, r in refine["options"].items()}
        k["refine_shapes"] = {part: refine["shapes"][part].get(k["name"], [])
                              for part in ("train", "eval")}
        k["refine_options_shapes"] = {f"miner cap {cap}": r["shapes"].get(k["name"], [])
                                      for cap, r in refine["options"].items()}
    masks = results["masks"]
    for k in kernels:
        k["masks_train_launches_per_step"] = masks["train_launches_per_step"][k["name"]]
        k["masks_eval_launches_per_batch"] = masks["eval_launches_per_batch"][k["name"]]
        k["masks_shapes"] = {part: masks["shapes"][part].get(k["name"], [])
                             for part in ("train", "eval")}
    kernels[1]["mask_target_crop"] = masks["target_crop"]
    classifier = results["classifier"]
    for k in kernels:
        k["classifier_warm_start_launches_per_step"] = \
            classifier["warm_start"]["train_launches_per_step"][k["name"]]
        k["classifier_eval_launches_per_batch"] = \
            classifier["warm_start"]["eval_launches_per_batch"][k["name"]]
    kernels[1]["classification_crop"] = dict(
        launches_per_call={tag: c["launches"] for tag, c in classifier["crops"]["calls"].items()},
        **classifier["crops"]["timed"])
    spatial = results["spatial"]["flagship"]
    for k in kernels:
        k["spatial_launches_per_step_per_rank"] = spatial["ranks"][0]["launches"][0][k["name"]]
        k["spatial_shapes"] = spatial["ranks"][0]["shapes"].get(k["name"], [])
    saved = {name: r for name, r in results["saved_model"].items() if name != "wall_s"}
    for k in kernels:
        k["spatial_shapes_timed"] = results["spatial_shapes"][k["name"]]
        k["saved_model_launches_per_request"] = {
            name: r["launches_per_request"].get(k["name"], 0) for name, r in saved.items()}
        if k["name"] in SAVED_MODEL_KERNELS:
            k["saved_model_device_ms"] = {name: r["kernel_ms"][k["name"]]
                                          for name, r in saved.items()}
    kernels[0]["coco_postprocess"] = coco["postprocess_nms"]
    library = coco["library"]
    if library is not None:
        kernels[0]["library_ms"] = library["nms_ms"]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
