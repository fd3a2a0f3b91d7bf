"""Training CLI (port of mtlx/train/train.py):

    python -m mtlx_torch.train.train --pipeline_config_path=... --train_dir=...

The pipeline file goes through the builders to the detector, the
optimizer and the augmentations; TFRecords go through the host loader
(`data/loader.py`) and the pinned-memory prefetch to the device; each
batch is padded to its bucket, augmented on the device and taken through
one train step. Checkpoints are written every `save_checkpoints_steps`
and at the end; a restart resumes from the latest one, and a first run
warm-starts from `fine_tune_checkpoint`. It runs on the CUDA device
unless `--device cpu` is passed.

Every `--log_every` steps (and at step 1) it prints `[train] {json}` with
the step, images_per_sec, learning_rate, the losses, grad_norm and
loader_wait_share: the share of wall time since the last line that the
loop waited for the loader; the losses, grad_norm, learning_rate and
global_step/sec also go to a TensorBoard event file in train_dir
(`utils/summary_writer.py`). `--profile_from N` traces steps N+1 to
N+`--profile_steps` with `torch.profiler` into `<train_dir>/profile`.

The random draws of step s come from a generator seeded by (seed, s), so
a resumed run takes the same draws as one that never stopped.

With a keep_aspect_ratio_resizer the crop / pad augmentations draw their
geometry on the host (data/host_geometry.py) and the step resamples the
pixels; the rest augment on the device. `--grain_workers N` loads the
batches in N worker processes (data/grain_loader.py: `batches`' batches
in `batches`' order, not grain's); `--max_bucket_variants N` bounds the
compute buckets (data/loader.py BucketCoalescer); `--precompile_buckets`
runs one forward and backward at every bucket shape before step 1 and
commits nothing (`warm_up_buckets`), so a run with it equals one without.

`--distributed` trains data-parallel over torch.distributed, one rank a
process, launched by `python -m torch.distributed.run --nproc_per_node=N
-m mtlx_torch.train.train --distributed ...` (NCCL on the cards, gloo
with `--device cpu`). train_config.batch_size is the global batch: rank r
reads records [r::N] and takes batch_size / N rows a step, the
gradients are averaged over the ranks, and a global step equals one step
on the concatenation of the ranks' rows (rank 0's first). Only rank 0
writes the pipeline.config, checkpoints, event files, `[train]` lines
and the profiler trace; every rank resumes from the same checkpoint.
On the card the run ends with `[train] summary {json}`: the peak device
memory and each hand-written kernel's launches on rank 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from mtlx_torch.data import preprocessor as prep
from mtlx_torch.train import train_step as ts


def make_augmented_batch_fn(aug_options: List[Tuple[str, dict]]) -> Callable:
    """Returns augment(batch, draws) -> batch: a batch that carries host
    geometry (the `aug_*` fields of data/host_geometry.py) has its pixels
    resampled through its window first, and its instance masks too, at
    their stride with the [G] instances as the resample's channels; then
    the options apply, the one at position i with
    draws[preprocessor.draw_key(i)]. A batch with instance masks or
    keypoints refuses the options that would not carry them along
    (preprocessor.MASK_SAFE_TRANSFORMS), as mtlx does."""

    def augment(batch: Dict[str, Tensor], draws: Dict[str, Tensor]) -> Dict[str, Tensor]:
        if "aug_window" in batch:
            # host-drawn crop / pad geometry: the boxes, keypoints and
            # true_shape were rewritten on the host, only the pixels move
            batch = dict(batch)
            window = batch.pop("aug_window")
            src_shape = batch.pop("aug_src_shape")
            content = batch.pop("aug_content", None)
            batch["image"] = prep.batch_apply_host_window(
                batch["image"].float(), batch["true_shape"], window, src_shape,
                batch.pop("aug_pad_color"), content)
            if "gt_instance_masks" in batch:
                # the loader pasted round(true / stride), so the mask
                # frame's extents round the same way
                m = batch["gt_instance_masks"]  # [B, G, mh, mw]
                ms = batch["image"].shape[1] // m.shape[2]

                def on_mask_grid(extent: Tensor) -> Tensor:
                    return torch.clamp_min(torch.round(extent.float() / ms), 1).to(torch.int32)

                soft = prep.batch_apply_host_window(
                    m.permute(0, 2, 3, 1).float(), on_mask_grid(batch["true_shape"]),
                    window.float() / ms, on_mask_grid(src_shape),
                    torch.zeros((m.shape[0], m.shape[1]), device=m.device),
                    content.float() / ms if content is not None else None)
                batch["gt_instance_masks"] = soft.permute(0, 3, 1, 2)
        if not aug_options:
            return batch
        sample = {
            "image": batch["image"].float(),
            "boxes": batch["gt_boxes"],
            "classes": batch["gt_classes"],
            "mask": batch["gt_mask"],
            "true_shape": batch["true_shape"],
        }
        carried = {"gt_instance_masks": "instance_masks", "gt_keypoints": "keypoints"}
        carried = {k: v for k, v in carried.items() if k in batch}
        if carried:
            unsafe = [n for n, _ in aug_options if n not in prep.MASK_SAFE_TRANSFORMS]
            if unsafe:
                raise ValueError(
                    "instance masks/keypoints are loaded but these augmentations do not "
                    f"transform them: {unsafe} — remove them or disable the annotation loading")
            sample.update({v: batch[k] for k, v in carried.items()})
        out = prep.batch_preprocess(sample, aug_options, draws)
        return dict(batch, image=out["image"], gt_boxes=out["boxes"], gt_mask=out["mask"],
                    true_shape=out["true_shape"], **{k: out[v] for k, v in carried.items()})

    return augment


def make_step_fn(model, aug_options: List[Tuple[str, dict]],
                 regularization_fn: Optional[Callable] = None,
                 bucket_multiple: int = 0, replicas=None,
                 ema_decay: Optional[float] = None) -> Callable:
    """Returns step_fn(state, batch, generator=None, draws=None) ->
    (state, metrics): pad the batch to its bucket (SSD: to its canvas),
    augment it, take one train step. Draws not given come from
    `generator`, in the order of train_step.make_draws (the
    augmentations' first); with `replicas` they are made for the global
    batch and the rank takes its rows. `ema_decay` keeps the state's
    moving average of the parameters. `step_fn.warm_up(state, batch,
    generator)` takes the same path to one forward and backward that
    commits nothing (train_step.make_train_step)."""
    augment = make_augmented_batch_fn(aug_options)
    raw_step = ts.make_train_step(model, regularization_fn, replicas=replicas,
                                  ema_decay=ema_decay)

    def prepare(batch, generator, draws, ranks):
        batch = ts.pad_for_model(model, batch, bucket_multiple)
        draws = dict(draws or {})
        if generator is not None:
            img = batch["image"]
            made = ts.make_draws(model, ts.global_rows(img.shape[0], ranks),
                                 tuple(img.shape[1:3]), generator, aug_options,
                                 num_gt=batch["gt_boxes"].shape[1])
            draws = {**ts.rank_rows(made, ranks), **draws}
        return augment(batch, draws), draws

    def step_fn(state, batch, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Tensor]] = None):
        batch, draws = prepare(batch, generator, draws, replicas)
        return raw_step(state, batch, draws=draws)

    def warm_up(state, batch, generator: Optional[torch.Generator] = None) -> None:
        batch, draws = prepare(batch, generator, None, None)
        raw_step.warm_up(state, batch, draws=draws)

    step_fn.warm_up = warm_up
    return step_fn


def start_profiler(device: torch.device):
    """A started torch.profiler trace of the host and, on the card, its kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler, train_dir: str, step: int) -> None:
    """Stop the trace and write it as `<train_dir>/profile/trace_to_step_<step>.json`
    (Chrome trace format)."""
    profiler.stop()
    out = os.path.join(train_dir, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace_to_step_{step}.json")
    profiler.export_chrome_trace(path)
    print(f"[train] profiler trace written to {path}", flush=True)


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s draws."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


# reference TF1 cluster flags: accepted, noted and ignored
_TF1_FLAGS = (("master", ""), ("task", 0), ("num_clones", 1), ("clone_on_cpu", False),
              ("worker_replicas", 1), ("ps_tasks", 0), ("worker_job_name", "lonely_worker"))


def parse_args(argv=None):
    from mtlx_torch.utils.bucketing import bucket_multiple_arg

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pipeline_config_path", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--num_steps", type=int, default=None,
                   help="override train_config.num_steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--deterministic", action="store_true",
                   help="fixed data order (no shuffling); the draws are always seeded")
    p.add_argument("--decode_threads", type=int, default=2,
                   help=">0 decodes each batch's JPEGs on the codec's thread pool")
    p.add_argument("--tf1_resize", action="store_true",
                   help="the reference's TF1 resize_images (align_corners=False) "
                        "convention for the initial image resize")
    p.add_argument("--pack_transfer", type=int, default=1,
                   help="1 = ship images cropped to their bucketed true shape; "
                        "0 = ship the full canvas")
    p.add_argument("--aspect_grouping", type=int, default=1,
                   help="1 = batch records sharing a compute bucket together "
                        "(with --pack_transfer)")
    p.add_argument("--bucket_multiple", type=bucket_multiple_arg, default=0,
                   help="compute bucket granularity in pixels (a multiple of 32); "
                        "overrides the pipeline's `bucketing {}` block; default 128")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--grain_workers", type=int, default=0,
                   help=">0 loads batches in this many worker processes "
                        "(data/grain_loader.py), the same batches in the same order")
    p.add_argument("--max_bucket_variants", type=int, default=0,
                   help="bound the compute buckets to N shapes (with --pack_transfer): the "
                        "N - 1 most frequent and the canvas; rarer buckets pad up to a kept "
                        "superset. 0 = the pipeline's `bucketing {}` block, else no bound")
    p.add_argument("--precompile_buckets", action="store_true",
                   help="before step 1, run one forward and backward of the train step at "
                        "every bucket shape the data can give (cuDNN's choices, the "
                        "allocator), committing nothing (with --pack_transfer and a "
                        "bucketed-compute model)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over torch.distributed: launch with python -m "
                        "torch.distributed.run; every rank runs this command on its shard")
    p.add_argument("--profile_from", type=int, default=0,
                   help="trace steps from this count on with torch.profiler (0 = off); "
                        "the trace is written under <train_dir>/profile")
    p.add_argument("--profile_steps", type=int, default=5,
                   help="number of steps to trace with --profile_from")
    for flag, default in _TF1_FLAGS:
        kw = {"action": "store_true"} if isinstance(default, bool) else {
            "default": default, "type": type(default)}
        p.add_argument(f"--{flag}", help=argparse.SUPPRESS, **kw)
    args = p.parse_args(argv)
    for flag, default in _TF1_FLAGS[:-1]:
        if getattr(args, flag) != default:
            print(f"[train] note: --{flag} is a TF1 cluster knob; this program has no "
                  "clones or parameter servers (ignored)", flush=True)
    return args


def warm_up_buckets(model, step_fn, state, dataset, batch_size: int, host_geometry,
                    max_variants: int, multiple: int, device: torch.device,
                    pack_transfer: bool, say=print) -> List[Tuple[int, int]]:
    """--precompile_buckets: one forward and backward of the train step
    (`step_fn.warm_up`, which commits nothing) at every compute bucket the
    data can give (loader.achievable_bucket_shapes), on record 0 (through
    the host geometry with default_rng(0)) repeated to the batch. It fixes
    cuDNN's choices and grows the allocator before step 1, draws from its
    own generator, and leaves the kernels' launch counts as it found them.
    Skipped, with a note, without --pack_transfer or for a model that
    computes on its whole canvas (SSD), as mtlx skips."""
    from mtlx_torch.data.loader import achievable_bucket_shapes

    if not (pack_transfer and getattr(model, "supports_bucketed_compute", True)):
        say("[train] note: --precompile_buckets needs --pack_transfer and a bucketed-compute "
            "model; skipped", flush=True)
        return []
    t0 = time.perf_counter()
    shapes = achievable_bucket_shapes(dataset, batch_size, host_geometry=host_geometry,
                                      max_bucket_variants=max_variants,
                                      bucket_multiple=multiple)
    sample = dataset.get(0)
    if host_geometry is not None:
        sample = host_geometry(sample, np.random.default_rng(0))
    drop = {"gt_difficult", "gt_group_of", "original_shape", "source_id", "pack_shape"}
    template = {k: torch.from_numpy(np.stack([np.asarray(v)] * batch_size)).to(device)
                for k, v in sample.items() if k not in drop}
    counts = kernel_launches()
    generator = torch.Generator(device=device)
    for hb, wb in shapes:
        generator.manual_seed(0)
        image = template["image"][:, :hb, :wb].contiguous()
        step_fn.warm_up(state, dict(template, image=image), generator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    set_kernel_launches(counts)
    say(f"[train] warmed up {len(shapes)} bucket shapes {shapes} in "
        f"{time.perf_counter() - t0:.2f} s", flush=True)
    return shapes


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launches in this process so far."""
    from mtlx_torch.kernels import batch_norm_cuda, iou_cuda, nms_cuda, roi_cuda

    return {"nms": nms_cuda.non_max_suppression.launches,
            "roi_crop": roi_cuda.crop_and_resize.launches,
            "roi_crop_backward": roi_cuda.crop_and_resize_backward.launches,
            "iou": iou_cuda.iou_matrix.launches,
            "paired_sums": batch_norm_cuda.paired_sums.launches,
            "bn_affine": batch_norm_cuda.bn_affine.launches}


def set_kernel_launches(counts: Dict[str, int]) -> None:
    """Set each hand-written kernel's launch count (kernel_launches' keys)."""
    from mtlx_torch.kernels import batch_norm_cuda, iou_cuda, nms_cuda, roi_cuda

    nms_cuda.non_max_suppression.launches = counts["nms"]
    roi_cuda.crop_and_resize.launches = counts["roi_crop"]
    roi_cuda.crop_and_resize_backward.launches = counts["roi_crop_backward"]
    iou_cuda.iou_matrix.launches = counts["iou"]
    batch_norm_cuda.paired_sums.launches = counts["paired_sums"]
    batch_norm_cuda.bn_affine.launches = counts["bn_affine"]


def main(argv=None) -> None:
    # finer interpreter-lock switching: the prefetch thread and the step
    # loop otherwise starve each other on hosts with few cores
    sys.setswitchinterval(0.001)
    args = parse_args(argv)
    replicas = None
    if args.distributed:
        from mtlx_torch.parallel import distributed

        device, replicas = distributed.init_process_group(args.device)
    else:
        from mtlx_torch.device import resolve_device

        device = resolve_device(args.device)
    try:
        _train(args, device, replicas)
    finally:
        if replicas is not None:
            distributed.destroy_process_group()


def _train(args, device: torch.device, replicas) -> None:
    from mtlx_torch.builders import model_builder, optimizer_builder, preprocessor_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.host_geometry import HostGeometry, split_host_geometry
    from mtlx_torch.data.loader import (DetectionDataset, batches, batches_per_epoch,
                                        device_prefetch)
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.utils.bucketing import resolve_bucketing
    from mtlx_torch.utils.summary_writer import SummaryWriter

    main_rank = replicas is None or replicas.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    configs = config_util.get_configs_from_pipeline_file(args.pipeline_config_path)
    for note in config_util.compatibility_notes(configs):
        say(f"[train] note: {note}", flush=True)
    multiple, max_variants = resolve_bucketing(configs["bucketing"], args.bucket_multiple,
                                               args.max_bucket_variants)
    # the pipeline.config saved into train_dir carries the granularity and
    # the bound, so eval and serving of this model use them without the flags
    configs["bucketing"].bucket_multiple = multiple
    configs["bucketing"].max_bucket_variants = max_variants
    train_config = configs["train_config"]
    model = model_builder.build(configs["model"], is_training=True,
                                max_gt_boxes=train_config.max_number_of_boxes or 100,
                                device=device)
    num_steps = args.num_steps or train_config.num_steps or 200000
    batch_size = train_config.batch_size or 1  # the global batch
    local_batch = batch_size if replicas is None else replicas.per_rank_batch(batch_size)

    if main_rank:
        os.makedirs(args.train_dir, exist_ok=True)
        config_util.save_pipeline_config(
            config_util.create_pipeline_proto_from_configs(configs), args.train_dir)

    tx, _, ema_decay = optimizer_builder.build(train_config.optimizer, train_config)
    aug_options = preprocessor_builder.build(train_config.data_augmentation_options)
    resizer = model_builder.resizer_params(model_builder.image_resizer(configs["model"]))
    # with a keep-aspect resizer the crop / pad family changes the final
    # shape: its geometry is drawn on the host and the batch computes at
    # the post-crop bucket (data/host_geometry.py)
    host_ops, aug_options = split_host_geometry(aug_options, resizer)
    host_geometry = None
    if host_ops:
        host_geometry = HostGeometry(host_ops, resizer[1]["min_dimension"],
                                     resizer[1]["max_dimension"], model.cfg.canvas_size)
        say(f"[train] host-side crop / pad geometry: {[n for n, _ in host_ops]}", flush=True)
    reg_fn = ts.make_regularization_fn(model_builder.regularization_scopes(configs["model"]))

    input_config = configs["train_input_config"]
    dataset = DetectionDataset(
        list(input_config.tf_record_input_reader.input_path),
        canvas_size=model.cfg.canvas_size,
        resizer=resizer,
        max_boxes=model.cfg.max_gt_boxes,
        process_index=0 if replicas is None else replicas.rank,
        process_count=1 if replicas is None else replicas.world_size,
        load_instance_masks=(input_config.load_instance_masks
                             and model.cfg.predict_instance_masks),
        num_keypoints=input_config.num_keypoints,
        tf1_resize=args.tf1_resize,
    )
    ranks = "" if replicas is None else (
        f" (world size {replicas.world_size} over {replicas.backend}, {local_batch} a rank; "
        "examples of rank 0's shard)")
    say(f"[train] {len(dataset)} examples, batch {batch_size}{ranks}, canvas "
        f"{model.cfg.canvas_size}, {num_steps} steps, device {device}", flush=True)

    state = ts.create_train_state(model, tx, keep_ema=ema_decay is not None)
    manager = ckpt_lib.CheckpointManager(
        args.train_dir, keep_every_n_hours=train_config.keep_checkpoint_every_n_hours)
    latest = manager.latest_step()
    if latest is not None:  # every weight comes from the checkpoint
        state = manager.restore(state)
        say(f"[train] resumed from step {latest}", flush=True)
    else:
        model.init_weights(torch.Generator().manual_seed(args.seed))
        if train_config.fine_tune_checkpoint:
            restored, skipped = ckpt_lib.restore_warm_start(
                model, train_config.fine_tune_checkpoint,
                train_config.from_detection_checkpoint)
            say(f"[train] warm start: {restored} restored, {skipped} skipped", flush=True)
        # the moving average starts at the weights the run starts from
        state = ts.create_train_state(model, tx, keep_ema=ema_decay is not None)
    if replicas is not None:  # every rank starts from rank 0's state
        replicas.broadcast_(list(model.modules.state_dict().values())
                            + list(state.opt_state.trace) + list(state.opt_state.nu or [])
                            + list((state.ema or {}).values()))

    step_fn = make_step_fn(model, aug_options, reg_fn, bucket_multiple=multiple,
                           replicas=replicas, ema_decay=ema_decay)
    generator = torch.Generator(device=device)
    shuffle = input_config.shuffle and not args.deterministic
    # input_reader.num_epochs: 0 repeats forever; otherwise the run ends
    # when the data does, even before num_steps
    epochs = input_config.num_epochs or None
    if epochs is not None and replicas is not None:
        # the ranks' shards may give unequal batch counts: stop all of them
        # with the shortest, or one would wait forever in an all-reduce
        per_epoch = batches_per_epoch(dataset, local_batch, bool(args.pack_transfer),
                                      bool(args.aspect_grouping), multiple, host_geometry,
                                      max_variants)
        num_steps = min(num_steps, state.step + replicas.min_int(epochs * per_epoch))
    if args.precompile_buckets:
        warm_up_buckets(model, step_fn, state, dataset, local_batch, host_geometry,
                        max_variants, multiple, device, bool(args.pack_transfer), say)
    loader_args = dict(shuffle=shuffle, seed=args.seed, decode_threads=args.decode_threads,
                       pack_images=bool(args.pack_transfer),
                       aspect_grouping=bool(args.aspect_grouping), bucket_multiple=multiple,
                       host_geometry=host_geometry, max_bucket_variants=max_variants)
    if args.grain_workers > 0:
        from mtlx_torch.data.grain_loader import make_grain_loader

        host_iter = make_grain_loader(dataset, local_batch, worker_count=args.grain_workers,
                                      num_epochs=epochs, **loader_args)
    else:
        host_iter = batches(dataset, local_batch, epochs=epochs, **loader_args)
    stalls: list = []  # seconds the loop waited for each batch
    save_every = train_config.save_checkpoints_steps or 1000
    saved = latest
    cur = state.step
    t_log, step_log, stall_log = time.perf_counter(), cur, 0
    writer = SummaryWriter(args.train_dir) if main_rank else None
    profiler = None
    profile_from = args.profile_from if main_rank else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    data_iter = device_prefetch(host_iter, device, stalls=stalls)  # starts at its first next()
    try:
        while cur < num_steps:
            batch, _ = next(data_iter, (None, None))
            if batch is None:  # num_epochs ran out
                break
            if profile_from and cur == profile_from:
                profiler = start_profiler(device)
            if profiler is not None and cur >= profile_from + args.profile_steps:
                stop_profiler(profiler, args.train_dir, cur)
                profiler = None
            batch = {k: v for k, v in batch.items()
                     if k not in ("gt_difficult", "gt_group_of", "original_shape")}
            generator.manual_seed(step_seed(args.seed + 1, cur))
            state, metrics = step_fn(state, batch, generator=generator)
            cur = state.step
            if main_rank and (cur % args.log_every == 0 or cur == 1):
                raw = {k: float(v) for k, v in metrics.items()}  # syncs
                values = {k: round(v, 4) for k, v in raw.items()}
                now = time.perf_counter()
                wall = now - t_log
                line = {
                    "step": cur,
                    "images_per_sec": round((cur - step_log) * batch_size / wall, 2),
                    "learning_rate": float(tx.lr(cur)),
                    **values,
                    "loader_wait_share": round(sum(stalls[stall_log:]) / wall, 4),
                }
                print("[train] " + json.dumps(line), flush=True)
                for k, v in raw.items():
                    writer.scalar(k, v, cur)
                writer.scalar("learning_rate", line["learning_rate"], cur)
                writer.scalar("global_step/sec", line["images_per_sec"] / batch_size, cur)
                writer.flush()
                t_log, step_log, stall_log = now, cur, len(stalls)
            if main_rank and (cur % save_every == 0 or cur >= num_steps):
                manager.save(cur, state)
                saved = cur
    finally:
        if profiler is not None:
            stop_profiler(profiler, args.train_dir, cur)
        data_iter.close()
        if args.grain_workers > 0:
            host_iter.close()
        dataset.close()
        if writer is not None:
            writer.close()
    if main_rank:
        if saved != state.step:
            manager.save(state.step, state)
        manager.wait()
    if replicas is not None:  # the other ranks wait for rank 0's checkpoint
        replicas.barrier()
    if main_rank and device.type == "cuda":
        summary = {"peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30,
                   "kernel_launches": kernel_launches()}
        print("[train] summary " + json.dumps(summary), flush=True)
    say(f"[train] done at step {state.step}", flush=True)


if __name__ == "__main__":
    main()
