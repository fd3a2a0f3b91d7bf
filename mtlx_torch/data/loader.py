"""Host input pipeline: TFRecord -> decoded, canvas-shaped batches (port of
mtlx/data/loader.py).

The host decodes each record's image (data/imgcodec.py: libjpeg for
JPEG, numpy + zlib for PNG) onto its resizer target and pads it onto
the static canvas; augmentation, labels and target assignment run on
the device inside the train step. `batches` gives the same batches as
mtlx's for the same arguments and seed (the same numpy generator calls):
the record order, the crop / pad geometry drawn on the host for each
record visit (data/host_geometry.py) and the bucket each batch ships
at, bounded by `max_bucket_variants` (`BucketCoalescer`).
`device_prefetch` moves each batch to the device on a side CUDA stream
from pinned memory while the step runs; data/grain_loader.py runs
`batches`' work in worker processes.

With load_instance_masks a sample carries `gt_instance_masks` [G, CH /
mask_stride, CW / mask_stride] uint8 0 / 1: each instance's mask resized
with PIL (bilinear, thresholded at half) onto round(true / mask_stride)
and pasted at the top left of the reduced canvas, as mtlx carries them
(the mask loss crops them to 14x14 anyway). With num_keypoints P a
sample carries `gt_keypoints` [G, P, 2], absolute (y, x) on the canvas.
Both are arrays of the batch like any other, so the worker loader ships
them through its shared memory too.
"""

from __future__ import annotations

import logging
import mmap
import queue as queue_lib
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mtlx_torch.data import imgcodec, tfrecord
from mtlx_torch.data.example_decoder import InputDataFields, decode_example
from mtlx_torch.device import DeviceLike, resolve_device
from mtlx_torch.utils.bucketing import bucket_extent, bucket_multiple as _bucket_multiple


def keep_aspect_target(h: int, w: int, min_dimension: int,
                       max_dimension: int) -> Tuple[int, int]:
    """Target (th, tw) of the reference keep_aspect_ratio_resizer."""
    scale = min(min_dimension / min(h, w), max_dimension / max(h, w))
    return int(round(h * scale)), int(round(w * scale))


def pad_or_clip(x: np.ndarray, length: int) -> np.ndarray:
    """x padded with zeros or clipped along axis 0 to `length` (mtlx's
    shape_utils.pad_or_clip_along_axis on numpy input)."""
    n = x.shape[0]
    if n >= length:
        return x[:length]
    return np.concatenate([x, np.zeros((length - n,) + x.shape[1:], x.dtype)], axis=0)


class DetectionDataset:
    """Random-access TFRecord detection dataset with canvas shaping. With
    process_count > 1 it holds records [process_index::process_count] of
    the input files (a data-parallel rank's shard, as mtlx's loader
    shards by JAX process)."""

    def __init__(
        self,
        input_paths: Sequence[str],
        canvas_size: Tuple[int, int],
        resizer: Tuple[str, dict] = ("keep_aspect", {"min_dimension": 600,
                                                      "max_dimension": 1024}),
        max_boxes: int = 100,
        process_index: int = 0,
        process_count: int = 1,
        keep_difficult: bool = True,
        load_instance_masks: bool = False,
        mask_stride: int = 8,
        num_keypoints: int = 0,
        tf1_resize: bool = False,
    ):
        self.load_instance_masks = load_instance_masks
        self.mask_stride = mask_stride
        self.num_keypoints = num_keypoints
        self.canvas_size = canvas_size
        self.resizer = resizer
        self.tf1_resize = tf1_resize
        self.max_boxes = max_boxes
        self.keep_difficult = keep_difficult
        self._files: List[Tuple[str, int]] = []
        for path in input_paths:
            for off in tfrecord.record_index(path):
                self._files.append((path, off))
        self._files = self._files[process_index::process_count]
        # each file is mapped once: a record is a slice of the map, so
        # reading one copies nothing and needs no lock across threads
        self._maps: Dict[str, mmap.mmap] = {}
        self._map_lock = threading.Lock()

    def __getstate__(self) -> Dict:
        """What a loader worker process gets: the record index, not the
        maps (it maps the files anew)."""
        state = dict(self.__dict__)
        del state["_maps"], state["_map_lock"]
        return state

    def __setstate__(self, state: Dict) -> None:
        self.__dict__.update(state)
        self._maps = {}
        self._map_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._files)

    def close(self) -> None:
        with self._map_lock:
            for m in self._maps.values():
                try:
                    m.close()
                except BufferError:  # a sample still holds a slice: freed with it
                    pass
            self._maps.clear()

    def _read(self, i: int) -> memoryview:
        """Record i's payload, a slice of its file's map."""
        path, off = self._files[i]
        m = self._maps.get(path)
        if m is None:
            with self._map_lock:
                m = self._maps.get(path)
                if m is None:
                    with open(path, "rb") as f:
                        m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                    self._maps[path] = m
        (length,) = struct.unpack_from("<Q", m, off)
        return memoryview(m)[off + 12: off + 12 + length]

    def _parse(self, i: int, with_masks: bool = False) -> Dict:
        """Example parse only, no image decode; with_masks decodes the
        instance masks too (when loaded), which only a sample needs, not
        the header scans."""
        return decode_example(self._read(i), decode_image=False, return_encoded=True,
                              load_instance_masks=with_masks and self.load_instance_masks)

    def _target(self, h0: int, w0: int) -> Tuple[int, int]:
        kind, params = self.resizer
        if kind == "fixed":
            return params["height"], params["width"]
        return keep_aspect_target(h0, w0, **params)

    def peek_target_shape(self, i: int) -> Tuple[int, int]:
        """(th, tw) the resizer will produce for record i, from the image
        header only."""
        ex = self._parse(i)
        kind, params = self.resizer
        if kind == "fixed":
            return params["height"], params["width"]
        h0, w0 = imgcodec.image_dims(ex[InputDataFields.image_encoded],
                                     ex.get(InputDataFields.image_format, b"jpeg"))
        return keep_aspect_target(h0, w0, **params)

    def peek_geometry_sample(self, i: int) -> Dict[str, np.ndarray]:
        """Record i's true_shape, original_shape, gt_boxes and gt_mask from
        the Example and the image header, no pixels: what
        host_geometry.HostGeometry reads."""
        ex = self._parse(i)
        h0, w0 = imgcodec.image_dims(ex[InputDataFields.image_encoded],
                                     ex.get(InputDataFields.image_format, b"jpeg"))
        th, tw = self._target(h0, w0)
        ch, cw = self.canvas_size
        th, tw = min(th, ch), min(tw, cw)
        boxes_norm = ex[InputDataFields.groundtruth_boxes]
        difficult = ex[InputDataFields.groundtruth_difficult]
        if not self.keep_difficult and len(difficult) == len(boxes_norm):
            boxes_norm = boxes_norm[difficult == 0]
        boxes_abs = boxes_norm * np.asarray([th, tw, th, tw], np.float32)
        mask = np.zeros((self.max_boxes,), bool)
        mask[: min(len(boxes_abs), self.max_boxes)] = True
        return {
            "true_shape": np.asarray([th, tw], np.int32),
            "original_shape": np.asarray([h0, w0], np.int32),
            "gt_boxes": pad_or_clip(boxes_abs.astype(np.float32), self.max_boxes),
            "gt_mask": mask,
        }

    def get(self, i: int) -> Dict[str, np.ndarray]:
        """One canvas-shaped sample (numpy)."""
        return self._decode_assemble(self._parse(i, with_masks=True), i)

    def _decode_assemble(self, ex: Dict, i: int) -> Dict[str, np.ndarray]:
        enc = ex[InputDataFields.image_encoded]
        fmt = ex.get(InputDataFields.image_format, b"jpeg")
        h0, w0 = imgcodec.image_dims(enc, fmt)
        th, tw = self._target(h0, w0)
        image = imgcodec.decode_resized(enc, fmt, th, tw, self.tf1_resize)
        return self._assemble(ex, image, h0, w0, i)

    def get_batch(self, indices: Sequence[int],
                  decode_threads: int = 4) -> List[Dict[str, np.ndarray]]:
        """Samples with the JPEGs decoded on the codec's thread pool (the
        interpreter lock released); a batch holding another format decodes
        one image at a time."""
        exs = [self._parse(int(i), with_masks=True) for i in indices]
        fmts = [ex.get(InputDataFields.image_format, b"jpeg") for ex in exs]
        if any(f not in imgcodec.JPEG_FORMATS for f in fmts):
            return [self._decode_assemble(ex, int(i)) for ex, i in zip(exs, indices)]
        blobs = [ex[InputDataFields.image_encoded] for ex in exs]
        dims = [imgcodec.jpeg_dims(b) for b in blobs]
        targets = [self._target(h0, w0) for h0, w0 in dims]
        images = imgcodec.decode_jpeg_batch(blobs, [t[0] for t in targets],
                                            [t[1] for t in targets], decode_threads,
                                            self.tf1_resize)
        return [self._assemble(ex, image, h0, w0, int(i))
                for ex, i, image, (h0, w0) in zip(exs, indices, images, dims)]

    def _assemble(self, ex: Dict, image: np.ndarray, h0: int, w0: int,
                  i: int) -> Dict[str, np.ndarray]:
        boxes_norm = ex[InputDataFields.groundtruth_boxes]
        classes = ex[InputDataFields.groundtruth_classes].astype(np.int32) - 1
        difficult = ex[InputDataFields.groundtruth_difficult]
        group_of = ex.get(InputDataFields.groundtruth_group_of)
        if group_of is None or len(group_of) != len(classes):
            group_of = np.zeros(len(classes), np.int64)
        inst_masks = ex.get(InputDataFields.groundtruth_instance_masks)
        keypoints_norm = ex.get(InputDataFields.groundtruth_keypoints)
        if not self.keep_difficult and len(difficult) == len(classes):
            keep = difficult == 0
            boxes_norm, classes = boxes_norm[keep], classes[keep]
            difficult, group_of = difficult[keep], group_of[keep]
            if inst_masks is not None and len(inst_masks):
                inst_masks = inst_masks[keep]
            if keypoints_norm is not None and len(keypoints_norm):
                keypoints_norm = keypoints_norm[keep]

        th, tw = image.shape[:2]
        ch, cw = self.canvas_size
        if th > ch or tw > cw:  # canvas chosen from resizer, shouldn't happen
            image = image[:ch, :cw]
            th, tw = image.shape[:2]
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:th, :tw] = image

        # normalized boxes -> absolute canvas pixels of the resized image
        boxes_abs = boxes_norm * np.asarray([th, tw, th, tw], np.float32)
        n = len(boxes_abs)
        mask = np.zeros((self.max_boxes,), bool)
        mask[: min(n, self.max_boxes)] = True
        extra = {}
        if self.num_keypoints > 0:
            p = self.num_keypoints
            gt_kp = np.zeros((self.max_boxes, p, 2), np.float32)
            if keypoints_norm is not None and keypoints_norm.size:
                k = keypoints_norm[: self.max_boxes, :p]
                # normalized -> absolute canvas pixels (the boxes' frame)
                gt_kp[: k.shape[0], : k.shape[1]] = k * np.asarray([th, tw], np.float32)
            extra["gt_keypoints"] = gt_kp
        if self.load_instance_masks:
            extra["gt_instance_masks"] = self._paste_masks(inst_masks, th, tw)
        return {
            "image": canvas,
            "true_shape": np.asarray([th, tw], np.int32),
            "original_shape": np.asarray([h0, w0], np.int32),
            "gt_boxes": pad_or_clip(boxes_abs.astype(np.float32), self.max_boxes),
            "gt_classes": pad_or_clip(classes, self.max_boxes),
            "gt_difficult": pad_or_clip(difficult.astype(np.int32), self.max_boxes),
            "gt_group_of": pad_or_clip(group_of.astype(np.int32), self.max_boxes),
            "gt_mask": mask,
            "source_id": ex.get(InputDataFields.source_id, str(i)),
            **extra,
        }

    def _paste_masks(self, inst_masks: Optional[np.ndarray], th: int, tw: int) -> np.ndarray:
        """[max_boxes, CH / s, CW / s] uint8: each instance mask resized with
        the image onto round(true / s) (PIL bilinear, thresholded at 127)
        and pasted on the reduced canvas (s = mask_stride)."""
        from PIL import Image

        ms = self.mask_stride
        ch, cw = self.canvas_size
        mch, mcw = ch // ms, cw // ms
        out = np.zeros((self.max_boxes, mch, mcw), np.uint8)
        if inst_masks is None:
            return out
        mth, mtw = max(1, round(th / ms)), max(1, round(tw / ms))
        for k in range(min(len(inst_masks), self.max_boxes)):
            small = np.asarray(
                Image.fromarray((inst_masks[k] > 0.5).astype(np.uint8) * 255, "L").resize(
                    (min(mtw, mcw), min(mth, mch)), Image.BILINEAR))
            out[k, : small.shape[0], : small.shape[1]] = small > 127
        return out


def _bucket(true_shapes: np.ndarray, canvas_hw, bucket_multiple: int,
            coalescer: Optional["BucketCoalescer"] = None) -> Tuple[int, int]:
    """The compute bucket of a batch: its largest true extents rounded up
    to the granularity, capped at the canvas, and with a coalescer its
    kept superset."""
    mult = _bucket_multiple(bucket_multiple)
    hb = bucket_extent(true_shapes[:, 0].max(), canvas_hw[0], mult)
    wb = bucket_extent(true_shapes[:, 1].max(), canvas_hw[1], mult)
    if coalescer is not None:
        hb, wb = coalescer.map((hb, wb))
        hb, wb = min(canvas_hw[0], hb), min(canvas_hw[1], wb)
    return hb, wb


def pack_batch_images(images: np.ndarray, true_shapes: np.ndarray, bucket_multiple: int = 0,
                      coalescer: Optional["BucketCoalescer"] = None) -> np.ndarray:
    """Crop a canvas-shaped image batch to its bucketed true region: the
    canvas padding is zeros, so it need not cross to the device (the step
    pads back to its bucket)."""
    hb, wb = _bucket(true_shapes, images.shape[1:3], bucket_multiple, coalescer)
    return np.ascontiguousarray(images[:, :hb, :wb])


def _collate(samples: List[Dict], pack_images: bool = False, bucket_multiple: int = 0,
             coalescer: Optional["BucketCoalescer"] = None) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        if key == "source_id":
            out[key] = [s[key] for s in samples]
        elif key != "image" or not pack_images:
            out[key] = np.stack([s[key] for s in samples])
    if pack_images:
        # pack_batch_images of the stacked canvases, without stacking them;
        # with host geometry the pixels shipped cover the resample's reads
        # and its output region (pack_shape)
        extents = out.get("pack_shape", out["true_shape"])
        hb, wb = _bucket(extents, samples[0]["image"].shape[:2], bucket_multiple, coalescer)
        out["image"] = np.empty((len(samples), hb, wb, 3), np.uint8)
        for j, s in enumerate(samples):
            out["image"][j] = s["image"][:hb, :wb]
    out.pop("pack_shape", None)
    return out


def achievable_bucket_shapes(dataset: "DetectionDataset", batch_size: int,
                             max_records: Optional[int] = None, host_geometry=None,
                             max_bucket_variants: int = 0,
                             bucket_multiple: int = 0) -> List[Tuple[int, int]]:
    """Every (h, w) compute bucket the batches of this dataset can take,
    from the image headers only (the train CLI's --precompile_buckets
    warms each up before step 1).

    A batch's bucket is the componentwise max of its records' buckets, so
    at batch_size > 1 the set is the pairwise max-closure of the distinct
    record buckets. With host geometry a sample ships at pack_shape =
    max(post-crop shape, the crop window's read extent), so its bucket can
    be any multiple between the smallest post-crop bucket and the per-axis
    max: the whole grid over that range. With max_bucket_variants every
    batch packs through the coalescer, so the kept set is the answer."""
    mult = _bucket_multiple(bucket_multiple)
    per_record = set(record_bucket_keys(dataset, max_records, bucket_multiple=mult))
    if max_bucket_variants:
        co = build_bucket_coalescer(dataset, max_bucket_variants, host_geometry=host_geometry,
                                    bucket_multiple=mult)
        return list(co.kept)
    if host_geometry is not None:
        both = per_record | set(host_geometry.achievable_post_buckets(mult))
        lo_h, lo_w = min(h for h, _ in both), min(w for _, w in both)
        hi_h, hi_w = max(h for h, _ in both), max(w for _, w in both)
        return [(h, w) for h in range(lo_h, hi_h + 1, mult) for w in range(lo_w, hi_w + 1, mult)]
    shapes = set(per_record)
    if batch_size > 1:
        for h1, w1 in per_record:
            for h2, w2 in per_record:
                shapes.add((max(h1, h2), max(w1, w2)))
    return sorted(shapes)


class BucketCoalescer:
    """Bounds the compute-bucket variants (the train CLI's
    --max_bucket_variants): keeps the whole canvas (a superset of every
    bucket) and the `max_variants - 1` most frequent other ranking
    buckets, and maps every other bucket, seen or not, to its
    smallest-area kept superset. While the distinct ranking buckets and
    the canvas fit the bound, seen buckets map to themselves; buckets
    that only appear at run time (host-geometry shapes, mixed tail
    batches) still land in the kept set.

    `runtime_stats` counts the map() calls after construction by outcome
    (exact, padded, canvas), so a caller can tell a kept set ranked from
    shapes that do not ship (maybe_warn_misranked)."""

    def __init__(self, keys: List[Tuple[int, int]], max_variants: int,
                 canvas: Tuple[int, int]):
        from collections import Counter

        if max_variants < 1:
            raise ValueError(f"max_variants must be >= 1, got {max_variants}")
        self.canvas = (int(canvas[0]), int(canvas[1]))
        counts = Counter(tuple(int(a) for a in k) for k in keys)
        # active: some ranking bucket was dropped from the kept set
        self.active = len(set(counts) | {self.canvas}) > max_variants
        if not self.active:
            kept = set(counts) | {self.canvas}
        else:
            # frequency, then shape; one slot is the canvas's
            by_freq = sorted(counts, key=lambda k: (-counts[k], k))
            kept = set([k for k in by_freq if k != self.canvas][: max_variants - 1])
            kept.add(self.canvas)
        self.kept = sorted(kept)
        self._map: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._warned = False
        for k in counts:
            self.map(k)
        self.runtime_stats = Counter()

    def map(self, key: Tuple[int, int]) -> Tuple[int, int]:
        """The kept bucket this bucket computes at (a key beyond the canvas
        is clamped to it first)."""
        key = (min(int(key[0]), self.canvas[0]), min(int(key[1]), self.canvas[1]))
        hit = self._map.get(key)
        if hit is None:
            supers = [s for s in self.kept if s[0] >= key[0] and s[1] >= key[1]]
            hit = min(supers, key=lambda s: (s[0] * s[1], s))
            self._map[key] = hit
        stats = getattr(self, "runtime_stats", None)
        if stats is not None:
            stats["exact" if hit == key else "canvas" if hit == self.canvas else "padded"] += 1
        return hit

    def maybe_warn_misranked(self, min_calls: int = 64, canvas_fraction: float = 0.5) -> bool:
        """Warn once when most run-time buckets fall through to the canvas:
        the kept set was ranked from shapes that do not ship."""
        stats = self.runtime_stats
        total = sum(stats.values())
        if self._warned or total < min_calls or stats["canvas"] / total <= canvas_fraction:
            return False
        self._warned = True
        logging.getLogger(__name__).warning(
            "max_bucket_variants: %d/%d run-time buckets mapped to the whole canvas %s; the "
            "kept set %s does not match the shapes that ship", stats["canvas"], total,
            self.canvas, self.kept)
        return True


# the post-geometry bucket ranking's own seed and sample size: batches()
# and achievable_bucket_shapes() build the same kept set whatever the
# training seed
_GEOMETRY_RANK_SEED = 0x6B75
_GEOMETRY_RANK_RECORDS = 512


def sampled_post_geometry_keys(dataset: "DetectionDataset", host_geometry,
                               max_records: int = _GEOMETRY_RANK_RECORDS,
                               bucket_multiple: int = 0) -> List[Tuple[int, int]]:
    """The pack-shape buckets of one geometry draw on each of up to
    max_records records spread over the dataset (a fixed seed, headers
    only): with host geometry these are the shapes that ship, not the
    records' own buckets."""
    mult = _bucket_multiple(bucket_multiple)
    ch, cw = dataset.canvas_size
    n = len(dataset)
    idx = sorted(set(np.linspace(0, n - 1, min(n, max_records)).astype(int).tolist()))
    out = []
    for i in idx:
        post = host_geometry(dataset.peek_geometry_sample(int(i)),
                             np.random.default_rng([_GEOMETRY_RANK_SEED, int(i)]))
        ph, pw = post["pack_shape"]
        out.append((bucket_extent(int(ph), ch, mult), bucket_extent(int(pw), cw, mult)))
    return out


def build_bucket_coalescer(dataset: "DetectionDataset", max_variants: int, host_geometry=None,
                           record_keys: Optional[List[Tuple[int, int]]] = None,
                           bucket_multiple: int = 0) -> BucketCoalescer:
    """The one construction of the --max_bucket_variants coalescer
    (batches, the worker loader, achievable_bucket_shapes), so every
    consumer keeps the same set: ranked from the sampled post-geometry
    pack buckets with host geometry, from the record buckets otherwise."""
    if host_geometry is not None:
        keys = sampled_post_geometry_keys(dataset, host_geometry,
                                          bucket_multiple=bucket_multiple)
    else:
        keys = record_keys if record_keys is not None else record_bucket_keys(
            dataset, bucket_multiple=bucket_multiple)
    return BucketCoalescer(keys, max_variants, dataset.canvas_size)


def record_bucket_keys(dataset: DetectionDataset, max_records: Optional[int] = None,
                       bucket_multiple: int = 0) -> List[Tuple[int, int]]:
    """Per-record compute-bucket shape from image headers only, the
    grouping key of aspect-grouped batching; cached on the dataset per
    bucket granularity."""
    mult = _bucket_multiple(bucket_multiple)
    ch, cw = dataset.canvas_size
    n = len(dataset)
    if max_records is not None:
        n = min(n, max_records)
    cache_mult, cached = getattr(dataset, "_bucket_key_cache", (None, []))
    if cache_mult != mult:
        cached = []
    if len(cached) >= n:
        return cached[:n]
    out = list(cached)
    for i in range(len(out), n):
        th, tw = dataset.peek_target_shape(i)
        out.append((bucket_extent(th, ch, mult), bucket_extent(tw, cw, mult)))
    dataset._bucket_key_cache = (mult, out)
    return out


def _grouped_epoch_order(keys: List[Tuple[int, int]], batch_size: int,
                         rng, shuffle: bool) -> List[np.ndarray]:
    """One epoch's batches with aspect grouping: records sharing a compute
    bucket batch together; per-group leftovers form mixed tail batches, so
    every record is visited once an epoch."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    out, leftover = [], []
    for k in sorted(groups):
        idxs = np.asarray(groups[k])
        if shuffle:
            rng.shuffle(idxs)
        full = len(idxs) // batch_size * batch_size
        out += [idxs[s : s + batch_size] for s in range(0, full, batch_size)]
        leftover += list(idxs[full:])
    leftover = np.asarray(leftover, dtype=np.int64)
    if shuffle and len(leftover):
        rng.shuffle(leftover)
    out += [leftover[s : s + batch_size]
            for s in range(0, len(leftover), batch_size)]
    if shuffle:
        rng.shuffle(out)
    return out


class BatchPlan:
    """What `batches` decides before reading a pixel: whether batches
    group by bucket, the grouping keys, and the coalescer
    (max_bucket_variants > 0 with pack_images). `epochs` yields each
    batch's (epoch, record indices) in `batches`' order."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, pack_images: bool = False,
                 aspect_grouping: Optional[bool] = None, bucket_multiple: int = 0,
                 host_geometry=None, max_bucket_variants: int = 0):
        if aspect_grouping is None:
            aspect_grouping = pack_images
        self.batch_size = batch_size
        self.aspect_grouping = aspect_grouping and batch_size > 1
        self.n = len(dataset)
        self.keys = record_bucket_keys(dataset, bucket_multiple=bucket_multiple) \
            if self.aspect_grouping else None
        self.coalescer = None
        # the bound holds wherever images pack (at batch 1 too)
        if max_bucket_variants and pack_images:
            self.coalescer = build_bucket_coalescer(dataset, max_bucket_variants,
                                                    host_geometry=host_geometry,
                                                    record_keys=self.keys,
                                                    bucket_multiple=bucket_multiple)
            # records sharing a kept bucket group together; under host
            # geometry the record buckets are only a grouping heuristic
            if self.keys is not None and host_geometry is None:
                self.keys = [self.coalescer.map(k) for k in self.keys]

    def epochs(self, shuffle: bool = True, seed: int = 0, epochs: Optional[int] = None,
               drop_remainder: bool = True) -> Iterator[Tuple[int, np.ndarray]]:
        rng = np.random.RandomState(seed)
        epoch = 0
        bs, n = self.batch_size, self.n
        while epochs is None or epoch < epochs:
            if self.aspect_grouping:
                epoch_batches = _grouped_epoch_order(self.keys, bs, rng, shuffle)
                order = np.concatenate(epoch_batches) if epoch_batches else np.arange(n)
            else:
                order = rng.permutation(n) if shuffle else np.arange(n)
                epoch_batches = [order[s : s + bs] for s in range(0, n, bs)]
            for idx in epoch_batches:
                if len(idx) < bs:
                    if drop_remainder:
                        continue
                    idx = np.concatenate([idx, order[: bs - len(idx)]])
                yield epoch, idx
            epoch += 1

    def per_epoch(self) -> int:
        """Batches an epoch with drop_remainder: with grouping, each
        group's full batches and the full batches of the leftovers."""
        bs = self.batch_size
        if not self.aspect_grouping:
            return self.n // bs
        counts: Dict[Tuple[int, int], int] = {}
        for k in self.keys:
            counts[k] = counts.get(k, 0) + 1
        return (sum(c // bs for c in counts.values())
                + sum(c % bs for c in counts.values()) // bs)


def load_batch(dataset: DetectionDataset, idx: np.ndarray, epoch: int, seed: int = 0,
               decode_threads: int = 0, host_geometry=None, pack_images: bool = False,
               bucket_multiple: int = 0,
               coalescer: Optional[BucketCoalescer] = None) -> Dict[str, np.ndarray]:
    """One batch of `batches`: decode records idx, draw each one's host
    geometry from np.random.default_rng([seed, epoch, record]) (so a
    record visit's draws depend on nothing else), collate and pack."""
    if decode_threads > 0:
        samples = dataset.get_batch(idx, decode_threads)
    else:
        samples = [dataset.get(int(i)) for i in idx]
    if host_geometry is not None:
        samples = [host_geometry(s, np.random.default_rng([seed, epoch, int(i)]))
                   for s, i in zip(samples, idx)]
    return _collate(samples, pack_images, bucket_multiple, coalescer)


def batches_per_epoch(dataset: DetectionDataset, batch_size: int, pack_images: bool = False,
                      aspect_grouping: Optional[bool] = None, bucket_multiple: int = 0,
                      host_geometry=None, max_bucket_variants: int = 0) -> int:
    """How many batches `batches` yields an epoch with drop_remainder (the
    same arguments)."""
    return BatchPlan(dataset, batch_size, pack_images, aspect_grouping, bucket_multiple,
                     host_geometry, max_bucket_variants).per_epoch()


def batches(
    dataset: DetectionDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = None,
    drop_remainder: bool = True,
    decode_threads: int = 0,
    pack_images: bool = False,
    aspect_grouping: Optional[bool] = None,
    bucket_multiple: int = 0,
    host_geometry=None,
    max_bucket_variants: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host batch iterator, shuffled each epoch from `seed` (the batches
    of mtlx's `batches` for the same arguments). decode_threads > 0
    decodes each batch's JPEGs on the codec's thread pool; pack_images
    ships bucketed true-shape images; aspect_grouping (default: on when
    pack_images is) batches records by shared compute bucket;
    host_geometry (a host_geometry.HostGeometry) draws each record
    visit's crop / pad geometry; max_bucket_variants > 0 bounds the
    compute buckets (BucketCoalescer): rarer ones pad up to a kept
    superset."""
    plan = BatchPlan(dataset, batch_size, pack_images, aspect_grouping, bucket_multiple,
                     host_geometry, max_bucket_variants)
    for epoch, idx in plan.epochs(shuffle, seed, epochs, drop_remainder):
        yield load_batch(dataset, idx, epoch, seed, decode_threads, host_geometry,
                         pack_images, bucket_multiple, plan.coalescer)
        if plan.coalescer is not None:
            plan.coalescer.maybe_warn_misranked()


def _to_device(batch: Dict[str, np.ndarray], device: torch.device,
               stream, consumer_stream) -> Tuple[Dict[str, torch.Tensor], object]:
    """The batch as tensors on `device`. On a CUDA device each array is
    pinned and copied on `stream`; the returned event marks the copies'
    end, and each tensor is recorded as used on the consumer's stream so
    the allocator keeps its memory until the consumer's work is done."""
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, None
    out = {}
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            t = host.to(device, non_blocking=True)
            t.record_stream(consumer_stream)
            out[k] = t
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def device_prefetch(iterator, device: DeviceLike = None, size: int = 2,
                    stalls: Optional[List[float]] = None):
    """Yield (batch of tensors on `device`, source ids) from a host batch
    iterator, `size` batches ahead, filled by a background thread.

    On the CUDA device the thread pins each batch and copies it on a side
    stream; the consumer's stream waits on the copy's event before the
    batch is handed over. The thread stops when the consumer stops
    iterating (the generator is closed or collected). `stalls`, when
    given, gets the seconds the consumer waited for each batch (0 when
    the thread keeps ahead)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    consumer_stream = torch.cuda.current_stream(device) if cuda else None
    side_stream = torch.cuda.Stream(device) if cuda else None
    q: queue_lib.Queue = queue_lib.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_lib.Full:
                continue
        return False

    def producer():
        try:
            while not stop.is_set():
                try:
                    batch = next(iterator)
                except StopIteration:
                    break
                ids = batch.pop("source_id", None)
                tensors, event = _to_device(batch, device, side_stream, consumer_stream)
                if not put((tensors, ids, event)):
                    return
            put(end)
        except BaseException as e:  # surface errors to the consumer
            put(e)

    iterator = iter(iterator)
    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stalls is not None:
                stalls.append(time.perf_counter() - t0)
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, ids, event = item
            if event is not None:
                consumer_stream.wait_event(event)
            yield tensors, ids
    finally:
        stop.set()
        try:  # unblock a producer stuck in q.put
            q.get_nowait()
        except queue_lib.Empty:
            pass
        thread.join(timeout=10)
