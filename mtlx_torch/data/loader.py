"""Host input pipeline: TFRecord -> decoded, canvas-shaped batches (port of
the parts of mtlx/data/loader.py that the flagship's CLIs run).

The host decodes each record's image (data/imgcodec.py: libjpeg for
JPEG, numpy + zlib for PNG) onto its resizer target and pads it onto
the static canvas; augmentation, labels and target assignment run on
the device inside the train step. `batches` gives the same record order
as mtlx's for the same seed (the same numpy generator calls), and
`device_prefetch` moves each batch to the device on a side CUDA stream
from pinned memory while the step runs.

Not ported, each raising where it is asked for: host geometry (the
crop/pad family of augmentations), the grain loader, bucket coalescing
(`max_bucket_variants > 0`), instance masks and keypoints.
"""

from __future__ import annotations

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

_NOT_PORTED = "is not ported: ROADMAP.md queue 1"


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
        num_keypoints: int = 0,
        tf1_resize: bool = False,
    ):
        if load_instance_masks:
            raise NotImplementedError(f"load_instance_masks {_NOT_PORTED}, masks and keypoints")
        if num_keypoints:
            raise NotImplementedError(f"num_keypoints {_NOT_PORTED}, masks and keypoints")
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

    def _parse(self, i: int) -> Dict:
        """Example parse only, no image decode."""
        return decode_example(self._read(i), decode_image=False, return_encoded=True)

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

    def get(self, i: int) -> Dict[str, np.ndarray]:
        """One canvas-shaped sample (numpy)."""
        return self._decode_assemble(self._parse(i), i)

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
        exs = [self._parse(int(i)) for i in indices]
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
        if not self.keep_difficult and len(difficult) == len(classes):
            keep = difficult == 0
            boxes_norm, classes = boxes_norm[keep], classes[keep]
            difficult, group_of = difficult[keep], group_of[keep]

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
        }


def _bucket(true_shapes: np.ndarray, canvas_hw, bucket_multiple: int) -> Tuple[int, int]:
    """The compute bucket of a batch: its largest true extents rounded up
    to the granularity, capped at the canvas."""
    mult = _bucket_multiple(bucket_multiple)
    return (bucket_extent(true_shapes[:, 0].max(), canvas_hw[0], mult),
            bucket_extent(true_shapes[:, 1].max(), canvas_hw[1], mult))


def pack_batch_images(images: np.ndarray, true_shapes: np.ndarray,
                      bucket_multiple: int = 0) -> np.ndarray:
    """Crop a canvas-shaped image batch to its bucketed true region: the
    canvas padding is zeros, so it need not cross to the device (the step
    pads back to its bucket)."""
    hb, wb = _bucket(true_shapes, images.shape[1:3], bucket_multiple)
    return np.ascontiguousarray(images[:, :hb, :wb])


def _collate(samples: List[Dict], pack_images: bool = False,
             bucket_multiple: int = 0) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        if key == "source_id":
            out[key] = [s[key] for s in samples]
        elif key != "image" or not pack_images:
            out[key] = np.stack([s[key] for s in samples])
    if pack_images:
        # pack_batch_images of the stacked canvases, without stacking them
        hb, wb = _bucket(out["true_shape"], samples[0]["image"].shape[:2], bucket_multiple)
        out["image"] = np.empty((len(samples), hb, wb, 3), np.uint8)
        for j, s in enumerate(samples):
            out["image"][j] = s["image"][:hb, :wb]
    return out


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


def batches_per_epoch(dataset: DetectionDataset, batch_size: int, pack_images: bool = False,
                      aspect_grouping: Optional[bool] = None, bucket_multiple: int = 0) -> int:
    """How many batches `batches` yields an epoch with drop_remainder (the
    same arguments): with aspect grouping, each bucket's full batches and
    the full batches of the leftovers."""
    if aspect_grouping is None:
        aspect_grouping = pack_images
    if not (aspect_grouping and batch_size > 1):
        return len(dataset) // batch_size
    counts: Dict[Tuple[int, int], int] = {}
    for k in record_bucket_keys(dataset, bucket_multiple=bucket_multiple):
        counts[k] = counts.get(k, 0) + 1
    return (sum(c // batch_size for c in counts.values())
            + sum(c % batch_size for c in counts.values()) // batch_size)


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
    """Host batch iterator, shuffled each epoch from `seed` (the record
    order of mtlx's `batches` for the same arguments). decode_threads > 0
    decodes each batch's JPEGs on the codec's thread pool; pack_images
    ships bucketed true-shape images; aspect_grouping (default: on when
    pack_images is) batches records by shared compute bucket."""
    if host_geometry is not None:
        raise NotImplementedError(f"host geometry (crop/pad augmentations) {_NOT_PORTED} item 11")
    if max_bucket_variants:
        raise NotImplementedError(f"max_bucket_variants {_NOT_PORTED} item 10")
    if aspect_grouping is None:
        aspect_grouping = pack_images
    aspect_grouping = aspect_grouping and batch_size > 1
    rng = np.random.RandomState(seed)
    epoch = 0
    n = len(dataset)
    keys = record_bucket_keys(dataset, bucket_multiple=bucket_multiple) if aspect_grouping \
        else None
    while epochs is None or epoch < epochs:
        if aspect_grouping:
            epoch_batches = _grouped_epoch_order(keys, batch_size, rng, shuffle)
            order = np.concatenate(epoch_batches) if epoch_batches else np.arange(n)
        else:
            order = rng.permutation(n) if shuffle else np.arange(n)
            epoch_batches = [order[s : s + batch_size]
                             for s in range(0, n, batch_size)]
        for idx in epoch_batches:
            if len(idx) < batch_size:
                if drop_remainder:
                    continue
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            if decode_threads > 0:
                samples = dataset.get_batch(idx, decode_threads)
            else:
                samples = [dataset.get(int(i)) for i in idx]
            yield _collate(samples, pack_images, bucket_multiple)
        epoch += 1


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
