"""mtlx_torch's host data pipeline against mtlx's: TFRecords, Examples,
the JPEG and PNG codecs, the dataset, the batch order and the prefetch.

Tolerance: none. Record bytes, crcs, decoded Examples, decoded pixels
(the port's libjpeg codec is a copy of mtlx's and must give the same
bits), samples and the record order of `batches` must all be equal.
"""

import io
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from mtlx.config.protos import example_pb2
from mtlx.data import example_decoder as jdec
from mtlx.data import loader as jloader
from mtlx.data import tfrecord as jtfrecord
from mtlx.data.native_build import ensure_native
from mtlx_torch.data import example_decoder as tdec
from mtlx_torch.data import imgcodec
from mtlx_torch.data import loader as tloader
from mtlx_torch.data import tfrecord as ttfrecord

RESIZER = ("keep_aspect", {"min_dimension": 150, "max_dimension": 300})
CANVAS = (320, 320)
# landscape, portrait and square sources: three compute buckets at 128
SIZES = ((60, 140), (140, 60), (100, 100), (90, 120))


def _jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _image(rs, h, w):
    image = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    image[h // 4: h // 2, w // 4: w // 2] = [220, 40, 60]  # some structure for the DCT
    return image


def _boxes(rs, k):
    y0, x0 = rs.uniform(0, 0.6, k), rs.uniform(0, 0.6, k)
    return np.stack([y0, x0, y0 + rs.uniform(0.1, 0.4, k), x0 + rs.uniform(0.1, 0.4, k)],
                    1).astype(np.float32)


def _write(path, fmt: str, n: int = 10, seed: int = 0) -> None:
    """n records (mtlx's writer and Example builder) of JPEG images of
    SIZES in turn, or of PNG images at their resizer target size."""
    rs = np.random.RandomState(seed)
    with jtfrecord.TFRecordWriter(str(path)) as w:
        for i in range(n):
            h, wd = SIZES[i % len(SIZES)]
            if fmt == "png":
                h, wd = tloader.keep_aspect_target(h, wd, **RESIZER[1])
            image = _image(rs, h, wd)
            k = rs.randint(0, 5)
            enc = _jpeg(image) if fmt == "jpeg" else imgcodec.encode_png(image)
            ex = jdec.build_example(enc, fmt.encode(), h, wd, f"im{i}", _boxes(rs, k),
                                    rs.randint(1, 4, k), ["c"] * k,
                                    difficult=(rs.uniform(size=k) < 0.3).astype(int))
            w.write(ex.SerializeToString())


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    out = {}
    for fmt in ("jpeg", "png"):
        out[fmt] = str(tmp / f"{fmt}.record")
        _write(out[fmt], fmt, seed=len(fmt))
    return out


# ---------------------------------------------------------------- TFRecords


def test_tfrecord_bytes_and_crc_equal_mtlx(tmp_path):
    rs = np.random.RandomState(1)
    payloads = [rs.bytes(n) for n in (0, 1, 7, 8, 9, 1000, 65537)]
    for data in payloads:
        for value in (0, 12345):
            assert ttfrecord.crc32c(data, value) == jtfrecord.crc32c(data, value)
    for writer, name in ((ttfrecord.TFRecordWriter, "port"), (jtfrecord.TFRecordWriter, "mtlx")):
        with writer(str(tmp_path / name)) as w:
            for data in payloads:
                w.write(data)
    port, ref = (tmp_path / "port").read_bytes(), (tmp_path / "mtlx").read_bytes()
    assert port == ref
    path = str(tmp_path / "port")
    assert list(ttfrecord.read_records(path, verify_crc=True)) == payloads
    assert ttfrecord.record_index(path) == jtfrecord.record_index(path)
    with open(path, "rb") as f:
        assert [ttfrecord.read_record_at(f, o) for o in ttfrecord.record_index(path)] == payloads
    bad = bytearray(ref)
    bad[-5] ^= 1  # last payload byte
    (tmp_path / "bad").write_bytes(bytes(bad))
    with pytest.raises(IOError, match="corrupt data crc"):
        list(ttfrecord.read_records(str(tmp_path / "bad"), verify_crc=True))


# ---------------------------------------------------------------- Examples


def _assert_decoded_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), key
        else:
            assert g == w, key


@pytest.mark.parametrize("k", [0, 3])
def test_examples_equal_mtlx(k):
    rs = np.random.RandomState(k)
    image = _image(rs, 30, 40)
    args = (_jpeg(image), b"jpeg", 30, 40, "x.jpg", _boxes(rs, k), rs.randint(1, 21, k),
            ["a"] * k)
    kw = dict(difficult=[1, 0, 0][:k], group_of=[0, 1, 0][:k],
              keypoints=rs.uniform(size=(k, 2, 2)) if k else None)
    ref = jdec.build_example(*args, **kw)
    port = tdec.build_example(*args, **kw)
    assert example_pb2.Example.FromString(port) == ref
    serialized = ref.SerializeToString()
    for decode_image in (False, True):
        want = jdec.decode_example(serialized, decode_image=decode_image, return_encoded=True)
        got = tdec.decode_example(serialized, decode_image=decode_image, return_encoded=True)
        _assert_decoded_equal(got, want)


def test_example_unpacked_repeated_fields():
    """A reader must accept float and int64 lists written unpacked."""
    ex = example_pb2.Example()
    feat = ex.features.feature
    feat["image/object/bbox/ymin"].float_list.value.extend([0.25, 0.5])
    feat["image/object/class/label"].int64_list.value.extend([3, -1])
    packed = ex.SerializeToString()
    # rewrite the packed payloads as one field per value
    fmap = tdec.parse_features(packed)
    assert np.array_equal(fmap["image/object/bbox/ymin"][1], np.float32([0.25, 0.5]))
    assert fmap["image/object/class/label"][1].tolist() == [3, -1]
    unpacked = bytearray()
    for key, payload in (("image/object/bbox/ymin", b"".join(
            b"\x0d" + struct.pack("<f", v) for v in (0.25, 0.5))),
                         ("image/object/class/label", b"\x08\x03" + b"\x08" + b"\xff" * 9 + b"\x01")):
        kind = 2 if "bbox" in key else 3
        entry = bytearray()
        tdec.write_bytes_field(entry, 1, key.encode())
        tdec.write_bytes_field(entry, 2, tdec._feature(kind, payload))
        tdec.write_bytes_field(unpacked, 1, entry)
    outer = bytearray()
    tdec.write_bytes_field(outer, 1, unpacked)
    assert example_pb2.Example.FromString(bytes(outer)) == ex
    fmap = tdec.parse_features(bytes(outer))
    assert np.array_equal(fmap["image/object/bbox/ymin"][1], np.float32([0.25, 0.5]))
    assert fmap["image/object/class/label"][1].tolist() == [3, -1]


# ---------------------------------------------------------------- codecs


@pytest.mark.parametrize("tf1", [False, True])
def test_jpeg_decode_bit_equal_to_mtlx(tf1):
    native = ensure_native("_imgcodec_ext")
    assert native is not None, "mtlx's native codec must build here"
    rs = np.random.RandomState(2)
    gray = Image.fromarray(_image(rs, 37, 53)).convert("L")
    buf = io.BytesIO()
    gray.save(buf, format="JPEG")
    blobs = [_jpeg(_image(rs, 97, 131)), _jpeg(_image(rs, 64, 48), quality=70), buf.getvalue()]
    for blob in blobs:
        h, w = native.dims(blob)
        assert imgcodec.jpeg_dims(blob) == (h, w)
        for th, tw in ((h, w), (h // 2, w // 3), (h * 2 - 1, w + 7), (h // 8 + 1, w // 8 + 1)):
            pixels, _, _, oh, ow = native.decode(blob, th, tw, int(tf1))
            want = np.frombuffer(pixels, np.uint8).reshape(oh, ow, 3)
            assert np.array_equal(imgcodec.decode_jpeg(blob, th, tw, tf1), want), (th, tw)
    targets = [(20, 30), (97, 131), (50, 60)]
    got = imgcodec.decode_jpeg_batch(blobs, [t[0] for t in targets], [t[1] for t in targets],
                                     threads=3, tf1_resize=tf1)
    for blob, (th, tw), g in zip(blobs, targets, got):
        assert np.array_equal(g, imgcodec.decode_jpeg(blob, th, tw, tf1))
    with pytest.raises(ValueError, match="JPEG"):
        imgcodec.decode_jpeg(b"not a jpeg")
    with pytest.raises(ValueError, match="image 1"):
        imgcodec.decode_jpeg_batch([blobs[0], b"\xff\xd8junk"], [8, 8], [8, 8])


def _filtered_png(image: np.ndarray) -> bytes:
    """An 8-bit PNG whose row y uses filter y % 5 (None, Sub, Up,
    Average, Paeth), written by hand."""
    h, w, ch = image.shape
    rows = image.reshape(h, w * ch).astype(np.int64)
    out = []
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        r, kind = rows[y], y % 5
        left = np.concatenate([np.zeros(ch, np.int64), r[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        if kind == 0:
            f = r
        elif kind == 1:
            f = r - left
        elif kind == 2:
            f = r - prior
        elif kind == 3:
            f = r - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            f = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prior = r
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decode_equals_pil(channels):
    rs = np.random.RandomState(channels)
    image = rs.randint(0, 256, (23, 17, channels)).astype(np.uint8)
    blob = _filtered_png(image)
    want = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    assert np.array_equal(imgcodec.decode_png(blob), want)
    assert imgcodec.png_dims(blob) == (23, 17)
    # PIL's own encoder (its adaptive row filters)
    buf = io.BytesIO()
    Image.fromarray(image[..., 0] if channels == 1 else image).save(buf, format="PNG")
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    assert np.array_equal(imgcodec.decode_png(buf.getvalue()), want)


def test_png_round_trip():
    image = np.random.RandomState(5).randint(0, 256, (31, 45, 3)).astype(np.uint8)
    blob = imgcodec.encode_png(image)
    assert np.array_equal(imgcodec.decode_png(blob), image)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), image)
    with pytest.raises(ValueError, match="bit depth 16"):
        imgcodec.decode_png(np.asarray(blob[:24] + b"\x10" + blob[25:]).tobytes())
    assert np.array_equal(imgcodec.decode_resized(blob, b"png", 31, 45), image)
    with pytest.raises(ValueError, match="not decoded by the port"):
        imgcodec.decode_resized(blob, b"gif", 31, 45)


def test_png_resize_follows_mtlx():
    image = np.random.RandomState(6).randint(0, 256, (31, 45, 3)).astype(np.uint8)
    blob = imgcodec.encode_png(image)
    assert np.array_equal(imgcodec.decode_resized(blob, b"png", 50, 70, tf1_resize=True),
                          jloader.legacy_resize_bilinear(image, 50, 70))
    want, _ = jloader.resize_keep_aspect(image, 50, 100)
    assert np.array_equal(imgcodec.decode_resized(blob, b"png", *want.shape[:2]), want)


# ---------------------------------------------------------------- dataset and batches


def _datasets(path, **kw):
    return (tloader.DetectionDataset([path], CANVAS, RESIZER, max_boxes=6, **kw),
            jloader.DetectionDataset([path], CANVAS, RESIZER, max_boxes=6, **kw))


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype and np.array_equal(got[key], w), key
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("fmt,kw", [("jpeg", {}), ("jpeg", {"tf1_resize": True}),
                                    ("jpeg", {"keep_difficult": False}), ("png", {})])
def test_dataset_get_equals_mtlx(records, fmt, kw):
    port, ref = _datasets(records[fmt], **kw)
    assert len(port) == len(ref) == 10
    for i in range(len(ref)):
        _assert_samples_equal(port.get(i), ref.get(i))
        assert port.peek_target_shape(i) == ref.peek_target_shape(i)
    idx = [3, 0, 7]
    for a, b in zip(port.get_batch(idx, 2), ref.get_batch(idx, 2)):
        _assert_samples_equal(a, b)
    port.close()


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key == "source_id":
            assert got[key] == w
        else:
            assert np.array_equal(got[key], w), key


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3, pack_images=True),  # aspect grouping on
    dict(shuffle=True, seed=4, pack_images=False, drop_remainder=False),
    dict(shuffle=False, pack_images=True, aspect_grouping=False),
])
def test_batches_equal_mtlx(records, kw):
    port, ref = _datasets(records["jpeg"])
    got = list(tloader.batches(port, 3, epochs=2, decode_threads=2, **kw))
    want = list(jloader.batches(ref, 3, epochs=2, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert tloader.record_bucket_keys(port) == jloader.record_bucket_keys(ref)
    assert len(set(tloader.record_bucket_keys(port))) == 3
    port.close()


def test_unported_loader_options_raise(records):
    # no loader option raises any longer: instance masks and keypoints are
    # ported (tests/test_torch_masks.py holds them to mtlx on records that
    # have them); on records without them both come out as zeros, as mtlx's
    port, ref = _datasets(records["png"], load_instance_masks=True, num_keypoints=17)
    for i in range(2):
        got, want = port.get(i), ref.get(i)
        _assert_samples_equal(got, want)
        assert got["gt_instance_masks"].shape == (6, 40, 40) and not got["gt_instance_masks"].any()
        assert got["gt_keypoints"].shape == (6, 17, 2) and not got["gt_keypoints"].any()
    assert next(tloader.batches(port, 2, pack_images=True, max_bucket_variants=2))
    port.close()


def test_device_prefetch_on_cpu(records):
    port, _ = _datasets(records["png"])
    want = list(tloader.batches(port, 2, seed=1, epochs=1, pack_images=True))
    stalls = []
    got = list(tloader.device_prefetch(
        tloader.batches(port, 2, seed=1, epochs=1, pack_images=True), "cpu", stalls=stalls))
    assert len(got) == len(want) == 5 and len(stalls) == 6  # the end is waited for too
    for (tensors, ids), w in zip(got, want):
        assert ids == w["source_id"]
        for key, t in tensors.items():
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), w[key]), key
    # a consumer that stops early stops the thread
    before = set(threading.enumerate())
    it = tloader.device_prefetch(tloader.batches(port, 2, seed=1), "cpu")
    next(it)
    assert len(set(threading.enumerate()) - before) == 1
    it.close()
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


def test_device_prefetch_concurrent_readers(records):
    """Two prefetch threads read one dataset's shared file handle at once,
    with fast thread switching: each must still see its own records."""
    port, _ = _datasets(records["jpeg"])
    want = [b["source_id"] for b in tloader.batches(port, 2, seed=2, epochs=3)]
    out = {}

    def consume(tag):
        out[tag] = [ids for _, ids in tloader.device_prefetch(
            tloader.batches(port, 2, seed=2, epochs=3, decode_threads=1), "cpu")]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert out["a"] == want and out["b"] == want


def test_preprocessor_builder_equals_mtlx():
    from mtlx.builders import preprocessor_builder as jprep
    from mtlx.config.protos import pipeline_pb2
    from google.protobuf import text_format as pb_text_format

    from mtlx_torch.builders import preprocessor_builder as tprep
    from mtlx_torch.config import config_util

    text = "train_config { data_augmentation_options { random_horizontal_flip {} } }"
    ours = config_util.parse_pipeline_text(text).train_config.data_augmentation_options
    theirs = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
    assert tprep.build(ours) == jprep.build(theirs.train_config.data_augmentation_options)
    # the other steps build too (every one: test_torch_pipeline.py)
    for step in ("random_vertical_flip {}", "random_crop_image {}", "ssd_random_crop_pad {}"):
        text = f"train_config {{ data_augmentation_options {{ {step} }} }}"
        steps = config_util.parse_pipeline_text(text).train_config.data_augmentation_options
        theirs = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
        assert tprep.build(steps) == jprep.build(theirs.train_config.data_augmentation_options)
