"""The port's event-file writer (`mtlx_torch/utils/summary_writer.py`)
against mtlx's (`mtlx/utils/summary_writer.py`) on the CPU.

With `time.time` fixed, the same scalars and image give the same file
name and the same bytes, once both encode the image to the same PNG
bytes (mtlx encodes with PIL, the port with its own encoder, so the test
hands mtlx's PIL the port's PNG). With each side's own PNG the files
parse with mtlx's `event_pb2` to equal events field for field but the
PNG bytes, whose decoded pixels are equal. Tolerance: none.
"""

import glob
import io
import os
import time

import numpy as np
from PIL import Image

from mtlx.config.protos import event_pb2
from mtlx.data.tfrecord import read_records
from mtlx.utils.summary_writer import SummaryWriter as JWriter
from mtlx_torch.data.imgcodec import encode_png
from mtlx_torch.utils import summary_writer as tsw

SCALARS = [("Loss/total_loss", 3.25, 1), ("learning_rate", 0.0013000006, 1),
           ("global_step/sec", 12.5, 50), ("Precision/mAP@0.5IOU", 0.8401, 300),
           ("tiny", 1e-30, 2**40)]


def _write(writer_cls, logdir, image):
    w = writer_cls(logdir)
    for tag, value, step in SCALARS:
        w.scalar(tag, value, step)
    w.image("image/0", image, 7)
    w.flush()
    w.close()
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    return path


def _image():
    return np.random.RandomState(0).randint(0, 256, (9, 13, 3)).astype(np.uint8)


def test_bytes_equal_mtlx_writer(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792216019.25)
    pil_save = Image.Image.save

    def save(self, fp, format=None, **kw):  # mtlx's PNG, as the port encodes it
        if format == "PNG":
            fp.write(encode_png(np.asarray(self)))
        else:
            pil_save(self, fp, format, **kw)

    monkeypatch.setattr(Image.Image, "save", save)
    image = _image()
    jpath = _write(JWriter, str(tmp_path / "mtlx"), image)
    tpath = _write(tsw.SummaryWriter, str(tmp_path / "port"), image)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    with open(jpath, "rb") as f:
        want = f.read()
    with open(tpath, "rb") as f:
        assert f.read() == want


def test_events_equal_field_for_field(tmp_path):
    image = _image()
    jpath = _write(JWriter, str(tmp_path / "mtlx"), image)
    tpath = _write(tsw.SummaryWriter, str(tmp_path / "port"), image)
    jevents = [event_pb2.Event.FromString(r) for r in read_records(jpath)]
    tevents = [event_pb2.Event.FromString(r) for r in read_records(tpath)]
    assert len(tevents) == len(jevents) == len(SCALARS) + 2
    assert tevents[0].file_version == "brain.Event:2" and not tevents[0].HasField("step")
    for t, j in zip(tevents, jevents):
        assert t.WhichOneof("what") == j.WhichOneof("what")
        assert t.step == j.step and t.HasField("step") == j.HasField("step")
        assert abs(t.wall_time - j.wall_time) < 60
        for tv, jv in zip(t.summary.value, j.summary.value):
            assert tv.tag == jv.tag and tv.WhichOneof("value") == jv.WhichOneof("value")
            if tv.WhichOneof("value") == "simple_value":
                assert tv.simple_value == jv.simple_value
            else:
                for field in ("height", "width", "colorspace"):
                    assert getattr(tv.image, field) == getattr(jv.image, field)
                pixels = [np.asarray(Image.open(io.BytesIO(v.image.encoded_image_string)))
                          for v in (tv, jv)]
                assert np.array_equal(pixels[0], pixels[1])
                assert np.array_equal(pixels[0], image)
    # the port reads mtlx's file back with its own decoder
    read = tsw.read_events(jpath)
    assert read[0]["file_version"] == "brain.Event:2"
    for event, (tag, value, step) in zip(read[1:], SCALARS):
        assert event["step"] == step and event["values"] == [(tag, float(np.float32(value)))]
    tag, (h, w, png) = read[-1]["values"][0]
    assert (tag, h, w) == ("image/0", 9, 13)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))), image)
