"""TensorBoard event files (port of mtlx/utils/summary_writer.py).

An event file is a TFRecord file (`data/tfrecord.py`) named
`events.out.tfevents.<seconds>.<host>` whose records are serialized
`Event` messages: the first holds `file_version` "brain.Event:2", each
later one a `Summary` with one scalar or one PNG image. The messages are
written by hand on the wire format, with the field numbers of mtlx's
`event.proto` (TensorBoard's) and in the order protobuf's serializer
emits them:
  Event: wall_time 1 (double), step 2 (int64), file_version 3, summary 5
  Summary: value 1; Summary.Value: tag 1, simple_value 2 (float), image 4
  Summary.Image: height 1, width 2, colorspace 3, encoded_image_string 4
No protobuf and no PIL: images go through the port's PNG encoder.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import List, Tuple

import numpy as np

from mtlx_torch.config.text_format import iter_fields, write_bytes_field, write_varint
from mtlx_torch.data.tfrecord import TFRecordWriter, read_records

_FILE_VERSION = b"brain.Event:2"


def _tag(out: bytearray, number: int, wire: int) -> None:
    write_varint(out, (number << 3) | wire)


def encode_event(wall_time: float, step=None, file_version: bytes = None,
                 summary: bytes = None) -> bytes:
    """A serialized Event; fields left None are absent, as unset proto2
    fields are."""
    out = bytearray()
    _tag(out, 1, 1)
    out += struct.pack("<d", wall_time)
    if step is not None:
        _tag(out, 2, 0)
        write_varint(out, int(step))
    if file_version is not None:
        write_bytes_field(out, 3, file_version)
    if summary is not None:
        write_bytes_field(out, 5, summary)
    return bytes(out)


def encode_scalar_summary(tag: str, value: float) -> bytes:
    """A serialized Summary of one Value {tag, simple_value}."""
    v = bytearray()
    write_bytes_field(v, 1, tag.encode())
    _tag(v, 2, 5)
    v += struct.pack("<f", value)
    out = bytearray()
    write_bytes_field(out, 1, v)
    return bytes(out)


def encode_image_summary(tag: str, height: int, width: int, png: bytes) -> bytes:
    """A serialized Summary of one Value {tag, image}: an RGB PNG."""
    image = bytearray()
    for number, value in ((1, height), (2, width), (3, 3)):  # colorspace 3: RGB
        _tag(image, number, 0)
        write_varint(image, int(value))
    write_bytes_field(image, 4, png)
    v = bytearray()
    write_bytes_field(v, 1, tag.encode())
    write_bytes_field(v, 4, image)
    out = bytearray()
    write_bytes_field(out, 1, v)
    return bytes(out)


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._writer = TFRecordWriter(self.path)
        self._writer.write(encode_event(time.time(), file_version=_FILE_VERSION))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._writer.write(encode_event(time.time(), step=int(step),
                                        summary=encode_scalar_summary(tag, float(value))))

    def image(self, tag: str, image_uint8: np.ndarray, step: int) -> None:
        """image_uint8: [H, W, 3] uint8, PNG-encoded into the event."""
        from mtlx_torch.data.imgcodec import encode_png

        h, w = image_uint8.shape[:2]
        summary = encode_image_summary(tag, h, w, encode_png(image_uint8))
        self._writer.write(encode_event(time.time(), step=int(step), summary=summary))

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def read_events(path: str) -> List[dict]:
    """The events of a file, read back with the port's wire decoder: a
    dict each of wall_time, step, file_version and, for a summary,
    `values`: [(tag, a float or (height, width, png bytes))]."""
    events = []
    for record in read_records(path, verify_crc=True):
        event = {}
        for number, _, value in iter_fields(record):
            if number == 1:
                event["wall_time"] = struct.unpack("<d", value.to_bytes(8, "little"))[0]
            elif number == 2:
                event["step"] = value
            elif number == 3:
                event["file_version"] = bytes(value).decode()
            elif number == 5:
                event["values"] = [_read_value(v) for n, _, v in iter_fields(value) if n == 1]
        events.append(event)
    return events


def _read_value(buf) -> Tuple[str, object]:
    tag, val = None, None
    for number, _, value in iter_fields(buf):
        if number == 1:
            tag = bytes(value).decode()
        elif number == 2:
            val = struct.unpack("<f", value.to_bytes(4, "little"))[0]
        elif number == 4:
            image = {n: v for n, _, v in iter_fields(value)}
            val = (image.get(1, 0), image.get(2, 0), bytes(image.get(4, b"")))
    return tag, val
