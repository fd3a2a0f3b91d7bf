"""TFRecord container I/O (port of mtlx/data/tfrecord.py).

    each record = | uint64 length | uint32 masked_crc32c(length_bytes) |
                  | data bytes    | uint32 masked_crc32c(data)         |

The crc32c is the port's copy of mtlx's C source (`csrc/crc32c.c`),
built with gcc at first use and bound through ctypes: a pure-Python crc
would take about a second for a 2 MB record.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List


def crc32c(data: bytes, value: int = 0) -> int:
    from mtlx_torch.kernels import build

    data = bytes(data)
    return build.load_host_library("crc32c").mtlx_crc32c(data, len(data), value)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if _masked_crc(header[:8]) != crc:
                    raise IOError(f"corrupt length crc in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"truncated record in {path}")
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if _masked_crc(data) != crc:
                    raise IOError(f"corrupt data crc in {path}")
            yield data


def record_index(path: str) -> List[int]:
    """Byte offsets of every record (random access without loading the
    file)."""
    offsets = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            offsets.append(pos)
            f.seek(pos)
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            pos += 12 + length + 4
    return offsets


def read_record_at(f, offset: int) -> bytes:
    f.seek(offset)
    (length,) = struct.unpack("<Q", f.read(8))
    f.seek(offset + 12)
    return f.read(length)

