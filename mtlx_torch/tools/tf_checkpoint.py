"""TensorFlow checkpoints read with numpy: no TensorFlow, no protobuf.

What `tools/convert_checkpoint.py` of mtlx takes from
`tf.train.load_checkpoint`: `get_variable_to_shape_map()` and
`get_tensor(name)`, on the two formats TF writes.

  * V2, a tensor bundle: `<prefix>.index`, a table whose "" key holds the
    BundleHeaderProto (shard count, endianness) and whose other keys are
    the tensors' names, each holding a BundleEntryProto (dtype, shape,
    shard, offset, size, masked crc32c); the bytes themselves lie in
    `<prefix>.data-NNNNN-of-MMMMM`. Every read checks the crc.
  * V1, one table per file (`Saver(write_version=V1)`, the slim
    checkpoints of 2016): the "" key holds SavedTensorSlices.meta (name,
    shape, dtype and slices of each tensor) and every other key one
    slice's SavedTensorSlices.data, its values in the TensorProto's
    repeated `*_val` fields (packed or not) or in `tensor_content`. A
    tensor saved whole (an unpartitioned variable) is read; a partial
    slice raises, naming the tensor.

A table is LevelDB's format: a 48-byte footer (the metaindex and index
block handles, then the magic number), blocks of prefix-compressed keys
with restart points, each followed by its type byte and masked crc32c.
Only uncompressed blocks (type 0) are read: another type raises, naming
it. The protos are read with the port's wire decoder, the crc with its
crc32c (data/tfrecord.py).

`load_checkpoint(path)` resolves `path` as TF does: a directory means the
checkpoint its `checkpoint` file names last; `model.ckpt` is a V2 bundle
when `model.ckpt.index` exists, else a V1 file (or a glob of V1 shards).
"""

from __future__ import annotations

import glob
import os
import re
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from mtlx_torch.config.text_format import (
    WIRE_BYTES,
    WIRE_FIXED32,
    WIRE_FIXED64,
    iter_fields,
    read_varint,
    signed64,
)
from mtlx_torch.data.tfrecord import crc32c

TABLE_MAGIC = bytes.fromhex("57fb808b247547db")  # 0xdb4775248b80fb57, little-endian
FOOTER_SIZE = 48
BLOCK_TRAILER_SIZE = 5  # type byte + masked crc32c
BLOCK_TYPES = {0: "uncompressed", 1: "snappy", 2: "zlib"}

# TF DataType -> numpy dtype (the types a weight or a counter takes)
DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16, 6: np.int8,
    9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
}
DTYPE_NAMES = {7: "string", 8: "complex64", 14: "bfloat16", 18: "complex128", 20: "resource",
               21: "variant"}


def masked_crc32c(data) -> int:
    """TF's masked crc32c (a rotation plus a constant)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _dtype(code: int, what: str) -> np.dtype:
    if code not in DTYPES:
        raise ValueError(f"{what}: dtype {DTYPE_NAMES.get(code, code)} is not read")
    return np.dtype(DTYPES[code])


# ---------------------------------------------------------------- tables


def _block_entries(data, offset: int, size: int, where: str) -> Iterator[Tuple[bytes, memoryview]]:
    """(key, value) of each entry of the block at `offset`: its type byte
    and crc checked first."""
    end = offset + size
    if end + BLOCK_TRAILER_SIZE > len(data):
        raise ValueError(f"{where}: block at {offset} runs past the end of the file")
    kind = data[end]
    if kind != 0:
        name = BLOCK_TYPES.get(kind, "of unknown type")
        raise ValueError(f"{where}: block at {offset} is {name} (block type {kind}); only "
                         "uncompressed tables are read")
    (stored,) = struct.unpack_from("<I", data, end + 1)
    if masked_crc32c(data[offset:end + 1]) != stored:
        raise ValueError(f"{where}: block at {offset} fails its crc32c")
    block = memoryview(data)[offset:end]
    (num_restarts,) = struct.unpack_from("<I", block, size - 4)
    limit = size - 4 - 4 * num_restarts
    pos, key = 0, b""
    while pos < limit:
        shared, pos = read_varint(block, pos)
        unshared, pos = read_varint(block, pos)
        value_len, pos = read_varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + unshared])
        pos += unshared
        yield key, block[pos:pos + value_len]
        pos += value_len


def read_table(path: str) -> Dict[bytes, memoryview]:
    """Every (key, value) of a LevelDB table file, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_SIZE or data[-8:] != TABLE_MAGIC:
        raise ValueError(f"{path}: not a TF checkpoint table (bad footer magic)")
    footer = memoryview(data)[-FOOTER_SIZE:]
    pos = 0
    _, pos = read_varint(footer, pos)  # metaindex handle: no filters are read
    _, pos = read_varint(footer, pos)
    index_off, pos = read_varint(footer, pos)
    index_size, pos = read_varint(footer, pos)
    out: Dict[bytes, memoryview] = {}
    for _, handle in _block_entries(data, index_off, index_size, path):
        off, p = read_varint(handle, 0)
        size, _ = read_varint(handle, p)
        for key, value in _block_entries(data, off, size, path):
            out[key] = value
    return out


# ---------------------------------------------------------------- protos


def _message(buf) -> Dict[int, list]:
    """field number -> its values, in order."""
    out: Dict[int, list] = {}
    for number, wire, value in iter_fields(buf):
        out.setdefault(number, []).append((wire, value))
    return out


def _int(fields, number: int, default: int = 0) -> int:
    vals = fields.get(number)
    return signed64(vals[-1][1]) if vals else default


def _shape(buf) -> List[int]:
    """TensorShapeProto -> its dims."""
    dims = []
    for number, _, dim in iter_fields(buf):
        if number == 2:
            dims.append(_int(_message(dim), 1))
    return dims


def _extents(buf) -> List[Tuple[int, int]]:
    """TensorSliceProto -> (start, length) each dim, length -1 where the
    slice takes the whole dim."""
    out = []
    for number, _, ext in iter_fields(buf):
        if number == 1:
            f = _message(ext)
            out.append((_int(f, 1), _int(f, 2, -1)))
    return out


def _is_full(extents: List[Tuple[int, int]], shape: List[int]) -> bool:
    return all(length == -1 or (start == 0 and length == dim)
               for (start, length), dim in zip(extents, shape))


def _repeated(fields, number: int, kind: str) -> np.ndarray:
    """The values of a repeated numeric field, packed or not; kind is
    '<f4', '<f8' or 'varint'."""
    parts = []
    for wire, v in fields.get(number, ()):
        if wire == WIRE_BYTES:
            if kind == "varint":
                vals, pos = [], 0
                while pos < len(v):
                    x, pos = read_varint(v, pos)
                    vals.append(signed64(x))
                parts.append(np.asarray(vals, np.int64))
            else:
                parts.append(np.frombuffer(v, kind))
        elif wire == WIRE_FIXED32:
            parts.append(np.frombuffer(struct.pack("<I", v), "<f4"))
        elif wire == WIRE_FIXED64:
            parts.append(np.frombuffer(struct.pack("<Q", v), "<f8"))
        else:
            parts.append(np.asarray([signed64(v)], np.int64))
    return np.concatenate(parts) if parts else np.zeros((0,), np.float64)


# TensorProto value field of each dtype: (field, wire kind)
_VALUE_FIELDS = {
    np.dtype(np.float32): (5, "<f4"), np.dtype(np.float64): (6, "<f8"),
    np.dtype(np.int32): (7, "varint"), np.dtype(np.int16): (7, "varint"),
    np.dtype(np.int8): (7, "varint"), np.dtype(np.uint8): (7, "varint"),
    np.dtype(np.uint16): (7, "varint"), np.dtype(np.int64): (10, "varint"),
    np.dtype(np.bool_): (11, "varint"), np.dtype(np.float16): (13, "varint"),
    np.dtype(np.uint32): (16, "varint"), np.dtype(np.uint64): (17, "varint"),
}


def _tensor_proto(buf, dtype: np.dtype, shape: List[int], name: str) -> np.ndarray:
    """The values of a TensorProto as `dtype` of `shape`."""
    fields = _message(buf)
    count = int(np.prod(shape, dtype=np.int64))
    if 4 in fields:  # tensor_content: the raw little-endian bytes
        raw = np.frombuffer(fields[4][-1][1], dtype.newbyteorder("<"))
        values = raw.astype(dtype)
    else:
        number, kind = _VALUE_FIELDS[dtype]
        vals = _repeated(fields, number, kind)
        if dtype == np.float16:  # half_val holds the bits in an int32
            values = vals.astype(np.uint16).view(np.float16)
        else:
            values = vals.astype(dtype)
    if values.size != count:
        raise ValueError(f"{name}: the slice holds {values.size} values for shape {shape}")
    return values.reshape(shape)


# ---------------------------------------------------------------- readers


class CheckpointReader:
    """The tensors of one checkpoint, V1 or V2 (module docstring)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._shapes: Dict[str, List[int]] = {}
        self._dtypes: Dict[str, np.dtype] = {}
        if os.path.exists(prefix + ".index"):
            self.version = 2
            self._open_v2(prefix)
        else:
            files = [prefix] if os.path.isfile(prefix) else sorted(glob.glob(prefix))
            if not files:
                raise FileNotFoundError(f"no checkpoint at {prefix!r} (neither "
                                        f"{prefix}.index nor a V1 file)")
            self.version = 1
            self._open_v1(files)

    # -- V2
    def _open_v2(self, prefix: str) -> None:
        index = read_table(prefix + ".index")
        header = _message(index.get(b"", b""))
        self._num_shards = _int(header, 1, 1)
        self._big_endian = _int(header, 2) == 1
        self._entries = {}
        for key, value in index.items():
            if key == b"":
                continue
            name = key.decode()
            entry = _message(value)
            self._entries[name] = entry
            self._shapes[name] = _shape(entry[2][-1][1]) if 2 in entry else []
            self._dtypes[name] = _int(entry, 1)

    def _get_v2(self, name: str) -> np.ndarray:
        entry = self._entries[name]
        dtype = _dtype(self._dtypes[name], name)
        if 7 in entry:
            raise ValueError(f"{name}: saved as partitioned slices, which are not read")
        shard, offset, size = _int(entry, 3), _int(entry, 4), _int(entry, 5)
        path = f"{self.prefix}.data-{shard:05d}-of-{self._num_shards:05d}"
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(size)
        if len(raw) != size:
            raise ValueError(f"{name}: {path} ends before its {size} bytes at {offset}")
        stored = _int(entry, 6) & 0xFFFFFFFF
        if masked_crc32c(raw) != stored:
            raise ValueError(f"{name}: its bytes in {path} fail their crc32c")
        order = ">" if self._big_endian else "<"
        return np.frombuffer(raw, dtype.newbyteorder(order)).astype(dtype).reshape(
            self._shapes[name])

    # -- V1
    def _open_v1(self, files: List[str]) -> None:
        self._slices: Dict[str, Tuple[memoryview, List[Tuple[int, int]]]] = {}
        self._partial: Dict[str, bool] = {}
        for path in files:
            table = read_table(path)
            sts = _message(table.get(b"", b""))
            if 1 not in sts:
                raise ValueError(f"{path}: no SavedTensorSlices meta at the \"\" key")
            for number, _, meta in iter_fields(sts[1][-1][1]):
                if number != 1:
                    continue
                f = _message(meta)
                name = bytes(f[1][-1][1]).decode()
                shape = _shape(f[2][-1][1]) if 2 in f else []
                self._shapes[name] = shape
                self._dtypes[name] = _int(f, 3)
                slices = [_extents(s) for _, s in f.get(4, ())]
                self._partial[name] = not (len(slices) == 1 and _is_full(slices[0], shape))
            for key, value in table.items():
                if key == b"":
                    continue
                data = _message(_message(value)[2][-1][1])  # SavedTensorSlices.data
                name = bytes(data[1][-1][1]).decode()
                self._slices[name] = (data[3][-1][1], _extents(data[2][-1][1]) if 2 in data
                                      else [])

    def _get_v1(self, name: str) -> np.ndarray:
        shape = self._shapes[name]
        if self._partial[name]:
            raise ValueError(f"{name}: saved as partial slices (a partitioned variable), "
                             "which are not read")
        dtype = _dtype(self._dtypes[name], name)
        return _tensor_proto(self._slices[name][0], dtype, shape, name)

    # -- the tf.train.CheckpointReader surface
    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: list(v) for k, v in self._shapes.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self._shapes:
            raise KeyError(f"{name} is not in the checkpoint {self.prefix}")
        return self._get_v2(name) if self.version == 2 else self._get_v1(name)


def latest_checkpoint(directory: str) -> str:
    """The prefix the `checkpoint` file of `directory` names last
    (model_checkpoint_path), relative to the directory unless absolute."""
    path = os.path.join(directory, "checkpoint")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{directory} holds no `checkpoint` file")
    with open(path) as f:
        m = re.search(r'^model_checkpoint_path:\s*"(.*)"\s*$', f.read(), re.M)
    if m is None:
        raise ValueError(f"{path} names no model_checkpoint_path")
    return os.path.join(directory, m.group(1))


def load_checkpoint(path: str) -> CheckpointReader:
    """tf.train.load_checkpoint without TensorFlow: a directory, a V2
    prefix or a V1 file (or glob)."""
    if os.path.isdir(path):
        path = latest_checkpoint(path)
    return CheckpointReader(path)
