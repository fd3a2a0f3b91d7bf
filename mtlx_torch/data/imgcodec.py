"""Image decoding for the port's host data pipeline, by `image/format`.

  * JPEG: the fused libjpeg decode + bilinear resize of `csrc/imgcodec.cc`
    (the port's copy of mtlx/data/_imgcodec.cc, bit-equal to it), built
    with g++ at first use against the libjpeg-turbo headers in
    `csrc/jpeg/` and the libjpeg-turbo of Pillow's wheel (one rule on
    every machine: `kernels/build.py`), and called through ctypes, which
    releases the interpreter lock; `decode_jpeg_batch` decodes on a
    thread pool.
  * PNG: a numpy + zlib decoder (8-bit gray, gray + alpha, RGB and RGBA,
    not interlaced, all five row filters), and a filter-0 encoder.

There is no fallback from one decoder to another: a JPEG that libjpeg
cannot decode, or a machine without Pillow's libjpeg-turbo, raises. An
image that needs resizing and is not a JPEG is resized as mtlx's loader
resizes it: with the TF1 convention in numpy (`tf1_resize`), else with
PIL, which raises where PIL is not installed.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

JPEG_FORMATS = (b"jpeg", b"jpg", b"JPEG", b"JPG")
PNG_FORMATS = (b"png", b"PNG")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 512


def _codec():
    from mtlx_torch.kernels import build

    try:
        return build.load_host_library("imgcodec")
    except RuntimeError as e:
        raise RuntimeError(
            "the JPEG decoder (mtlx_torch/data/csrc/imgcodec.cc) needs g++ and the "
            "libjpeg-turbo of Pillow's wheel; its build failed:\n" + str(e)
        ) from None


def _view(encoded) -> np.ndarray:
    """The encoded bytes (bytes or a memoryview) as a uint8 array over the
    same memory, whose address the codec reads; no copy."""
    return np.frombuffer(encoded, np.uint8)


def jpeg_dims(encoded: bytes) -> Tuple[int, int]:
    """(height, width) from the JPEG header."""
    data = _view(encoded)
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if _codec().mtlx_jpeg_dims(data.ctypes.data, data.size, ctypes.byref(h), ctypes.byref(w),
                               err, _ERRLEN):
        raise ValueError(f"JPEG header: {err.value.decode(errors='replace')}")
    return h.value, w.value


def decode_jpeg(encoded: bytes, th: int = 0, tw: int = 0, tf1_resize: bool = False) -> np.ndarray:
    """[th, tw, 3] uint8 RGB: the JPEG decoded (at a DCT scale where it
    shrinks) and resized bilinearly; th = tw = 0 keeps the source size."""
    if th <= 0 or tw <= 0:
        th, tw = jpeg_dims(encoded)
    data = _view(encoded)
    out = np.empty((th, tw, 3), np.uint8)
    dims = (ctypes.c_int * 4)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if _codec().mtlx_jpeg_decode(data.ctypes.data, data.size, th, tw, int(tf1_resize),
                                 out.ctypes.data, out.nbytes, dims, err, _ERRLEN):
        raise ValueError(f"JPEG decode: {err.value.decode(errors='replace')}")
    return out


def decode_jpeg_tf(encoded: bytes) -> np.ndarray:
    """[h, w, 3] uint8 RGB at the JPEG's own size, as TensorFlow's
    `decode_jpeg` (and `decode_image`) decodes it by default: the fast
    integer inverse DCT where `decode_jpeg` above takes the accurate one."""
    th, tw = jpeg_dims(encoded)
    data = _view(encoded)
    out = np.empty((th, tw, 3), np.uint8)
    dims = (ctypes.c_int * 4)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if _codec().mtlx_jpeg_decode_tf(data.ctypes.data, data.size, th, tw, out.ctypes.data,
                                    out.nbytes, dims, err, _ERRLEN):
        raise ValueError(f"JPEG decode: {err.value.decode(errors='replace')}")
    return out


def decode_jpeg_batch(blobs: Sequence[bytes], ths: Sequence[int], tws: Sequence[int],
                      threads: int = 4, tf1_resize: bool = False) -> List[np.ndarray]:
    """decode_jpeg of each blob onto its target, on `threads` threads."""
    n = len(blobs)
    views = [_view(b) for b in blobs]  # held while the threads read them
    outs = [np.empty((int(h), int(w), 3), np.uint8) for h, w in zip(ths, tws)]
    datas = (ctypes.c_void_p * n)(*[v.ctypes.data for v in views])
    lens = (ctypes.c_size_t * n)(*[v.size for v in views])
    ths_c = (ctypes.c_int * n)(*[int(h) for h in ths])
    tws_c = (ctypes.c_int * n)(*[int(w) for w in tws])
    out_ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    caps = (ctypes.c_size_t * n)(*[o.nbytes for o in outs])
    dims = (ctypes.c_int * (4 * n))()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = _codec().mtlx_jpeg_decode_batch(n, datas, lens, ths_c, tws_c, int(tf1_resize),
                                         out_ptrs, caps, dims, max(1, int(threads)),
                                         err, _ERRLEN)
    if rc:
        raise ValueError(f"JPEG decode of image {rc - 1}: {err.value.decode(errors='replace')}")
    return outs


# ---------------------------------------------------------------- PNG

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def png_dims(encoded: bytes) -> Tuple[int, int]:
    """(height, width) from the PNG header."""
    for kind, body in _png_chunks(encoded):
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            return h, w
    raise ValueError("PNG without IHDR")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of PNG scanlines."""
    rows = raw.reshape(height, stride + 1)
    if not rows[:, 0].any():  # every row unfiltered (what encode_png writes)
        return rows[:, 1:]
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: pixel by pixel
            cur = line.astype(np.int32)
            up = prior.astype(np.int32)
            for x in range(0, stride, bpp):
                s = slice(x, x + bpp)
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                if kind == 3:
                    cur[s] = (cur[s] + ((left + up[s]) >> 1)) & 0xFF
                else:
                    upleft = up[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = left + up[s] - upleft
                    pa, pb, pc = np.abs(p - left), np.abs(p - up[s]), np.abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up[s], upleft))
                    cur[s] = (cur[s] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def _png_samples(encoded: bytes) -> np.ndarray:
    """[H, W, samples] uint8 of an 8-bit PNG as stored (gray, gray + alpha,
    RGB or RGBA)."""
    header, idat = None, []
    for kind, body in _png_chunks(encoded):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"PNG bit depth {depth} / color type {color} is not supported "
                         "(8-bit gray, gray + alpha, RGB or RGBA only)")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    ch = _CHANNELS[color]
    size = height * (width * ch + 1)
    # one output buffer of the known size: no copy joining the pieces
    raw = np.frombuffer(zlib.decompress(idat[0] if len(idat) == 1 else b"".join(idat),
                                        bufsize=size), np.uint8)
    if raw.size != size:
        raise ValueError("PNG image data has the wrong size")
    return _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)


def decode_png(encoded: bytes) -> np.ndarray:
    """[H, W, 3] uint8 RGB of an 8-bit PNG (gray is replicated, alpha
    dropped, as PIL's convert('RGB') does)."""
    pixels = _png_samples(encoded)
    if pixels.shape[2] in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def decode_png_luma(encoded: bytes) -> np.ndarray:
    """[H, W] uint8 of a PNG as PIL's convert('L') gives it: gray as
    stored (alpha dropped), color as its ITU-R 601 luma in PIL's integer
    rounding."""
    pixels = _png_samples(encoded)
    if pixels.shape[2] in (1, 2):
        return np.ascontiguousarray(pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def encode_png(image: np.ndarray) -> bytes:
    """An 8-bit PNG of [H, W, 3] RGB or [H, W] gray uint8 pixels, every row
    filter 0."""
    image = np.ascontiguousarray(image, np.uint8)
    gray = image.ndim == 2
    if gray:
        image = image[..., None]
    h, w, ch = image.shape
    if ch != 3 and not gray:
        raise ValueError(f"encode_png takes RGB or gray images, got {ch} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * ch)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))  # fast; noise does not shrink
            + chunk(b"IEND", b""))


# ---------------------------------------------------------------- by format


def image_dims(encoded: bytes, fmt: bytes) -> Tuple[int, int]:
    """(height, width) from the image's header only."""
    if fmt in JPEG_FORMATS:
        return jpeg_dims(encoded)
    if fmt in PNG_FORMATS:
        return png_dims(encoded)
    raise ValueError(f"image/format {fmt!r} is not decoded by the port (JPEG and PNG are)")


def legacy_resize_bilinear(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Numpy TF1 resize_images (align_corners=False) bilinear, bit-equal to
    the JPEG codec's legacy mode (mtlx's loader does the same)."""
    h, w = image.shape[:2]
    fy = np.minimum(np.arange(th, dtype=np.float64) * (h / th), h - 1)
    fx = np.minimum(np.arange(tw, dtype=np.float64) * (w / tw), w - 1)
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    img = image.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(image.dtype, np.integer):
        out = np.floor(out + 0.5)
    return out.astype(image.dtype)


def pil_resize(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    """PIL bilinear resize to (th, tw); an image already at that size is
    returned as it is (PIL's own resize copies it unchanged). Raises
    where PIL is not installed."""
    if image.shape[:2] == (th, tw):
        return image
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"resizing a {image.shape[0]}x{image.shape[1]} decoded image to {th}x{tw} needs "
            "PIL, which is not installed; give images at their resizer target size (or "
            "JPEG records)"
        ) from None
    return np.asarray(Image.fromarray(image).resize((tw, th), Image.BILINEAR), dtype=image.dtype)


def decode_resized(encoded: bytes, fmt: bytes, th: int, tw: int,
                   tf1_resize: bool = False) -> np.ndarray:
    """[th, tw, 3] uint8: the image decoded by its format and resized onto
    the resizer target as mtlx's loader resizes it."""
    if fmt in JPEG_FORMATS:
        return decode_jpeg(encoded, th, tw, tf1_resize)
    if fmt not in PNG_FORMATS:
        raise ValueError(f"image/format {fmt!r} is not decoded by the port (JPEG and PNG are)")
    full = decode_png(encoded)
    if tf1_resize and full.shape[:2] != (th, tw):
        return legacy_resize_bilinear(full, th, tw)
    return pil_resize(full, th, tw)
