"""The port's JPEG codec as its one build rule makes it: `csrc/imgcodec.cc`
compiled against the libjpeg-turbo headers kept in `data/csrc/jpeg/` and
linked by path to the libjpeg-turbo of Pillow's wheel, the same rule as on
the card's machine. Held to mtlx's native codec (`mtlx/data/_imgcodec.cc`,
built against the system libjpeg) bit for bit: at the targets whose
sha256 `chip_smoke.py` checks on the card, and at every DCT scale from
1/8 to 8/8 in both resize conventions. Tolerance: none (equal bytes).
"""

import io
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from mtlx.data.native_build import ensure_native
from mtlx_torch.data import imgcodec
from mtlx_torch.kernels import build


def _jpeg(image: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _native_decode(native, blob, th, tw, tf1):
    pixels, _, _, oh, ow = native.decode(blob, th, tw, int(tf1))
    return np.frombuffer(pixels, np.uint8).reshape(oh, ow, 3)


def test_codec_links_pillows_libjpeg_only():
    build.load_host_library("imgcodec")
    _, lib = build._host_library_path("imgcodec")
    ldd = subprocess.run(["ldd", lib], capture_output=True, text=True, check=True).stdout
    jpeg = [ln.split() for ln in ldd.splitlines() if "libjpeg" in ln]
    assert len(jpeg) == 1, ldd
    assert os.path.realpath(jpeg[0][2]) == os.path.realpath(build.pillow_libjpeg()), ldd


def test_build_digest_covers_headers_and_library(tmp_path, monkeypatch):
    _, lib = build._host_library_path("imgcodec")
    headers = tmp_path / "jpeg"
    shutil.copytree(build.JPEG_INCLUDE_DIR, headers)
    monkeypatch.setattr(build, "JPEG_INCLUDE_DIR", str(headers))
    assert build._host_library_path("imgcodec")[1] == lib  # same bytes, same library
    with open(headers / "jconfig.h", "a") as f:
        f.write("\n")
    assert build._host_library_path("imgcodec")[1] != lib
    monkeypatch.undo()
    assert build._host_library_path("imgcodec")[1] == lib
    copy = tmp_path / os.path.basename(build.pillow_libjpeg())
    shutil.copy(build.pillow_libjpeg(), copy)
    monkeypatch.setattr(build, "pillow_libjpeg", lambda: str(copy))
    assert build._host_library_path("imgcodec")[1] != lib  # another library path


def test_embedded_jpeg_matches_the_card_check():
    import base64
    import hashlib

    native = ensure_native("_imgcodec_ext")
    assert native is not None, "mtlx's native codec must build here"
    blob = base64.b64decode("".join(chip_smoke.JPEG_B64))
    for (th, tw, tf1), want in chip_smoke.JPEG_SHA256.items():
        got = imgcodec.decode_jpeg(blob, th, tw, tf1)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want, (th, tw, tf1)
        assert np.array_equal(got, _native_decode(native, blob, th, tw, tf1))


@pytest.mark.parametrize("tf1", [False, True])
@pytest.mark.parametrize("h,w,quality", [(97, 131, 95), (480, 640, 90), (375, 500, 75)])
def test_every_dct_scale_bit_equal_to_mtlx(h, w, quality, tf1):
    native = ensure_native("_imgcodec_ext")
    assert native is not None, "mtlx's native codec must build here"
    rs = np.random.RandomState(h)
    image = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    image[h // 4: h // 2, w // 3: w // 2] = [220, 40, 60]
    blob = _jpeg(image, quality)
    # a target of k/8 of each side makes the codec decode at scale k/8
    # (the smallest M/8 not below the target); 8/8 also one pixel short
    targets = [((h * k) // 8, (w * k) // 8) for k in range(1, 8)]
    targets += [(h - 1, w - 1), (h, w), (h + 50, w * 2)]
    for th, tw in targets:
        got = imgcodec.decode_jpeg(blob, th, tw, tf1)
        assert np.array_equal(got, _native_decode(native, blob, th, tw, tf1)), (th, tw)
    got = imgcodec.decode_jpeg_batch([blob] * len(targets), [t[0] for t in targets],
                                     [t[1] for t in targets], threads=3, tf1_resize=tf1)
    for (th, tw), g in zip(targets, got):
        assert np.array_equal(g, _native_decode(native, blob, th, tw, tf1)), (th, tw)
