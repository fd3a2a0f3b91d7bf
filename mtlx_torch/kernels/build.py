"""Build the port's native libraries and load them with ctypes.

Each CUDA source `kernels/csrc/<name>.cu` has a plain C interface and
compiles, on its own, into `mtlx_torch/_build/lib<name>-<source hash>.so`
for `sm_90a`. The host sources of the data pipeline (`data/csrc/`: the
TFRecord crc32c and the JPEG codec) compile the same way with gcc / g++
(`load_host_library`). The JPEG codec has one rule on every machine: the
libjpeg-turbo headers kept in `data/csrc/jpeg/` and the libjpeg-turbo
that Pillow's wheel bundles, linked by path with an rpath
(`pillow_libjpeg`). Every build runs at first use, from the sources in
the checkout; a library whose name carries the hash of its source,
flags, headers and linked library is never stale. `build_all` starts
one nvcc per CUDA source at once, so a cold process pays for the
slowest source only.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "kernels", "csrc")
HOST_CSRC_DIR = os.path.join(_PKG_DIR, "data", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C interface of each source: function -> (argtypes, restype)
SIGNATURES = {
    "nms": {
        "mtlx_nms_scratch_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "mtlx_nms_f32": ([_P, _P, _P, _I, _I, _I, _F, _F, _P, _I, _P, _P, _P], _I),
    },
    "roi_crop": {
        "mtlx_roi_crop_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "mtlx_roi_crop_bwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "iou": {
        "mtlx_iou_f32": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    },
}
SOURCES = tuple(SIGNATURES)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-add: the kernels repeat the plain versions'
    # arithmetic bit for bit (NMS selections must be identical)
    "--fmad=false",
    "-Xptxas", "-v",
)

_S = ctypes.c_size_t
_U32 = ctypes.c_uint32
JPEG_INCLUDE_DIR = os.path.join(HOST_CSRC_DIR, "jpeg")
JPEG_HEADERS = ("jpeglib.h", "jmorecfg.h", "jerror.h", "jconfig.h")
# the host sources: name -> (file, compiler, flags, C interface)
HOST_SOURCES = {
    "crc32c": ("crc32c.c", "gcc", ("-O3", "-shared", "-fPIC"), {
        "mtlx_crc32c": ([_P, _S, _U32], _U32),
    }),
    "imgcodec": ("imgcodec.cc", "g++",
                 ("-O3", "-shared", "-fPIC", "-std=c++17", "-I" + JPEG_INCLUDE_DIR,
                  "-lpthread"), {
        "mtlx_jpeg_dims": ([_P, _S, _P, _P, ctypes.c_char_p, _I], _I),
        "mtlx_jpeg_decode": ([_P, _S, _I, _I, _I, _P, _S, _P, ctypes.c_char_p, _I], _I),
        "mtlx_jpeg_decode_tf": ([_P, _S, _I, _I, _P, _S, _P, ctypes.c_char_p, _I], _I),
        "mtlx_jpeg_decode_batch": ([_I, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                                    ctypes.c_char_p, _I], _I),
    }),
}

_libs: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()
# the compiler's output (ptxas register / shared-memory report) per source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (neither on PATH, under CUDA_HOME nor under "
        "/usr/local/cuda); the port's CUDA kernels are built from "
        "mtlx_torch/kernels/csrc at first use"
    )


def _library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.mtlx_tmp = tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(proc.mtlx_tmp, out)  # type: ignore[attr-defined]


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Build every missing library, one nvcc per source in parallel, and
    load them all. Returns the wall seconds each build took (0.0 for a
    library that was already built)."""
    _require_cuda()
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if name in _libs or os.path.exists(out):
            seconds[name] = 0.0
        else:
            procs[name] = (out, _start(name, out))
    try:
        for name, (out, proc) in procs.items():
            _finish(name, out, proc)
            seconds[name] = time.perf_counter() - t0
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in names:
        load_library(name)
    return seconds


def _require_cuda() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's kernels run only on a CUDA "
            "device (CPU tensors take the plain PyTorch versions)"
        )


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building it first if needed,
    with argtypes and restype set for every function of its C interface."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _require_cuda()
    out = _library_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        _finish(name, out, _start(name, out))
    lib = ctypes.CDLL(out)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.mtlx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mtlx_cuda_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.mtlx_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def pillow_libjpeg() -> str:
    """The path of the libjpeg-turbo (ABI 62) that Pillow's wheel bundles
    in `<site-packages>/pillow.libs/`, which the JPEG codec links against.
    Only Pillow's installed location is looked up: Pillow is not imported."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        raise RuntimeError("the JPEG codec links the libjpeg-turbo of Pillow's wheel, and "
                           "Pillow is not installed")
    site = os.path.dirname(os.path.abspath(list(spec.submodule_search_locations)[0]))
    found = sorted(glob.glob(os.path.join(site, "pillow.libs", "libjpeg-*.so.62*")))
    if len(found) != 1:
        raise RuntimeError(f"the JPEG codec links the libjpeg-turbo of Pillow's wheel: want one "
                           f"{site}/pillow.libs/libjpeg-*.so.62*, found {found}")
    return found[0]


def _host_link(name: str) -> Tuple[Tuple[str, ...], List[str]]:
    """(what the host library `name` links against after its source, the
    files besides the source that its build reads)."""
    if name != "imgcodec":
        return (), []
    lib = pillow_libjpeg()
    headers = [os.path.join(JPEG_INCLUDE_DIR, f) for f in JPEG_HEADERS]
    return (lib, "-Wl,-rpath," + os.path.dirname(lib)), [lib, *headers]


def _host_library_path(name: str) -> Tuple[str, str]:
    file, compiler, flags, _ = HOST_SOURCES[name]
    src = os.path.join(HOST_CSRC_DIR, file)
    link, inputs = _host_link(name)
    h = hashlib.sha256(" ".join((compiler,) + flags + link).encode())
    for path in [src, *inputs]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (a source of `data/csrc`), built
    with gcc / g++ first if needed. A failed build raises with the
    compiler's log; nothing falls back to another implementation."""
    with _host_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        file, compiler, flags, signatures = HOST_SOURCES[name]
        src, out = _host_library_path(name)
        if not os.path.exists(out):
            exe = shutil.which(compiler)
            if exe is None:
                raise RuntimeError(f"{compiler} not found on PATH; it builds "
                                   f"mtlx_torch/data/csrc/{file} at first use")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.tmp{os.getpid()}"
            # the libraries follow the source
            compile_flags = [f for f in flags if not f.startswith("-l")]
            libs = [*_host_link(name)[0], *(f for f in flags if f.startswith("-l"))]
            proc = subprocess.run([exe, *compile_flags, src, "-o", tmp, *libs],
                                  capture_output=True, text=True)
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"{compiler} failed for mtlx_torch/data/csrc/{file} "
                                   f"(rc {proc.returncode}):\n{build_logs[name]}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:  # a library it links against is missing here
            raise RuntimeError(f"loading {out} (built from mtlx_torch/data/csrc/{file}) "
                               f"failed: {e}") from None
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib
