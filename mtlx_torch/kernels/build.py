"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles, on its own,
into `mtlx_torch/_build/lib<name>-<source hash>.so` for `sm_90a`. The
build runs at first use, from the sources in the checkout; a library
whose name carries the hash of its source and flags is never stale.
`build_all` starts one nvcc per source at once, so a cold process pays
for the slowest source only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "kernels", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C interface of each source: function -> (argtypes, restype)
SIGNATURES = {
    "nms": {
        "mtlx_nms_f32": ([_P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P], _I),
    },
    "roi_crop": {
        "mtlx_roi_crop_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "mtlx_roi_crop_bwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
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

_libs: Dict[str, ctypes.CDLL] = {}
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
