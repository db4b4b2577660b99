"""ctypes bindings for the port's native preprocessing library
(counterpart of `tokenpacker_tpu/image/native.py`): bilinear resize, CLIP
normalization, HD slicing and libjpeg decoding on host threads.

The library is the port's copy of the JAX package's C++
(`tokenpacker_tpu_torch/native/preprocess.cpp`), built with g++ at the
first call of one of its functions (`load`) into `_kernels_build/` beside
the package, named by a hash of the source and flags. Where libjpeg's
header is missing it is built without `tpp_jpeg_decode`, as the JAX
bindings allow (`jpeg_available()` then says False).

`available()` tells whether the library is built, as the JAX package's
tells whether `native/libtpp.so` exists; `hd_tiler.slice_image` and
`io.load_image` take the native path when it is, as the JAX package's
do. `resize_bilinear` and `normalize_u8` fall back to numpy without g++.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "native" / "preprocess.cpp"
BUILD_DIR = PACKAGE / "_kernels_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
JPEG_FLAGS = ("-DTPP_JPEG", "-ljpeg")

_LIB = None
_LOCK = threading.Lock()


def _name(jpeg: bool) -> str:
    flags = FLAGS + (JPEG_FLAGS if jpeg else ())
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return f"libtpp-{digest}{'-jpeg' if jpeg else ''}.so"


def _built(build_dir: Path) -> Path | None:
    for jpeg in (True, False):
        path = build_dir / _name(jpeg)
        if path.exists():
            return path
    return None


def build(build_dir: Path | str = BUILD_DIR) -> Path:
    """Compile the library (with libjpeg where its header is found) unless
    it is built; returns its path. Raises without g++."""
    build_dir = Path(build_dir)
    have = _built(build_dir)
    if have is not None:
        return have
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the native library needs g++ to build")
    build_dir.mkdir(parents=True, exist_ok=True)
    errors = []
    for jpeg in (True, False):
        out = build_dir / _name(jpeg)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = [cxx, *FLAGS, *(("-DTPP_JPEG",) if jpeg else ()), str(SOURCE), "-o", tmp,
               *(("-ljpeg",) if jpeg else ())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a process building it at once loads either copy
            return out
        os.unlink(tmp)
        errors.append(proc.stderr[-2000:])
    raise RuntimeError("building the native library failed:\n" + "\n".join(errors))


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tpp_resize_bilinear.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpp_normalize_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p,
                                     ctypes.c_int]
    lib.tpp_hd_slice.argtypes = [f32p] + [ctypes.c_int] * 9 + [f32p, ctypes.c_int]
    lib.tpp_hd_slice.restype = ctypes.c_int
    if hasattr(lib, "tpp_jpeg_decode"):
        lib.tpp_jpeg_decode.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.tpp_jpeg_decode.restype = ctypes.c_int
    return lib


def load(build_dir: Path | str = BUILD_DIR):
    """The library, built first where it is not (thread-safe)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(build(build_dir))
        return _LIB


def _lib_or_none():
    """The library if it can be had (built now if g++ is there), else None."""
    try:
        return load()
    except RuntimeError:
        return None


def available() -> bool:
    """Whether the library is built (and so the native paths are taken)."""
    return _LIB is not None or _built(BUILD_DIR) is not None


def jpeg_available() -> bool:
    return available() and hasattr(load(), "tpp_jpeg_decode")


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3] through libjpeg (raises ValueError
    on data that is not a JPEG or is corrupt)."""
    lib = load()
    if not hasattr(lib, "tpp_jpeg_decode"):
        raise RuntimeError("native jpeg decode unavailable (built without libjpeg)")
    buf = np.frombuffer(data, dtype=np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.tpp_jpeg_decode(src, len(data), None, 0, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError("jpeg header decode failed")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.tpp_jpeg_decode(src, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             out.size, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return out


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bilinear(img: np.ndarray, dst_h: int, dst_w: int, n_threads: int = 4) -> np.ndarray:
    """img [C, H, W] float32 -> [C, dst_h, dst_w] (torch interpolate
    semantics); numpy (`hd_tiler._resize_bilinear`) without g++."""
    img = np.ascontiguousarray(img, np.float32)
    lib = _lib_or_none()
    if lib is None:
        from tokenpacker_tpu_torch.image.hd_tiler import _resize_bilinear

        return _resize_bilinear(img, dst_h, dst_w)
    c, h, w = img.shape
    out = np.empty((c, dst_h, dst_w), np.float32)
    lib.tpp_resize_bilinear(_fp(img), c, h, w, _fp(out), dst_h, dst_w, n_threads)
    return out


def normalize_u8(img_hwc: np.ndarray, mean, std, n_threads: int = 4) -> np.ndarray:
    """uint8 [H, W, 3] -> normalized float32 [3, H, W]; numpy without g++."""
    img_hwc = np.ascontiguousarray(img_hwc, np.uint8)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    lib = _lib_or_none()
    if lib is None:
        x = img_hwc.astype(np.float32) / 255.0
        return ((x - mean) / std).transpose(2, 0, 1).copy()
    h, w, _ = img_hwc.shape
    out = np.empty((3, h, w), np.float32)
    lib.tpp_normalize_u8(img_hwc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                         _fp(mean), _fp(std), _fp(out), n_threads)
    return out


def hd_slice(img: np.ndarray, hb: int, wb: int, block: int, fit_h: int, fit_w: int,
             g_fit_h: int, g_fit_w: int, n_threads: int = 4) -> np.ndarray:
    """The HD canvas and its crops (and the global view) in C++; img [3, H,
    W] float32 normalized."""
    lib = load()
    img = np.ascontiguousarray(img, np.float32)
    _, h, w = img.shape
    max_crops = hb * wb + (1 if hb * wb > 1 else 0)
    out = np.empty((max_crops, 3, block, block), np.float32)
    n = lib.tpp_hd_slice(_fp(img), h, w, hb, wb, block, fit_h, fit_w, g_fit_h, g_fit_w,
                         _fp(out), n_threads)
    return out[:n]
