"""ctypes bindings for the port's native preprocessing library
(counterpart of `tokenpacker_tpu/image/native.py`): bilinear resize, CLIP
normalization, HD slicing and libjpeg decoding on host threads.

The library is the port's copy of the JAX package's C++
(`tokenpacker_tpu_torch/native/preprocess.cpp`). It is built only on
request, as the JAX package's is built only by `make -C native`:

    python -m tokenpacker_tpu_torch.image.native [--build-dir DIR]

(or `build()`) compiles it with g++ into `_kernels_build/` beside the
package, named by a hash of the source and flags. Where libjpeg's header
is missing it is built without `tpp_jpeg_decode`, as the JAX bindings
allow (`jpeg_available()` then says False).

`load()` opens a library that is already built: the file that
`TOKENPACKER_NATIVE_LIB` names first, as in the JAX package, else the
build in `_kernels_build/`. Nothing else builds one. `available()` tells
whether there is one to load; `hd_tiler.slice_image`, `io.load_image`,
`resize_bilinear` and `normalize_u8` take the native path when there is,
as the JAX package's do, and numpy or PIL otherwise: also in an install
that has no C++ source.
"""

from __future__ import annotations

import argparse
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


def _name(jpeg: bool) -> str | None:
    """The library's file name for this source and these flags (None
    without the source: nothing can be built, and nothing built matches)."""
    if not SOURCE.is_file():
        return None
    flags = FLAGS + (JPEG_FLAGS if jpeg else ())
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return f"libtpp-{digest}{'-jpeg' if jpeg else ''}.so"


def _built(build_dir: Path) -> Path | None:
    for jpeg in (True, False):
        name = _name(jpeg)
        if name is not None and (build_dir / name).exists():
            return build_dir / name
    return None


def _find() -> Path | None:
    """The library to load: TOKENPACKER_NATIVE_LIB's file where it exists,
    else the build in BUILD_DIR, else None."""
    env = os.environ.get("TOKENPACKER_NATIVE_LIB")
    if env and os.path.exists(env):
        return Path(env)
    return _built(BUILD_DIR)


def build(build_dir: Path | str | None = None) -> Path:
    """Compile the library (with libjpeg where its header is found) into
    `build_dir` (default BUILD_DIR) unless it is built there; returns its
    path. Raises without g++ or the source."""
    build_dir = Path(BUILD_DIR if build_dir is None else build_dir)
    if not SOURCE.is_file():
        raise RuntimeError(f"the native library's source {SOURCE} is not installed")
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


def load(build_dir: Path | str | None = None):
    """The library, opened once (thread-safe): the one built in
    `build_dir`, or by default `_find()`'s. It never builds; raises
    RuntimeError when there is nothing to open."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = _find() if build_dir is None else _built(Path(build_dir))
            if path is None:
                raise RuntimeError("the native library is not built (python -m "
                                   "tokenpacker_tpu_torch.image.native builds it)")
            _LIB = _bind(path)
        return _LIB


def _lib_or_none():
    """The library where one is built, else None (numpy's path)."""
    try:
        return load()
    except RuntimeError:
        return None


def available() -> bool:
    """Whether a library is built (and so the native paths are taken)."""
    return _LIB is not None or _find() is not None


def jpeg_available() -> bool:
    lib = _lib_or_none()
    return lib is not None and hasattr(lib, "tpp_jpeg_decode")


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
    semantics); numpy (`hd_tiler._resize_bilinear`) where no library is
    built."""
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
    """uint8 [H, W, 3] -> normalized float32 [3, H, W]; numpy where no
    library is built."""
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


def main(argv=None) -> None:
    """Build the library (the counterpart of `make -C native`) and print
    its path."""
    ap = argparse.ArgumentParser(description="Build the port's native preprocessing library "
                                             "with g++.")
    ap.add_argument("--build-dir", default=None,
                    help="where to put it (default: the package's _kernels_build/)")
    print(build(ap.parse_args(argv).build_dir))


if __name__ == "__main__":
    main()
