"""Build and load the port's CUDA kernels.

At first use, `library()` compiles every `csrc/*.cu` with nvcc, one
process per source, all started together, and links the objects into one
shared library with a plain C interface that ctypes loads. The library
lands in `_kernels_build/` beside the package, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as built. No PyTorch header is compiled: nvcc takes seconds.

Pointers and the stream are passed as `ctypes.c_void_p`; every entry
point returns 0, a `cudaError_t` code from `cudaGetLastError()` right
after the launch, or -1 for a shape the kernel does not take, and
`check` turns anything but 0 into an exception. The flags leave IEEE
division and square roots on (no fast math): K4's int8 cache rows and
K8's int8 activation rows depend on it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _D = ctypes.c_longlong, ctypes.c_double
SIGNATURES = {
    # q, k, v, o, n, t, w, heads, stream
    "tp_vit_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, o, lse, bias, n, tq, tk, h, hkv, d, causal, stream
    "tp_flash_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, lse, bias, bias_sn, bias_sh, n, tq, tk, h, hkv, d, causal, stream
    "tp_flash_fwd_full_bias": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, lse, dout, bias, dq, dk, dv, delta, n, tq, tk, h, hkv, d, causal, stream
    "tp_flash_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, lengths, needed, slopes, o, n, s, h, hkv, d, span_start, splits, stream
    "tp_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k_pages, v_pages, k_scales, v_scales, page_table, lengths, o, n, h,
    # hkv, d, ps, mp, kv_int8, splits, stream
    "tp_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # weight table, layers, b, t_tok, d, f, heads, head_dim, s, eps, theta,
    # h, len0, start2, end2, write_pos, positions, cache_k, cache_v, k_scale,
    # v_scale, kv_int8, k_new, v_new, work, lora a_d, a_f, b_qkv, b_o, b_gu,
    # b_down, selm, wq, wo, wg, wd, stream
    "tp_fused_decode": (ctypes.POINTER(_P), _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # b, t_tok, d, f, heads, s, sms, out[5] (K4's splits a launch)
    "tp_fused_decode_plan": (_I, _I, _I, _I, _I, _I, _I, _P),
    # stream
    "tp_fused_decode_pdl_probe": (_P,),
    # params table, buffers table, n, t, w, f, heads, eps, stream
    "tp_vit_block": (ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _I, _I, _I, _I, _F, _P),
    # x, packed, absmax, out, m, k, n, nf4, splits, stream
    "tp_q4_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # xq, wq, out, m, k, n, splits, stream
    "tp_s8_matmul": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, wq, wscale, y, m, k, n, xq_out, ax_out, acc_out, stream
    "tp_s8_gemm": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # the card probes (csrc/stream_probes.cu). src, row_pitch, chunk_pitch,
    # copy_pitch, rows_per_chunk, nchunks, ncopies, row_bytes, reps,
    # load_bytes, elem_bytes, checksum, x, x_kind, x_count, value_scale,
    # value, value_rows, stream
    "tp_probe_stream_sum": (_P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _D, _P,
                            _I, _P),
    # x, w, partials, value, checksum, b, k, n, layers, reps, ncols_gemv, mode, stream
    "tp_probe_gemv_chain": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # src, dst, pairs, c, stream
    "tp_probe_pack_rows": (_P, _P, _L, _I, _P),
    "tp_probe_unpack_rows": (_P, _P, _L, _I, _P),
}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet: one nvcc
    per source in parallel, then one link.

    Returns (library path, seconds spent compiling), 0.0 seconds when the
    library was already built."""
    out = BUILD_DIR / f"libtokenpacker_kernels-{_digest()}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objects = [Path(tmp_dir) / f"{src.stem}.o" for src in _sources()]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objects)
        ]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        failed = []
        for cmd, proc in zip(compiles, procs):
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = Path(tmp_dir) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tp_error_string.argtypes = (ctypes.c_int,)
    lib.tp_error_string.restype = ctypes.c_char_p
    lib.tp_fused_decode_workspace.argtypes = (_I, _I, _I, _I, _I)
    lib.tp_fused_decode_workspace.restype = ctypes.c_longlong
    lib.tp_probe_gemv_chain_partials.argtypes = (_I, _I, _I, _I, _I)
    lib.tp_probe_gemv_chain_partials.restype = ctypes.c_longlong
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported anything but success."""
    if rc != 0:
        msg = library().tp_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}): {msg}")


def cuda_args(name: str, **tensors: tuple[torch.Tensor, torch.dtype]) -> int:
    """Check that every (tensor, dtype) is a contiguous, 16-byte aligned
    tensor of that dtype on the current CUDA device (the kernels use
    vector loads); return that device's current stream handle."""
    dev = torch.cuda.current_device()
    for arg, (t, dtype) in tensors.items():
        if not t.is_cuda or t.device.index != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda:{dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    return torch.cuda.current_stream().cuda_stream
