"""The card probes P1-P4: how fast weights stream on the card.

Counterparts of the TPU package's Pallas probes in `scripts/`:

- `dma_stride` (P1, `probe_dma_stride.py`): int8 [4096, 11008] streamed in
  512-row chunks, from a contiguous source or a column slice of the fused
  gate/up layout [4096, 22016] (at column 0 or 11008);
- `int4_ring` (P2, `probe_int4_ring.py`): a GEMV chain over int8 weights
  against the same chain over int4 nibbles with their unpack;
- `bitcast_pack` (P3, `probe_bitcast_pack.py`): the row-pair packing of
  int8 rows into 16 bits (P3a) and a GEMV chain over the packed source
  against the int8 one (P3b);
- `stream_dtype` (P4, `probe_stream_dtype.py`): the same bytes streamed as
  int8, int16, uint16, int32 or bf16, loaded at the element's width and as
  16-byte vectors.

Each keeps its script's constants and defaults, and has a `main()` run as
`python -m tokenpacker_tpu_torch.probes.<name>` with the script's
arguments and environment, which prints the script's lines with the rates
measured on the card (and exits non-zero where there is no card). Each
function has a definite value that a check can hold, and the kernels read
every byte they stream (`csrc/stream_probes.cu`). On a CPU tensor a
function runs its plain PyTorch version; on a CUDA tensor it launches its
kernel, counted on the function's `launches`, or raises.

The TPU has no cache between its memory and the kernel; the H100 has a
50 MB L2. P1's source is 45 MB, so its rate is taken over rotating copies
of at least 4x the L2 (`l2_copies`); P2-P4 stream 8 layers of 50 MB,
already past it.
"""

from __future__ import annotations

import math
import subprocess

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.timing import HBM_BYTES_PER_S


def visits(reps: int, period: int) -> torch.Tensor:
    """[period] int64: how many of the steps 0..reps-1 fall on each
    residue modulo period (step li streams item li % period)."""
    c = torch.arange(period, dtype=torch.int64)
    return torch.div(reps - c + period - 1, period, rounding_mode="floor").clamp_min(0)


def wrap32(total: int, device=None) -> torch.Tensor:
    """An integer taken modulo 2^32, as the int32 [1] with those bits."""
    return torch.tensor([(int(total) + 2**31) % 2**32 - 2**31], dtype=torch.int32, device=device)


def l2_copies(nbytes: int, l2_bytes: int) -> int:
    """Copies of an nbytes source that make a working set of at least 4x
    the L2 cache."""
    return max(1, math.ceil(4 * l2_bytes / nbytes))


def require_card(name: str) -> torch.device:
    """The card, or exit non-zero: the probes measure only on a GPU."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device visible; the probes run only on a GPU")
    return torch.device("cuda", 0)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except FileNotFoundError:
        out = ""
    if out:
        return out.splitlines()[0]
    return f"{torch.cuda.get_device_name(0)} (nvidia-smi: no output)"


def rate_line(name: str, ms: float, nbytes: float, extra: str = "") -> str:
    """'name: X ms for Y GB -> Z GB/s (share of 3.35 TB/s)', the scripts' line."""
    gb = nbytes / 1e9
    return (f"{name}: {ms:.3f} ms for {gb:.2f} GB -> {gb / (ms / 1e3):.0f} GB/s "
            f"({nbytes / (ms / 1e3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s){extra}")


# the kernels' x kinds (csrc/stream_probes.cu x_elem)
X_KINDS = {torch.int8: 0, torch.int16: 1, torch.uint16: 2, torch.int32: 3, torch.bfloat16: 4}
CHAIN_MODES = {"int8": 0, "int4": 1, "packed": 2}


def stream_sum_launch(src: torch.Tensor, offset: int, row_pitch: int, chunk_pitch: int,
                      copy_pitch: int, rows_per_chunk: int, nchunks: int, ncopies: int,
                      row_bytes: int, reps: int, load_bytes: int, elem_bytes: int,
                      x: torch.Tensor | None = None, value_scale: float = 0.0,
                      value_rows: int = 0):
    """One launch of `tp_probe_stream_sum` over src's bytes from `offset`
    (pitches in bytes): (checksum int32 [1], value f32 [value_rows, 1] or
    None). The caller counts the launch."""
    dt = src.dtype
    stream = _build.cuda_args("stream_sum", src=(src, dt),
                              **({} if x is None else {"x": (x, x.dtype)}))
    checksum = torch.zeros(1, dtype=torch.int32, device=src.device)
    value = None if x is None else torch.empty((value_rows, 1), dtype=torch.float32,
                                               device=src.device)
    rc = _build.library().tp_probe_stream_sum(
        src.data_ptr() + offset, row_pitch, chunk_pitch, copy_pitch, rows_per_chunk, nchunks,
        ncopies, row_bytes, reps, load_bytes, elem_bytes, checksum.data_ptr(),
        None if x is None else x.data_ptr(), 0 if x is None else X_KINDS[x.dtype],
        0 if x is None else x.numel(), value_scale, None if x is None else value.data_ptr(),
        value_rows, stream)
    _build.check(rc, "stream_sum")
    return checksum, value


def gemv_chain_launch(x: torch.Tensor, w: torch.Tensor, reps: int, mode: str, ncols_gemv: int):
    """One call of `tp_probe_gemv_chain` (the chain and its reduction, two
    launches): (value f32 [B, 1], checksum int32 [1]). x bf16 [B, K]; w
    int8 [L, K | K/2, N] (int8, int4) or int16 [L, K/2, N] (packed). The
    caller counts the call."""
    b, k = x.shape
    stream = _build.cuda_args("gemv_chain", x=(x, torch.bfloat16), w=(w, w.dtype))
    lib = _build.library()
    count = lib.tp_probe_gemv_chain_partials(b, k, ncols_gemv, reps, CHAIN_MODES[mode])
    if count < 0:
        raise ValueError(f"gemv_chain: {b} rows are not taken (1, 2, 4 or 8)")
    partials = torch.empty(max(count, 1) * b, dtype=torch.float32, device=x.device)
    value = torch.empty((b, 1), dtype=torch.float32, device=x.device)
    checksum = torch.zeros(1, dtype=torch.int32, device=x.device)
    rc = lib.tp_probe_gemv_chain(x.data_ptr(), w.data_ptr(), partials.data_ptr(),
                                 value.data_ptr(), checksum.data_ptr(), b, k, w.shape[-1],
                                 w.shape[0], reps, ncols_gemv, CHAIN_MODES[mode], stream)
    _build.check(rc, "gemv_chain")
    return value, checksum
