"""P4: does the stream rate depend on the element type or the load width?
(counterpart of `scripts/probe_stream_dtype.py`).

The TPU probe streamed the same bytes, L = 8 layers of 4096 bytes x 12288
rows, stored as int8, int16, uint16, int32 or bf16, through the fused
decode ring with its products off (TOKENPACKER_FD_DEBUG=nodot), so its
output was reps * N * sum(x), whatever the weights.

`stream` returns that value and the wrapping 32-bit sum of the streamed
elements' bit patterns (zero-extended), so that every byte is read. It
loads each element at its own width, or (`vector=True`) 16 bytes at a
time, the width of the port's GEMVs; `main` prints both.

    python -m tokenpacker_tpu_torch.probes.stream_dtype [dtype ...]
    Env: REPS (default 8, layer streams of L)
"""

from __future__ import annotations

import os
import sys

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.probes import (
    card,
    rate_line,
    require_card,
    stream_sum_launch,
    visits,
    wrap32,
)
from tokenpacker_tpu_torch.timing import time_ms

L = 8  # layers in the probe stack (cycled REPS times)
N = 12288
K_BYTES = 4096  # contraction extent in bytes (int8 rows)
CK_BYTES = 512
B = 8
NSLOTS = 2
CASES = {
    "int8": (torch.int8, 1),
    "int32": (torch.int32, 4),
    "bf16": (torch.bfloat16, 2),
    "uint16": (torch.uint16, 2),
    "int16": (torch.int16, 2),
}


def _values(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).double() if x.dtype == torch.uint16 else x.double()


def stream_plain(x: torch.Tensor, w: torch.Tensor,
                 reps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(value [B, 1] fp32, checksum int32 [1]): reps * N * sum(x) for every
    row (float64, rounded once), and the wrapping sum over li < reps of the
    bit patterns of W[li % L]'s elements, read unsigned. x [B, k], w [L, k,
    N] of one dtype."""
    value = reps * w.shape[-1] * _values(x).sum()
    bits = w.reshape(w.shape[0], -1)
    if w.element_size() > 1:
        bits = bits.view(torch.int16 if w.element_size() == 2 else torch.int32)
    mask = (1 << (8 * w.element_size())) - 1
    per = (bits.to(torch.int64) & mask).sum(-1).remainder(2**32).cpu()
    checksum = wrap32(int((per * visits(reps, w.shape[0])).sum()), x.device)
    return value.float().expand(x.shape[0], 1).clone(), checksum


def stream(x: torch.Tensor, w: torch.Tensor, reps: int,
           vector: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(value, checksum) of `stream_plain`: the kernel on CUDA tensors,
    loading at the element's width or (vector) 16 bytes at a time; the
    plain version on CPU ones."""
    if x.device.type == "cpu":
        return stream_plain(x, w, reps)
    esize = w.element_size()
    if w.dim() != 3 or x.dtype != w.dtype or x.shape[1] != w.shape[1] or w.dtype not in (
            dt for dt, _ in CASES.values()) or (vector and (w.shape[-1] * esize) % 16):
        raise ValueError(f"stream_dtype.stream: x {tuple(x.shape)} {x.dtype}, w "
                         f"{tuple(w.shape)} {w.dtype}")
    k, n = w.shape[1], w.shape[2]
    row = n * esize
    checksum, value = stream_sum_launch(w, 0, row, k * row, 0, k, w.shape[0], 1, row, reps,
                                        16 if vector else esize, esize, x=x.contiguous(),
                                        value_scale=float(reps * n), value_rows=x.shape[0])
    stream.launches += 1
    return value, checksum


stream.launches = 0


def make_case(name: str, device, g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(x [B, k], w [L, k, N]) of the case's dtype, drawn as the script
    draws them; k = K_BYTES / the element size."""
    dtype, esize = CASES[name]
    k = K_BYTES // esize
    if dtype == torch.bfloat16:
        w = torch.randn((L, k, N), generator=g, device=device) * 0.1
        x = torch.randn((B, k), generator=g, device=device) * 0.1
    elif dtype == torch.uint16:
        w = torch.randint(0, 60000, (L, k, N), generator=g, device=device)
        x = torch.randint(0, 60000, (B, k), generator=g, device=device)
    else:
        w = torch.randint(-127, 127, (L, k, N), generator=g, device=device)
        x = torch.randint(-127, 127, (B, k), generator=g, device=device)
    return x.to(dtype), w.to(dtype)


def main(argv: list[str] | None = None) -> None:
    names = (sys.argv[1:] if argv is None else argv) or list(CASES)
    reps_layers = int(os.environ.get("REPS", "8")) * L
    device = require_card("stream_dtype")
    _build.library()
    print(card())
    g = torch.Generator(device=device).manual_seed(0)
    print(f"backend=cuda ({torch.cuda.get_device_name(0)}) stream={reps_layers} x "
          f"[{K_BYTES}B x {N}] rows", flush=True)
    for name in names:
        x, w = make_case(name, device, g)
        want = stream_plain(x, w, reps_layers)
        for vector in (False, True):
            ms = time_ms(lambda: stream(x, w, reps_layers, vector))
            value, checksum = stream(x, w, reps_layers, vector)
            ok = torch.equal(checksum, want[1])
            rel = ((value.double() - want[0].double()).abs()
                   / want[0].double().abs().clamp_min(1e-30)).max().item()
            width = "16-byte vectors" if vector else f"{CASES[name][1]}-byte loads"
            label = f"{name:>6} ({width})"
            print(rate_line(label, ms, reps_layers * K_BYTES * N,
                            f"; checksum {'equals' if ok else 'DIFFERS FROM'} the plain version's,"
                            f" value relative difference {rel:.1e}"), flush=True)
        del x, w


if __name__ == "__main__":
    main()
