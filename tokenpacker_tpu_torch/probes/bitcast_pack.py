"""P3: int8 rows packed in pairs into 16 bits, and a GEMV chain over the
packed source (counterpart of `scripts/probe_bitcast_pack.py`).

P3a (`semantics` on the TPU): `pltpu.bitcast` of int8 [2R, C] to a 16-bit
[R, C] puts int8 row 2r in the low byte and row 2r + 1 in the high byte
of row r (interleaved pairs, not halves); the round trip is the identity.
`pack_rows` / `unpack_rows` are that packing (a `tensor.view(int16)`
pairs columns, not rows, so it is not this one); the packed rows are
int16 (their bits are the u16 ones).

P3b (`stream`): the same GEMV chain as P2 (`int4_ring`) at B = 8, over an
int8 source [L, K, N] or its packed form [L, K/2, N]: the TPU kernel
multiplied the first 4096 of the 12288 columns, streaming them all.
`stream` returns that value, sum over li < reps of rowsum(x @ W[li %
L][:, :4096]), and the wrapping 32-bit sum of the bytes of the other
8192 columns, so that every streamed byte is read; both are the same in
either mode. Decision rule: a packed/int8 wall ratio below 1 means the
16-bit stream is faster and worth building.

    python -m tokenpacker_tpu_torch.probes.bitcast_pack semantics|stream
    Env: REPS (default 64, layer streams of L)
"""

from __future__ import annotations

import os
import sys

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.probes import (
    card,
    gemv_chain_launch,
    rate_line,
    require_card,
    visits,
    wrap32,
)
from tokenpacker_tpu_torch.timing import time_ms

CK = 512
N = 12288
K = 4096
B = 8
L = 8
NSLOTS = 2
GEMV_COLS = 4096  # the columns whose product enters the value


def pack_rows_plain(w8: torch.Tensor) -> torch.Tensor:
    """int8 [..., 2R, C] -> int16 [..., R, C]: row r's low byte from row
    2r, its high byte from row 2r + 1."""
    lo = w8[..., 0::2, :].to(torch.int32) & 0xFF
    return (w8[..., 1::2, :].to(torch.int32) * 256 + lo).to(torch.int16)


def unpack_rows_plain(p: torch.Tensor) -> torch.Tensor:
    """int16 [..., R, C] -> int8 [..., 2R, C], the inverse of `pack_rows_plain`."""
    p32 = p.to(torch.int32)
    lo = ((p32 & 0xFF) ^ 0x80) - 0x80
    pairs = torch.stack([lo, p32 >> 8], dim=-2)  # [..., R, 2, C]
    return pairs.reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1]).to(torch.int8)


def _rows_launch(name: str, src: torch.Tensor, out: torch.Tensor, pairs: int) -> None:
    stream = _build.cuda_args(name, src=(src, src.dtype))
    c = src.shape[-1]
    if c % 4:
        raise ValueError(f"{name}: {c} columns, the kernel takes a multiple of 4")
    fn = getattr(_build.library(), f"tp_probe_{name}")
    _build.check(fn(src.data_ptr(), out.data_ptr(), pairs, c, stream), name)


def pack_rows(w8: torch.Tensor) -> torch.Tensor:
    """`pack_rows_plain` on the card for a CUDA tensor (contiguous int8,
    columns a multiple of 4), the plain version for a CPU one."""
    if w8.device.type == "cpu":
        return pack_rows_plain(w8)
    if w8.dtype != torch.int8 or w8.shape[-2] % 2:
        raise ValueError(f"pack_rows: {tuple(w8.shape)} {w8.dtype}, expected int8 [..., 2R, C]")
    out = torch.empty((*w8.shape[:-2], w8.shape[-2] // 2, w8.shape[-1]), dtype=torch.int16,
                      device=w8.device)
    _rows_launch("pack_rows", w8, out, out.numel() // out.shape[-1])
    pack_rows.launches += 1
    return out


def unpack_rows(p: torch.Tensor) -> torch.Tensor:
    """`unpack_rows_plain` on the card for a CUDA tensor (contiguous int16),
    the plain version for a CPU one."""
    if p.device.type == "cpu":
        return unpack_rows_plain(p)
    if p.dtype != torch.int16:
        raise ValueError(f"unpack_rows: {p.dtype}, expected int16")
    out = torch.empty((*p.shape[:-2], 2 * p.shape[-2], p.shape[-1]), dtype=torch.int8,
                      device=p.device)
    _rows_launch("unpack_rows", p, out, p.numel() // p.shape[-1])
    unpack_rows.launches += 1
    return out


pack_rows.launches = 0
unpack_rows.launches = 0


def stream_plain(x: torch.Tensor, w: torch.Tensor, reps: int,
                 packed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(value [B, 1] fp32, checksum int32 [1]): sum over li < reps of
    rowsum(x @ W[li % L][:, :4096]) in float64, and the wrapping sum of
    the bytes of W[li % L][:, 4096:]; W = w (int8 [L, K, N]) or
    `unpack_rows_plain(w)` (packed int16 [L, K/2, N])."""
    w8 = unpack_rows_plain(w) if packed else w
    counts = visits(reps, w8.shape[0])
    xf = x.double()
    value = sum(int(c) * (xf @ w8[i, :, :GEMV_COLS].double()).sum(-1)
                for i, c in enumerate(counts) if c)
    rest = w8[:, :, GEMV_COLS:].reshape(w8.shape[0], -1).view(torch.uint8).to(torch.int64)
    rest = rest.sum(-1).remainder(2**32).cpu()  # each layer's bytes, read unsigned
    return value.float()[:, None], wrap32(int((rest * counts).sum()), x.device)


def stream(x: torch.Tensor, w: torch.Tensor, reps: int,
           packed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(value, checksum) of `stream_plain`: the kernel on CUDA tensors (x
    bf16 [B, K] with B 1, 2, 4 or 8; w int8 [L, K, N] or packed int16 [L,
    K/2, N]; K % 512 == 0, N a multiple of 4096), the plain version on CPU
    ones."""
    if x.device.type == "cpu":
        return stream_plain(x, w, reps, packed)
    k = x.shape[1]
    want = (torch.int16, k // 2) if packed else (torch.int8, k)
    if w.dim() != 3 or (w.dtype, w.shape[1]) != want:
        raise ValueError(f"bitcast_pack.stream: w {tuple(w.shape)} {w.dtype}, expected "
                         f"{want[0]} [L, {want[1]}, N]")
    out = gemv_chain_launch(x, w, reps, "packed" if packed else "int8", GEMV_COLS)
    stream.launches += 1
    return out


stream.launches = 0


def semantics() -> None:
    """int8 [64, 256] labelled rows -> packed [32, 256] -> back: print the
    row mapping both ways, as the script does."""
    device = require_card("bitcast_pack")
    _build.library()
    print(card())
    src = torch.arange(64, dtype=torch.int8, device=device)[:, None].expand(64, 256).contiguous()
    packed = pack_rows(src)
    rt = unpack_rows(packed)
    print("roundtrip row labels (should be 0..63 in order):")
    print(rt[:, 0].tolist())
    u16 = packed[:, 0].to(torch.int32) & 0xFFFF
    print("bf16/u16 row r = (lo byte <- int8 row, hi byte <- int8 row):")
    print([(int(v) & 0xFF, int(v) >> 8) for v in u16])


def stream_main() -> None:
    """Time the chain over the int8 source and over its packed form, one
    pass over the L layers (each read once from device memory) and the
    script's REPS passes (concurrent blocks share layers through the L2)."""
    device = require_card("bitcast_pack")
    _build.library()
    print(card())
    reps = int(os.environ.get("REPS", "64")) * L
    g = torch.Generator(device=device).manual_seed(0)
    w8 = torch.randint(-127, 127, (L, K, N), dtype=torch.int8, device=device, generator=g)
    wp = pack_rows(w8)
    x = (torch.randn((B, K), generator=g, device=device) * 0.1).to(torch.bfloat16)
    passes = ("one pass", f"{reps // L} passes")
    results, values = {}, {label: [] for label in passes}
    for label, r in zip(passes, (L, reps)):
        for name, w, pk in (("int8", w8, False), ("packed-bf16", wp, True)):
            ms = time_ms(lambda: stream(x, w, r, pk))
            value, checksum = stream(x, w, r, pk)
            want_value, want_checksum = stream_plain(x, w, r, pk)
            rel = ((value.double() - want_value.double()).abs() / want_value.double().abs()).max()
            same = torch.equal(checksum, want_checksum)
            results[name, label] = ms
            values[label].append((value, checksum))
            print(rate_line(f"{name:>12} ({label})", ms, r * K * N,
                            f" (sum={value[0, 0].item():.1f}, relative difference from the plain "
                            f"version {rel.item():.2e}; checksum "
                            f"{'equals' if same else 'DIFFERS FROM'} the plain version's)"),
                  flush=True)
    for label in passes:
        same = all(torch.equal(a, b) for a, b in zip(*values[label]))
        print(f"packed/int8 wall ratio ({label}): "
              f"{results['packed-bf16', label] / results['int8', label]:.3f} (< 1: the packed "
              f"16-bit stream is faster, worth building; >= 1: it is not); the two modes' "
              f"values and checksums {'equal' if same else 'DIFFER'}", flush=True)


def main() -> None:
    {"semantics": semantics, "stream": stream_main}[sys.argv[1]]()


if __name__ == "__main__":
    main()
