"""P2: a GEMV chain over int4 nibbles against int8 (counterpart of
`scripts/probe_int4_ring.py`).

Question: would storing decode weights as int4 (two nibbles a byte)
beat int8? The bytes halve, but every weight pays an unpack before its
product. Both modes compute sum over li < reps of rowsum(x [B, K] @
W[li % L]), W [L, K, N]:

- int8: the source is W itself, int8 [L, K, N];
- int4: the source is int8 [L, K/2, N] of nibble pairs, plane-split per
  512-row chunk (`unpack_int4_nibbles`): source rows [c*256, (c+1)*256)
  give W rows c*512 + [0, 256) from their high nibbles (p >> 4) and
  c*512 + [256, 512) from their low ones (((p & 15) ^ 8) - 8).

`chain` is a real GEMV (per-column sums of x times the converted weight,
fp32) over every streamed byte. Decision rule (the script's): int4 wall
time near half of int8's (0.5) means the int4 path is worth building;
above 0.9 the unpack eats the saving. `main` times one pass over the L
layers (each read once from device memory, as a decode step reads its
weights) and the script's REPS passes, whose concurrently running blocks
share layers through the L2.

    python -m tokenpacker_tpu_torch.probes.int4_ring
    Env: REPS (default 16, layer streams of L), B (default 1)
"""

from __future__ import annotations

import os

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.probes import (
    card,
    gemv_chain_launch,
    rate_line,
    require_card,
    visits,
)
from tokenpacker_tpu_torch.timing import time_ms

L = 8
N = 12288
K = 4096  # effective (unpacked) contraction rows
CK = 512
NSLOTS = 2
B = int(os.environ.get("B", "1"))


def unpack_int4_nibbles(p: torch.Tensor) -> torch.Tensor:
    """int8 [r, n] nibble pairs -> int32 [2r, n] values in [-8, 7]: the
    high-nibble plane's rows first, then the low one's."""
    p32 = p.to(torch.int32)
    return torch.cat([p32 >> 4, ((p32 & 15) ^ 8) - 8], dim=-2)


def unpack_planes(w4: torch.Tensor, ck: int = CK) -> torch.Tensor:
    """[..., K/2, N] int8 nibble pairs -> [..., K, N] int32 W, each chunk of
    ck/2 source rows unpacked plane-split into ck W rows."""
    *lead, rows, n = w4.shape
    chunks = w4.reshape(*lead, rows // (ck // 2), ck // 2, n)
    return unpack_int4_nibbles(chunks).reshape(*lead, 2 * rows, n)


def chain_plain(x: torch.Tensor, w: torch.Tensor, reps: int, mode: str) -> torch.Tensor:
    """[B, 1] fp32: sum over li < reps of rowsum(x @ W[li % L]) in float64,
    W = w (mode "int8") or `unpack_planes(w)` (mode "int4")."""
    weights = unpack_planes(w) if mode == "int4" else w
    counts = visits(reps, w.shape[0])
    xf = x.double()
    total = sum(int(c) * (xf @ weights[i].double()).sum(-1)
                for i, c in enumerate(counts) if c)
    return total.float()[:, None]


def chain(x: torch.Tensor, w: torch.Tensor, reps: int, mode: str) -> torch.Tensor:
    """The chain's value [B, 1] fp32 (see `chain_plain`): x bf16 [B, K], w
    int8 [L, K, N] ("int8") or [L, K/2, N] ("int4"). The kernel on CUDA
    tensors (B 1, 2, 4 or 8; K % 512 == 0; N a multiple of 4096, or of
    2048 at B = 8), the plain version on CPU ones."""
    if x.device.type == "cpu":
        return chain_plain(x, w, reps, mode)
    rows = source_rows(x.shape[1], mode)
    if w.dtype != torch.int8 or w.dim() != 3 or w.shape[1] != rows:
        raise ValueError(f"int4_ring.chain: w {tuple(w.shape)} {w.dtype}, expected int8 "
                         f"[L, {rows}, N] for mode {mode}")
    value, _ = gemv_chain_launch(x, w, reps, mode, w.shape[-1])
    chain.launches += 1
    return value


chain.launches = 0


def source_rows(k: int, mode: str) -> int:
    """Source rows of a layer: K for int8, K/2 for int4."""
    return k // 2 if mode == "int4" else k


def main() -> None:
    reps = int(os.environ.get("REPS", "16")) * L
    device = require_card("int4_ring")
    _build.library()
    print(card())
    g = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn((B, K), generator=g, device=device) * 0.1).to(torch.bfloat16)
    print(f"backend=cuda ({torch.cuda.get_device_name(0)}) B={B} stream={reps} x [{K} x {N}]",
          flush=True)
    results = {}
    for mode in ("int8", "int4"):
        src_rows = source_rows(K, mode)
        w = torch.randint(-127, 127, (L, src_rows, N), dtype=torch.int8, device=device,
                          generator=g)
        # one pass reads each layer once, from device memory; the script's
        # cycled stream runs blocks of several passes at once, which then
        # share layers through the L2 (its rate can pass the memory's)
        for label, r in (("one pass", L), (f"{reps // L} passes", reps)):
            ms = time_ms(lambda: chain(x, w, r, mode))
            got, want = chain(x, w, r, mode), chain_plain(x, w, r, mode)
            rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
            eff_gb = r * K * N / 1e9  # the int8-equivalent weight volume
            results[mode, label] = ms
            print(rate_line(f"{mode} ({label}): src", ms, r * src_rows * N,
                            f"; effective {eff_gb:.2f} GB ({eff_gb / (ms / 1e3):.0f} GB/s-eq); "
                            f"relative difference from the plain version {rel:.2e}"), flush=True)
    for label in ("one pass", f"{reps // L} passes"):
        print(f"int4/int8 wall ratio ({label}): "
              f"{results['int4', label] / results['int8', label]:.3f} "
              f"(0.5 = perfect; >0.9 = not worth building)", flush=True)


if __name__ == "__main__":
    main()
