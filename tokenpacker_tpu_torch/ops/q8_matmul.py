"""K7: the w8a8 GEMV, int8 x int8 -> exact int32 (counterpart of
`tokenpacker_tpu/ops/q8_matmul.py`).

The w8a8 mode (`ops/layers.linear(..., w8a8=True)`, the JAX package's
TOKENPACKER_W8A8=1) quantizes activations per row (symmetric absmax,
`quantize_activations`) so that both operands of a decode product are
int8: y = (xq @ q) * ax * scale. It is a different numerics point from
weight-only int8 (it adds the activations' rounding), hence opt-in.

On a CUDA tensor `s8_matmul` launches `csrc/s8_matmul.cu`: one launch
for up to 64 rows, the int8 products on the tensor cores, K split over
the `s8_splits` blocks of one cluster and summed in shared memory; on a
CPU tensor it runs `s8_matmul_plain`. The plain product is
taken in float64, exact on either device: every product and partial sum
is an integer below 127 * 127 * K < 2^53. (`torch.matmul` has no integer
kernel on CUDA; `torch._int_mm` is only the timed yardstick in
`chip_smoke.py`.) The TPU wrapper's padding of M to a multiple of 8 is
not carried over.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.splits import cluster_splits, sm_count

BLOCK_COLS = 128  # output columns a block of the kernel
MAX_ROWS = 64  # rows of x the kernel takes (the route's M <= 64)


def s8_splits(k: int, n: int, sms: int = 132) -> int:
    """The blocks that share one 128-column tile's K in the kernel: a power
    of two up to MAX_SPLITS, doubled while the grid holds fewer than two
    blocks an SM, as long as each split keeps a 64-row stage
    (`splits.cluster_splits`)."""
    return cluster_splits(k, -(-n // BLOCK_COLS), sms)


def quantize_activations(x: torch.Tensor):
    """Per-row symmetric int8: (xq int8 [..., K], ax f32 [..., 1]) with
    x ~ xq * ax, ax = max(absmax, 1e-8) / 127, rounding half to even as
    `jnp.round` does."""
    xf = x.float()
    # a divisor on x's device: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not amax / 127 in every bit
    ax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / xf.new_full((), 127.0)
    xq = torch.round(xf / ax).clamp(-127, 127).to(torch.int8)
    return xq, ax


def s8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ wq [K, N] int8 -> int32 [M, N], exact (float64)."""
    return (xq.double() @ wq.double()).to(torch.int32)


def s8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ wq [K, N] int8 -> exact int32 [M, N]; on the card
    M is at most MAX_ROWS."""
    if xq.device.type == "cpu":
        return s8_matmul_plain(xq, wq)
    m, k = xq.shape
    n = wq.shape[1]
    if wq.shape != (k, n) or k % 32 or n % 16 or m > MAX_ROWS:
        raise ValueError(f"s8_matmul: xq {tuple(xq.shape)}, wq {tuple(wq.shape)}: the kernel "
                         f"takes K % 32 == 0, N % 16 == 0 and M <= {MAX_ROWS}")
    stream = _build.cuda_args("s8_matmul", xq=(xq, torch.int8), wq=(wq, torch.int8))
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    rc = _build.library().tp_s8_matmul(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, k, n,
                                       s8_splits(k, n, sm_count(xq.device.index)), stream)
    _build.check(rc, "s8_matmul")
    s8_matmul.launches += 1
    return out


s8_matmul.launches = 0


def w8a8_matmul(x: torch.Tensor, qleaf: dict) -> torch.Tensor:
    """x [..., K] @ the int8 leaf {q [K, N], scale [1, N]} -> [..., N] in
    x's dtype: acc (int32) -> f32, times ax, times scale, in that order."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, ax = quantize_activations(x.reshape(-1, k))
    acc = s8_matmul(xq.contiguous(), qleaf["q"])
    y = acc.float() * ax * qleaf["scale"].reshape(1, -1)
    return y.to(x.dtype).reshape(*lead, qleaf["q"].shape[1])
