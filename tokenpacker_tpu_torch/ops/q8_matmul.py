"""K7: the w8a8 GEMV, int8 x int8 -> exact int32 (counterpart of
`tokenpacker_tpu/ops/q8_matmul.py`).

The w8a8 mode (`ops/layers.linear(..., w8a8=True)`, the JAX package's
TOKENPACKER_W8A8=1) quantizes activations per row (symmetric absmax,
`quantize_activations`) so that both operands of a decode product are
int8: y = (xq @ q) * ax * scale. It is a different numerics point from
weight-only int8 (it adds the activations' rounding), hence opt-in.

On a CUDA tensor `s8_matmul` launches `csrc/s8_matmul.cu` (dp4a into
int32); on a CPU tensor it runs `s8_matmul_plain`. The plain product is
taken in float64, exact on either device: every product and partial sum
is an integer below 127 * 127 * K < 2^53. (`torch.matmul` has no integer
kernel on CUDA; `torch._int_mm` is only the timed yardstick in
`chip_smoke.py`.) The TPU wrapper's padding of M to a multiple of 8 is
not carried over.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build


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
    """xq [M, K] int8 @ wq [K, N] int8 -> exact int32 [M, N]."""
    if xq.device.type == "cpu":
        return s8_matmul_plain(xq, wq)
    m, k = xq.shape
    n = wq.shape[1]
    if wq.shape != (k, n) or k % 32 or n % 16:
        raise ValueError(f"s8_matmul: xq {tuple(xq.shape)}, wq {tuple(wq.shape)}: the kernel "
                         "takes K % 32 == 0 and N % 16 == 0")
    stream = _build.cuda_args("s8_matmul", xq=(xq, torch.int8), wq=(wq, torch.int8))
    out = torch.zeros((m, n), dtype=torch.int32, device=xq.device)
    rc = _build.library().tp_s8_matmul(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, k, n,
                                       stream)
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
