"""int8 KV-cache quantization, one f32 absmax scale per (position, kv
head) (counterpart of `tokenpacker_tpu/ops/kv_quant.py`).

A head's row x[..., h, :] is stored as q = round(x / s) with
s = max(|x|, 1e-8) / 127, and read back as q * s. `torch.round` rounds
half to even, as `jnp.round` does, so both packages store the same bytes.
"""

from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor):
    """x: [..., d] float -> (int8 [..., d], f32 scale [...])."""
    x32 = x.float()
    # a divisor on x's device: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not amax / 127 in every bit
    scale = x32.abs().amax(dim=-1).clamp(min=1e-8) / x32.new_full((), 127.0)
    q = torch.round(x32 / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_kv: int8 [..., d] * f32 scale [...] -> dtype."""
    return (q.float() * scale[..., None]).to(dtype)
