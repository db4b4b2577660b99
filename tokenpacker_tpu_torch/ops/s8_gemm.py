"""K8: the large-M w8a8 GEMM with its own row-quantization pass
(counterpart of `tokenpacker_tpu/ops/s8_gemm.py`).

s8_gemm(x, wq, wscale) = (quantize(x) @ wq) * ax * wscale in x's dtype,
the scheme of `ops/q8_matmul` for prefill and admission chunks and the
int8-quantized CLIP tower (M >= 256, K and N multiples of 128; routing in
`ops/layers.linear`). On a CUDA tensor it launches `csrc/s8_gemm.cu`:
a pass that quantizes each row once into int8 rows and scales in device
memory, then int8 wgmma products fed by TMA into int32, both scales
applied as it writes bf16. On a CPU tensor it runs `s8_gemm_plain`.

The TPU kernel's tile budget (VMEM), TOKENPACKER_S8GEMM_BIG and its bf16
staging of the quantized rows are not carried over. It does not clip the
quantized rows and `quantize_activations` does; the two agree, since
|x / ax| <= 127.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.q8_matmul import quantize_activations, s8_matmul_plain


def s8_gemm_plain(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor, parts: bool = False):
    """x [M, K] @ wq [K, N] int8 with wscale [1, N] f32 -> [M, N] in x's
    dtype. parts=True also returns the int8 rows, their scales [M, 1] and
    the int32 accumulator."""
    xq, ax = quantize_activations(x)
    acc = s8_matmul_plain(xq, wq)
    y = (acc.float() * ax * wscale.float().reshape(1, -1)).to(x.dtype)
    return (y, xq, ax, acc) if parts else y


def s8_gemm(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor, parts: bool = False):
    """x [M, K] bf16, wq [K, N] int8, wscale [1, N] f32 -> [M, N] bf16.
    parts=True (the card checks) also returns the int8 rows [M, K] and
    their scales [M, 1] that the kernel's quantize pass wrote and the GEMM
    read, and its int32 accumulator [M, N]."""
    if x.device.type == "cpu":
        return s8_gemm_plain(x, wq, wscale, parts)
    m, k = x.shape
    n = wq.shape[1]
    if wq.shape != (k, n) or wscale.numel() != n or k % 128 or n % 128:
        raise ValueError(f"s8_gemm: x {tuple(x.shape)}, wq {tuple(wq.shape)}, wscale "
                         f"{tuple(wscale.shape)}: the kernel takes K and N multiples of 128")
    ws = wscale.reshape(1, n)
    stream = _build.cuda_args("s8_gemm", x=(x, torch.bfloat16), wq=(wq, torch.int8),
                              wscale=(ws, torch.float32))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    ax = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    acc = torch.empty((m, n), dtype=torch.int32, device=x.device) if parts else None
    rc = _build.library().tp_s8_gemm(
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), m, k, n, xq.data_ptr(),
        ax.data_ptr(), None if acc is None else acc.data_ptr(), stream)
    _build.check(rc, "s8_gemm")
    s8_gemm.launches += 1
    return (out, xq, ax, acc) if parts else out


s8_gemm.launches = 0


def w8a8_gemm(x: torch.Tensor, qleaf: dict) -> torch.Tensor:
    """x [..., K] @ the int8 leaf {q [K, N], scale [1, N]} -> [..., N] in
    x's dtype, through K8."""
    lead, k = x.shape[:-1], x.shape[-1]
    y = s8_gemm(x.reshape(-1, k).contiguous(), qleaf["q"], qleaf["scale"])
    return y.reshape(*lead, qleaf["q"].shape[1])
