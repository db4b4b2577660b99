"""K1: attention for the frozen CLIP tower (counterpart of
`tokenpacker_tpu/ops/vit_attention.py`).

`vit_attention` takes q/k/v in their natural `[N, T, W]` layout. On a
CUDA tensor it launches `csrc/vit_attention.cu`, a Hopper kernel (wgmma
products fed by TMA tiles read in place from the `[N, T, heads, 64]`
rows; S, P and O in registers; head_dim 64 only); on a CPU tensor it runs
`vit_attention_plain`, the same function in plain PyTorch.

Numerics: the kernel computes fp32 logits, multiplies unnormalized
bf16-rounded probabilities with V and divides by their sum once at the
output (the TPU kernel's scheme). The plain version is the einsum path
the JAX tower runs off the TPU (`clip_vit._attn_einsum`): logits in the
input dtype, fp32 softmax normalized, probabilities cast to the input
dtype. In fp32 the two agree to rounding; in bf16 they differ by the
rounding of the logits and probabilities.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """q/k/v: [N, T, W] -> [N, T, W], bidirectional, fp32 softmax."""
    n, t, w = q.shape
    d = w // num_heads
    qh = q.view(n, t, num_heads, d)
    kh = k.view(n, t, num_heads, d)
    vh = v.view(n, t, num_heads, d)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * (d**-0.5)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", probs, vh).reshape(n, t, w)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """q/k/v: [N, T, W] (projected, natural layout) -> [N, T, W]."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, num_heads)
    n, t, w = q.shape
    if k.shape != q.shape or v.shape != q.shape or w % num_heads:
        raise ValueError(f"vit_attention: shapes {q.shape} {k.shape} {v.shape}, {num_heads} heads")
    bf = torch.bfloat16
    stream = _build.cuda_args("vit_attention", q=(q, bf), k=(k, bf), v=(v, bf))
    out = torch.empty_like(q)
    rc = _build.library().tp_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, t, w, num_heads, stream
    )
    _build.check(rc, "vit_attention")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
