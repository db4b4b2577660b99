"""TokenPacker projector (counterpart of `tokenpacker_tpu/models/tokenpacker.py`).

Point-to-region cross-attention as one batched einsum chain: each coarse
query (a bilinear fp32 downsample of the penultimate features) attends
over its own s x s region of keys/values built from the 4-level concat.
The JAX package has no Pallas kernel here, so this is plain PyTorch.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.config import ProjectorConfig
from tokenpacker_tpu_torch.ops.layers import bilinear_downsample_2d, gelu, layer_norm, linear


def _regionize(x: torch.Tensor, grid: int, s: int) -> torch.Tensor:
    """[N, grid*grid, C] row-major -> [N, (grid/s)^2, s^2, C], grouping each
    coarse region's s x s fine tokens."""
    n, _, c = x.shape
    g = grid // s
    x = x.reshape(n, g, s, g, s, c).permute(0, 1, 3, 2, 4, 5)  # [N, g, g, s, s, C]
    return x.reshape(n, g * g, s * s, c)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def tokenpacker_forward(params, cfg: ProjectorConfig, x: torch.Tensor,
                        x_multi: torch.Tensor) -> torch.Tensor:
    """x [N, raw_grid^2, C] penultimate features; x_multi [N, raw_grid^2, 4C].
    Returns [N, num_queries, hidden_size] visual tokens in LM space."""
    eps = cfg.ln_eps
    s, g, h, e = cfg.scale_factor, cfg.grid_size, cfg.num_heads, cfg.embed_dim
    d = e // h
    n = x.shape[0]

    key = layer_norm(params["ln_k"], gelu_mlp(params["k_proj"], x_multi), eps)
    value = layer_norm(params["ln_v"], gelu_mlp(params["v_proj"], x_multi), eps)

    q = x.reshape(n, cfg.raw_grid, cfg.raw_grid, -1)
    q = bilinear_downsample_2d(q, g, g).to(x.dtype).reshape(n, g * g, -1)
    query = layer_norm(params["ln_q"], linear(params["q_proj"], q), eps)

    qh = linear(params["attn"]["q"], query)
    kh = linear(params["attn"]["k"], key)
    vh = linear(params["attn"]["v"], value)
    kr = _regionize(kh, cfg.raw_grid, s).reshape(n, g * g, s * s, h, d)
    vr = _regionize(vh, cfg.raw_grid, s).reshape(n, g * g, s * s, h, d)
    qr = qh.reshape(n, g * g, h, d)

    logits = torch.einsum("nghd,ngshd->nghs", qr, kr) * (d**-0.5)
    attn = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    out = torch.einsum("nghs,ngshd->nghd", attn, vr).reshape(n, g * g, e)
    out = linear(params["attn"]["o"], out)
    return gelu_mlp(params["mlp"], out)
