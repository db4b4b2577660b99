"""Primitive NN ops (counterpart of `tokenpacker_tpu/ops/layers.py`).

Parameters are plain dicts of tensors. Linear kernels keep the JAX
package's **[in, out]** layout (y = x @ W), so the weight bridge copies
them without a transpose. Norms compute in fp32 and cast back, as the
JAX code does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ kernel + bias. kernel: [in, out], or the int8 leaf {"q"
    [in, out] int8, "scale" [1, out] f32} (`ops/quantize`); bias optional."""
    k = params["kernel"]
    if isinstance(k, dict):
        if set(k) != {"q", "scale"}:
            raise NotImplementedError(
                f"quantized kernel {sorted(k)}: only the int8 {{q, scale}} leaf is ported "
                "(4-bit comes with K6)"
            )
        # The JAX package's default int8 branch, a plain product it leaves
        # to XLA. On the card the cast makes a bf16 copy of the weight for
        # each call (180 MB for Vicuna-7B's gateup); the decode step avoids
        # it through K4 (ops/fused_decode), prefill pays it once per layer.
        y = (x @ k["q"].to(x.dtype)) * k["scale"].squeeze(-2).to(x.dtype)
    else:
        y = x @ k
    if params.get("bias") is not None:
        y = y + params["bias"]
    return y


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch-compatible LayerNorm over the last axis, computed in fp32."""
    y = F.layer_norm(
        x.float(), (x.shape[-1],), params["scale"].float(), params["bias"].float(), eps
    )
    return y.to(x.dtype)


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LLaMA RMSNorm: normalize in fp32, scale in the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["scale"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def bilinear_resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] 1-D interpolation matrix reproducing
    `F.interpolate(mode='bilinear', align_corners=False, antialias=False)`:
    out pixel i samples input position (i+0.5)*src/dst - 0.5 with a 2-tap
    triangle kernel and edge clamping."""
    w = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    for i in range(dst):
        pos = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(pos))
        frac = pos - i0
        i0c = min(max(i0, 0), src - 1)
        i1c = min(max(i0 + 1, 0), src - 1)
        w[i, i0c] += 1.0 - frac
        w[i, i1c] += frac
    return w.astype(np.float32)


def bilinear_downsample_2d(x: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """x: [..., H, W, C] -> [..., dst_h, dst_w, C] in fp32."""
    h, w = x.shape[-3], x.shape[-2]
    wh = torch.from_numpy(bilinear_resize_matrix(h, dst_h)).to(x.device)
    ww = torch.from_numpy(bilinear_resize_matrix(w, dst_w)).to(x.device)
    y = x.float()
    y = torch.einsum("oh,...hwc->...owc", wh, y)
    return torch.einsum("pw,...owc->...opc", ww, y)
