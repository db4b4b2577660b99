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

from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul
from tokenpacker_tpu_torch.ops.q8_matmul import w8a8_matmul
from tokenpacker_tpu_torch.ops.quantize import dequantize_4bit, is_q4leaf, is_qleaf
from tokenpacker_tpu_torch.ops.s8_gemm import w8a8_gemm
from tokenpacker_tpu_torch.parallel import comm


def _quantized_product(x: torch.Tensor, k: dict, w8a8: bool) -> torch.Tensor:
    """x @ the quantized leaf k (without any adapter keys), by `linear`'s
    route for x's M; no autograd graph."""
    m = x.numel() // x.shape[-1]
    if is_q4leaf(k):
        return q4_matmul(x, k) if m <= 32 else x @ dequantize_4bit(k, x.dtype)
    if not is_qleaf(k):
        raise NotImplementedError(f"quantized kernel {sorted(k)}: not a ported leaf")
    if w8a8 and k["q"].dim() == 2 and m <= 64:
        return w8a8_matmul(x, k)
    if (w8a8 and k["q"].dim() == 2 and m >= 256 and x.shape[-1] % 128 == 0
            and k["q"].shape[1] % 128 == 0):
        return w8a8_gemm(x, k)
    # The JAX package's default int8 branch, a plain product it leaves to
    # XLA. On the card the cast makes a bf16 copy of the weight for each
    # call (180 MB for Vicuna-7B's gateup); the decode step avoids it
    # through K4 (ops/fused_decode) or, with w8a8, through K7.
    return (x @ k["q"].to(x.dtype)) * k["scale"].squeeze(-2).to(x.dtype)


class QuantizedProduct(torch.autograd.Function):
    """The frozen quantized base product x @ W under autograd. The forward
    takes `linear`'s route (K6, K7, K8 or a plain product); the Function
    saves the quantized leaf, never a dense copy of W, and its backward
    is dx = dy @ deq(W)^T from one layer's weight at a time, the
    derivative JAX's autodiff takes through the weight-only product
    ((dy * scale) @ q^T for int8, dy @ dequantize_4bit(W)^T for 4-bit).
    For the w8a8 routes that is the straight-through derivative (the
    activations' rounding passes the gradient unchanged). W gets no
    gradient: the base is frozen."""

    @staticmethod
    def forward(ctx, x, w8a8, keys, *tensors):
        leaf = dict(zip(keys, tensors))
        ctx.keys = keys
        ctx.save_for_backward(*tensors)
        return _quantized_product(x, leaf, w8a8)

    @staticmethod
    def backward(ctx, dy):
        k = dict(zip(ctx.keys, ctx.saved_tensors))
        if is_q4leaf(k):
            dx = dy @ dequantize_4bit(k, dy.dtype).transpose(-1, -2)
        else:
            dx = (dy * k["scale"].squeeze(-2).to(dy.dtype)) @ k["q"].to(dy.dtype).transpose(-1, -2)
        return (dx, None, None) + (None,) * len(ctx.keys)


def linear(params, x: torch.Tensor, w8a8: bool = False) -> torch.Tensor:
    """y = x @ kernel + bias. kernel: [in, out], the int8 leaf {"q" [in,
    out] int8, "scale" [1, out] f32} or a 4-bit leaf (`ops/quantize`);
    bias optional.

    Quantized kernels route by M (the rows of x) as the JAX package routes
    them on a TPU, on every device (on the CPU each kernel's wrapper runs
    its plain version, so the CPU walks the card's route):
    - 4-bit: K6 (`q4_matmul`) for M <= 32, else a dense product with the
      dequantized weight;
    - int8 with `w8a8` (the JAX package's TOKENPACKER_W8A8=1): K7
      (`w8a8_matmul`) for M <= 64, K8 (`w8a8_gemm`) for M >= 256 with
      in and out multiples of 128, else the weight-only product;
    - int8: the weight-only product.
    When autograd records (x requires grad), the quantized product runs
    inside `QuantizedProduct`, which keeps x's gradient and saves only the
    quantized leaf.

    LoRA training (`train/lora.merge_lora_params`): `lora_a` [in, r] and
    `lora_b` [r, out] (alpha / r folded into b) inside a quantized kernel
    leaf, as the JAX package attaches them, or beside a dense `kernel`,
    add (x @ lora_a) @ lora_b in x's dtype after the base product.

    Multi-LoRA serving (`serve/multi_lora`): with `slot_lora_a` [n, in, r],
    `slot_lora_b` [n, r, out] and `slot_lora_sel` [N, n] (one row per
    sample of x [N, ..., in]) the leaf adds every adapter's term, selected
    by the sample's one-hot row, after the base product of whatever kind
    and before the bias, in x's dtype as the JAX package computes it: an
    all-zero row adds an exact zero."""
    k = params["kernel"]
    lora = params
    if isinstance(k, dict):
        lora = k
        base = {n: t for n, t in k.items() if n not in ("lora_a", "lora_b")}
        if torch.is_grad_enabled() and x.requires_grad:
            keys = tuple(base)
            y = QuantizedProduct.apply(x, w8a8, keys, *(base[n] for n in keys))
        else:
            y = _quantized_product(x, base, w8a8)
    else:
        y = x @ k
    if "lora_a" in lora:
        y = y + (x @ lora["lora_a"].to(x.dtype)) @ lora["lora_b"].to(x.dtype)
    a = params.get("slot_lora_a")
    if a is not None:
        sel = params["slot_lora_sel"].to(x.dtype)
        xa = torch.einsum("b...d,ndr->b...nr", x, a.to(x.dtype))
        ctx = torch.einsum("b...nr,nro->b...no", xa, params["slot_lora_b"].to(x.dtype))
        y = y + torch.einsum("b...no,bn->b...o", ctx, sel)
    if params.get("bias") is not None:
        y = y + params["bias"]
    return y


def row_linear(params, x: torch.Tensor, axis, w8a8: bool = False) -> torch.Tensor:
    """A row-parallel product: x holds this rank's slice of the input
    features and the kernel its rows; the partial products are summed over
    `axis` ('model', `parallel/comm.reduce_from`) before the bias. Plain
    `linear` when axis is None (a replicated block)."""
    if axis is None:
        return linear(params, x, w8a8)
    y = comm.reduce_from(linear({k: v for k, v in params.items() if k != "bias"}, x, w8a8), axis)
    return y if params.get("bias") is None else y + params["bias"]


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
