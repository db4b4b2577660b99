"""LLaMA / Vicuna decoder (counterpart of `tokenpacker_tpu/models/llama.py`).

Parameters are dicts of tensors with the layers as a list (the JAX
package stacks them on a leading axis for `lax.scan`). Both projection
layouts are served: unfused q/k/v and gate/up, and the fused `qkv` /
`gateup` of `ops/quantize.fuse_llama_layers` (the int8 serving tree).
Attention runs on the port's kernels:

- prefill (T > 1): K2 flash forward with a pure causal mask over the
  current tokens. That is exact for right-padded batches: pad keys come
  after every valid query, and pad rows' outputs are never read.
- decode (T == 1): K3 over the cache with `decode_info = (lengths,
  needed, span_start)`, the two valid ranges of `generate.decode_step`.
  An int8 cache is dequantized layer by layer before K3, as the JAX
  package dequantizes before its attention. (Eligible int8 trees decode
  through K4 instead, `generate._decode_step_fused`.)

The KV cache is preallocated and **written in place**: a layer stores
its new k/v rows into `cache.k[layer]` / `cache.v[layer]` at
`cache.length`, where the JAX package returns an updated copy. An int8
cache stores `ops/kv_quant.quantize_kv` of the rows with their scales.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from tokenpacker_tpu_torch.ops.layers import linear, rms_norm, silu


@dataclass
class KVCache:
    k: torch.Tensor  # [L, N, S_max, kv_heads, head_dim], the model dtype or int8
    v: torch.Tensor
    length: int  # positions [0, length) hold keys
    # per-(position, kv head) scales of an int8 cache: [L, N, S_max,
    # kv_heads] f32; None for a float cache
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: torch.device | str = "cpu") -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        scales = (None, None)
        if dtype == torch.int8:
            scales = tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                           for _ in range(2))
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            0,
            *scales,
        )


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [N, T] -> (cos, sin) each [N, T, head_dim] fp32, HF layout."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exponent / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [N, T, H, hd]; cos/sin [N, T, hd], cast to x's dtype before the
    multiply as in the JAX code."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s


def qkv_proj(p_attn, cfg: LMConfig, h: torch.Tensor):
    """h [N, T, D] -> q [N, T, H, d], k/v [N, T, Hkv, d], from the unfused
    q/k/v layout or the fused `qkv` one."""
    n, t, _ = h.shape
    heads = (cfg.num_attention_heads, cfg.kv_heads, cfg.kv_heads)
    if "qkv" in p_attn:
        parts = linear(p_attn["qkv"], h).split([x * cfg.head_dim for x in heads], dim=-1)
    else:
        parts = [linear(p_attn[name], h) for name in ("q", "k", "v")]
    return tuple(x.reshape(n, t, hh, cfg.head_dim) for x, hh in zip(parts, heads))


def mlp_block(p_mlp, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP, gate/up or the fused `gateup` layout."""
    if "gateup" in p_mlp:
        gate, up = linear(p_mlp["gateup"], h).split(cfg.intermediate_size, dim=-1)
    else:
        gate, up = linear(p_mlp["gate"], h), linear(p_mlp["up"], h)
    return linear(p_mlp["down"], silu(gate) * up)


def _layer(p, cfg: LMConfig, x, cos, sin, cache: KVCache | None, layer: int,
           decode_info=None):
    h = rms_norm(p["input_ln"], x, cfg.rms_norm_eps)
    n, t, _ = h.shape
    q, k, v = qkv_proj(p["attn"], cfg, h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        start = cache.length
        if cache.k_scale is not None:
            for rows, scales, new in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
                rows[layer, :, start : start + t], scales[layer, :, start : start + t] = (
                    quantize_kv(new))
        else:
            cache.k[layer, :, start : start + t] = k
            cache.v[layer, :, start : start + t] = v
    if t > 1:
        attn, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    else:
        if cache is None or decode_info is None:
            raise ValueError("a single-token step needs the cache and decode_info")
        lengths, needed, span_start = decode_info
        ck, cv = cache.k[layer], cache.v[layer]
        if cache.k_scale is not None:
            ck = dequantize_kv(ck, cache.k_scale[layer], q.dtype)
            cv = dequantize_kv(cv, cache.v_scale[layer], q.dtype)
        attn = decode_attention(q[:, 0].contiguous(), ck, cv, lengths, needed, span_start)[:, None]
    x = x + linear(p["attn"]["o"], attn.reshape(n, t, -1))
    h = rms_norm(p["post_ln"], x, cfg.rms_norm_eps)
    return x + mlp_block(p["mlp"], cfg, h)


def llama_apply(params, cfg: LMConfig, inputs_embeds: torch.Tensor,
                positions: torch.Tensor, cache: KVCache | None = None,
                decode_info=None):
    """Run the decoder stack over [N, T, D] embeddings at `positions`.

    With a cache, the new k/v rows are written at `cache.length` and the
    length advances by T. decode_info = (lengths [N] int32, needed [N]
    int32, span_start) is required for T == 1. Returns the final-norm
    hidden states [N, T, D]."""
    x = inputs_embeds
    # cast once here rather than in every layer's apply_rope (same values)
    cos, sin = (c.to(x.dtype) for c in rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta))
    for i, p in enumerate(params["layers"]):
        x = _layer(p, cfg, x, cos, sin, cache, i, decode_info)
    if cache is not None:
        cache.length += inputs_embeds.shape[1]
    return rms_norm(params["norm"], x, cfg.rms_norm_eps)


def llama_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    return linear(params["lm_head"], hidden)


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; negative ids (IMAGE_TOKEN_INDEX) clamp to 0 and are
    overwritten by the projector output before use."""
    return params["embed"][input_ids.clamp(0, params["embed"].shape[0] - 1)]
