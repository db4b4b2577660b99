"""LLaMA / Vicuna decoder (counterpart of `tokenpacker_tpu/models/llama.py`).

Parameters are dicts of tensors with the layers as a list (the JAX
package stacks them on a leading axis for `lax.scan`). Both projection
layouts are served: unfused q/k/v and gate/up, and the fused `qkv` /
`gateup` of `ops/quantize.fuse_llama_layers` (the int8 serving tree).
Attention runs on the port's kernels:

- prefill and training (T > 1): K2 with a pure causal mask over the
  current tokens, through `FlashAttention` (K2's forward, and its
  backward when a gradient is asked for). That is exact for right-padded
  batches: pad keys come after every valid query, and pad rows' outputs
  are never read (their labels are IGNORE_INDEX).
- a chunk over a cache at an offset (T > 1 with `attn_bias`, the
  additive fp32 bias of `make_attention_bias`): the chunk's rows are
  written first (quantized for an int8 cache), then `sdpa`, the masked
  softmax attention of the JAX package's `_sdpa`, runs over the whole
  cache layer, dequantized for an int8 cache. The JAX package computes
  this in XLA outside any Pallas kernel; here it is plain PyTorch
  (`generate.prefill_chunk`, the paged admissions).
- decode (T == 1): K3 over the cache with `decode_info = (lengths,
  needed, span_start)`, the two valid ranges of `generate.decode_step`.
  An int8 cache is dequantized layer by layer before K3, as the JAX
  package dequantizes before its attention. (Eligible int8 trees decode
  through K4 instead, `generate._decode_step_fused`.)

The other family, MPT (ALiBi through K2's key-only bias and K3's
slopes), is `models/mpt.py`; `models/lm_api` dispatches between them.

Per-layer rematerialization of the cache-less (training) path is the
explicit `remat` argument of `llama_apply` (the JAX package reads
TOKENPACKER_REMAT): "" off; "full" checkpoints every layer
(`torch.utils.checkpoint`, non-reentrant); "dots" saves the outputs of
the projection products (`aten.mm` / `aten.addmm`) and recomputes the
rest, attention included, as `dots_with_no_batch_dims_saveable` does;
"dots:K" is full on the first L-K layers and dots on the last K.

The KV cache is preallocated and **written in place**: a layer stores
its new k/v rows into `cache.k[layer]` / `cache.v[layer]` at
`cache.length`, where the JAX package returns an updated copy. An int8
cache stores `ops/kv_quant.quantize_kv` of the rows with their scales.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
from tokenpacker_tpu_torch.ops.flash_attention import FlashAttention
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from tokenpacker_tpu_torch.ops.layers import linear, rms_norm, row_linear, silu
from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel.sharding import (
    gather_features,
    gathered,
    gathered_leaf,
    head_axis,
    local_lm_config,
)


@dataclass
class KVCache:
    k: torch.Tensor  # [L, N, S_max, kv_heads, head_dim], the model dtype or int8
    v: torch.Tensor
    # positions [0, length) hold keys; an [N] int tensor of per-sample
    # lengths for the continuous batchers' slot caches
    length: int | torch.Tensor
    # per-(position, kv head) scales of an int8 cache: [L, N, S_max,
    # kv_heads] f32; None for a float cache
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: torch.device | str = "cpu") -> "KVCache":
        """A zeroed cache; int8 storage is llama's only (an MPT cache keeps
        the model dtype, as in the JAX package, and int8 raises)."""
        if dtype == torch.int8 and cfg.model_family == "mpt":
            raise ValueError("an MPT KV cache keeps the model dtype: kv_cache_dtype=torch.int8 "
                             "is llama-only")
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

    def write_index(self, n: int, t: int):
        """Where a layer's [N, T] new rows go in its [N, S_max] cache rows:
        [length, length + T) for every sample, or [length[i], length[i] +
        T) for sample i when the length is a tensor."""
        start = self.length
        if isinstance(start, torch.Tensor):
            cols = start.long()[:, None] + torch.arange(t, device=start.device)
            return torch.arange(n, device=start.device)[:, None], cols
        return slice(None), slice(start, start + t)


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


def qkv_proj(p_attn, cfg: LMConfig, h: torch.Tensor, w8a8: bool = False):
    """h [N, T, D] -> q [N, T, H, d], k/v [N, T, Hkv, d], from the unfused
    q/k/v layout or the fused `qkv` one."""
    n, t, _ = h.shape
    heads = (cfg.num_attention_heads, cfg.kv_heads, cfg.kv_heads)
    if "qkv" in p_attn:
        parts = linear(p_attn["qkv"], h, w8a8).split([x * cfg.head_dim for x in heads], dim=-1)
    else:
        parts = [linear(p_attn[name], h, w8a8) for name in ("q", "k", "v")]
    return tuple(x.reshape(n, t, hh, cfg.head_dim) for x, hh in zip(parts, heads))


def mlp_block(p_mlp, cfg: LMConfig, h: torch.Tensor, w8a8: bool = False) -> torch.Tensor:
    """SwiGLU MLP, gate/up or the fused `gateup` layout; tensor-parallel
    over `cfg.mlp_axis` on a rank's slice of the width (a
    `parallel/sharding.LocalLMConfig`)."""
    axis = getattr(cfg, "mlp_axis", None)
    h = comm.copy_to(h, axis)
    if "gateup" in p_mlp:
        gate, up = linear(p_mlp["gateup"], h, w8a8).split(cfg.intermediate_size, dim=-1)
    else:
        gate, up = linear(p_mlp["gate"], h, w8a8), linear(p_mlp["up"], h, w8a8)
    return row_linear(p_mlp["down"], silu(gate) * up, axis, w8a8)


def attn_out(p_attn, cfg: LMConfig, attn: torch.Tensor, w8a8: bool = False) -> torch.Tensor:
    """The `o` product of [N, T, H * d] attention rows, all-reduced over
    `cfg.attn_axis` in a tensor-parallel block."""
    return row_linear(p_attn["o"], attn, getattr(cfg, "attn_axis", None), w8a8)


def make_attention_bias(positions: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
    """Additive fp32 bias [N, 1, T, S]: 0 where key slot j is valid
    (key_valid [N, S]) and j <= the query's position (positions [N, T],
    the cache offset already included), else the fp32 minimum. (The JAX
    package's signature also takes a cache length it does not use and
    S, which is key_valid's width.)"""
    key_pos = torch.arange(key_valid.shape[1], device=positions.device)[None, None, :]
    ok = (key_pos <= positions[..., None]) & key_valid[:, None, :]
    return torch.where(ok[:, None], 0.0, torch.finfo(torch.float32).min)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_sdpa`: q [N, T, H, d], k/v [N, S, Hkv, d], bias
    [N, 1, T, S] fp32. Logits in q's dtype scaled by d^-0.5, then fp32
    plus the bias, softmax, probabilities cast to q's dtype for the value
    product. GQA groups the query heads instead of repeating K/V."""
    n, t, h, d = q.shape
    hkv = k.shape[2]
    qg = q.view(n, t, hkv, h // hkv, d)
    logits = torch.einsum("ntkgd,nskd->nkgts", qg, k) * d**-0.5
    probs = torch.softmax(logits.float() + bias[:, :, None], dim=-1).to(q.dtype)
    return torch.einsum("nkgts,nskd->ntkgd", probs, v).reshape(n, t, h, d)


def _layer(p, cfg: LMConfig, x, cos, sin, cache: KVCache | None, layer: int,
           decode_info=None, attn_bias=None, w8a8: bool = False):
    p = gathered(p)
    h = rms_norm(p["input_ln"], x, cfg.rms_norm_eps)
    n, t, _ = h.shape
    h = comm.copy_to(h, getattr(cfg, "attn_axis", None))
    q, k, v = qkv_proj(p["attn"], cfg, h, w8a8)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        at = cache.write_index(n, t)
        if cache.k_scale is not None:
            for rows, scales, new in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
                rows[layer][at], scales[layer][at] = quantize_kv(new)
        else:
            cache.k[layer][at] = k
            cache.v[layer][at] = v
    if t > 1 and attn_bias is not None:
        if cache is None:
            raise ValueError("attn_bias is for a chunk over a cache")
        ck, cv = cache.k[layer], cache.v[layer]
        if cache.k_scale is not None:
            ck = dequantize_kv(ck, cache.k_scale[layer], q.dtype)
            cv = dequantize_kv(cv, cache.v_scale[layer], q.dtype)
        attn = sdpa(q, ck.to(q.dtype), cv.to(q.dtype), attn_bias)
    elif t > 1:
        attn = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), True)
    else:
        if cache is None or decode_info is None:
            raise ValueError("a single-token step needs the cache and decode_info")
        lengths, needed, span_start = decode_info
        ck, cv = cache.k[layer], cache.v[layer]
        if cache.k_scale is not None:
            ck = dequantize_kv(ck, cache.k_scale[layer], q.dtype)
            cv = dequantize_kv(cv, cache.v_scale[layer], q.dtype)
        attn = decode_attention(q[:, 0].contiguous(), ck, cv, lengths, needed, span_start)[:, None]
    x = x + attn_out(p["attn"], cfg, attn.reshape(n, t, -1), w8a8)
    h = rms_norm(p["post_ln"], x, cfg.rms_norm_eps)
    return x + mlp_block(p["mlp"], cfg, h, w8a8)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_layers(remat: str, n_layers: int) -> list[str]:
    """The checkpoint mode of each layer ("", "full" or "dots") for a
    `remat` argument; raises on an unknown one."""
    if remat in ("", "full", "dots"):
        return [remat] * n_layers
    head, _, k = remat.partition(":")
    if head != "dots" or not k.isdigit():
        raise ValueError(f"remat={remat!r}: expected '', 'full', 'dots' or 'dots:K'")
    k = min(int(k), n_layers)
    return ["full"] * (n_layers - k) + ["dots"] * k


def llama_apply(params, cfg: LMConfig, inputs_embeds: torch.Tensor,
                positions: torch.Tensor, cache: KVCache | None = None,
                decode_info=None, remat: str = "", attn_bias: torch.Tensor | None = None,
                w8a8: bool = False):
    """Run the decoder stack over [N, T, D] embeddings at `positions`.

    With a cache, the new k/v rows are written at `cache.length` (per
    sample for a tensor of lengths) and the length advances by T. decode_info = (lengths [N] int32, needed [N]
    int32, span_start) is required for T == 1. attn_bias [N, 1, T, S]
    (`make_attention_bias`) sends T > 1 through `sdpa` over the whole
    cache instead of K2 over the current tokens. `remat` applies to the
    cache-less path only (module docstring). `w8a8`: `ops/layers.linear`'s
    w8a8 mode for the int8 kernels. Returns the final-norm hidden states
    [N, T, D]. A tree of `parallel/sharding.shard_params` runs as this
    rank's part (`local_lm_config`)."""
    cfg = local_lm_config(cfg, params)
    x = inputs_embeds
    # cast once here rather than in every layer's apply_rope (same values)
    cos, sin = (c.to(x.dtype) for c in rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta))
    modes = remat_layers(remat, len(params["layers"]))
    for i, p in enumerate(params["layers"]):
        if cache is None and modes[i]:
            selective = {"context_fn": _dots_context} if modes[i] == "dots" else {}
            x = checkpoint(_layer, p, cfg, x, cos, sin, None, i, None, None, w8a8,
                           use_reentrant=False, **selective)
        else:
            x = _layer(p, cfg, x, cos, sin, cache, i, decode_info, attn_bias, w8a8)
    if cache is not None:
        # not in place: a tensor of lengths may be the caller's
        cache.length = cache.length + inputs_embeds.shape[1]
    return rms_norm(params["norm"], x, cfg.rms_norm_eps)


def _payload(kernel):
    """The tensor that carries a kernel's placement (a quantized leaf's
    int8 or 4-bit payload)."""
    if isinstance(kernel, dict):
        return kernel["q"] if "q" in kernel else next(
            (v for k, v in kernel.items() if k.startswith("q4:")), None)
    return kernel


def llama_logits(params, hidden: torch.Tensor, w8a8: bool = False) -> torch.Tensor:
    """The head; vocab-parallel logits are gathered over 'model'."""
    head = params["lm_head"]
    hidden = comm.copy_to(hidden, head_axis(_payload(head["kernel"])))
    y = linear(gathered(head), hidden, w8a8)
    return gather_features(y, _payload(head["kernel"]))


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; negative ids (IMAGE_TOKEN_INDEX) clamp to 0 and are
    overwritten by the projector output before use. A sharded table's
    features are gathered over 'model' after the lookup."""
    table = gathered_leaf(params["embed"])
    x = table[input_ids.clamp(0, table.shape[0] - 1)]
    return gather_features(x, params["embed"])
