"""MPT decoder family (counterpart of `tokenpacker_tpu/models/mpt.py`):
ALiBi attention, no positional embeddings, tied logits.

Pre-LN blocks: LayerNorm -> packed-QKV attention with the ALiBi bias ->
residual -> LayerNorm -> MLP (up, exact GELU, down) -> residual; no
biases in the projections (`no_bias`, MPT-7B). The logits are h @ wte^T
(`mpt_logits`), so the tied `wte` receives both gradients in training.
Parameters are dicts of tensors, the layers a list: `wte`, `layers[*]
.{norm_1, attn.{wqkv, out}, norm_2, ffn.{up, down}}`, `norm_f`.

ALiBi adds slope_h * key_position to every logit. A row-constant shift
cancels in the softmax, so the key-only form equals the |i - j| form under
a causal mask, and only key positions matter. Attention routes as in
`models/llama.py`:

- prefill and training (T > 1, no `attn_bias`): K2 with the key-only
  bias `alibi_bias(H, T)` over the current tokens, through
  `FlashAttention` (K2's bias forward, and its bias backward when a
  gradient is asked for). The JAX package's cached prefill instead runs
  `_sdpa` over all S cache slots with `attn_bias + alibi_bias(S)`. The
  two are equal: ALiBi over keys is shift-invariant under the softmax,
  and in a right-padded causal batch no valid query sees a pad key (pad
  rows' outputs are never read).
- a chunk at an offset and the speculative verify (T > 1 with
  `attn_bias`): plain `sdpa` over the whole cache layer with `attn_bias
  + alibi_bias_from_positions(key_positions)`, as the JAX package
  computes it in XLA. key_positions [N, S] defaults to the slot indices.
- decode (T == 1): K3 with `slopes = alibi_slopes(H)` and `decode_info`;
  the kernel compacts the bucketed layout's key positions itself
  (`ops/decode_attention`).

The KV cache is `models/llama.KVCache` in the model dtype (the JAX
package keeps float caches for MPT); an int8 cache raises. There is no
rematerialization (the JAX package's `mpt_apply` has none).

Every product goes through `ops/layers.linear`, so a quantized LM
(`io/weights.quantize_lm_int8` / `quantize_lm_4bit`, as the JAX `api.py`
quantizes the unfused MPT tree) runs on the repo's kernels: K6 for a
4-bit product of at most 32 rows, K7 / K8 for int8 ones in the w8a8 mode.
`wte` is no kernel, so it stays dense and the logits a dense product.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.models.llama import KVCache, sdpa
from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
from tokenpacker_tpu_torch.ops.flash_attention import FlashAttention
from tokenpacker_tpu_torch.ops.layers import gelu, layer_norm, linear, row_linear
from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel.sharding import (
    gather_features,
    gathered,
    gathered_leaf,
    local_lm_config,
)


def mpt_config(d_model=4096, n_heads=32, n_layers=32, expansion_ratio=4, vocab_size=50432,
               max_seq_len=2048) -> LMConfig:
    """MPT-7B by default (`mpt_config()` of the JAX package)."""
    return LMConfig(
        vocab_size=vocab_size,
        hidden_size=d_model,
        intermediate_size=expansion_ratio * d_model,
        num_hidden_layers=n_layers,
        num_attention_heads=n_heads,
        max_position_embeddings=max_seq_len,
        model_family="mpt",
        alibi=True,
        no_bias=True,
        tie_word_embeddings=True,
        bos_token_id=0,
        eos_token_id=0,
        pad_token_id=0,
    )


def alibi_slopes(n_heads: int, alibi_bias_max: float = 8.0, device=None) -> torch.Tensor:
    """[H] fp32 slopes (MPT's gen_slopes): 2^-(8 i / n2) for i = 1..n2, n2
    the power of two at or above H, interleaved (odd then even entries)
    when H is not a power of two."""
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n2 + 1, dtype=torch.float32, device=device) * (alibi_bias_max / n2)
    slopes = 1.0 / torch.pow(2.0, m)
    if n2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes


def alibi_bias(n_heads: int, s_total: int, device=None) -> torch.Tensor:
    """[1, H, 1, S] fp32 key-position bias slope * (j - S + 1)."""
    pos = torch.arange(1 - s_total, 1, dtype=torch.float32, device=device)
    return alibi_slopes(n_heads, device=device)[None, :, None, None] * pos[None, None, None, :]


def alibi_bias_from_positions(n_heads: int, key_positions: torch.Tensor) -> torch.Tensor:
    """[N, H, 1, S] fp32 ALiBi bias slope * key_position from the keys' true
    token positions [N, S] (which differ from cache slots in the bucketed
    decode layout)."""
    slopes = alibi_slopes(n_heads, device=key_positions.device)
    return slopes[None, :, None, None] * key_positions.float()[:, None, None, :]


def make_prefix_lm_bias(positions: torch.Tensor, key_valid: torch.Tensor,
                        prefix_lengths: torch.Tensor, s_total: int) -> torch.Tensor:
    """Prefix-LM additive bias [N, 1, T, S] fp32: bidirectional within the
    first prefix_lengths[n] keys, causal after, 0 where allowed and the
    fp32 minimum elsewhere. positions [N, T]; key_valid [N, S]. Such a bias
    runs only through the `attn_bias` route (K2's key-only form cannot hold
    it)."""
    key_pos = torch.arange(s_total, device=positions.device)[None, :]
    causal = key_pos[:, None, :] <= positions[..., None]
    in_prefix = key_pos[:, None, :] < prefix_lengths[:, None, None]
    ok = (causal | in_prefix) & key_valid[:, None, :]
    return torch.where(ok[:, None], 0.0, torch.finfo(torch.float32).min)


def init_mpt(cfg: LMConfig, generator: torch.Generator, dtype=torch.float32):
    """Random MPT parameters made on the generator's device, as the JAX
    `init_mpt`: kernels and `wte` N(0, 0.02^2), norms scale 1 and bias 0."""
    if not cfg.no_bias:
        raise NotImplementedError("MPT with biases is not supported (MPT-7B uses no_bias)")
    device = generator.device

    def normal(*shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return x.mul_(0.02).to(dtype)

    def norm(n):
        return {"scale": torch.ones(n, dtype=dtype, device=device),
                "bias": torch.zeros(n, dtype=dtype, device=device)}

    d, f = cfg.hidden_size, cfg.intermediate_size
    return {
        "wte": normal(cfg.vocab_size, d),
        "layers": [
            {
                "norm_1": norm(d),
                "attn": {"wqkv": {"kernel": normal(d, 3 * d)}, "out": {"kernel": normal(d, d)}},
                "norm_2": norm(d),
                "ffn": {"up": {"kernel": normal(d, f)}, "down": {"kernel": normal(f, d)}},
            }
            for _ in range(cfg.num_hidden_layers)
        ],
        "norm_f": norm(d),
    }


def _layer(p, cfg: LMConfig, x, cache: KVCache | None, layer: int, route: dict, w8a8: bool):
    p = gathered(p)
    n, t, _ = x.shape
    h, hd = cfg.num_attention_heads, cfg.head_dim
    attn_axis, mlp_axis = getattr(cfg, "attn_axis", None), getattr(cfg, "mlp_axis", None)
    y = comm.copy_to(layer_norm(p["norm_1"], x), attn_axis)
    q, k, v = (z.reshape(n, t, h, hd)
               for z in linear(p["attn"]["wqkv"], y, w8a8).split(h * hd, dim=-1))
    if cache is not None:
        at = cache.write_index(n, t)
        cache.k[layer][at] = k
        cache.v[layer][at] = v
    if "bias" in route:
        attn = sdpa(q, cache.k[layer].to(q.dtype), cache.v[layer].to(q.dtype), route["bias"])
    elif t > 1:
        attn = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), True,
                                    route["flash_bias"])
    else:
        lengths, needed, span_start = route["decode_info"]
        attn = decode_attention(q[:, 0].contiguous(), cache.k[layer], cache.v[layer], lengths,
                                needed, span_start, route["slopes"])[:, None]
    x = x + row_linear(p["attn"]["out"], attn.reshape(n, t, h * hd), attn_axis, w8a8)
    y = comm.copy_to(layer_norm(p["norm_2"], x), mlp_axis)
    return x + row_linear(p["ffn"]["down"], gelu(linear(p["ffn"]["up"], y, w8a8)), mlp_axis, w8a8)


def mpt_apply(params, cfg: LMConfig, inputs_embeds: torch.Tensor, cache: KVCache | None = None,
              decode_info=None, remat: str = "", attn_bias: torch.Tensor | None = None,
              key_positions: torch.Tensor | None = None, w8a8: bool = False):
    """Run the decoder stack over [N, T, D] embeddings (module docstring for
    the routes). With a cache the new k/v rows are written at
    `cache.length` (per sample for a tensor of lengths) and the length
    advances by T. decode_info = (lengths, needed, span_start) is required
    for T == 1. attn_bias [N, 1, T, S] (causal and padding, or
    `make_prefix_lm_bias`) sends T > 1 through `sdpa` over the whole cache,
    with ALiBi over `key_positions` [N, S] (the slot indices by default).
    Returns the final-norm hidden states [N, T, D]."""
    if remat:
        raise ValueError(f"remat={remat!r}: MPT has no rematerialization (nor has the JAX "
                         "package's mpt_apply)")
    if cache is not None and cache.k_scale is not None:
        raise ValueError("MPT keeps a float KV cache (the model dtype), not int8")
    cfg = local_lm_config(cfg, params)
    n, t, _ = inputs_embeds.shape
    # a tensor-parallel rank's heads are [off, off + h) of the model's
    h = getattr(cfg, "full_heads", 0) or cfg.num_attention_heads
    off = getattr(cfg, "head_offset", 0)
    mine = slice(off, off + cfg.num_attention_heads)
    device = inputs_embeds.device
    if t > 1 and attn_bias is not None:
        if cache is None:
            raise ValueError("attn_bias is for a chunk over a cache")
        if key_positions is None:
            key_positions = torch.arange(cache.k.shape[2], device=device).expand(n, -1)
        # [N, H, T, S]: `sdpa` adds it per head (MHA: one query head a kv head)
        route = {"bias": attn_bias + alibi_bias_from_positions(h, key_positions)[:, mine]}
    elif t > 1:
        route = {"flash_bias": alibi_bias(h, t, device)[:, mine].contiguous()}
    else:
        if cache is None or decode_info is None:
            raise ValueError("a single-token step needs the cache and decode_info")
        route = {"decode_info": decode_info,
                 "slopes": alibi_slopes(h, device=device)[mine].contiguous()}
    x = inputs_embeds
    for i, p in enumerate(params["layers"]):
        x = _layer(p, cfg, x, cache, i, route, w8a8)
    if cache is not None:
        # not in place: a tensor of lengths may be the caller's
        cache.length = cache.length + t
    return layer_norm(params["norm_f"], x)


def mpt_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """Weight-tied logits: h @ wte^T (a sharded wte gathered whole)."""
    return hidden @ gathered_leaf(params["wte"], full=True).T


def mpt_embed(params, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; negative ids (IMAGE_TOKEN_INDEX) clamp to 0 and are
    overwritten by the projector output before use."""
    table = gathered_leaf(params["wte"])
    return gather_features(table[input_ids.clamp(0, table.shape[0] - 1)], params["wte"])


def import_mpt(sd, cfg: LMConfig, dtype=torch.float32):
    """An HF / vendored MPT state dict (`transformer.wte`,
    `transformer.blocks.{i}.{norm_1, attn.Wqkv, attn.out_proj, norm_2,
    ffn.up_proj, ffn.down_proj}`, `transformer.norm_f`; torch tensors or
    numpy arrays) -> the port's MPT parameters on the CPU. Linear weights
    are [out, in] there and [in, out] here; the norms have no bias
    (`no_bias`), so theirs is zero."""

    def t(name):
        x = sd[name]
        x = x.detach().float() if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x, np.float32))
        return x.to(dtype)

    def norm(name):
        scale = t(f"{name}.weight")
        return {"scale": scale, "bias": torch.zeros_like(scale)}

    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"transformer.blocks.{i}"
        layers.append({
            "norm_1": norm(f"{b}.norm_1"),
            "attn": {"wqkv": {"kernel": t(f"{b}.attn.Wqkv.weight").T.contiguous()},
                     "out": {"kernel": t(f"{b}.attn.out_proj.weight").T.contiguous()}},
            "norm_2": norm(f"{b}.norm_2"),
            "ffn": {"up": {"kernel": t(f"{b}.ffn.up_proj.weight").T.contiguous()},
                    "down": {"kernel": t(f"{b}.ffn.down_proj.weight").T.contiguous()}},
        })
    return {"wte": t("transformer.wte.weight"), "layers": layers,
            "norm_f": norm("transformer.norm_f")}
