"""K4: the whole int8 weight-only LLaMA decode step (counterpart of
`tokenpacker_tpu/ops/fused_decode.py`, T = 1 and the T = k+1 verify form).

For B samples and one token each, every layer runs RMSNorm -> fused qkv
GEMV (int8 weights, f32 per-column scales) -> RoPE -> with an int8 cache,
quantize-dequantize of the new k/v -> attention over the cache ranges
[0, len0) U [start2, end2) plus the current token -> o GEMV, residual ->
RMSNorm -> gate/up GEMV -> SiLU * up -> down GEMV, residual. The final
norm and the LM head stay outside, as in the JAX package.

On CUDA tensors `fused_decode_hidden` makes one call into
`csrc/fused_decode.cu`, which loops over the layers and enqueues a few
kernels per layer; on CPU tensors it runs `fused_decode_hidden_plain`,
the same function in plain PyTorch. Either way the new k/v rows are
written into the cache **in place** at `write_pos` (the JAX function
returns updated copies): int8 rows with their scales from
`kv_quant.quantize_kv` of the quantize-dequantized rows, or the rows
themselves in a float cache.

The kernel takes per-layer weight pointers from a table
(`FusedWeights`) that the caller builds once per parameter tree, rather
than requiring the four matrices stacked [L, K, N]: the per-layer tree of
`io/weights` stays the one layout that llama.py, the weight bridge and the
tests share, and no stacked second copy of 6.5 GB is made.

`fused_verify_hidden` is the T = k+1 verify form of speculation (K4-verify):
the same call with T fed tokens a sample, causal among themselves.

Not ported: slot-LoRA terms (`build_fd_lora`, with multi-LoRA) and the
u16-row-packed `qp` storage. The TPU-only switches (FD_PACK, FD_W8A8,
FD_DEBUG, FD_CACHE, FD_RING, FD_ATTN) have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.models.llama import rope_cos_sin
from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from tokenpacker_tpu_torch.ops.quantize import is_qleaf

HEAD_DIM = 128
# per layer: ln1, qkv q/scale, o q/scale, ln2, gateup q/scale, down q/scale
_MATRICES = (("attn", "qkv"), ("attn", "o"), ("mlp", "gateup"), ("mlp", "down"))


def fused_eligible(lm_params, cfg: LMConfig) -> bool:
    """The kernel serves llama-family MHA with head_dim 128 whose every
    layer has the fused `qkv` / `gateup` layout with int8 {q, scale}
    kernels (`io/weights.quantize_lm_int8`). The TPU's geometry gates
    (mosaic lane widths) do not apply; the kernel's 16-byte column groups
    need hidden and intermediate sizes that are multiples of 16."""
    if cfg.model_family != "llama":
        return False
    if cfg.num_attention_heads != cfg.kv_heads or cfg.head_dim != HEAD_DIM:
        return False
    if cfg.hidden_size % 16 or cfg.intermediate_size % 16:
        return False
    layers = lm_params.get("layers") or []
    if not layers:
        return False
    for layer in layers:
        if "qkv" not in layer.get("attn", {}) or "gateup" not in layer.get("mlp", {}):
            return False
        for group, name in _MATRICES:
            k = layer[group][name].get("kernel")
            if not is_qleaf(k) or k["q"].dtype != torch.int8:
                return False
    return True


class FusedWeights:
    """K4's pointer table for one parameter tree on the card: per layer the
    device addresses of ln1, qkv q/scale, o q/scale, ln2, gateup q/scale
    and down q/scale, in the order `tp_fused_decode` reads them. It holds
    the tensors, so the addresses stay valid while the table lives."""

    def __init__(self, lm_params, cfg: LMConfig):
        if not fused_eligible(lm_params, cfg):
            raise ValueError("fused_decode: the tree is not an int8 fused-layout llama tree")
        d, f = cfg.hidden_size, cfg.intermediate_size
        widths = {"qkv": (d, 3 * d), "o": (d, d), "gateup": (d, 2 * f), "down": (f, d)}
        self.layers = len(lm_params["layers"])
        pairs = []  # (tensor, dtype) in the kernel's order
        for layer in lm_params["layers"]:
            pairs.append((layer["input_ln"]["scale"], torch.bfloat16))
            for group, name in _MATRICES:
                if name == "gateup":
                    pairs.append((layer["post_ln"]["scale"], torch.bfloat16))
                k = layer[group][name]["kernel"]
                if k["q"].shape != widths[name] or k["scale"].shape != (1, widths[name][1]):
                    raise ValueError(f"fused_decode: {name} is {tuple(k['q'].shape)}, "
                                     f"scale {tuple(k['scale'].shape)}")
                pairs += [(k["q"], torch.int8), (k["scale"], torch.float32)]
        _build.cuda_args("fused_decode", **{f"weight{i}": p for i, p in enumerate(pairs)})
        self.tensors = [t for t, _ in pairs]
        self.table = (ctypes.c_void_p * len(self.tensors))(*(t.data_ptr() for t in self.tensors))


def _rms(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm as the TPU kernel computes it: f32 statistics, the normalized
    row rounded to the working dtype, then times the scale in that dtype."""
    h32 = h.float()
    y = (h32 * torch.rsqrt(h32.square().mean(-1, keepdim=True) + eps)).to(h.dtype)
    return y * w.to(h.dtype)


def _gemv(x: torch.Tensor, leaf) -> torch.Tensor:
    """x [B, K] times an int8 {q, scale} kernel: f32 sums of exact products,
    times the f32 per-column scale -> f32 [B, N]."""
    return (x.float() @ leaf["q"].float()) * leaf["scale"].float().squeeze(-2)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., H, d] f32, rotate-half RoPE in f32; cos/sin [..., 1, d]."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _qdq(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize per (row, head) as the int8-cache kernel does:
    the current token is attended through its int8 value."""
    q, scale = quantize_kv(x)
    return dequantize_kv(q, scale, x.dtype)


def fused_verify_hidden_plain(layers, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2,
                              end2, positions, k_scale=None, v_scale=None):
    """K4's function for T fed tokens per sample in plain PyTorch, rounding
    to h0's dtype where the kernel rounds to bf16. layers: the tree's layer
    list; h0 [B, T, D]; cache_k/v [L, B, S, H, d] (int8 with k_scale/v_scale
    [L, B, S, H] f32, or float); lengths0/start2/end2 [B], the cache ranges
    every fed token attends; positions [B, T]. Fed token t also attends fed
    tokens 0..t. As in the TPU kernel's T > 1 form, the fed tokens'
    probabilities are rounded to h0's dtype for the value product like the
    cache's; at T = 1 the current token's is not. Reads the cache, never
    writes it. Returns (hidden [B, T, D] before the final norm, k_new, v_new
    [L, B, T, H, d]: the new rows as attended)."""
    dt = h0.dtype
    b, t, d = h0.shape
    heads, hd, f = cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size
    s = cache_k.shape[2]
    scale = hd**-0.5
    cos, sin = (c[:, :, None] for c in rope_cos_sin(positions, hd, cfg.rope_theta))
    kpos = torch.arange(s, device=h0.device)[None, :]
    valid = (kpos < lengths0[:, None]) | ((kpos >= start2[:, None]) & (kpos < end2[:, None]))
    causal = torch.ones(t, t, dtype=torch.bool, device=h0.device).tril()
    h = h0
    k_rows, v_rows = [], []
    for i, p in enumerate(layers):
        x1 = _rms(h, p["input_ln"]["scale"], cfg.rms_norm_eps)
        q, k, v = _gemv(x1, p["attn"]["qkv"]["kernel"]).view(b, t, 3, heads, hd).unbind(2)
        q, k, v = _rope(q, cos, sin).to(dt), _rope(k, cos, sin).to(dt), v.to(dt)
        ck, cv = cache_k[i], cache_v[i]
        if k_scale is not None:
            k, v = _qdq(k), _qdq(v)
            ck, cv = dequantize_kv(ck, k_scale[i], dt), dequantize_kv(cv, v_scale[i], dt)
        logits = torch.einsum("bthd,bshd->bhts", q.float(), ck.float()) * scale
        logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        fed = torch.einsum("bthd,buhd->bhtu", q.float(), k.float()) * scale
        fed = fed.masked_fill(~causal, float("-inf"))
        m = torch.maximum(logits.amax(-1), fed.amax(-1))  # [B, H, T]
        p_ = torch.exp(logits - m[..., None])
        p_fed = torch.exp(fed - m[..., None])
        den = p_.sum(-1) + p_fed.sum(-1)
        ctx = torch.einsum("bhts,bshd->bthd", p_.to(dt).float(), cv.float())
        ctx = ctx + torch.einsum("bhtu,buhd->bthd", p_fed.to(dt).float() if t > 1 else p_fed,
                                 v.float())
        attn = (ctx / den.transpose(1, 2)[..., None]).to(dt).reshape(b, t, d)
        h = h + _gemv(attn, p["attn"]["o"]["kernel"]).to(dt)
        gate, up = _gemv(_rms(h, p["post_ln"]["scale"], cfg.rms_norm_eps),
                     p["mlp"]["gateup"]["kernel"]).split(f, dim=-1)
        h = h + _gemv((F.silu(gate) * up).to(dt), p["mlp"]["down"]["kernel"]).to(dt)
        k_rows.append(k)
        v_rows.append(v)
    return h, torch.stack(k_rows), torch.stack(v_rows)


def fused_decode_hidden_plain(layers, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2,
                              end2, positions, k_scale=None, v_scale=None):
    """K4's one-token function in plain PyTorch: `fused_verify_hidden_plain`
    at T = 1. h0 [B, D]; positions [B]. Returns (hidden [B, D] before the
    final norm, k_new, v_new [L, B, H, d]: the new rows as attended)."""
    hidden, k_new, v_new = fused_verify_hidden_plain(
        layers, cfg, h0[:, None], cache_k, cache_v, lengths0, start2, end2, positions[:, None],
        k_scale, v_scale)
    return hidden[:, 0], k_new[:, :, 0], v_new[:, :, 0]


def write_rows(cache_k, cache_v, k_scale, v_scale, k_new, v_new, write_pos) -> None:
    """Store the new rows [L, B, T, H, d] (or [L, B, H, d], T = 1) at cache
    slots write_pos[b] + t, in place; slots at or past the cache's end are
    dropped, as the kernel drops them."""
    if k_new.dim() == 4:
        k_new, v_new = k_new[:, :, None], v_new[:, :, None]
    b, t = k_new.shape[1:3]
    cols = write_pos.long()[:, None] + torch.arange(t, device=k_new.device)
    rows = torch.arange(b, device=k_new.device)[:, None].expand(b, t)
    keep = cols < cache_k.shape[2]
    rows, cols = rows[keep], cols[keep]
    k_new, v_new = k_new[:, keep], v_new[:, keep]
    if k_scale is not None:
        for cache, scales, new in ((cache_k, k_scale, k_new), (cache_v, v_scale, v_new)):
            cache[:, rows, cols], scales[:, rows, cols] = quantize_kv(new)
    else:
        cache_k[:, rows, cols] = k_new.to(cache_k.dtype)
        cache_v[:, rows, cols] = v_new.to(cache_v.dtype)


def _fused_call(lm_params, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2, end2,
                write_pos, positions, k_scale, v_scale, weights, t_tok: int):
    """One `tp_fused_decode` call over h0 [B * t_tok, D] (sample-major),
    positions [B * t_tok]; returns (hidden, k_new, v_new [L, B * t_tok, H,
    d])."""
    weights = weights or FusedWeights(lm_params, cfg)
    layers, b, s, hkv, hd = cache_k.shape
    d, f, heads = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    rows = b * t_tok
    if (h0.shape != (rows, d) or positions.shape != (rows,) or cache_v.shape != cache_k.shape
            or weights.layers != layers):
        raise ValueError(f"fused_decode: h0 {tuple(h0.shape)}, positions "
                         f"{tuple(positions.shape)}, cache {tuple(cache_k.shape)}, "
                         f"{weights.layers} weight layers, {t_tok} tokens a sample")
    int8 = cache_k.dtype == torch.int8
    bf, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    cache_dt = torch.int8 if int8 else bf
    tensors = dict(h0=(h0, bf), cache_k=(cache_k, cache_dt), cache_v=(cache_v, cache_dt),
                   lengths0=(lengths0, i32), start2=(start2, i32), end2=(end2, i32),
                   write_pos=(write_pos, i32), positions=(positions, i32))
    if int8:
        if k_scale is None or v_scale is None or k_scale.shape != cache_k.shape[:-1]:
            raise ValueError("fused_decode: an int8 cache needs k_scale/v_scale [L, B, S, H]")
        tensors.update(k_scale=(k_scale, f32), v_scale=(v_scale, f32))
    stream = _build.cuda_args("fused_decode", **tensors)
    lib = _build.library()
    hidden = h0.clone()
    k_new = torch.empty((layers, rows, hkv, hd), dtype=bf, device=h0.device)
    v_new = torch.empty_like(k_new)
    work = torch.empty(lib.tp_fused_decode_workspace(rows, d, f), dtype=torch.uint8,
                       device=h0.device)
    rc = lib.tp_fused_decode(
        weights.table, layers, b, t_tok, d, f, heads, hd, s, cfg.rms_norm_eps, cfg.rope_theta,
        hidden.data_ptr(), lengths0.data_ptr(), start2.data_ptr(), end2.data_ptr(),
        write_pos.data_ptr(), positions.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None, int(int8),
        k_new.data_ptr(), v_new.data_ptr(), work.data_ptr(), stream,
    )
    _build.check(rc, "fused_decode")
    return hidden, k_new, v_new


def _check_tree(lm_params, cfg: LMConfig, weights) -> None:
    if weights is None and not fused_eligible(lm_params, cfg):  # a table was checked when built
        raise NotImplementedError("K4 takes llama MHA trees with head_dim 128 and int8 fused "
                                  "{q, scale} kernels (no u16-packed qp storage)")


def fused_decode_hidden(lm_params, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2, end2,
                        write_pos, positions, *, k_scale=None, v_scale=None, slot_lora=None,
                        weights: FusedWeights | None = None):
    """One decode step of the whole decoder stack.

    h0 [B, D] embedded tokens; cache_k/v [L, B, S, H, 128] int8 (with
    k_scale/v_scale [L, B, S, H] f32) or bf16; lengths0/start2/end2 the
    attendable cache ranges [0, len0) U [start2, end2) (the current token
    is always attended); write_pos the cache slot of the new row; positions
    the RoPE positions; all [B] int32. weights: `FusedWeights` of
    `lm_params`, built here when not given. Writes the new rows into the
    cache in place and returns (hidden [B, D] before the final norm, k_new,
    v_new [L, B, H, 128])."""
    if slot_lora is not None:
        raise NotImplementedError("slot-LoRA terms in K4 come with multi-LoRA serving")
    if h0.dim() != 2:
        raise ValueError(f"fused_decode_hidden: h0 is {tuple(h0.shape)}, expected [B, D]; "
                         "T fed tokens a sample go through fused_verify_hidden")
    _check_tree(lm_params, cfg, weights)
    if h0.device.type == "cpu":
        hidden, k_new, v_new = fused_decode_hidden_plain(
            lm_params["layers"], cfg, h0, cache_k, cache_v, lengths0, start2, end2, positions,
            k_scale, v_scale,
        )
        write_rows(cache_k, cache_v, k_scale, v_scale, k_new, v_new, write_pos)
        return hidden, k_new, v_new
    out = _fused_call(lm_params, cfg, h0, cache_k, cache_v, lengths0, start2, end2, write_pos,
                      positions, k_scale, v_scale, weights, 1)
    fused_decode_hidden.launches += 1
    return out


def fused_verify_hidden(lm_params, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2, end2,
                        write_pos0, positions, *, k_scale=None, v_scale=None, slot_lora=None,
                        weights: FusedWeights | None = None):
    """The whole decoder stack for T fed tokens a sample (speculative
    verify: the last accepted token and its drafts, through one pass of the
    weights).

    h0 [B, T, D] embedded tokens; positions [B, T] their RoPE positions;
    lengths0/start2/end2 [B] the cache ranges [0, len0) U [start2, end2)
    that all T queries attend; fed token t also attends fed tokens 0..t and
    writes its row at cache slot write_pos0 + t (a slot past the cache's
    end is dropped). The cache as in `fused_decode_hidden`, written in
    place. Returns (hidden [B, T, D] before the final norm, k_new, v_new
    [L, B, T, H, 128])."""
    if slot_lora is not None:
        raise NotImplementedError("slot-LoRA terms in K4 come with multi-LoRA serving")
    if h0.dim() != 3:
        raise ValueError(f"fused_verify_hidden: h0 is {tuple(h0.shape)}, expected [B, T, D]")
    _check_tree(lm_params, cfg, weights)
    b, t, d = h0.shape
    if h0.device.type == "cpu":
        hidden, k_new, v_new = fused_verify_hidden_plain(
            lm_params["layers"], cfg, h0, cache_k, cache_v, lengths0, start2, end2, positions,
            k_scale, v_scale,
        )
        write_rows(cache_k, cache_v, k_scale, v_scale, k_new, v_new, write_pos0)
        return hidden, k_new, v_new
    hidden, k_new, v_new = _fused_call(
        lm_params, cfg, h0.reshape(b * t, d), cache_k, cache_v, lengths0, start2, end2,
        write_pos0, positions.reshape(b * t).contiguous(), k_scale, v_scale, weights, t)
    fused_verify_hidden.launches += 1
    layers = k_new.shape[0]
    return (hidden.view(b, t, d), k_new.view(layers, b, t, *k_new.shape[2:]),
            v_new.view(layers, b, t, *v_new.shape[2:]))


fused_verify_hidden.launches = 0
fused_decode_hidden.launches = 0
