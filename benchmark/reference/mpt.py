"""MPT-7B's decoder (mosaicml/mpt-7b, `MPTForCausalLM` with `attn_config.alibi`,
`no_bias`): pre-LN blocks of LayerNorm without bias, packed QKV attention
whose logits gain ALiBi's -slope_h * (i - j), a residual, LayerNorm, an MLP
of up (4x), exact GELU and down, a residual; a final LayerNorm and logits
tied to the embedding. No positional embedding."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def alibi_slopes(heads: int, alibi_bias_max: float = 8.0) -> torch.Tensor:
    """MPT's `gen_slopes`: 2^(-alibi_bias_max * i / n) for i = 1..n, n the power
    of two at or above the head count, interleaved when they differ."""
    n = 2 ** math.ceil(math.log2(heads))
    m = torch.arange(1, n + 1, dtype=torch.float32) * (alibi_bias_max / n)
    s = 1.0 / torch.pow(2.0, m)
    if n != heads:
        s = torch.cat([s[1::2], s[::2]])[:heads]
    return s


def _ln(x, scale, eps):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), None, eps)


def hidden(lm: dict, c: dict, x: torch.Tensor, prec) -> torch.Tensor:
    """x [N, T, D] float32 input embeddings (right-padded: no valid query
    sees a later key) -> final-norm hidden states [N, T, D]."""
    n, t, d = x.shape
    h = c["n_heads"]
    hd = d // h
    eps = c["layer_norm_epsilon"]
    pos = torch.arange(t, device=x.device)
    dist = (pos[:, None] - pos[None, :]).float()  # i - j
    bias = -alibi_slopes(h, c["alibi_bias_max"]).to(x.device)[:, None, None] * dist
    bias = bias.masked_fill(dist < 0, float("-inf"))  # causal
    for lp in lm["layers"]:
        y = _ln(x, lp["norm_1"]["scale"], eps)
        q, k, v = (z.reshape(n, t, h, hd).transpose(1, 2)
                   for z in prec.linear(y, lp["attn"]["wqkv"]["kernel"]).split(d, dim=-1))
        att = torch.softmax(prec.bmm(q, k.transpose(-1, -2)) * hd**-0.5 + bias, dim=-1)
        o = prec.bmm(att, v).transpose(1, 2).reshape(n, t, d)
        x = x + prec.linear(o, lp["attn"]["out"]["kernel"])
        y = _ln(x, lp["norm_2"]["scale"], eps)
        x = x + prec.linear(F.gelu(prec.linear(y, lp["ffn"]["up"]["kernel"])),
                            lp["ffn"]["down"]["kernel"])
    return _ln(x, lm["norm_f"]["scale"], eps)


def logits(lm: dict, hid: torch.Tensor, prec) -> torch.Tensor:
    """Tied head: hidden [..., D] -> [..., V]."""
    return prec.linear(hid, lm["wte"].T)


def upcast(lm: dict) -> dict:
    """The decoder's weights as float32 tensors (kept for a backward pass)."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x.float()
    return walk(lm)
