"""CLIP ViT vision tower (counterpart of `tokenpacker_tpu/models/clip_vit.py`).

HF `CLIPVisionModel` semantics: patch embed as a matmul over HF's conv
flatten order (no bias), CLS + learned positions, pre-LayerNorm, pre-LN
blocks with quick-GELU MLPs. Attention runs on K1 (`ops/vit_attention`);
with `vit_block` each whole block is one K9 call (`ops/vit_block`), where
the JAX package reads TOKENPACKER_VIT_BLOCK. The tower is frozen, so this
is inference only.

`quantize_tower_int8` makes the blocks' products int8 {q, scale} leaves;
with `w8a8` their batched products (M = views x 577 rows) then route to
K8 (`ops/layers.linear`), where the JAX package reads TOKENPACKER_W8A8.
K9 reads dense weights only: `vit_block` with an int8 tower raises, and
with a dense tower K9 ignores `w8a8`, as the JAX package's does.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.config import VisionConfig
from tokenpacker_tpu_torch.ops.layers import layer_norm, linear, quick_gelu
from tokenpacker_tpu_torch.ops.quantize import quantize_int8
from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
from tokenpacker_tpu_torch.ops.vit_block import vit_block as fused_block


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[N, H, W, 3] -> [N, (H/p)*(W/p), 3*p*p] in HF conv-kernel flatten
    order (out-channel dot over [c_in, kh, kw])."""
    n, hh, ww, c = images.shape
    gh, gw = hh // patch_size, ww // patch_size
    x = images.reshape(n, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [N, gh, gw, C, ph, pw]
    return x.reshape(n, gh * gw, c * patch_size * patch_size)


def quantize_tower_int8(params):
    """int8-quantize the blocks' products (attn q/k/v/o, mlp fc1/fc2) per
    out channel; embeddings, LayerNorms and biases stay dense. Returns a
    new tree that shares the untouched tensors."""

    def quant_leaf(leaf):
        q, scale = quantize_int8(leaf["kernel"])
        return {**leaf, "kernel": {"q": q, "scale": scale}}

    layers = [{**layer,
               "attn": {name: quant_leaf(layer["attn"][name]) for name in ("q", "k", "v", "o")},
               "mlp": {name: quant_leaf(layer["mlp"][name]) for name in ("fc1", "fc2")}}
              for layer in params["layers"]]
    return {**params, "layers": layers}


def _attn(p, x: torch.Tensor, num_heads: int, w8a8: bool = False) -> torch.Tensor:
    q = linear(p["q"], x, w8a8)
    k = linear(p["k"], x, w8a8)
    v = linear(p["v"], x, w8a8)
    return linear(p["o"], vit_attention(q, k, v, num_heads), w8a8)


def _block(p, x: torch.Tensor, cfg: VisionConfig, w8a8: bool = False,
           vit_block: bool = False) -> torch.Tensor:
    if vit_block:
        return fused_block(x, p, cfg.num_attention_heads, cfg.layer_norm_eps)
    x = x + _attn(p["attn"], layer_norm(p["ln1"], x, cfg.layer_norm_eps), cfg.num_attention_heads,
                  w8a8)
    h = layer_norm(p["ln2"], x, cfg.layer_norm_eps)
    h = linear(p["mlp"]["fc2"], quick_gelu(linear(p["mlp"]["fc1"], h, w8a8)), w8a8)
    return x + h


def _embed(params, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    n = images.shape[0]
    x = patchify(images, cfg.patch_size) @ params["patch_embed"]["kernel"]
    cls = params["class_embedding"].to(x.dtype).expand(n, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    return layer_norm(params["pre_ln"], x, cfg.layer_norm_eps)


def clip_tower_features(params, cfg: VisionConfig, images: torch.Tensor, w8a8: bool = False,
                        vit_block: bool = False):
    """(features [N, P, W] at select_layer, multi-level concat [N, P, 4W]),
    P = patches (CLS dropped when select_feature == "patch"). `vit_block`:
    each block through K9.

    Only the consumed hidden states are kept, and blocks past the deepest
    consumed layer are not run (block 24 when select_layer = -2)."""
    total = cfg.num_hidden_layers + 1  # hidden-states entries
    sel = cfg.select_layer if cfg.select_layer >= 0 else total + cfg.select_layer
    needed = set([sel, *cfg.multi_layers])

    x = _embed(params, cfg, images)
    outputs = {0: x} if 0 in needed else {}
    for i in range(max(needed)):
        x = _block(params["layers"][i], x, cfg, w8a8, vit_block)
        if i + 1 in needed:
            outputs[i + 1] = x

    feats = outputs[sel]
    multi = torch.cat([outputs[l] for l in cfg.multi_layers], dim=-1)
    if cfg.select_feature == "patch":
        feats = feats[:, 1:]
        multi = multi[:, 1:]
    return feats, multi
