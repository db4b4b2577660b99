"""CLIP ViT vision tower (counterpart of `tokenpacker_tpu/models/clip_vit.py`).

HF `CLIPVisionModel` semantics: patch embed as a matmul over HF's conv
flatten order (no bias), CLS + learned positions, pre-LayerNorm, pre-LN
blocks with quick-GELU MLPs. Attention runs on K1 (`ops/vit_attention`).
The tower is frozen, so this is inference only.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.config import VisionConfig
from tokenpacker_tpu_torch.ops.layers import layer_norm, linear, quick_gelu
from tokenpacker_tpu_torch.ops.vit_attention import vit_attention


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[N, H, W, 3] -> [N, (H/p)*(W/p), 3*p*p] in HF conv-kernel flatten
    order (out-channel dot over [c_in, kh, kw])."""
    n, hh, ww, c = images.shape
    gh, gw = hh // patch_size, ww // patch_size
    x = images.reshape(n, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [N, gh, gw, C, ph, pw]
    return x.reshape(n, gh * gw, c * patch_size * patch_size)


def _attn(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    q = linear(p["q"], x)
    k = linear(p["k"], x)
    v = linear(p["v"], x)
    return linear(p["o"], vit_attention(q, k, v, num_heads))


def _block(p, x: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    x = x + _attn(p["attn"], layer_norm(p["ln1"], x, cfg.layer_norm_eps), cfg.num_attention_heads)
    h = layer_norm(p["ln2"], x, cfg.layer_norm_eps)
    h = linear(p["mlp"]["fc2"], quick_gelu(linear(p["mlp"]["fc1"], h)))
    return x + h


def _embed(params, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    n = images.shape[0]
    x = patchify(images, cfg.patch_size) @ params["patch_embed"]["kernel"]
    cls = params["class_embedding"].to(x.dtype).expand(n, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    return layer_norm(params["pre_ln"], x, cfg.layer_norm_eps)


def clip_tower_features(params, cfg: VisionConfig, images: torch.Tensor):
    """(features [N, P, W] at select_layer, multi-level concat [N, P, 4W]),
    P = patches (CLS dropped when select_feature == "patch").

    Only the consumed hidden states are kept, and blocks past the deepest
    consumed layer are not run (block 24 when select_layer = -2)."""
    total = cfg.num_hidden_layers + 1  # hidden-states entries
    sel = cfg.select_layer if cfg.select_layer >= 0 else total + cfg.select_layer
    needed = set([sel, *cfg.multi_layers])

    x = _embed(params, cfg, images)
    outputs = {0: x} if 0 in needed else {}
    for i in range(max(needed)):
        x = _block(params["layers"][i], x, cfg)
        if i + 1 in needed:
            outputs[i + 1] = x

    feats = outputs[sel]
    multi = torch.cat([outputs[l] for l in cfg.multi_layers], dim=-1)
    if cfg.select_feature == "patch":
        feats = feats[:, 1:]
        multi = multi[:, 1:]
    return feats, multi
