"""The port's parameters -> HF / torch state-dict layout (counterpart of
`tokenpacker_tpu/io/hf_export.py`).

The inverse of `io/hf_import`: fp32 numpy arrays under the reference's key
names, `[out, in]` Linear weights, as the JAX package writes them, so a
checkpoint written here loads in the reference, in the JAX package and
back in the port. A kernel is transposed on its own device before it is
copied to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.io.hf_import import export_tokenpacker


def _a(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _t(x) -> np.ndarray:
    return x.detach().t().float().contiguous().cpu().numpy()


def export_llama_state_dict(params) -> dict:
    sd = {"model.embed_tokens.weight": _a(params["embed"])}
    for i, layer in enumerate(params["layers"]):
        b = f"model.layers.{i}"
        attn, mlp = layer["attn"], layer["mlp"]
        sd[f"{b}.input_layernorm.weight"] = _a(layer["input_ln"]["scale"])
        for x in ("q", "k", "v", "o"):
            sd[f"{b}.self_attn.{x}_proj.weight"] = _t(attn[x]["kernel"])
        sd[f"{b}.post_attention_layernorm.weight"] = _a(layer["post_ln"]["scale"])
        for x in ("gate", "up", "down"):
            sd[f"{b}.mlp.{x}_proj.weight"] = _t(mlp[x]["kernel"])
    sd["model.norm.weight"] = _a(params["norm"]["scale"])
    sd["lm_head.weight"] = _t(params["lm_head"]["kernel"])
    return sd


def export_clip_state_dict(params) -> dict:
    v = "vision_model"
    pe = _t(params["patch_embed"]["kernel"])  # [W, 3*p*p] -> the conv's [W, 3, p, p]
    p_side = int(np.sqrt(pe.shape[1] // 3))
    sd = {
        f"{v}.embeddings.class_embedding": _a(params["class_embedding"]),
        f"{v}.embeddings.patch_embedding.weight": pe.reshape(pe.shape[0], 3, p_side, p_side),
        f"{v}.embeddings.position_embedding.weight": _a(params["pos_embed"]),
        f"{v}.pre_layrnorm.weight": _a(params["pre_ln"]["scale"]),
        f"{v}.pre_layrnorm.bias": _a(params["pre_ln"]["bias"]),
        f"{v}.post_layernorm.weight": _a(params["post_ln"]["scale"]),
        f"{v}.post_layernorm.bias": _a(params["post_ln"]["bias"]),
    }
    for i, layer in enumerate(params["layers"]):
        b = f"{v}.encoder.layers.{i}"
        for n in ("1", "2"):
            sd[f"{b}.layer_norm{n}.weight"] = _a(layer[f"ln{n}"]["scale"])
            sd[f"{b}.layer_norm{n}.bias"] = _a(layer[f"ln{n}"]["bias"])
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            sd[f"{b}.self_attn.{theirs}.weight"] = _t(layer["attn"][ours]["kernel"])
            sd[f"{b}.self_attn.{theirs}.bias"] = _a(layer["attn"][ours]["bias"])
        for fc in ("fc1", "fc2"):
            sd[f"{b}.mlp.{fc}.weight"] = _t(layer["mlp"][fc]["kernel"])
            sd[f"{b}.mlp.{fc}.bias"] = _a(layer["mlp"][fc]["bias"])
    return sd


def export_vlm_state_dict(params, cfg: TokenPackerVLMConfig) -> dict:
    """A full checkpoint in the reference's key layout: the LM at the top
    level, the tower under `model.vision_tower.vision_tower.`, the
    projector under `model.mm_projector.`."""
    sd = export_llama_state_dict(params["lm"])
    for k, v in export_clip_state_dict(params["vision"]).items():
        sd[f"model.vision_tower.vision_tower.{k}"] = v
    for k, v in export_tokenpacker(params["projector"]).items():
        sd[f"model.mm_projector.{k}"] = v
    return sd


def to_torch_state_dict(sd: dict, dtype: torch.dtype = torch.float32) -> dict:
    """numpy arrays -> contiguous CPU tensors of `dtype`, for `torch.save`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in sd.items()}
