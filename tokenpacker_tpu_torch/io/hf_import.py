"""HF / torch checkpoint -> the port's parameters (counterpart of
`tokenpacker_tpu/io/hf_import.py`).

Maps the state-dict layouts of the released TokenPacker checkpoints
(`sunshine-lwt/TokenPacker-*`) onto the port's parameters:

- CLIP tower: HF `CLIPVisionModel` keys (`vision_model.*`; HF spells the
  first norm `pre_layrnorm`), the patch conv flattened to the `[3*p*p, W]`
  matmul of `clip_vit.patchify`;
- projector: the reference's module names (`mm_projector.{q_proj_1,
  k_proj_1, v_proj_1, ln_{q,k,v}_1, clip_attn, mlp}`, projector
  builder.py:59-83), with the packed `clip_attn.in_proj_weight`;
- LM: HF `LlamaForCausalLM` keys (`model.layers.*`, `lm_head`).

Torch's Linear weights are `[out, in]`; the port keeps the JAX package's
`[in, out]` kernels, so every weight is transposed exactly once, on the
device it lands on: a `[out, in]` tensor moves there as stored and is
made `[in, out]` there (a transpose is exact, and on the card it costs
none of the host's time). Layers are per-layer lists, as `params_from_jax`
makes them. Values may be torch tensors (bf16 included), numpy arrays or
memmaps; the result never shares memory with them.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tokenpacker_tpu_torch.config import LMConfig, ProjectorConfig, VisionConfig


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    """A state-dict value as a CPU (or already placed) tensor, without a
    copy where the value allows one."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    arr = np.asarray(x)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _put(x, dtype, device, transpose: bool = False) -> torch.Tensor:
    """The value on `device` in `dtype` (a copy), transposed there if asked."""
    t = _tensor(x).to(device=device, copy=True).to(dtype)
    return t.t().contiguous() if transpose else t


def _lin(sd: Mapping, name: str, dtype, device="cpu") -> dict:
    p = {"kernel": _put(sd[f"{name}.weight"], dtype, device, transpose=True)}
    if f"{name}.bias" in sd:
        p["bias"] = _put(sd[f"{name}.bias"], dtype, device)
    return p


def _ln(sd: Mapping, name: str, dtype, device="cpu") -> dict:
    return {"scale": _put(sd[f"{name}.weight"], dtype, device),
            "bias": _put(sd[f"{name}.bias"], dtype, device)}


def strip_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# -- CLIP vision tower ---------------------------------------------------------


def import_clip_vision(sd: Mapping, cfg: VisionConfig, dtype=torch.float32,
                       device="cpu") -> dict:
    """sd: `vision_model.*` keys (any wrapper prefix such as
    `model.vision_tower.vision_tower.` stripped) -> the tower's params."""
    v = "vision_model"
    emb = f"{v}.embeddings"
    pe = _tensor(sd[f"{emb}.patch_embedding.weight"])  # [W, 3, p, p]
    params = {
        "class_embedding": _put(sd[f"{emb}.class_embedding"], dtype, device),
        "patch_embed": {"kernel": _put(pe.reshape(pe.shape[0], -1), dtype, device,
                                       transpose=True)},
        "pos_embed": _put(sd[f"{emb}.position_embedding.weight"], dtype, device),
        "pre_ln": _ln(sd, f"{v}.pre_layrnorm", dtype, device),
        "post_ln": _ln(sd, f"{v}.post_layernorm", dtype, device),
    }
    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"{v}.encoder.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{b}.layer_norm1", dtype, device),
            "attn": {ours: _lin(sd, f"{b}.self_attn.{theirs}", dtype, device)
                     for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                          ("o", "out_proj"))},
            "ln2": _ln(sd, f"{b}.layer_norm2", dtype, device),
            "mlp": {"fc1": _lin(sd, f"{b}.mlp.fc1", dtype, device),
                    "fc2": _lin(sd, f"{b}.mlp.fc2", dtype, device)},
        })
    params["layers"] = layers
    return params


# -- TokenPacker projector -----------------------------------------------------


def import_tokenpacker(sd: Mapping, cfg: ProjectorConfig, dtype=torch.float32,
                       device="cpu") -> dict:
    """sd: keys relative to the projector module (`q_proj_1.weight`, ...),
    values torch tensors or numpy arrays -> the port's projector params."""
    e = cfg.embed_dim
    in_w = _tensor(sd["clip_attn.in_proj_weight"])  # [3E, E]
    in_b = _tensor(sd["clip_attn.in_proj_bias"])  # [3E]
    return {
        "q_proj": {"kernel": _put(sd["q_proj_1.weight"], dtype, device, transpose=True),
                   "bias": None},
        "k_proj": {"fc1": _lin(sd, "k_proj_1.0", dtype, device),
                   "fc2": _lin(sd, "k_proj_1.2", dtype, device)},
        "v_proj": {"fc1": _lin(sd, "v_proj_1.0", dtype, device),
                   "fc2": _lin(sd, "v_proj_1.2", dtype, device)},
        "ln_q": _ln(sd, "ln_q_1", dtype, device),
        "ln_k": _ln(sd, "ln_k_1", dtype, device),
        "ln_v": _ln(sd, "ln_v_1", dtype, device),
        "attn": {
            name: {"kernel": _put(in_w[i * e:(i + 1) * e], dtype, device, transpose=True),
                   "bias": _put(in_b[i * e:(i + 1) * e], dtype, device)}
            for i, name in enumerate(("q", "k", "v"))
        } | {"o": _lin(sd, "clip_attn.out_proj", dtype, device)},
        "mlp": {"fc1": _lin(sd, "mlp.0", dtype, device), "fc2": _lin(sd, "mlp.2", dtype, device)},
    }


def export_tokenpacker(params, dtype=np.float32) -> dict:
    """Inverse of `import_tokenpacker`: reference-layout numpy arrays, the
    `mm_projector.bin` layout without its `model.mm_projector.` prefix."""

    def a(x):
        return _np(x).astype(dtype)

    def t(x):
        return a(x).T

    at = params["attn"]
    out = {
        "q_proj_1.weight": t(params["q_proj"]["kernel"]),
        "k_proj_1.0.weight": t(params["k_proj"]["fc1"]["kernel"]),
        "k_proj_1.0.bias": a(params["k_proj"]["fc1"]["bias"]),
        "k_proj_1.2.weight": t(params["k_proj"]["fc2"]["kernel"]),
        "k_proj_1.2.bias": a(params["k_proj"]["fc2"]["bias"]),
        "v_proj_1.0.weight": t(params["v_proj"]["fc1"]["kernel"]),
        "v_proj_1.0.bias": a(params["v_proj"]["fc1"]["bias"]),
        "v_proj_1.2.weight": t(params["v_proj"]["fc2"]["kernel"]),
        "v_proj_1.2.bias": a(params["v_proj"]["fc2"]["bias"]),
        "ln_q_1.weight": a(params["ln_q"]["scale"]),
        "ln_q_1.bias": a(params["ln_q"]["bias"]),
        "ln_k_1.weight": a(params["ln_k"]["scale"]),
        "ln_k_1.bias": a(params["ln_k"]["bias"]),
        "ln_v_1.weight": a(params["ln_v"]["scale"]),
        "ln_v_1.bias": a(params["ln_v"]["bias"]),
        "clip_attn.in_proj_weight": np.concatenate([t(at[x]["kernel"]) for x in ("q", "k", "v")]),
        "clip_attn.in_proj_bias": np.concatenate([a(at[x]["bias"]) for x in ("q", "k", "v")]),
        "clip_attn.out_proj.weight": t(at["o"]["kernel"]),
        "clip_attn.out_proj.bias": a(at["o"]["bias"]),
        "mlp.0.weight": t(params["mlp"]["fc1"]["kernel"]),
        "mlp.0.bias": a(params["mlp"]["fc1"]["bias"]),
        "mlp.2.weight": t(params["mlp"]["fc2"]["kernel"]),
        "mlp.2.bias": a(params["mlp"]["fc2"]["bias"]),
    }
    return out


# -- LLaMA ---------------------------------------------------------------------


def import_llama(sd: Mapping, cfg: LMConfig, dtype=torch.float32, device="cpu") -> dict:
    """sd: HF LlamaForCausalLM keys (`model.embed_tokens.weight`, ...)."""

    def nb(name):  # a bias-free linear
        return {"kernel": _put(sd[f"{name}.weight"], dtype, device, transpose=True)}

    def norm(name):
        return {"scale": _put(sd[f"{name}.weight"], dtype, device)}

    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"model.layers.{i}"
        layers.append({
            "input_ln": norm(f"{b}.input_layernorm"),
            "attn": {x: nb(f"{b}.self_attn.{x}_proj") for x in ("q", "k", "v", "o")},
            "post_ln": norm(f"{b}.post_attention_layernorm"),
            "mlp": {x: nb(f"{b}.mlp.{x}_proj") for x in ("gate", "up", "down")},
        })
    return {
        "embed": _put(sd["model.embed_tokens.weight"], dtype, device),
        "layers": layers,
        "norm": norm("model.norm"),
        "lm_head": nb("lm_head"),
    }


# -- Full VLM checkpoint -------------------------------------------------------


def import_vlm(sd: Mapping, config, dtype=torch.float32, device="cpu") -> dict:
    """Split a full TokenPacker / LLaVA state dict into the three parts: the
    LM at the top level (`model.layers.*`), the tower under
    `model.vision_tower.vision_tower.`, the projector under
    `model.mm_projector.`."""
    tower_sd = strip_prefix(sd, "model.vision_tower.vision_tower.")
    proj_sd = strip_prefix(sd, "model.mm_projector.")
    lm_sd = {k: v for k, v in sd.items()
             if not k.startswith("model.vision_tower.") and not k.startswith("model.mm_projector.")}
    return {
        "vision": import_clip_vision(tower_sd, config.vision, dtype, device),
        "projector": import_tokenpacker(proj_sd, config.projector, dtype, device),
        "lm": import_llama(lm_sd, config.lm, dtype, device),
    }
