"""Public API (counterpart of `tokenpacker_tpu/api.py`): the loading and
inference surface of the reference (llava/model/builder.py:26-152).

`load_pretrained_model(model_path, model_base, model_name)` returns
`(tokenizer, model, image_processor, context_len)`, `model` being a
`LoadedModel` (params, config and a `Generator`).

Checkpoint layouts (reference builder.py:42-128):
- a full checkpoint directory (`config.json` and `*.safetensors` or
  `pytorch_model*.bin`); without tower keys the tower comes from
  `_load_tower_params`;
- a base LLM (`model_base`) and a `mm_projector.bin` delta (stage 1);
- LoRA: the base, `adapter_model.bin` and `non_lora_trainables.bin`,
  merged at load.

The state dict is read on the host (memory-mapped, `io/checkpoint`); each
tensor moves to `device` as stored and is transposed there
(`io/hf_import`). `load_8bit` / `load_4bit` then quantize the LM layer by
layer on the device (`io/weights.quantize_lm_int8` / `quantize_lm_4bit`),
so the dense and the quantized LM never coexist whole there. The default
device is the card; with no CUDA device the call raises unless the caller
passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass

import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.data.conversation import conv_templates, default_conversation
from tokenpacker_tpu_torch.data.mm_tokenize import get_model_name_from_path, tokenizer_image_token
from tokenpacker_tpu_torch.generate import Generator
from tokenpacker_tpu_torch.image.processing import process_image, process_images
from tokenpacker_tpu_torch.io.checkpoint import load_state_dict
from tokenpacker_tpu_torch.io.hf_import import (
    import_clip_vision,
    import_llama,
    import_tokenpacker,
    import_vlm,
    strip_prefix,
)
from tokenpacker_tpu_torch.io.weights import (
    init_tower_on_device,
    quantize_lm_4bit,
    quantize_lm_int8,
)

__all__ = [
    "load_pretrained_model",
    "process_images",
    "process_image",
    "tokenizer_image_token",
    "conv_templates",
    "default_conversation",
    "get_model_name_from_path",
    "LoadedModel",
]

log = logging.getLogger(__name__)


@dataclass
class LoadedModel:
    params: dict
    config: TokenPackerVLMConfig
    generator: Generator

    @property
    def cfg(self):
        return self.config


def _load_tokenizer(model_path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_path, use_fast=False)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to load on the CPU")
    return device


def load_pretrained_model(
    model_path: str,
    model_base: str | None = None,
    model_name: str | None = None,
    dtype: torch.dtype = torch.bfloat16,
    load_8bit: bool = False,
    load_4bit: bool = False,
    quant_type: str = "nf4",
    device: torch.device | str = "cuda",
    **kwargs,
):
    """Returns (tokenizer, model: LoadedModel, image_processor, context_len).

    `image_processor` is `process_images` bound to the model's
    image_aspect_ratio and patch_num (the reference returns an HF
    CLIPImageProcessor; this is the whole preprocessing front door).
    `model_name` and other keyword arguments are taken for the
    reference's signature and not used, as in the JAX package.

    load_8bit: the LM's linear weights as per-channel int8 (q/k/v and
    gate/up fused), the reference's BitsAndBytes slot; its decode runs on
    K4. load_4bit: blockwise 4-bit weight-only (quant_type "nf4" or
    "int4"), products of up to 32 rows on K6. Both at once raise
    ValueError."""
    device = _device(device)
    if load_8bit and load_4bit:
        raise ValueError("load_8bit and load_4bit are mutually exclusive")
    cfg = TokenPackerVLMConfig.from_json(os.path.join(model_path, "config.json"))

    is_lora = os.path.exists(os.path.join(model_path, "adapter_config.json"))
    has_projector_only = os.path.exists(os.path.join(model_path, "mm_projector.bin"))
    params = _import_params(model_path, model_base, cfg, dtype, is_lora, has_projector_only,
                            device)
    if load_8bit:
        quantize_lm_int8(params)
    elif load_4bit:
        quantize_lm_4bit(params, quant_type)

    tokenizer = _load_tokenizer(
        model_base if (is_lora or (has_projector_only and model_base)) else model_path
    )
    cfg = dataclasses.replace(cfg, dtype=dtype)
    generator = Generator(params, cfg, tokenizer)
    model = LoadedModel(params, cfg, generator)

    def image_processor(images, image_aspect_ratio=None, patch_num=None):
        return process_images(
            images,
            image_aspect_ratio or cfg.image_aspect_ratio,
            patch_num or cfg.patch_num,
        )

    context_len = cfg.model_max_length
    return tokenizer, model, image_processor, context_len


def _import_params(model_path, model_base, cfg, dtype, is_lora, has_projector_only, device):
    if is_lora:
        if model_base is None:
            raise ValueError("LoRA checkpoints need model_base")
        return _load_lora_merged(model_path, model_base, cfg, dtype, device)
    if has_projector_only and model_base is not None:
        # stage-1 delta: the base LLM and the projector's weights
        base_sd = load_state_dict(model_base)
        proj_sd = torch.load(os.path.join(model_path, "mm_projector.bin"), map_location="cpu",
                             weights_only=True)
        proj_sd = strip_prefix(proj_sd, "model.mm_projector.")
        return {
            "lm": import_llama(base_sd, cfg.lm, dtype, device),
            "projector": import_tokenpacker(proj_sd, cfg.projector, dtype, device),
            "vision": _load_tower_params(cfg, dtype, device),
        }
    sd = load_state_dict(model_path)
    if not any(k.startswith("model.vision_tower.") for k in sd):
        # a checkpoint shipped without the tower: the tower comes on its own
        return {
            "lm": import_llama(sd, cfg.lm, dtype, device),
            "projector": import_tokenpacker(strip_prefix(sd, "model.mm_projector."),
                                            cfg.projector, dtype, device),
            "vision": _load_tower_params(cfg, dtype, device),
        }
    return import_vlm(sd, cfg, dtype, device)


def _load_tower_params(cfg: TokenPackerVLMConfig, dtype, device="cpu"):
    """openai/clip-vit-large-patch14-336's weights: from the directory in
    TOKENPACKER_CLIP_PATH, else through `transformers` (the HF cache or a
    download), else random (`init_tower_on_device`, seed 0: other values
    than the JAX package's random tower). Logs which source it used."""
    path = os.environ.get("TOKENPACKER_CLIP_PATH")
    if path and os.path.isdir(path):
        log.info("vision tower: TOKENPACKER_CLIP_PATH=%s", path)
        return import_clip_vision(load_state_dict(path), cfg.vision, dtype, device)
    try:
        from transformers import CLIPVisionModel

        tower = CLIPVisionModel.from_pretrained("openai/clip-vit-large-patch14-336")
        log.info("vision tower: transformers' openai/clip-vit-large-patch14-336")
        return import_clip_vision(tower.state_dict(), cfg.vision, dtype, device)
    except Exception as e:
        log.warning("vision tower: random weights (seed 0); no TOKENPACKER_CLIP_PATH and "
                    "transformers failed: %r", e)
        return init_tower_on_device(cfg.vision, 0, device, dtype)


def _load_lora_merged(model_path, model_base, cfg, dtype, device="cpu"):
    """The base's weights with the LoRA deltas merged, W + (alpha / r) B A in
    fp32 on the host, and `non_lora_trainables.bin` laid over them
    (reference builder.py:46-79). A delta whose target is not in the base
    is skipped, as in the JAX package."""
    base_sd = load_state_dict(model_base)
    with open(os.path.join(model_path, "adapter_config.json")) as f:
        acfg = json.load(f)
    scaling = acfg["lora_alpha"] / acfg["r"]
    lora_sd = torch.load(os.path.join(model_path, "adapter_model.bin"), map_location="cpu",
                         weights_only=True)

    merged = dict(base_sd)
    for k in list(lora_sd.keys()):
        if k.endswith("lora_A.weight"):
            a = lora_sd[k].float()
            b = lora_sd[k.replace("lora_A", "lora_B")].float()
            target = k.replace("base_model.model.", "").replace(".lora_A.weight", ".weight")
            if target in merged:
                merged[target] = merged[target].float() + scaling * (b @ a)

    nlt_file = os.path.join(model_path, "non_lora_trainables.bin")
    if os.path.exists(nlt_file):
        nlt = torch.load(nlt_file, map_location="cpu", weights_only=True)
        for k, v in nlt.items():
            merged[k.replace("base_model.model.", "")] = v

    if any(k.startswith("model.vision_tower.") for k in merged):
        return import_vlm(merged, cfg, dtype, device)
    return {
        "lm": import_llama(merged, cfg.lm, dtype, device),
        "projector": import_tokenpacker(strip_prefix(merged, "model.mm_projector."),
                                        cfg.projector, dtype, device),
        "vision": _load_tower_params(cfg, dtype, device),
    }
