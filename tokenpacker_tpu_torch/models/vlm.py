"""The composed model: tower -> projector -> LM (counterpart of
`tokenpacker_tpu/models/vlm.py`). Params: {"vision", "projector", "lm"}.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.models.clip_vit import clip_tower_features
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.lm_api import lm_apply
from tokenpacker_tpu_torch.models.splice import assemble_embeds
from tokenpacker_tpu_torch.models.tokenpacker import tokenpacker_forward


def encode_images(params, cfg: TokenPackerVLMConfig, images: torch.Tensor) -> torch.Tensor:
    """images [views, H, W, 3] normalized -> [views, tokens_per_view, lm_hidden].
    The tower is frozen, so it runs without autograd."""
    with torch.no_grad():
        feats, multi = clip_tower_features(params["vision"], cfg.vision, images)
    return tokenpacker_forward(params["projector"], cfg.projector, feats, multi)


def vlm_hidden(params, cfg: TokenPackerVLMConfig, batch: dict,
               cache: KVCache | None = None) -> torch.Tensor:
    """Splice + decoder over a batch of device tensors: images [views, H, W,
    3] or None, token_ids / is_image / image_slot / positions [N, L].

    Batches must be right-padded (as build_splice_plan makes them): the
    prefill attention is causal over the current tokens, so pad keys are
    never seen by a valid query. Returns the final-norm hidden [N, L, D]."""
    lm = params["lm"]
    if batch.get("images") is not None:
        visual = encode_images(params, cfg, batch["images"])
    else:
        visual = torch.zeros(
            (1, cfg.tokens_per_view, cfg.lm.hidden_size), dtype=lm["embed"].dtype,
            device=lm["embed"].device,
        )
    embeds = assemble_embeds(
        lm, visual, batch["token_ids"], batch["is_image"], batch["image_slot"], cfg.lm
    )
    return lm_apply(lm, cfg.lm, embeds, batch["positions"], cache)
