"""The composed model: tower -> projector -> LM, and the training loss
(counterpart of `tokenpacker_tpu/models/vlm.py`). Params: {"vision",
"projector", "lm"}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.constants import IGNORE_INDEX
from tokenpacker_tpu_torch.models.clip_vit import clip_tower_features
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.lm_api import embedding_table, lm_apply, lm_logits
from tokenpacker_tpu_torch.models.splice import assemble_embeds
from tokenpacker_tpu_torch.models.tokenpacker import tokenpacker_forward


def encode_images(params, cfg: TokenPackerVLMConfig, images: torch.Tensor,
                  w8a8: bool = False, vit_block: bool = False) -> torch.Tensor:
    """images [views, H, W, 3] normalized -> [views, tokens_per_view, lm_hidden].
    The tower is frozen in every recipe, so it runs without autograd (the
    JAX package's stop_gradient). `w8a8`: the tower's int8 products (after
    `clip_vit.quantize_tower_int8`) in the w8a8 mode; `vit_block`: each
    tower block through K9 (a dense tower only)."""
    with torch.no_grad():
        feats, multi = clip_tower_features(params["vision"], cfg.vision, images, w8a8,
                                           vit_block)
    return tokenpacker_forward(params["projector"], cfg.projector, feats, multi)


def vlm_hidden(params, cfg: TokenPackerVLMConfig, batch: dict,
               cache: KVCache | None = None, remat: str = "", w8a8: bool = False,
               vit_block: bool = False) -> torch.Tensor:
    """Splice + decoder over a batch of device tensors: images [views, H, W,
    3] or None, token_ids / is_image / image_slot / positions [N, L].

    Batches must be right-padded (as build_splice_plan makes them): the
    prefill attention is causal over the current tokens, so pad keys are
    never seen by a valid query. Either LM family (`cfg.lm.model_family`).
    `remat`: `llama_apply`'s per-layer rematerialization of the cache-less
    path (llama only); `w8a8`: `ops/layers.linear`'s w8a8 mode for the int8
    products; `vit_block`: the tower's blocks through K9. Returns the
    final-norm hidden [N, L, D]."""
    lm = params["lm"]
    table = embedding_table(lm)
    if batch.get("images") is not None:
        visual = encode_images(params, cfg, batch["images"], w8a8, vit_block)
    else:
        visual = torch.zeros(
            (1, cfg.tokens_per_view, cfg.lm.hidden_size), dtype=table.dtype,
            device=table.device,
        )
    embeds = assemble_embeds(
        lm, visual, batch["token_ids"], batch["is_image"], batch["image_slot"], cfg.lm
    )
    return lm_apply(lm, cfg.lm, embeds, batch["positions"], cache, remat=remat, w8a8=w8a8)


def vlm_loss(params, cfg: TokenPackerVLMConfig, batch: dict, remat: str = ""):
    """Shifted next-token cross-entropy in fp32 over the labels that are not
    IGNORE_INDEX (`batch["labels"]` [N, L]), averaged over them (at least
    one). Returns (loss, {"loss", "n_tokens"})."""
    hidden = vlm_hidden(params, cfg, batch, remat=remat)
    logits = lm_logits(params["lm"], cfg.lm, hidden)
    labels = batch["labels"][:, 1:].long()
    n_valid = (labels != IGNORE_INDEX).sum().clamp(min=1)
    shift_logits = logits[:, :-1].float()
    total = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]), labels.reshape(-1),
                            ignore_index=IGNORE_INDEX, reduction="sum")
    loss = total / n_valid
    return loss, {"loss": loss, "n_tokens": n_valid}
