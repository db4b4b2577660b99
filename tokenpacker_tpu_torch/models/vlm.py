"""The composed model: tower -> projector -> LM, and the training loss
(counterpart of `tokenpacker_tpu/models/vlm.py`). Params: {"vision",
"projector", "lm"}.

Under an active mesh (`with mesh:`, `parallel/mesh`) with a 'data' axis
of more than one rank, the image crops of a batch are split over 'data':
each rank runs the tower and the projector on its share and the features
are all-gathered before the splice (per-crop vision DP, the JAX
package's crops sharded over 'data'). The loss then sums its
cross-entropy over the rank's rows and divides by the valid-token count
of the global batch, all-reduced over 'data'.
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
from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel.mesh import DATA_AXIS, active
from tokenpacker_tpu_torch.parallel.sharding import gathered, local_config


def data_axis():
    """The active mesh's 'data' axis when it has more than one rank."""
    mesh = active()
    if mesh is None or mesh.shape.get(DATA_AXIS, 1) == 1:
        return None
    return mesh.axis(DATA_AXIS)


def encode_images(params, cfg: TokenPackerVLMConfig, images: torch.Tensor,
                  w8a8: bool = False, vit_block: bool = False) -> torch.Tensor:
    """images [views, H, W, 3] normalized -> [views, tokens_per_view, lm_hidden].
    The tower is frozen in every recipe, so it runs without autograd (the
    JAX package's stop_gradient). `w8a8`: the tower's int8 products (after
    `clip_vit.quantize_tower_int8`) in the w8a8 mode; `vit_block`: each
    tower block through K9 (a dense tower only). Under a mesh with a
    'data' axis the crops are split over it (module docstring)."""
    axis = data_axis()
    n = images.shape[0]
    if axis is not None:
        per = -(-n // axis.size)
        if per * axis.size != n:
            images = torch.cat([images, images.new_zeros((per * axis.size - n,) + images.shape[1:])])
        images = images[axis.index * per:(axis.index + 1) * per]
    with torch.no_grad():
        feats, multi = clip_tower_features(gathered(params["vision"]), cfg.vision, images, w8a8,
                                           vit_block)
    out = tokenpacker_forward(gathered(params["projector"]), cfg.projector, feats, multi)
    if axis is not None:
        out = comm.gather(out, 0, axis, "sum")[:n]
    return out


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
    final-norm hidden [N, L, D]. A tree of `parallel/sharding.shard_params`
    runs as this rank's part."""
    cfg = local_config(cfg, params)
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
    one). Returns (loss, {"loss", "n_tokens"}). Under a mesh with a 'data'
    axis the batch is this rank's rows: the count is the global batch's,
    the first value is this rank's share of the loss (what its backward
    differentiates) and metrics["loss"] the global loss."""
    hidden = vlm_hidden(params, cfg, batch, remat=remat)
    logits = lm_logits(params["lm"], cfg.lm, hidden)
    labels = batch["labels"][:, 1:].long()
    axis = data_axis()
    n_valid = comm.all_reduce((labels != IGNORE_INDEX).sum(), axis).clamp(min=1)
    shift_logits = logits[:, :-1].float()
    total = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]), labels.reshape(-1),
                            ignore_index=IGNORE_INDEX, reduction="sum")
    loss = total / n_valid
    return loss, {"loss": comm.all_reduce(loss.detach(), axis), "n_tokens": n_valid}
