"""Multimodal token splicing (counterpart of `tokenpacker_tpu/models/splice.py`).

The plan (where each text token and each visual token lands) is built on
the host in numpy, once per batch; the device does one gather and one
select. Two modes:

- "single": one view per image hole;
- "slice" (HD): the crops row-major, `sep_id` between the views of a row,
  `newline_id` after each row and, when there is more than one crop, the
  global view followed by `newline_id`. The separators are real
  vocabulary tokens and are labelled IGNORE_INDEX like the visual tokens.

Crops are numbered across the batch in sample/image order (the crops of
all images concatenated), including each image's global view.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tokenpacker_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from tokenpacker_tpu_torch.models.llama import embed_tokens
from tokenpacker_tpu_torch.models.mpt import mpt_embed


@dataclass
class SplicePlan:
    """Per-batch arrays, all [N, L] (right-padded)."""

    token_ids: np.ndarray  # int32; pad_id at visual positions and padding
    is_image: np.ndarray  # bool; True where a visual token goes
    image_slot: np.ndarray  # int32 index into the flat [crops*tpv] visual tokens
    attn_mask: np.ndarray  # bool validity
    labels: np.ndarray | None  # int32, IGNORE_INDEX at non-target positions
    lengths: np.ndarray  # [N] true sequence lengths


def _expand_sample(ids: np.ndarray, labels: np.ndarray | None, blocks: list[tuple[int, int]],
                   crop_base: list[int], tokens_per_view: int, mode: str, sep_id: int,
                   newline_id: int, pad_id: int):
    """One sample's (tok, img, slot, lab) lists."""
    tok, img, slot, lab = [], [], [], []

    def add_text(part_ids, part_labels):
        tok.extend(part_ids.tolist())
        img.extend([False] * len(part_ids))
        slot.extend([0] * len(part_ids))
        if labels is not None:
            lab.extend(part_labels.tolist())

    def add_view(crop):
        start = crop * tokens_per_view
        tok.extend([pad_id] * tokens_per_view)
        img.extend([True] * tokens_per_view)
        slot.extend(range(start, start + tokens_per_view))
        if labels is not None:
            lab.extend([IGNORE_INDEX] * tokens_per_view)

    def add_sep(t):
        tok.append(t)
        img.append(False)
        slot.append(0)
        if labels is not None:
            lab.append(IGNORE_INDEX)

    cursor = 0
    for n_img, pos in enumerate(np.where(ids == IMAGE_TOKEN_INDEX)[0]):
        add_text(ids[cursor:pos], None if labels is None else labels[cursor:pos])
        hb, wb = blocks[n_img]
        crop = crop_base[n_img]
        if mode == "slice":
            for _ in range(hb):
                for j in range(wb):
                    add_view(crop)
                    crop += 1
                    if j < wb - 1:
                        add_sep(sep_id)
                add_sep(newline_id)
            if hb * wb > 1:
                add_view(crop)  # the global view
                add_sep(newline_id)
        else:
            add_view(crop)
        cursor = pos + 1
    add_text(ids[cursor:], None if labels is None else labels[cursor:])
    return tok, img, slot, (lab if labels is not None else None)


def build_splice_plan(
    input_ids: list[np.ndarray],
    blocks: list[list[tuple[int, int]]],
    tokens_per_view: int,
    mode: str = "single",
    sep_id: int = 0,
    newline_id: int = 0,
    pad_id: int = 0,
    labels: list[np.ndarray] | None = None,
    pad_to: int | None = None,
) -> SplicePlan:
    """input_ids: per-sample int arrays with IMAGE_TOKEN_INDEX holes; blocks:
    per-sample (h_block, w_block) per image, (1, 1) in single mode. Same
    signature and result as the JAX original; sep_id/newline_id only
    matter in slice mode."""
    crop_base: list[list[int]] = []
    nxt = 0
    for bs in blocks:
        row = []
        for hb, wb in bs:
            row.append(nxt)
            nxt += hb * wb + (1 if hb * wb > 1 and mode == "slice" else 0)
        crop_base.append(row)

    n = len(input_ids)
    rows = [
        _expand_sample(
            np.asarray(input_ids[i]), None if labels is None else np.asarray(labels[i]),
            blocks[i], crop_base[i], tokens_per_view, mode, sep_id, newline_id, pad_id,
        )
        for i in range(n)
    ]
    lengths = np.array([len(r[0]) for r in rows], dtype=np.int32)
    max_len = pad_to if pad_to is not None else int(lengths.max())
    if max_len < lengths.max():
        raise ValueError(f"pad_to={pad_to} < longest spliced sequence {lengths.max()}")

    token_ids = np.full((n, max_len), pad_id, dtype=np.int32)
    is_image = np.zeros((n, max_len), dtype=bool)
    image_slot = np.zeros((n, max_len), dtype=np.int32)
    attn_mask = np.zeros((n, max_len), dtype=bool)
    out_labels = np.full((n, max_len), IGNORE_INDEX, dtype=np.int32) if labels is not None else None
    for i, (tok, img, slot, lab) in enumerate(rows):
        ln = len(tok)
        token_ids[i, :ln] = tok
        is_image[i, :ln] = img
        image_slot[i, :ln] = slot
        attn_mask[i, :ln] = True
        if out_labels is not None:
            out_labels[i, :ln] = lab
    return SplicePlan(token_ids, is_image, image_slot, attn_mask, out_labels, lengths)


def assemble_embeds(lm_params, visual_tokens: torch.Tensor, token_ids: torch.Tensor,
                    is_image: torch.Tensor, image_slot: torch.Tensor, lm_cfg=None) -> torch.Tensor:
    """visual_tokens [views, tokens_per_view, D] -> input embeddings [N, L, D];
    the text embedding by the LM's family (`lm_cfg`, llama when None)."""
    flat = visual_tokens.reshape(-1, visual_tokens.shape[-1])
    if lm_cfg is not None and lm_cfg.model_family == "mpt":
        text = mpt_embed(lm_params, token_ids)
    else:
        text = embed_tokens(lm_params, token_ids)
    vis = flat[image_slot.clamp(0, flat.shape[0] - 1)]
    return torch.where(is_image[..., None], vis.to(text.dtype), text)
