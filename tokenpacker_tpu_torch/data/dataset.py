"""Supervised dataset, collator and length-grouped samplers (counterpart
of `tokenpacker_tpu/data/dataset.py`).

- `SupervisedDataset` ~ the reference `LazySupervisedDataset`
  (train.py:631-767): JSON conversations, per-item image load with the
  pad / HD-slice branch, `lengths` / `modality_lengths` for the sampler,
  a zero dummy image for text-only samples of a multimodal run. `mode`
  is carried to the collator.
- `collate` ~ `DataCollatorForSupervisedDataset` (train.py:771-802), but
  it emits a splice-plan batch of numpy arrays (static shapes) instead of
  raw -200-holed ids.
- the samplers ~ `LengthGroupedSampler` with modality grouping
  (llava_trainer.py:38-130), on numpy's RNG, so one seed gives the JAX
  package's orders.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from tokenpacker_tpu_torch.data.preprocess import preprocess, preprocess_multimodal
from tokenpacker_tpu_torch.image.io import load_image
from tokenpacker_tpu_torch.image.processing import process_image
from tokenpacker_tpu_torch.models.splice import build_splice_plan


class SupervisedDataset:
    def __init__(
        self,
        data_path: str,
        tokenizer,
        image_folder: str | None = None,
        image_aspect_ratio: str = "pad",
        patch_num: int = 9,
        version: str = "v1",
        is_multimodal: bool = True,
        model_max_length: int = 2048,
        mm_use_im_start_end: bool = False,
        image_size: int | None = None,  # tower input size (None = ViT-L 336)
    ):
        with open(data_path) as f:
            self.records = json.load(f)
        self.tokenizer = tokenizer
        self.image_folder = image_folder or "."
        self.image_aspect_ratio = image_aspect_ratio
        self.patch_num = patch_num
        self.version = version
        self.is_multimodal = is_multimodal
        self.model_max_length = model_max_length
        self.mm_use_im_start_end = mm_use_im_start_end
        self.image_size = image_size

    def __len__(self):
        return len(self.records)

    @property
    def lengths(self):
        out = []
        for rec in self.records:
            img_tokens = 128 if "image" in rec else 0
            out.append(
                sum(len(c["value"].split()) for c in rec["conversations"]) + img_tokens
            )
        return out

    @property
    def modality_lengths(self):
        out = []
        for rec in self.records:
            n = sum(len(c["value"].split()) for c in rec["conversations"])
            out.append(n if "image" in rec else -n)
        return out

    def __getitem__(self, i: int) -> dict:
        rec = self.records[i]
        has_image = "image" in rec
        item: dict = {}
        if has_image:
            img = load_image(os.path.join(self.image_folder, rec["image"]))
            aspect = self.image_aspect_ratio
            crops, hb, wb = process_image(img, aspect, self.patch_num,
                                          image_size=self.image_size)
            item["image"] = crops
            item["h_block"], item["w_block"] = hb, wb
            item["mode"] = "slice" if aspect == "slice" else "single"
            sources = preprocess_multimodal(
                copy.deepcopy([rec["conversations"]]),
                is_multimodal=self.is_multimodal,
                mm_use_im_start_end=self.mm_use_im_start_end,
                version=self.version,
            )
        else:
            sources = copy.deepcopy([rec["conversations"]])
            if self.is_multimodal:
                item["image"] = np.zeros((1, 3, 336, 336), np.float32)
                item["h_block"], item["w_block"] = 1, 1
            item["mode"] = "text"

        out = preprocess(
            sources,
            self.tokenizer,
            has_image=has_image,
            version=self.version,
            model_max_length=self.model_max_length,
        )
        item["input_ids"] = out["input_ids"][0][: self.model_max_length]
        item["labels"] = out["labels"][0][: self.model_max_length]
        return item


def collate(
    items: Sequence[dict],
    tokens_per_view: int,
    sep_id: int,
    newline_id: int,
    pad_id: int,
    pad_to: int | None = None,
) -> dict:
    """Batch items into a device-ready splice-plan dict.

    Samples whose mode is 'text' keep an image crop in the batch (the
    reference's zero dummy keeps projector grads alive under ZeRO-3,
    train.py:760-767) but splice no visual tokens.
    """
    mode = "slice" if any(it.get("mode") == "slice" for it in items) else "single"
    input_ids = [it["input_ids"] for it in items]
    labels = [it["labels"] for it in items]
    blocks = []
    images = []
    for it in items:
        if "image" in it:
            images.append(it["image"])
            blocks.append([(it["h_block"], it["w_block"])] if it.get("mode") != "text" else [(1, 1)])
        else:
            blocks.append([])
    plan = build_splice_plan(
        input_ids,
        blocks,
        tokens_per_view,
        mode,
        sep_id,
        newline_id,
        pad_id,
        labels=labels,
        pad_to=pad_to,
    )
    n, l = plan.token_ids.shape
    batch = {
        "images": np.concatenate(images, axis=0).transpose(0, 2, 3, 1) if images else None,
        "token_ids": plan.token_ids,
        "is_image": plan.is_image,
        "image_slot": plan.image_slot,
        "attn_mask": plan.attn_mask,
        "key_valid": plan.attn_mask,
        "positions": np.broadcast_to(np.arange(l), (n, l)).copy(),
        "labels": plan.labels,
        "lengths": plan.lengths,
        "mode": mode,
    }
    return batch


# ---------------------------------------------------------------------------
# Length-grouped samplers (llava_trainer.py:38-130, numpy RNG)
# ---------------------------------------------------------------------------


def split_to_even_chunks(indices, lengths, num_chunks):
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    sums = [0.0] * num_chunks
    for idx in indices:
        tgt = sums.index(min(sums))
        chunks[tgt].append(idx)
        sums[tgt] += lengths[idx]
        if len(chunks[tgt]) == per_chunk:
            sums[tgt] = float("inf")
    return chunks


def get_length_grouped_indices(lengths, batch_size, world_size, rng: np.random.Generator):
    indices = rng.permutation(len(lengths)).tolist()
    mega = world_size * batch_size
    megabatches = [indices[i : i + mega] for i in range(0, len(lengths), mega)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True) for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size) for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(lengths, batch_size, world_size, rng: np.random.Generator):
    assert all(l != 0 for l in lengths), "Should not have zero length."
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    if not mm or not lang:
        return get_length_grouped_indices(
            [abs(l) for l in lengths], batch_size, world_size, rng
        )
    mm_idx, mm_len = zip(*mm)
    lang_idx, lang_len = zip(*lang)
    mm_shuffle = [mm_idx[i] for i in get_length_grouped_indices(mm_len, batch_size, world_size, rng)]
    lang_shuffle = [
        lang_idx[i] for i in get_length_grouped_indices(lang_len, batch_size, world_size, rng)
    ]
    mega = world_size * batch_size
    mm_mb = [mm_shuffle[i : i + mega] for i in range(0, len(mm_shuffle), mega)]
    lang_mb = [lang_shuffle[i : i + mega] for i in range(0, len(lang_shuffle), mega)]
    additional = mm_mb[-1] + lang_mb[-1]
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    order = rng.permutation(len(megabatches)).tolist()
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [i for m in megabatches for i in m]


@dataclass
class LengthGroupedSampler:
    batch_size: int
    world_size: int
    lengths: list
    group_by_modality: bool = False
    seed: int = 0

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        if self.group_by_modality:
            idx = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng
            )
        else:
            idx = get_length_grouped_indices(self.lengths, self.batch_size, self.world_size, rng)
        return iter(idx)

    def __len__(self):
        return len(self.lengths)
