"""Common evaluation machinery (counterpart of `tokenpacker_tpu/eval/runner.py`).

The reference's benchmark CLIs share one pattern (SURVEY.md §2.4): load
the model, iterate questions, render the conversation prompt, generate
greedily (temperature 0, max_new_tokens 128), write an answers jsonl,
then convert or score. Data-parallel sharding is `--num-chunks N
--chunk-idx k` (model_vqa_loader.py:22-30).

`EvalRunner` batches prompts (the reference runs batch 1), builds the
splice plans on the host two batches ahead (`data/prefetch`) and streams
answers from `Generator.generate`. Each benchmark module supplies a
question iterator and its answers' post-processing.

Unlike the JAX runner, the views of a batch are not padded to a bucket
of crop counts: XLA needed one executable per shape, while here padded
views would only add work to the tower. The answers are the same.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

from tokenpacker_tpu_torch.beam import MAX_BEAMS
from tokenpacker_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from tokenpacker_tpu_torch.data.conversation import SeparatorStyle, conv_templates
from tokenpacker_tpu_torch.data.mm_tokenize import tokenizer_image_token
from tokenpacker_tpu_torch.data.prefetch import DevicePrefetcher
from tokenpacker_tpu_torch.generate import pick_bucket
from tokenpacker_tpu_torch.image.io import load_image
from tokenpacker_tpu_torch.image.processing import process_image
from tokenpacker_tpu_torch.models.splice import build_splice_plan

MODEL_ID = "tokenpacker-tpu"  # the JAX package's, so that answers files compare byte for byte


def get_chunk(lst: list, n_chunks: int, idx: int) -> list:
    """Reference chunking (model_vqa_loader.py:22-30): ceil-sized chunks."""
    size = math.ceil(len(lst) / n_chunks)
    return lst[idx * size : (idx + 1) * size]


@dataclass
class EvalSample:
    question_id: object
    prompt_text: str  # user text, may or may not include <image>
    image_path: str | None = None
    image: object = None  # PIL image (overrides image_path)
    extra: dict = field(default_factory=dict)


class EvalRunner:
    def __init__(
        self,
        model,  # api.LoadedModel
        tokenizer,
        conv_mode: str = "vicuna_v1",
        image_aspect_ratio: str | None = None,
        patch_num: int | None = None,
        batch_size: int = 8,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        speculative: int = 0,
        num_beams: int = 1,
    ):
        self.model = model
        self.cfg = model.config
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self.image_aspect_ratio = image_aspect_ratio or self.cfg.image_aspect_ratio
        self.patch_num = patch_num or self.cfg.patch_num
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        # --num_beams, which every reference eval CLI forwards to HF
        # generate (e.g. model_vqa_loader.py:181,220). The beams of a batch
        # decode as one step of n x k rows (beam.py); the batch is capped
        # so that n x k stays within beam.MAX_BEAMS, as in the JAX runner
        self.num_beams = num_beams
        if num_beams > 1:
            self.batch_size = batch_size = max(1, min(batch_size, MAX_BEAMS // num_beams))
        # prompt-lookup speculation: greedy batch-1 runs only (Generator
        # ignores it otherwise)
        self.speculative = speculative
        self.generator = model.generator
        self._sep_id = tokenizer.convert_tokens_to_ids(",")
        self._ret_id = tokenizer.convert_tokens_to_ids("\n")
        pad = getattr(tokenizer, "pad_token_id", None)
        self._pad_id = pad if pad is not None else 0

    def build_prompt(self, text: str, has_image: bool) -> str:
        conv = conv_templates[self.conv_mode].copy()
        if has_image and DEFAULT_IMAGE_TOKEN not in text:
            text = DEFAULT_IMAGE_TOKEN + "\n" + text
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def _prepare(self, samples: list[EvalSample]):
        """Host work for one batch (numpy and PIL only): the splice plan at
        the sequence bucket and the views [n, S, S, 3] (None without an
        image)."""
        ids_list, blocks, crops_list = [], [], []
        mode = "slice" if self.image_aspect_ratio == "slice" else "single"
        for s in samples:
            has_image = s.image is not None or s.image_path is not None
            prompt = self.build_prompt(s.prompt_text, has_image)
            ids = np.asarray(tokenizer_image_token(prompt, self.tokenizer), dtype=np.int64)
            ids_list.append(ids)
            if has_image:
                img = s.image if s.image is not None else load_image(s.image_path)
                crops, hb, wb = process_image(
                    img, self.image_aspect_ratio, self.patch_num,
                    image_size=self.cfg.vision.image_size,
                )
                crops_list.append(crops)
                blocks.append([(hb, wb)])
            else:
                blocks.append([])
        tpv = self.cfg.tokens_per_view
        args = (ids_list, blocks, tpv, mode, self._sep_id, self._ret_id, self._pad_id)
        plan = build_splice_plan(*args)
        plan = build_splice_plan(*args, pad_to=pick_bucket(int(plan.lengths.max())))
        images = (
            np.concatenate(crops_list, axis=0).transpose(0, 2, 3, 1) if crops_list else None
        )
        return plan, images

    def stop_strings(self) -> tuple[str, ...]:
        conv = conv_templates[self.conv_mode]
        if conv.sep_style == SeparatorStyle.TWO:
            return (conv.sep2,)
        return (conv.sep,) if conv.sep else ()

    def run(self, samples: Iterable[EvalSample]) -> Iterator[dict]:
        """Yields {"question_id", "text", **extra} per sample, in order.

        A background thread prepares batches (image decode, preprocessing,
        splice plan) two ahead (`data/prefetch.DevicePrefetcher`, on the
        host), beside the current batch's `generate`."""

        def batches():
            batch: list[EvalSample] = []
            for s in samples:
                batch.append(s)
                if len(batch) == self.batch_size:
                    yield batch
                    batch = []
            if batch:
                yield batch

        prepared = DevicePrefetcher(
            batches(), transform=lambda b: (b, self._prepare(b)), depth=2
        )
        for batch, (plan, images) in prepared:
            yield from self._run_batch(batch, plan, images)

    def _run_batch(self, samples: list[EvalSample], plan=None, images=None) -> Iterator[dict]:
        if plan is None:
            plan, images = self._prepare(samples)
        result = self.generator.generate(
            {
                "token_ids": plan.token_ids,
                "is_image": plan.is_image,
                "image_slot": plan.image_slot,
                "lengths": plan.lengths,
                "images": images,
            },
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature,
            stop_strings=self.stop_strings(),
            speculative=self.speculative,
            num_beams=self.num_beams,
        )
        for s, text in zip(samples, result.texts):
            yield {"question_id": s.question_id, "text": text, **s.extra}


def write_answers(path: str, answers: Iterable[dict], model_id: str = MODEL_ID):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for a in answers:
            rec = {"model_id": model_id, **a}
            f.write(json.dumps(rec) + "\n")
