"""Supervised-conversation preprocessing: tokenize and mask the labels
(counterpart of `tokenpacker_tpu/data/preprocess.py`).

Behaviour-parity with reference llava/train/train.py:307-628 for the four
template families the training recipes use: plain (stage 1, '<image>' +
caption + '\\n', everything up to and including the image token
masked), v1 (stage 2, vicuna_v1 / TWO style: system and 'USER: ...
ASSISTANT: ' spans masked per round), llama_2 ([INST] spans masked) and
mpt (rounds regrouped as system+user+gpt, role headers masked). On a
tokenization mismatch the whole target is masked with a warning, as in
the reference. The tokenizer is duck-typed (`tokenizer(text).input_ids`,
`bos_token_id`, `pad_token_id`). Outputs are numpy int64 arrays.
"""

from __future__ import annotations

import logging

import numpy as np

from tokenpacker_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
)
from tokenpacker_tpu_torch.data import conversation as conversation_lib
from tokenpacker_tpu_torch.data.mm_tokenize import tokenizer_image_token

logger = logging.getLogger(__name__)


def preprocess_multimodal(sources, is_multimodal=True, mm_use_im_start_end=False, version="v1"):
    """Normalize '<image>' placement to the front of the first turn
    (reference train.py:307-328). Mutates and returns sources."""
    if not is_multimodal:
        return sources
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                text = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = (DEFAULT_IMAGE_TOKEN + "\n" + text).strip()
                if "mmtag" in version:
                    sentence["value"] = sentence["value"].replace(
                        DEFAULT_IMAGE_TOKEN, "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>"
                    )
            if mm_use_im_start_end:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN,
                    DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN,
                )
    return sources


def _render_conversations(sources, conv):
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _tokenize(prompt, tokenizer, has_image):
    if has_image:
        return tokenizer_image_token(prompt, tokenizer)
    return tokenizer(prompt).input_ids


def _mask_rounds(
    conversations, input_ids, tokenizer, has_image, sep, sep2, *,
    start_len=1, inst_adjust=-2, model_max_length=2048,
):
    """Common round-masking loop for v1/llama_2 styles."""
    targets = []
    for conversation, ids in zip(conversations, input_ids):
        target = np.asarray(ids, dtype=np.int64).copy()
        total_len = int((target != (tokenizer.pad_token_id or -1)).sum())
        rounds = conversation.split(sep2)
        cur_len = start_len
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, has_image))
            instruction_len = len(_tokenize(parts[0], tokenizer, has_image)) + inst_adjust
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            logger.warning("tokenization mismatch: %d vs. %d. (ignored)", cur_len, total_len)
        targets.append(target)
    return targets


def preprocess_plain(sources, tokenizer):
    """Stage-1 alignment: '<image>' + caption + sep (train.py:561-580)."""
    conv = conversation_lib.conv_templates["plain"]
    input_ids, targets = [], []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        prompt = DEFAULT_IMAGE_TOKEN + source[1]["value"] + conv.sep
        ids = np.asarray(tokenizer_image_token(prompt, tokenizer), dtype=np.int64)
        target = ids.copy()
        masked_len = len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tokenizer))
        target[:masked_len] = IGNORE_INDEX
        input_ids.append(ids)
        targets.append(target)
    return {"input_ids": input_ids, "labels": targets}


def preprocess_v1(sources, tokenizer, has_image=False, conv=None, model_max_length=2048):
    conv = (conv or conversation_lib.conv_templates["v1"]).copy()
    conversations = _render_conversations(sources, conv)
    input_ids = [
        np.asarray(_tokenize(p, tokenizer, has_image), dtype=np.int64) for p in conversations
    ]
    sep = conv.sep + conv.roles[1] + ": "
    targets = _mask_rounds(
        conversations, input_ids, tokenizer, has_image, sep, conv.sep2,
        start_len=1, inst_adjust=-2, model_max_length=model_max_length,
    )
    return {"input_ids": input_ids, "labels": targets}


def preprocess_llama_2(sources, tokenizer, has_image=False, model_max_length=2048):
    conv = conversation_lib.conv_templates["llama_2"].copy()
    conversations = _render_conversations(sources, conv)
    input_ids = [
        np.asarray(_tokenize(p, tokenizer, has_image), dtype=np.int64) for p in conversations
    ]
    targets = _mask_rounds(
        conversations, input_ids, tokenizer, has_image, "[/INST] ", conv.sep2,
        start_len=1, inst_adjust=-2, model_max_length=model_max_length,
    )
    return {"input_ids": input_ids, "labels": targets}


def preprocess_mpt(sources, tokenizer, model_max_length=2048):
    """MPT style: rounds regrouped (system+user+gpt), headers masked
    (train.py:495-558)."""
    conv = conversation_lib.conv_templates["mpt"].copy()
    conversations = _render_conversations(sources, conv)
    input_ids = [
        np.asarray(tokenizer_image_token(p, tokenizer), dtype=np.int64) for p in conversations
    ]
    sep = conv.sep + conv.roles[1]
    targets = []
    for conversation, ids in zip(conversations, input_ids):
        target = ids.copy()
        total_len = int((target != (tokenizer.pad_token_id or -1)).sum())
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[idx : idx + 2]))
        cur_len = 0
        for rou in re_rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tokenizer_image_token(rou, tokenizer)) + len(
                tokenizer_image_token(conv.sep, tokenizer)
            )
            instruction_len = len(tokenizer_image_token(parts[0], tokenizer))
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            logger.warning("tokenization mismatch: %d vs. %d. (ignored)", cur_len, total_len)
        targets.append(target)
    return {"input_ids": input_ids, "labels": targets}


def preprocess(sources, tokenizer, has_image=False, version="v1", model_max_length=2048):
    """Dispatch by template family (reference train.py:583-602)."""
    if version in ("plain", "v0_plain"):
        return preprocess_plain(sources, tokenizer)
    if version in ("llama_2", "llava_llama_2"):
        return preprocess_llama_2(sources, tokenizer, has_image, model_max_length)
    if version.startswith("v1") or version in ("vicuna_v1", "llava_v1"):
        return preprocess_v1(
            sources, tokenizer, has_image, model_max_length=model_max_length
        )
    if version == "mpt":
        return preprocess_mpt(sources, tokenizer, model_max_length)
    raise NotImplementedError(f"preprocess version {version!r}")
