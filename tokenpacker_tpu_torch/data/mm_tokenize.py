"""Prompt tokenization with image holes (counterpart of
`tokenpacker_tpu/data/mm_tokenize.py`).

`tokenizer_image_token` reproduces reference mm_utils.py:43-62: split the
prompt on '<image>', tokenize each chunk, rejoin with IMAGE_TOKEN_INDEX
(-200) sentinels while keeping a single BOS at the front. The tokenizer
is duck-typed: `tokenizer(text).input_ids` and `tokenizer.bos_token_id`.
"""

from __future__ import annotations

import numpy as np

from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    return_array: bool = False,
):
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    ids: list[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    joined: list[list[int]] = []
    for i, c in enumerate(chunks):
        joined.append(c)
        if i < len(chunks) - 1:
            joined.append(sep)
    for x in joined:
        ids.extend(x[offset:])

    if return_array:
        return np.asarray(ids, dtype=np.int64)
    return ids


def get_model_name_from_path(model_path: str) -> str:
    """The last path component, or "<parent>_checkpoint-N" for a trainer's
    checkpoint directory (reference mm_utils.py)."""
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]
