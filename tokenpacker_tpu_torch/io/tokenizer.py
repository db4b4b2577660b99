"""Tokenizer utilities (counterpart of `tokenpacker_tpu/io/tokenizer.py`,
which imports no JAX; copied so the port imports nothing of the JAX
package).

- `load_tokenizer`: a SentencePiece / HF tokenizer with the reference's
  loading conventions (use_fast=False for LLaMA, right padding,
  model_max_length).
- `adapt_tokenizer_for_denoising`: adds the UL2 sentinel tokens
  <extra_id_0..99> and a `sentinel_token_ids` attribute (the reference's
  llava/model/language_model/mpt/adapt_tokenizer.py:6-40).

`transformers` is imported inside the functions: the port's modules
import without it.
"""

from __future__ import annotations

NUM_SENTINELS = 100


def load_tokenizer(path: str, model_max_length: int = 2048, use_fast: bool = False):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(
        path,
        model_max_length=model_max_length,
        padding_side="right",
        use_fast=use_fast,
    )
    if tok.pad_token is None and tok.unk_token is not None:
        tok.pad_token = tok.unk_token
    return tok


def adapt_tokenizer_for_denoising(tokenizer):
    """Add <extra_id_0..99> sentinels and a `sentinel_token_ids` attribute,
    as the UL2 adapter the vendored MPT ships."""
    sentinels = [f"<extra_id_{i}>" for i in range(NUM_SENTINELS)]
    tokenizer.add_tokens(sentinels)
    if tokenizer.pad_token is None:
        tokenizer.add_tokens("<pad>")
        tokenizer.pad_token = "<pad>"
        if tokenizer.pad_token_id is None:
            raise ValueError("the tokenizer gave <pad> no id")
    joined = "".join(sentinels)
    tokenizer.sentinel_token_ids = tokenizer(joined, add_special_tokens=False).input_ids
    return tokenizer
