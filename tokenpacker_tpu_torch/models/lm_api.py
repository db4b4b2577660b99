"""Decoder API by model family (counterpart of
`tokenpacker_tpu/models/lm_api.py`). Only the llama family is ported;
MPT (ALiBi through K2's key-only bias and K3's slopes) is ROADMAP queue 1,
"Eval, tools and MPT".
"""

from __future__ import annotations

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.models import llama as _llama


def _require_llama(cfg: LMConfig) -> None:
    if cfg.model_family != "llama":
        raise NotImplementedError(
            f"model_family={cfg.model_family!r}: only llama is ported; MPT waits for "
            "ROADMAP queue 1 'Eval, tools and MPT'"
        )


def lm_embed(params, cfg: LMConfig, input_ids):
    _require_llama(cfg)
    return _llama.embed_tokens(params, input_ids)


def lm_apply(params, cfg: LMConfig, inputs_embeds, positions, cache=None, decode_info=None):
    _require_llama(cfg)
    return _llama.llama_apply(params, cfg, inputs_embeds, positions, cache, decode_info)


def lm_logits(params, cfg: LMConfig, hidden):
    _require_llama(cfg)
    return _llama.llama_logits(params, hidden)
