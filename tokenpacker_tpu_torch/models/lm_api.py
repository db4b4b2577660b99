"""Decoder API by model family (counterpart of
`tokenpacker_tpu/models/lm_api.py`): `cfg.model_family` ("llama" |
"mpt") picks `models/llama.py` or `models/mpt.py`. The meta-arch
(`models/vlm.py`), the engine and the batchers call these functions.
"""

from __future__ import annotations

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.models import llama as _llama
from tokenpacker_tpu_torch.models import mpt as _mpt


def embedding_table(lm_params):
    """The LM's [V, D] token embedding (`embed`, MPT's tied `wte`): its dtype
    and device are the LM's."""
    return lm_params["wte"] if "wte" in lm_params else lm_params["embed"]


def lm_embed(params, cfg: LMConfig, input_ids):
    if cfg.model_family == "mpt":
        return _mpt.mpt_embed(params, input_ids)
    return _llama.embed_tokens(params, input_ids)


def lm_apply(params, cfg: LMConfig, inputs_embeds, positions, cache=None, decode_info=None,
             remat: str = "", attn_bias=None, w8a8: bool = False, key_positions=None):
    """positions [N, T] drive RoPE (llama); MPT's ALiBi reads key_positions,
    the optional [N, S] true token position of each cache slot on the
    `attn_bias` route (the slot indices by default; K3 compacts the
    bucketed decode layout itself). `remat` is llama's; `w8a8` is the
    int8 products' mode in both families."""
    if cfg.model_family == "mpt":
        return _mpt.mpt_apply(params, cfg, inputs_embeds, cache, decode_info, remat, attn_bias,
                              key_positions, w8a8)
    return _llama.llama_apply(params, cfg, inputs_embeds, positions, cache, decode_info, remat,
                              attn_bias, w8a8)


def lm_logits(params, cfg: LMConfig, hidden, w8a8: bool = False):
    if cfg.model_family == "mpt":
        return _mpt.mpt_logits(params, hidden)
    return _llama.llama_logits(params, hidden, w8a8)
