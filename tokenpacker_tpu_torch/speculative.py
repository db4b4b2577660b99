"""Speculative decoding by prompt lookup (counterpart of
`tokenpacker_tpu/speculative.py`).

Decoding is bound by streaming the weights, so a verify step that feeds
the last accepted token and k drafts costs about one plain step's bytes,
and every accepted draft is a token nearly for free. Drafts are the
continuation of the earliest earlier occurrence of the trailing n-gram of
the request's tokens (no draft model). A draft is accepted only where it
equals the verify step's own argmax, so the emitted tokens are exactly
plain greedy decoding's.

On an int8 fused-layout tree (`ops/fused_decode.fused_eligible`) every
verify step is one call of K4's verify form (`fused_verify_hidden`), as
the JAX package's `_verify_fused` and `verify_step_cb` dispatch there;
other trees take the per-layer path with an explicit causal bias over the
cache (the JAX package's XLA path); for MPT it carries ALiBi over the
keys' true token positions (`speculative.py:124-129` of the JAX package).
TOKENPACKER_FD_VERIFY has no counterpart.

`speculative_chunk` is a host loop of draft -> verify -> accept rounds
(the JAX package's on-device `while_loop`): eager PyTorch syncs once a
round for the acceptance count either way.

Cache discipline: a round at decode step s writes rows for all k+1 fed
tokens; the rejected drafts' rows are written again by the next round
(which starts at s + a + 1 <= s + k + 1) before they are ever attended.
"""

from __future__ import annotations

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.generate import fused_weights
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.lm_api import lm_apply, lm_embed, lm_logits
from tokenpacker_tpu_torch.ops.fused_decode import FusedWeights, fused_verify_hidden
from tokenpacker_tpu_torch.ops.layers import rms_norm

NEG_INF = torch.finfo(torch.float32).min


def _fused_logits(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens, len0, start2, end2,
                  write_pos0, positions, fused, w8a8: bool):
    """K4-verify over the T fed tokens (K4-LoRA's verify form when the tree
    carries a multi-LoRA bundle), then the final norm and the head."""
    lm = params["lm"]
    hidden, _, _ = fused_verify_hidden(
        lm, cfg.lm, lm_embed(lm, cfg.lm, tokens), cache.k, cache.v, len0, start2, end2,
        write_pos0, positions.int(), k_scale=cache.k_scale, v_scale=cache.v_scale,
        slot_lora=lm.get("fd_slot_lora"),
        weights=fused if isinstance(fused, FusedWeights) else None,
    )
    return lm_logits(lm, cfg.lm, rms_norm(lm["norm"], hidden, cfg.lm.rms_norm_eps), w8a8)


def _layers_logits(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens, positions, ok,
                   w8a8: bool, key_positions=None):
    """The per-layer path over the T fed tokens with the key mask ok
    [N, T, S], written from cache.length; key_positions [N, S]: the keys'
    token positions for MPT's ALiBi (the slot indices when None)."""
    lm = params["lm"]
    bias = torch.where(ok[:, None], 0.0, NEG_INF)
    hidden = lm_apply(lm, cfg.lm, lm_embed(lm, cfg.lm, tokens), positions, cache, attn_bias=bias,
                      w8a8=w8a8, key_positions=key_positions)
    return lm_logits(lm, cfg.lm, hidden, w8a8)


def verify_step(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens: torch.Tensor,
                lengths: torch.Tensor, step: int, prefill_len: int, fused=None,
                w8a8: bool = False):
    """Score T = k+1 tokens in one forward over the bucket-padded cache of
    `generate.prefill`. tokens [N, T]: the last accepted token and T-1
    drafts. logits[:, j] is what the j'th of T `generate.decode_step`s from
    `step` gives: token j goes in at cache slot prefill_len + step + j and
    query position lengths + step + j, and attends the prompt [0, lengths)
    and the decoded span up to itself. fused: `generate.fused_weights` of
    the params (None decides here). Writes the cache in place; returns
    (logits [N, T, V], cache) with length prefill_len + step + T."""
    if fused is None:
        fused = fused_weights(params, cfg)
    n, t = tokens.shape
    offs = torch.arange(t, device=tokens.device)
    positions = lengths.long()[:, None] + step + offs
    if fused:
        start2 = torch.full_like(lengths, prefill_len)
        end2 = start2 + step
        logits = _fused_logits(params, cfg, cache, tokens, lengths, start2, end2, end2, positions,
                               fused, w8a8)
    else:
        key = torch.arange(cache.k.shape[2], device=tokens.device)[None, None, :]
        ok = (key < lengths[:, None, None]) | (
            (key >= prefill_len) & (key <= prefill_len + step + offs[None, :, None]))
        # the decoded span's keys sit at token positions lengths + j
        slot = key[:, 0]
        key_pos = torch.where(slot >= prefill_len, slot - prefill_len + lengths.long()[:, None], slot)
        cache.length = prefill_len + step
        logits = _layers_logits(params, cfg, cache, tokens, positions, ok, w8a8, key_pos)
    cache.length = prefill_len + step + t
    return logits, cache


def verify_step_cb(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens: torch.Tensor,
                   cur_lens: torch.Tensor, fused=None, w8a8: bool = False):
    """The continuous batcher's verify step over slot-contiguous caches
    (the speculative sibling of `generate.decode_step_cb`): tokens [N, T],
    each slot's last accepted token and its drafts (-1 pads a slot with
    fewer; such tokens are never accepted). Token j of slot i is written at
    cur_lens[i] + j and attends [0, cur_lens[i] + j]. Returns (logits
    [N, T, V], cache) with cache.length = cur_lens: the caller advances each
    slot by its own acceptance."""
    if fused is None:
        fused = fused_weights(params, cfg)
    n, t = tokens.shape
    positions = cur_lens.long()[:, None] + torch.arange(t, device=tokens.device)
    if fused:
        zeros = torch.zeros_like(cur_lens)
        logits = _fused_logits(params, cfg, cache, tokens, cur_lens, zeros, zeros, cur_lens,
                               positions, fused, w8a8)
    else:
        key = torch.arange(cache.k.shape[2], device=tokens.device)[None, None, :]
        cache.length = cur_lens
        logits = _layers_logits(params, cfg, cache, tokens, positions,
                                key <= positions[:, :, None], w8a8)
    cache.length = cur_lens
    return logits, cache


def propose_ngram(ctx: torch.Tensor, ctx_len: int, k: int, ngram: int = 2):
    """Prompt lookup on the device. ctx [S] int: the request's tokens
    (prompt and generated; -1 at image and pad positions, so they never
    match a token), ctx_len the count of valid ones. Returns (draft [k],
    dk in [0, k]): the continuation of the earliest earlier occurrence of
    ctx[ctx_len - ngram : ctx_len]. ctx must have k slots of slack past
    ctx_len (the callers allocate it)."""
    s = ctx.shape[0]
    idx = torch.arange(s, device=ctx.device)
    suffix = ctx[max(ctx_len - ngram, 0):][:ngram]
    eq = idx < ctx_len - ngram  # a window strictly before the suffix's own
    for j in range(ngram):
        eq &= torch.roll(ctx, -j) == suffix[j]
    start = int(eq.int().argmax()) + ngram  # the earliest match (argmax takes the first)
    draft = ctx[min(start, s - k):][:k]
    found = bool(eq.any()) and ctx_len > ngram
    return draft, min(k, ctx_len - start) if found else 0


def propose_ngram_host(ctx: list[int], k: int, ngram: int = 2) -> list[int]:
    """`propose_ngram` on a host list, the continuation cut to what exists
    (the batchers' drafts)."""
    if len(ctx) <= ngram or k <= 0:
        return []
    suffix = ctx[-ngram:]
    for i in range(len(ctx) - ngram):
        if ctx[i:i + ngram] == suffix:
            return list(ctx[i + ngram:i + ngram + k])
    return []


def accept_greedy(preds_row, draft_row, dk: int, eos: int) -> list[int]:
    """The emitted burst of one round: the verify argmax of the longest
    prefix of drafts that match it, plus the token after them, cut at EOS.
    preds_row [T], draft_row [T - 1] (the fed drafts)."""
    burst = [int(preds_row[0])]
    for j in range(dk):
        if int(preds_row[j]) != int(draft_row[j]) or burst[-1] == eos:
            break
        burst.append(int(preds_row[j + 1]))
    return burst


def speculative_chunk(params, cfg: TokenPackerVLMConfig, cache: KVCache, ctx: torch.Tensor,
                      ctx_len: int, lengths: torch.Tensor, last_tok, step0: int,
                      prefill_len: int, n_max: int, k: int, ngram: int = 2, fused=None,
                      w8a8: bool = False):
    """At least n_max greedy tokens of one request (batch 1) by draft ->
    verify -> accept rounds. ctx [S_ctx] on the device (`make_ctx`, at least
    n_max + k slots past ctx_len), ctx_len its valid count; lengths [1] the
    true prompt length; last_tok the last emitted token; step0 the decode
    step that consumes it. The cache needs room for prefill_len + step0 +
    n_max + k + 1 rows. Returns (tokens: the emitted ones, n_max to
    n_max + k of them, exactly the plain greedy sequence; cache, ctx,
    ctx_len, last token, rounds, logits [1, V] behind the last token).
    len(tokens) / rounds is the gain over one-token decoding."""
    if fused is None:
        fused = fused_weights(params, cfg)
    tokens: list[int] = []
    step, rounds = step0, 0
    last = torch.as_tensor(last_tok, device=ctx.device).reshape(1).to(ctx.dtype)
    while len(tokens) < n_max:
        draft, dk = propose_ngram(ctx, ctx_len, k, ngram)
        fed = torch.cat([last, draft])[None].long()  # [1, k + 1]
        logits, cache = verify_step(params, cfg, cache, fed, lengths, step, prefill_len, fused,
                                    w8a8)
        preds = logits[0].argmax(-1)  # [k + 1]
        match = (preds[:k] == draft).tolist()
        a = 0
        while a < dk and match[a]:
            a += 1
        ctx[ctx_len:ctx_len + k + 1] = preds.to(ctx.dtype)  # the rest is rewritten next round
        accepted = preds[:a + 1].tolist()
        tokens += accepted
        ctx_len += a + 1
        step += a + 1
        rounds += 1
        last = preds[a:a + 1].to(ctx.dtype)
    return tokens, cache, ctx, ctx_len, last, rounds, logits[:, a]


def make_ctx(token_ids_row, is_image_row, true_len: int, capacity: int) -> np.ndarray:
    """The [capacity] int32 lookup buffer of a splice-plan row: image
    positions and padding become -1. Two -1s can still match (a suffix over
    an image region may match an earlier one); such drafts are rejected by
    verify, whose argmax is never -1, so that costs draft quality only."""
    ctx = np.full((capacity,), -1, np.int32)
    row = np.asarray(token_ids_row, np.int64).copy()
    row[np.asarray(is_image_row, bool)] = -1
    row[true_len:] = -1
    n = min(len(row), capacity)
    ctx[:n] = row[:n].astype(np.int32)
    return ctx
