"""Generation engine: prefill + greedy decode with a KV cache (counterpart
of `tokenpacker_tpu/generate.py`).

Shape discipline as in the JAX engine: prompts are right-padded to a
bucket length L, the cache holds L + max_new_tokens positions (rounded up
to 8 for a float cache and 32 for an int8 one, so shapes equal the JAX
engine's), prefill writes keys to slots [0, L), and decode step t writes
slot L + t for every sample while sample i's query position is its true
length + t. Decode attention sees the two ranges [0, length_i) and
[L, L + t] (K3's `decode_info` on the per-layer path; K4's ranges
[0, length_i) U [L, L + t) plus the current token on the fused path).

The cache dtype is an explicit `kv_cache_dtype` (the model dtype, or
torch.int8 for per-(position, head) int8 rows), where the JAX package
reads TOKENPACKER_KV_CACHE. A decode step goes through K4
(`_decode_step_fused`) whenever `fused_eligible` holds for the tree (the
int8 fused layout of `io/weights.quantize_lm_int8`), where the JAX
package also reads TOKENPACKER_FUSED_DECODE and the TPU's cache gates.
A 4-bit tree (`io/weights.quantize_lm_4bit`) decodes per layer, each
product through K6. The w8a8 mode of the int8 products is the explicit
`w8a8` (the JAX package reads TOKENPACKER_W8A8): prefill's products take
K8, the LM head of a step K7; K4's step is unchanged by it. The fused
tower block is the explicit `vit_block` (TOKENPACKER_VIT_BLOCK): each
tower block one K9 call.

`decode_step_cb` and `insert_into_cache` are the continuous batcher's
steps over slot-contiguous caches (`serve/scheduler.ContinuousBatcher`).
With multi-LoRA serving (`serve/multi_lora`) the tree carries slot-LoRA
leaves, and on a K4 tree also K4's bundle (`lm["fd_slot_lora"]`): the
fused step then runs K4-LoRA (the JAX package's default; it has no
TOKENPACKER_FD_LORA switch here), and leaves without a bundle take the
per-layer path, where `ops/layers.linear` adds the term.
`Generator.generate(speculative=k)` decodes batch 1 by prompt-lookup
speculation (`speculative.py`, K4's verify form on an int8 tree).

Both LM families run here. MPT (`models/mpt.py`) prefills through K2's
key-only ALiBi bias, decodes per layer through K3's slopes (the kernel
compacts the bucketed key positions), takes `prefill_chunk`'s chunks and
the speculative verify through `sdpa` with ALiBi over true key positions,
and keeps a cache in the model dtype (`kv_cache_dtype=torch.int8`
raises, where the JAX package ignores TOKENPACKER_KV_CACHE for it).

Sampling follows the JAX package's `sample_tokens` and
`sample_tokens_per_row` (one function here, `sample_tokens`): the
filters of HF 4.57's warper order (temperature, top-k, top-p, min-p;
`filter_logits`) and then a Gumbel-max draw (`draw`), as
`jax.random.categorical` draws. Unseeded rows take their noise from an
explicit `torch.Generator`; a row with a seed takes it from a counter
hash of (seed, step, vocabulary index) alone (`seed_keys` on the host,
`seeded_uniform` on the device), so its
k-th token depends on its seed, k and its logits and on nothing else
(JAX's threefry stream itself cannot be reproduced, so sampled paths
are held by support and distribution, not by equal samples). The
token-history penalties (`apply_penalties`) run before the filters and
apply to greedy decoding too; logprob entries (`token_logprob_entry`)
read the raw logits. Everything stays on the logits' device: the host
syncs once per `check_every` chunk, as greedy decoding does. Beams run
in `beam.py`. `Generator.generate_stream(seed=)` draws a seeded
request's tokens by the same rule as the batchers (the HTTP worker's
direct path), and `Generator.warmup` runs the kernels' build and one
prefill and decode step when a server starts.

Over a sharded tree (`parallel/sharding.shard_params`, one process a
rank) every rank runs the same calls in lockstep on its part: the cache
holds the rank's local kv heads, the tower splits the crops over 'data'
under an active mesh, and the logits are gathered whole on every rank, so
the host's decisions (tokens, stops) agree. K4 runs one device's full
width and reads whole weights, so the decode dispatch is written here:
on a sharded tree `fused_weights` is False and every step takes the
per-layer path (K3 attention, K7 / K6 / plain products, an all-reduce
over 'model' after `o` and `down`); K4 under tensor parallelism is later
work (ROADMAP queue 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.models.llama import KVCache, make_attention_bias
from tokenpacker_tpu_torch.models.lm_api import embedding_table, lm_apply, lm_embed, lm_logits
from tokenpacker_tpu_torch.models.splice import assemble_embeds
from tokenpacker_tpu_torch.models.vlm import vlm_hidden
from tokenpacker_tpu_torch.parallel.sharding import local_config, mesh_of
from tokenpacker_tpu_torch.ops.fused_decode import FusedWeights, fused_decode_hidden, fused_eligible
from tokenpacker_tpu_torch.ops.layers import rms_norm
from tokenpacker_tpu_torch.serve.multi_lora import has_slot_lora

DEFAULT_BUCKETS = (128, 256, 512, 1024, 1536, 2048)


def cache_len_tile(dtype: torch.dtype) -> int:
    """Cache-length alignment of `prefill`: the JAX engine's (32 rows for
    an int8 cache, 8 otherwise), so both engines make the same shapes."""
    return 32 if dtype == torch.int8 else 8


def pick_bucket(length: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return int(np.ceil(length / 512) * 512)


def device_batch(batch: dict, dtype: torch.dtype, device: torch.device | str) -> dict:
    """A splice-plan batch (numpy token_ids / is_image / image_slot /
    lengths, optional images [views, H, W, 3]) as tensors on `device`."""

    def put(x, dt):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    images = batch.get("images")
    return {
        "token_ids": put(batch["token_ids"], torch.int64),
        "is_image": put(batch["is_image"], torch.bool),
        "image_slot": put(batch["image_slot"], torch.int64),
        "lengths": put(batch["lengths"], torch.int32),
        "images": None if images is None else torch.as_tensor(images).to(device=device, dtype=dtype),
    }


def prefill(params, cfg: TokenPackerVLMConfig, batch: dict, s_max: int,
            kv_cache_dtype: torch.dtype | None = None, w8a8: bool = False,
            vit_block: bool = False):
    """batch: device tensors from `device_batch`. kv_cache_dtype: the cache
    storage, cfg.dtype by default or torch.int8; w8a8: `ops/layers.linear`'s
    w8a8 mode; vit_block: the tower's blocks through K9. Returns (next-token
    logits [N, V], cache) with the prompt's keys in cache slots [0, L)."""
    cfg = local_config(cfg, params)
    dtype = kv_cache_dtype or cfg.dtype
    tile = cache_len_tile(dtype)
    s_max = -(-s_max // tile) * tile
    n, l = batch["token_ids"].shape
    device = batch["token_ids"].device
    cache = KVCache.create(cfg.lm, n, s_max, dtype=dtype, device=device)
    positions = torch.arange(l, device=device).expand(n, l)
    hidden = vlm_hidden(params, cfg, {**batch, "positions": positions}, cache, w8a8=w8a8,
                        vit_block=vit_block)
    idx = (batch["lengths"].long() - 1).clamp(min=0)
    last = hidden[torch.arange(n, device=device), idx]
    return lm_logits(params["lm"], cfg.lm, last, w8a8), cache


def prefill_chunk(params, cfg: TokenPackerVLMConfig, cache: KVCache, visual: torch.Tensor,
                  token_ids: torch.Tensor, is_image: torch.Tensor, image_slot: torch.Tensor,
                  offset: int, chunk_len: int, kv_cache_dtype: torch.dtype | None = None,
                  w8a8: bool = False):
    """One chunk of an incremental batch-1 prefill (chunked admission and
    prefix-cache suffixes in `serve/scheduler`).

    cache: a batch-1 KVCache whose positions [0, offset) are filled, made
    by the caller with storage `kv_cache_dtype` (cfg.dtype by default, or
    torch.int8; a cache of another dtype raises). visual [views, tpv, D]:
    the request's projector output. token_ids / is_image / image_slot
    [1, chunk_len]: slices of the splice plan (image_slot global, as
    `visual`). The chunk's rows are written at [offset, offset +
    chunk_len) and it attends every cache position up to its own (K2,
    which sees the current tokens only, would be wrong for offset > 0).
    Returns (final-norm hidden [1, chunk_len, D], cache with length
    offset + chunk_len)."""
    dtype = kv_cache_dtype or cfg.dtype
    if cache.k.dtype != dtype:
        raise ValueError(f"prefill_chunk: the cache holds {cache.k.dtype}, expected {dtype}")
    s_max = cache.k.shape[2]
    device = token_ids.device
    embeds = assemble_embeds(params["lm"], visual, token_ids, is_image, image_slot, cfg.lm)
    positions = offset + torch.arange(chunk_len, device=device)[None, :]
    key_valid = torch.arange(s_max, device=device)[None, :] < offset + chunk_len
    bias = make_attention_bias(positions, key_valid)
    cache.length = offset
    hidden = lm_apply(params["lm"], cfg.lm, embeds, positions, cache, attn_bias=bias, w8a8=w8a8)
    return hidden, cache


def fused_weights(params, cfg: TokenPackerVLMConfig) -> FusedWeights | bool:
    """How decode steps of these params run: K4's weight table for an
    eligible tree on the card, True for one on the CPU (its plain version
    needs no table), False for the per-layer path (also for slot-LoRA
    leaves without K4's bundle, as in the JAX package, and for a sharded
    tree: module docstring)."""
    lm = params["lm"]
    if mesh_of(lm) is not None or not fused_eligible(lm, cfg.lm):
        return False
    if lm.get("fd_slot_lora") is None and has_slot_lora(lm):
        return False
    return True if embedding_table(lm).device.type == "cpu" else FusedWeights(lm, cfg.lm)


def _decode_step_fused(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens, lengths,
                       step: int, prefill_len: int, weights, w8a8: bool = False):
    """decode_step on K4: the attendable ranges are the prompt [0, lengths_i)
    and the decoded span [prefill_len, prefill_len + step); the current
    token is attended in the kernel, which writes its row at slot
    prefill_len + step. The final norm and the LM head run outside."""
    lm = params["lm"]
    emb = lm_embed(lm, cfg.lm, tokens[:, None])[:, 0]
    start2 = torch.full_like(lengths, prefill_len)
    end2 = start2 + step
    hidden, _, _ = fused_decode_hidden(
        lm, cfg.lm, emb, cache.k, cache.v, lengths, start2, end2, end2, lengths + step,
        k_scale=cache.k_scale, v_scale=cache.v_scale, slot_lora=lm.get("fd_slot_lora"),
        weights=weights if isinstance(weights, FusedWeights) else None,
    )
    cache.length = prefill_len + step + 1
    return lm_logits(lm, cfg.lm, rms_norm(lm["norm"], hidden, cfg.lm.rms_norm_eps), w8a8), cache


def decode_step(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens: torch.Tensor,
                lengths: torch.Tensor, step: int, prefill_len: int, fused=None,
                w8a8: bool = False):
    """One token for every sample: tokens [N] go in at cache slot
    prefill_len + step, at query position lengths + step. Writes the cache
    in place; returns (logits [N, V], cache).

    fused: what `fused_weights` returned for these params (Generator
    computes it once); None decides here. Eligible trees go through K4,
    the others through the per-layer path (K3). w8a8: `ops/layers.linear`'s
    w8a8 mode for the int8 products outside K4."""
    if fused is None:
        fused = fused_weights(params, cfg)
    if fused:
        return _decode_step_fused(params, cfg, cache, tokens, lengths, step, prefill_len, fused,
                                  w8a8)
    positions = (lengths.long() + step)[:, None]
    emb = lm_embed(params["lm"], cfg.lm, tokens[:, None])
    cache.length = prefill_len + step
    needed = torch.full_like(lengths, prefill_len + step + 1)
    hidden = lm_apply(
        params["lm"], cfg.lm, emb, positions, cache, decode_info=(lengths, needed, prefill_len),
        w8a8=w8a8,
    )
    return lm_logits(params["lm"], cfg.lm, hidden[:, 0], w8a8), cache


def decode_step_cb(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens: torch.Tensor,
                   cur_lens: torch.Tensor, active: torch.Tensor, fused=None,
                   w8a8: bool = False):
    """A continuous-batching step over slot-contiguous caches: slot i's
    sequence fills positions [0, cur_lens[i]); its token is written at
    cur_lens[i] and attends [0, cur_lens[i]]. tokens, cur_lens (int32),
    active: [N]. An eligible tree takes one K4 call (ranges [0, cur_lens)
    plus the current token), the others the per-layer path (K3). Writes the
    cache in place; returns (logits [N, V], cache) with cache.length =
    cur_lens + active. Inactive slots write at their cur_lens too, rows
    that an admission overwrites."""
    if fused is None:
        fused = fused_weights(params, cfg)
    lm = params["lm"]
    if fused:
        emb = lm_embed(lm, cfg.lm, tokens[:, None])[:, 0]
        zeros = torch.zeros_like(cur_lens)
        hidden, _, _ = fused_decode_hidden(
            lm, cfg.lm, emb, cache.k, cache.v, cur_lens, zeros, zeros, cur_lens, cur_lens,
            k_scale=cache.k_scale, v_scale=cache.v_scale, slot_lora=lm.get("fd_slot_lora"),
            weights=fused if isinstance(fused, FusedWeights) else None,
        )
        logits = lm_logits(lm, cfg.lm, rms_norm(lm["norm"], hidden, cfg.lm.rms_norm_eps), w8a8)
    else:
        needed = cur_lens + 1
        cache.length = cur_lens
        hidden = lm_apply(lm, cfg.lm, lm_embed(lm, cfg.lm, tokens[:, None]),
                          cur_lens.long()[:, None], cache, decode_info=(needed, needed, 0),
                          w8a8=w8a8)
        logits = lm_logits(lm, cfg.lm, hidden[:, 0], w8a8)
    cache.length = cur_lens + active.to(cur_lens.dtype)
    return logits, cache


def insert_into_cache(big: KVCache, small: KVCache, slot: int) -> KVCache:
    """Copy a prefilled batch-1 cache into slot `slot` of the shared one, in
    place. The storage must match (an int8 cache's rows copied raw into a
    float cache would be read as values). The small cache may be wider than
    the shared one when prefill's length alignment passes max_seq_len: the
    copy stops at the shared cache's end (those rows are padding)."""
    if big.k.dtype != small.k.dtype or (big.k_scale is None) != (small.k_scale is None):
        raise ValueError(f"KV cache dtype mismatch: shared {big.k.dtype} (quantized="
                         f"{big.k_scale is not None}) vs prefill {small.k.dtype} (quantized="
                         f"{small.k_scale is not None})")
    l_pad = min(small.k.shape[2], big.k.shape[2])
    pairs = [(big.k, small.k), (big.v, small.v)]
    if big.k_scale is not None:
        pairs += [(big.k_scale, small.k_scale), (big.v_scale, small.v_scale)]
    for dst, src in pairs:
        dst[:, slot, :l_pad] = src[:, 0, :l_pad]
    return big


# -- penalties, sampling and logprobs (the JAX package's generate.py:551-704) ----


def _rows(x, like: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A setting as a [N | 1, 1] tensor on `like`'s device: a tensor or an
    array of one value a row, or one value for every row. A Python number
    becomes a device tensor (`torch.full`, no host copy): dividing by a
    Python float rounds differently from JAX's float32 division."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=dtype).reshape(-1, 1)
    if np.ndim(x) == 0:
        return torch.full((1, 1), x, dtype=dtype, device=like.device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=like.device).reshape(-1, 1)


def _per_row(x) -> bool:
    return isinstance(x, torch.Tensor) or np.ndim(x) > 0


def prompt_presence_mask(batch, vocab: int) -> np.ndarray:
    """[n, V] bool: which vocabulary ids each sample's prompt holds, for
    `apply_penalties`' repetition term. Only true-length text positions
    count (pads and image placeholder positions do not)."""
    ids = np.asarray(batch["token_ids"])
    im = np.asarray(batch["is_image"])
    lens = np.asarray(batch["lengths"]).astype(np.int64)
    out = np.zeros((ids.shape[0], vocab), bool)
    for i in range(ids.shape[0]):
        v = ids[i, : lens[i]][~im[i, : lens[i]]]
        out[i, v[(v >= 0) & (v < vocab)]] = True
    return out


def apply_penalties(logits, counts, prompt_presence, repetition_penalty,
                    presence_penalty=0.0, frequency_penalty=0.0) -> torch.Tensor:
    """Token-history penalties, before the filters (HF runs its logits
    processors before the warpers, greedy decoding included).
    repetition_penalty: HF RepetitionPenaltyLogitsProcessor's arithmetic
    over every id seen (the prompt's text tokens and the generated ones):
    score * penalty where the score is negative, score / penalty
    otherwise. presence / frequency: the OpenAI fields over generated
    tokens only, score - frequency * count - presence * (count > 0).
    counts [N, V] int (generated tokens), prompt_presence [N, V] bool;
    each penalty a number or one a row. Identity values (1, 0, 0) leave a
    row's fp32 logits bit-unchanged; a term whose single value is the
    identity is skipped (the same bits, fewer launches). Returns fp32
    [N, V]."""
    logits = logits.float()
    generated = counts > 0
    if _per_row(repetition_penalty) or repetition_penalty != 1.0:
        rep = _rows(repetition_penalty, logits)
        logits = torch.where(prompt_presence | generated,
                             torch.where(logits < 0, logits * rep, logits / rep), logits)
    if _per_row(frequency_penalty) or frequency_penalty != 0.0:
        logits = logits - _rows(frequency_penalty, logits) * counts.float()
    if _per_row(presence_penalty) or presence_penalty != 0.0:
        logits = logits - _rows(presence_penalty, logits) * generated.float()
    return logits


def filter_logits(logits, temperature, top_k=None, top_p=None, min_p=None) -> torch.Tensor:
    """The sampling filters in HF 4.57's warper order: temperature, top-k,
    top-p, min-p, each on the temperature-scaled logits; the dropped
    entries become -inf. Each setting is a number (the JAX package's
    `sample_tokens`) or one value a row (`sample_tokens_per_row`); None
    leaves a filter off, as do values outside its range: top_k <= 0 or
    >= V, top_p >= 1, min_p outside (0, 1].
    - top-k keeps every entry tied with the k-th largest (`< kth` drops);
    - top-p's cutoff is the sorted row's entry at sum(cdf < top_p) (the
      last one if rounding leaves the cdf below top_p), and every entry
      tied with it stays;
    - min-p drops probabilities below min_p times the row's largest.
    Returns fp32 [N, V]; a row with temperature <= 0 is scaled by 1e-6
    (the sampler takes its argmax instead). A filter with one value for
    every row needs no per-row masks."""
    temps = _rows(temperature, logits)
    scaled = logits.float() / (temps.clamp(min=1e-6) if _per_row(temperature) else temps)
    v = scaled.shape[-1]
    neg = -torch.inf
    use_k = top_k is not None and (_per_row(top_k) or 0 < top_k < v)
    use_p = top_p is not None and (_per_row(top_p) or top_p < 1.0)
    use_m = min_p is not None and (_per_row(min_p) or 0.0 < min_p <= 1.0)
    srt = scaled.sort(dim=-1, descending=True).values if use_k or use_p else None
    if use_k:
        if _per_row(top_k):
            k = _rows(top_k, scaled, torch.int64)
            kth = srt.gather(-1, (k - 1).clamp(0, v - 1).expand(srt.shape[0], 1))
            on = (k > 0) & (k < v)
            drop, srt_drop = on & (scaled < kth), on & (srt < kth)
        else:
            kth = srt[:, top_k - 1:top_k]
            drop, srt_drop = scaled < kth, srt < kth
        scaled = torch.where(drop, neg, scaled)
        if use_p:  # the dropped entries are the sorted row's tail: no second sort
            srt = torch.where(srt_drop, neg, srt)
    if use_p:
        p = _rows(top_p, scaled) if _per_row(top_p) else top_p
        cdf = srt.softmax(dim=-1).cumsum(dim=-1)
        # JAX's take_along_axis clamps an index of V; gather would raise
        idx = (cdf < p).sum(dim=-1, keepdim=True).clamp(max=v - 1)
        drop = scaled < srt.gather(-1, idx)
        scaled = torch.where(drop & (p < 1.0) if _per_row(top_p) else drop, neg, scaled)
    if use_m:
        m = _rows(min_p, scaled) if _per_row(min_p) else min_p
        probs = scaled.softmax(dim=-1)
        drop = probs < m * probs.amax(dim=-1, keepdim=True)
        if _per_row(min_p):
            drop = drop & (m > 0.0) & (m <= 1.0)
        scaled = torch.where(drop, neg, scaled)
    return scaled


_U32 = 0xFFFFFFFF


def _fmix32(h: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer, on the host in uint64."""
    h = h.astype(np.uint64) & _U32
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(_U32)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(_U32)
    return h ^ (h >> np.uint64(16))


def seed_keys(seeds, steps) -> np.ndarray:
    """The host's half of the seed rule: a 32-bit key a row from (seed &
    0x7FFFFFFF, step) alone (murmur3's finalizer twice), -1 for a row whose
    seed is negative (no seed). int64 [N]."""
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    steps = np.asarray(steps, np.int64).reshape(-1)
    key = _fmix32(_fmix32((seeds & 0x7FFFFFFF) ^ 0x9E3779B9) ^ (steps & _U32).astype(np.uint64))
    return np.where(seeds >= 0, key.astype(np.int64), -1)


def seeded_uniform(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Uniform (0, 1) fp32 [N, V] from each row's `seed_keys` key and the
    vocabulary index alone: a 32-bit xorshift-multiply mix in int64 tensor
    ops whose multipliers stay below 2^31, so that no product of 32-bit
    values overflows and any device gives the same bits."""
    idx = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    h = ((idx * 0x9E3779B1) & _U32)[None, :] ^ keys.to(torch.int64).reshape(-1, 1)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x5BD1E995) & _U32
    h = h ^ (h >> 16)
    return ((h >> 9).float() + 0.5) * 2.0**-23  # 23 bits and a half: exact in fp32, in (0, 1)


def gumbel_noise(shape, device, generator: torch.Generator | None = None,
                 keys=None) -> torch.Tensor:
    """Gumbel(0, 1) noise [N, V], -log(-log(u)). Rows with keys[i] >= 0
    (`seed_keys`) take u from `seeded_uniform`, the others from
    `generator` (torch's default generator of the device when None)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    if keys is not None:
        keys = torch.as_tensor(keys, device=device).reshape(-1, 1)
        u = torch.where(keys >= 0, seeded_uniform(keys, shape[-1]), u)
    return -torch.log(-torch.log(u))


def draw(filtered: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One token a row from the filtered logits: argmax(filtered + noise),
    the Gumbel-max draw of jax.random.categorical. [N] int64."""
    return (filtered + noise).argmax(dim=-1)


def sample_tokens(logits, temperature, top_p=None, top_k=None, min_p=None,
                  generator: torch.Generator | None = None, keys=None):
    """The next token of every row (the JAX package's `sample_tokens` and
    `sample_tokens_per_row` in one): the argmax of the unfiltered logits
    where a row's temperature is <= 0, else a draw from `filter_logits`.
    Settings are numbers or one value a row. keys [N] (`seed_keys` of the
    OpenAI `seed` and the request's token count): a row with keys[i] >= 0
    draws from `seeded_uniform`, whatever its slot, its neighbours or
    `generator`; the others from `generator`. No host sync."""
    per_row = _per_row(temperature)
    if not per_row and temperature <= 0.0:
        return logits.argmax(dim=-1)
    filtered = filter_logits(logits, temperature, top_k, top_p, min_p)
    sampled = draw(filtered, gumbel_noise(filtered.shape, filtered.device, generator, keys))
    if not per_row:
        return sampled
    return torch.where(_rows(temperature, logits)[:, 0] <= 0.0, logits.argmax(dim=-1), sampled)


def top_sorted(x: torch.Tensor, n: int):
    """The n largest entries of each row and their ids, lower ids first
    among equal values (jax.lax.top_k's order; torch.topk promises none)."""
    values, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :n], ids[..., :n]


def token_logprob_entry(logits_row, tok: int, n_top: int) -> dict:
    """OpenAI-style logprob record of one token, {"id", "logprob", "top":
    [(id, logprob), ...]}, from the model's raw next-token distribution
    (before penalties and filters)."""
    tok = int(tok)
    chosen, values, ids = logprob_rows(logits_row.reshape(1, -1),
                                       torch.full((1,), tok, device=logits_row.device), n_top)
    entry = {"id": tok, "logprob": chosen.item()}
    if n_top > 0:
        entry["top"] = list(zip(ids[0].tolist(), values[0].tolist()))
    return entry


def logprob_rows(logits: torch.Tensor, toks: torch.Tensor, n_top: int):
    """`token_logprob_entry` for every row at once, on the device: (the
    chosen tokens' logprobs [N], the top n_top logprobs [N, n_top] and
    their ids)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = lp.gather(-1, toks.reshape(-1, 1).long())[:, 0]
    return (chosen, *top_sorted(lp, n_top))


@dataclass
class GenerationResult:
    sequences: list[list[int]]  # generated ids per sample (prompt excluded)
    texts: list[str] | None = None
    last_logits: torch.Tensor | None = None  # [N, V] raw logits of the last step run
    # host-clock seconds: "prefill_s" (vision + prefill + first token on the
    # host), "decode_s" (the decode loop or the beam search); "decode_steps"
    # and (speculation) "verify_rounds" run
    stats: dict = field(default_factory=dict)


class Generator:
    """Generation over the port's parameters (on one device): greedy or
    sampled decoding with token-history penalties, prompt-lookup
    speculation (batch 1), beam search (`beam.py`) and per-request
    streaming. kv_cache_dtype: the cache storage, cfg.dtype by default or
    torch.int8; w8a8: `ops/layers.linear`'s w8a8 mode for the int8
    products; vit_block: the tower's blocks through K9."""

    def __init__(self, params, cfg: TokenPackerVLMConfig, tokenizer=None,
                 kv_cache_dtype: torch.dtype | None = None, w8a8: bool = False,
                 vit_block: bool = False):
        self.params = params
        self.cfg = local_config(cfg, params)
        self.tokenizer = tokenizer
        self.kv_cache_dtype = kv_cache_dtype
        self.w8a8 = w8a8
        self.vit_block = vit_block
        self.device = embedding_table(params["lm"]).device
        self.fused = fused_weights(params, self.cfg)
        # generate_stream's work, summed over its calls (host counts): the
        # prefills, the plain decode steps and the speculative verify rounds
        self.stream_stats = {"prefills": 0, "decode_steps": 0, "verify_rounds": 0}

    def _prefill(self, batch: dict, s_max: int):
        dev = device_batch(batch, self.cfg.dtype, self.device)
        logits, cache = prefill(self.params, self.cfg, dev, s_max, self.kv_cache_dtype, self.w8a8,
                                self.vit_block)
        return dev, logits, cache

    def _sampler(self, batch: dict, generator, temperature, top_p, top_k, min_p,
                 repetition_penalty, presence_penalty, frequency_penalty):
        """logits [n, V] (and the keys of `seed_keys`, or None) -> next
        tokens [n], on the device: the penalties over the prompt and the
        tokens drawn so far (their counts stay on the device), then
        `sample_tokens`. generator None: a fresh one seeded 0 (JAX's
        PRNGKey(0)), so two calls give the same tokens."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if repetition_penalty == 1.0 and presence_penalty == 0.0 and frequency_penalty == 0.0:
            return lambda logits, keys=None: sample_tokens(logits, temperature, top_p, top_k,
                                                           min_p, generator, keys)
        n, vocab = batch["token_ids"].shape[0], self.cfg.lm.vocab_size
        presence = torch.as_tensor(prompt_presence_mask(batch, vocab), device=self.device)
        counts = torch.zeros((n, vocab), dtype=torch.int32, device=self.device)
        ones = torch.ones((n, 1), dtype=torch.int32, device=self.device)

        def sample(logits, keys=None):
            logits = apply_penalties(logits, counts, presence, repetition_penalty,
                                     presence_penalty, frequency_penalty)
            tok = sample_tokens(logits, temperature, top_p, top_k, min_p, generator, keys)
            counts.scatter_add_(1, tok[:, None], ones)
            return tok

        return sample

    @torch.no_grad()
    def generate(
        self,
        batch: dict,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float | None = None,
        top_k: int | None = None,
        min_p: float | None = None,
        stop_strings: tuple[str, ...] = (),
        generator: torch.Generator | None = None,
        check_every: int = 8,
        speculative: int = 0,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        early_stopping: bool | str = False,
        repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
    ) -> GenerationResult:
        """batch: splice-plan numpy arrays (token_ids / is_image /
        image_slot / lengths) + optional images [views, H, W, 3].

        The host syncs once every `check_every` tokens to test EOS and the
        stop strings (which need a tokenizer). Sampling (temperature > 0,
        top_k, top_p, min_p: `filter_logits`) draws from `generator` (the
        counterpart of JAX's rng_key). The penalties (`apply_penalties`)
        apply to greedy decoding too.

        speculative: the draft length k of prompt-lookup speculation
        (`speculative.py`); used when greedy, unpenalized and batch 1, and
        ignored otherwise, as in the JAX engine. num_beams > 1: beam search
        (`beam.py`, with length_penalty and early_stopping) when
        temperature <= 0, where penalties raise ValueError; a positive
        temperature falls back to plain sampling."""
        n, l = batch["token_ids"].shape
        penalized = repetition_penalty != 1.0 or presence_penalty != 0.0 or frequency_penalty != 0.0
        if num_beams > 1 and temperature <= 0.0:
            if penalized:
                raise ValueError("repetition/presence/frequency penalties are not supported "
                                 "with beam search")
            return self._generate_beams(batch, num_beams, max_new_tokens, length_penalty,
                                        early_stopping, stop_strings)
        use_spec = speculative > 0 and temperature <= 0.0 and n == 1 and not penalized
        cfg = self.cfg
        # speculation runs whole chunks of rounds and truncates on the host,
        # so the cache has room for a chunk and a round past the end
        spec_chunk = max(check_every, 2 * speculative)
        s_max = l + max_new_tokens + (spec_chunk + speculative if use_spec else 0)
        t0 = time.perf_counter()
        dev, logits, cache = self._prefill(batch, s_max)
        sample = self._sampler(batch, generator, temperature, top_p, top_k, min_p,
                               repetition_penalty, presence_penalty, frequency_penalty)
        lengths = dev["lengths"]
        eos = cfg.lm.eos_token_id
        done = np.zeros(n, dtype=bool)
        out_tokens: list[list[int]] = [[] for _ in range(n)]

        def absorb(tok_2d: np.ndarray) -> bool:
            """Append tokens per sample up to its EOS; True when all are done."""
            for i in range(n):
                if done[i]:
                    continue
                for t in tok_2d[i]:
                    out_tokens[i].append(int(t))
                    if t == eos:
                        done[i] = True
                        break
            if stop_strings and self.tokenizer is not None:
                for i in range(n):
                    if not done[i] and any(
                        s in self.tokenizer.decode(out_tokens[i]) for s in stop_strings
                    ):
                        done[i] = True
            return bool(done.all())

        tok = sample(logits)
        all_done = absorb(tok.cpu().numpy()[:, None])
        t1 = time.perf_counter()
        produced, steps, rounds = 1, 0, 0
        if use_spec:
            # imported here: speculative.py builds on this module
            from tokenpacker_tpu_torch.speculative import make_ctx, speculative_chunk

            k = speculative
            cap = l + max_new_tokens + spec_chunk + 2 * k + 8
            ctx = torch.as_tensor(make_ctx(batch["token_ids"][0], batch["is_image"][0],
                                           int(batch["lengths"][0]), cap), device=self.device)
            ctx_len = int(batch["lengths"][0])
            ctx[ctx_len] = tok[0]
            ctx_len += 1
            last = tok[0]
            while not all_done and produced < max_new_tokens:
                toks, cache, ctx, ctx_len, last, n_rounds, logits = speculative_chunk(
                    self.params, cfg, cache, ctx, ctx_len, lengths, last, produced - 1, l,
                    spec_chunk, k, fused=self.fused, w8a8=self.w8a8)
                toks = toks[: max_new_tokens - produced]
                rounds += n_rounds
                all_done = absorb(np.asarray(toks)[None])
                produced += len(toks)
        while not all_done and produced < max_new_tokens:
            chunk = min(check_every, max_new_tokens - produced)
            toks = []
            for i in range(chunk):
                logits, cache = decode_step(
                    self.params, cfg, cache, tok, lengths, produced - 1 + i, l, self.fused,
                    self.w8a8,
                )
                tok = sample(logits)
                toks.append(tok)
            steps += chunk
            all_done = absorb(torch.stack(toks, dim=1).cpu().numpy())
            produced += chunk
        t2 = time.perf_counter()

        texts = None
        if self.tokenizer is not None:
            texts = []
            for i in range(n):
                ids = [t for t in out_tokens[i] if t != eos]
                text = self.tokenizer.decode(ids, skip_special_tokens=True)
                for s in stop_strings:
                    if s and text.endswith(s):
                        text = text[: -len(s)]
                texts.append(text.strip())
        stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_steps": steps,
                 "verify_rounds": rounds}
        return GenerationResult(out_tokens, texts, logits, stats)

    def _generate_beams(self, batch, num_beams, max_new_tokens, length_penalty,
                        early_stopping, stop_strings) -> GenerationResult:
        # imported here: beam.py builds on this module
        from tokenpacker_tpu_torch.beam import beam_generate

        t0 = time.perf_counter()
        seqs, _scores = beam_generate(
            self.params, self.cfg, batch, num_beams, max_new_tokens, length_penalty,
            early_stopping, kv_cache_dtype=self.kv_cache_dtype, w8a8=self.w8a8,
            vit_block=self.vit_block, fused=self.fused)
        seconds = time.perf_counter() - t0
        texts = None
        if self.tokenizer is not None:
            eos = self.cfg.lm.eos_token_id
            texts = []
            for ids in seqs:
                text = self.tokenizer.decode([t for t in ids if t != eos],
                                             skip_special_tokens=True)
                # beams run to EOS or the length limit, so a stop string can
                # sit inside the text: cut at the first one
                for s in stop_strings:
                    if s and s in text:
                        text = text[: text.index(s)]
                texts.append(text.strip())
        return GenerationResult(seqs, texts, stats={"decode_s": seconds})

    def _stream_text(self, toks: list[int], stop_strings) -> tuple[str, bool]:
        """The streamed text of `toks`, cut before the first stop string;
        and whether one was found."""
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        stopped = False
        for s in stop_strings:
            if s and s in text:
                text = text.split(s)[0]
                stopped = True
        return text, stopped

    @torch.no_grad()
    def generate_stream(
        self,
        batch: dict,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float | None = None,
        top_k: int | None = None,
        min_p: float | None = None,
        stop_strings: tuple[str, ...] = (),
        generator: torch.Generator | None = None,
        speculative: int = 0,
        repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        logprobs: int | None = None,
        seed: int | None = None,
    ):
        """Streaming of one request (batch 1): yields the decoded text so
        far after every token, or (text, entry) with `logprobs` set, the
        entry `token_logprob_entry` of the token just produced with
        `logprobs` alternatives, from the raw logits. EOS ends the stream
        (its token is not shown) and a stop string cuts the text and ends
        it. speculative: greedy prompt-lookup speculation, accepted drafts
        arriving as a burst; ignored when sampling, penalized or with
        logprobs, as in the JAX engine. seed: the OpenAI `seed`; token k
        of a sampled stream then draws with `seed_keys(seed, k)` and
        `seeded_uniform`, the rule of both batchers, whatever `generator`
        is (None: noise from `generator`). Needs a tokenizer."""
        n, l = batch["token_ids"].shape
        if n != 1:
            raise ValueError(f"streaming is per request (batch 1), got a batch of {n}")
        if self.tokenizer is None:
            raise ValueError("streaming decodes text: the Generator needs a tokenizer")
        penalized = repetition_penalty != 1.0 or presence_penalty != 0.0 or frequency_penalty != 0.0
        if speculative > 0 and temperature <= 0.0 and not penalized and logprobs is None:
            yield from self._stream_speculative(batch, max_new_tokens, stop_strings, speculative)
            return
        dev, logits, cache = self._prefill(batch, l + max_new_tokens)
        self.stream_stats["prefills"] += 1
        sample = self._sampler(batch, generator, temperature, top_p, top_k, min_p,
                               repetition_penalty, presence_penalty, frequency_penalty)
        eos = self.cfg.lm.eos_token_id
        toks: list[int] = []
        for step in range(max_new_tokens):
            keys = None
            if seed is not None and temperature > 0.0:
                keys = torch.as_tensor(seed_keys([seed], [step]), device=self.device)
            tok_t = sample(logits, keys)
            tok = int(tok_t[0])
            if tok == eos:
                break
            toks.append(tok)
            text, stopped = self._stream_text(toks, stop_strings)
            yield text if logprobs is None else (text, token_logprob_entry(logits[0], tok,
                                                                           logprobs))
            if stopped or step == max_new_tokens - 1:
                break
            logits, cache = decode_step(self.params, self.cfg, cache, tok_t, dev["lengths"], step,
                                        l, self.fused, self.w8a8)
            self.stream_stats["decode_steps"] += 1

    def _stream_speculative(self, batch, max_new_tokens: int, stop_strings, k: int):
        """Greedy streaming by host-side prompt-lookup drafts and one verify
        step a round; no draft (or a backoff after 4 rounds that landed
        none: 16 rounds) takes a plain decode step instead."""
        from tokenpacker_tpu_torch.speculative import accept_greedy, propose_ngram_host, verify_step

        l = batch["token_ids"].shape[1]
        dev, logits, cache = self._prefill(batch, l + max_new_tokens + k + 1)
        self.stream_stats["prefills"] += 1
        lengths = dev["lengths"]
        eos = self.cfg.lm.eos_token_id
        true_len = int(batch["lengths"][0])
        ctx = [-1 if im else int(t) for t, im in zip(batch["token_ids"][0][:true_len],
                                                     batch["is_image"][0][:true_len])]
        last = int(logits[0].argmax())
        toks: list[int] = []
        step = zero_streak = plain_budget = 0
        while last != eos and len(toks) < max_new_tokens:
            toks.append(last)
            ctx.append(last)
            text, stopped = self._stream_text(toks, stop_strings)
            yield text
            if stopped or len(toks) >= max_new_tokens:
                return
            draft = [] if plain_budget > 0 else propose_ngram_host(ctx, k)
            if not draft:
                # a k+1-wide verify with nothing to verify costs more than a step
                plain_budget = max(0, plain_budget - 1)
                logits, cache = decode_step(
                    self.params, self.cfg, cache, torch.tensor([last], device=self.device),
                    lengths, step, l, self.fused, self.w8a8)
                self.stream_stats["decode_steps"] += 1
                burst = [int(logits[0].argmax())]
            else:
                fed = np.full((1, k + 1), -1, np.int64)
                fed[0, 0] = last
                fed[0, 1:1 + len(draft)] = draft
                logits, cache = verify_step(self.params, self.cfg, cache,
                                            torch.as_tensor(fed, device=self.device), lengths,
                                            step, l, self.fused, self.w8a8)
                self.stream_stats["verify_rounds"] += 1
                burst = accept_greedy(logits[0].argmax(-1).cpu().numpy(), draft, len(draft), eos)
                zero_streak = zero_streak + 1 if len(burst) == 1 else 0
                if zero_streak >= 4:
                    plain_budget, zero_streak = 16, 0
            step += len(burst)
            # all but the burst's last token are emitted here; the last one
            # becomes `last`, which the loop's head emits or stops at
            for t in burst[:-1]:
                if t == eos or len(toks) >= max_new_tokens:
                    return
                toks.append(t)
                ctx.append(t)
                text, stopped = self._stream_text(toks, stop_strings)
                yield text
                if stopped:
                    return
            last = burst[-1]

    @torch.no_grad()
    def warmup(self, buckets=(256, 512), batch_sizes=(1,), max_new_tokens: int = 128,
               n_crops: int = 1, speculative: int = 0):
        """What the first request would pay once, paid at start-up (the
        counterpart of the JAX engine's `warmup`, which compiles its
        executables): on the card, the kernels' build (`ops/_build.library()`);
        then one prefill of `n_crops` views and one decode step at each
        bucket length and batch size, and with `speculative` = k > 0 a
        verify step of k + 1 tokens at batch 1, so that cuBLAS, the
        allocator and every kernel of the streaming path have run once."""
        if self.device.type == "cuda":
            from tokenpacker_tpu_torch.ops import _build

            _build.library()
        cfg = self.cfg
        size = cfg.vision.image_size
        for l in buckets:
            for n in batch_sizes:
                token_ids = np.zeros((n, l), np.int64)
                token_ids[:, 0] = cfg.lm.bos_token_id
                batch = {"token_ids": token_ids, "is_image": np.zeros((n, l), bool),
                         "image_slot": np.zeros((n, l), np.int64),
                         "lengths": np.full((n,), 2, np.int32),
                         "images": np.zeros((n_crops, size, size, 3), np.float32)}
                s_max = l + max_new_tokens + (speculative + 1 if speculative > 0 else 0)
                dev, logits, cache = self._prefill(batch, s_max)
                tok = logits.argmax(dim=-1)
                logits, cache = decode_step(self.params, cfg, cache, tok, dev["lengths"], 0, l,
                                            self.fused, self.w8a8)
                if speculative > 0 and n == 1:
                    from tokenpacker_tpu_torch.speculative import verify_step

                    fed = torch.zeros((1, speculative + 1), dtype=torch.int64, device=self.device)
                    verify_step(self.params, cfg, cache, fed, dev["lengths"], 1, l, self.fused,
                                self.w8a8)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
