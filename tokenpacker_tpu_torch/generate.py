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

This port is greedy only: sampling, penalties and beams raise
NotImplementedError.
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
    leaves without K4's bundle, as in the JAX package)."""
    lm = params["lm"]
    if not fused_eligible(lm, cfg.lm):
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


@dataclass
class GenerationResult:
    sequences: list[list[int]]  # generated ids per sample (prompt excluded)
    texts: list[str] | None = None
    last_logits: torch.Tensor | None = None  # [N, V] of the last step run
    # host-clock seconds: "prefill_s" (vision + prefill + first token on the
    # host), "decode_s" (the decode loop); "decode_steps" and (speculation)
    # "verify_rounds" run
    stats: dict = field(default_factory=dict)


class Generator:
    """Greedy generation over the port's parameters (on one device).
    kv_cache_dtype: the cache storage, cfg.dtype by default or torch.int8;
    w8a8: `ops/layers.linear`'s w8a8 mode for the int8 products; vit_block:
    the tower's blocks through K9."""

    def __init__(self, params, cfg: TokenPackerVLMConfig, tokenizer=None,
                 kv_cache_dtype: torch.dtype | None = None, w8a8: bool = False,
                 vit_block: bool = False):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.kv_cache_dtype = kv_cache_dtype
        self.w8a8 = w8a8
        self.vit_block = vit_block
        self.device = embedding_table(params["lm"]).device
        self.fused = fused_weights(params, cfg)

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
        check_every: int = 8,
        speculative: int = 0,
        num_beams: int = 1,
        repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
    ) -> GenerationResult:
        """batch: splice-plan numpy arrays (token_ids / is_image /
        image_slot / lengths) + optional images [views, H, W, 3].

        Greedy: the host syncs once every `check_every` tokens to test EOS
        and the stop strings (which need a tokenizer). speculative: the
        draft length k of prompt-lookup speculation (`speculative.py`),
        batch 1 only; the tokens are plain greedy decoding's."""
        n, l = batch["token_ids"].shape
        unported = {
            "temperature > 0": temperature > 0.0,
            "top_p": top_p is not None,
            "top_k": top_k is not None,
            "min_p": min_p is not None,
            # the JAX engine decodes a batch plainly and ignores the option
            "speculative > 0 with a batch of more than 1": speculative > 0 and n > 1,
            "num_beams > 1": num_beams > 1,
            "repetition/presence/frequency penalties": (
                repetition_penalty != 1.0 or presence_penalty != 0.0 or frequency_penalty != 0.0
            ),
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(f"not ported yet (greedy only): {', '.join(asked)}")

        cfg = self.cfg
        # speculation runs whole chunks of rounds and truncates on the host,
        # so the cache has room for a chunk and a round past the end
        spec_chunk = max(check_every, 2 * speculative)
        s_max = l + max_new_tokens + (spec_chunk + speculative if speculative > 0 else 0)
        t0 = time.perf_counter()
        dev = device_batch(batch, cfg.dtype, self.device)
        logits, cache = prefill(self.params, cfg, dev, s_max, self.kv_cache_dtype, self.w8a8,
                                self.vit_block)
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

        tok = logits.argmax(dim=-1)
        all_done = absorb(tok.cpu().numpy()[:, None])
        t1 = time.perf_counter()
        produced, steps, rounds = 1, 0, 0
        if speculative > 0:
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
                tok = logits.argmax(dim=-1)
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
