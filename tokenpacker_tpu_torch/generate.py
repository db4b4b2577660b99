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

This slice is greedy only: sampling, penalties, beams and speculation
raise NotImplementedError.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.lm_api import lm_apply, lm_embed, lm_logits
from tokenpacker_tpu_torch.models.vlm import vlm_hidden
from tokenpacker_tpu_torch.ops.fused_decode import FusedWeights, fused_decode_hidden, fused_eligible
from tokenpacker_tpu_torch.ops.layers import rms_norm

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
            kv_cache_dtype: torch.dtype | None = None):
    """batch: device tensors from `device_batch`. kv_cache_dtype: the cache
    storage, cfg.dtype by default or torch.int8. Returns (next-token logits
    [N, V], cache) with the prompt's keys in cache slots [0, L)."""
    dtype = kv_cache_dtype or cfg.dtype
    tile = cache_len_tile(dtype)
    s_max = -(-s_max // tile) * tile
    n, l = batch["token_ids"].shape
    device = batch["token_ids"].device
    cache = KVCache.create(cfg.lm, n, s_max, dtype=dtype, device=device)
    positions = torch.arange(l, device=device).expand(n, l)
    hidden = vlm_hidden(params, cfg, {**batch, "positions": positions}, cache)
    idx = (batch["lengths"].long() - 1).clamp(min=0)
    last = hidden[torch.arange(n, device=device), idx]
    return lm_logits(params["lm"], cfg.lm, last), cache


def fused_weights(params, cfg: TokenPackerVLMConfig) -> FusedWeights | bool:
    """How decode steps of these params run: K4's weight table for an
    eligible tree on the card, True for one on the CPU (its plain version
    needs no table), False for the per-layer path."""
    lm = params["lm"]
    if not fused_eligible(lm, cfg.lm):
        return False
    return True if lm["embed"].device.type == "cpu" else FusedWeights(lm, cfg.lm)


def _decode_step_fused(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens, lengths,
                       step: int, prefill_len: int, weights):
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
        k_scale=cache.k_scale, v_scale=cache.v_scale,
        weights=weights if isinstance(weights, FusedWeights) else None,
    )
    cache.length = prefill_len + step + 1
    return lm_logits(lm, cfg.lm, rms_norm(lm["norm"], hidden, cfg.lm.rms_norm_eps)), cache


def decode_step(params, cfg: TokenPackerVLMConfig, cache: KVCache, tokens: torch.Tensor,
                lengths: torch.Tensor, step: int, prefill_len: int, fused=None):
    """One token for every sample: tokens [N] go in at cache slot
    prefill_len + step, at query position lengths + step. Writes the cache
    in place; returns (logits [N, V], cache).

    fused: what `fused_weights` returned for these params (Generator
    computes it once); None decides here. Eligible trees go through K4,
    the others through the per-layer path (K3)."""
    if fused is None:
        fused = fused_weights(params, cfg)
    if fused:
        return _decode_step_fused(params, cfg, cache, tokens, lengths, step, prefill_len, fused)
    positions = (lengths.long() + step)[:, None]
    emb = lm_embed(params["lm"], cfg.lm, tokens[:, None])
    cache.length = prefill_len + step
    needed = torch.full_like(lengths, prefill_len + step + 1)
    hidden = lm_apply(
        params["lm"], cfg.lm, emb, positions, cache, decode_info=(lengths, needed, prefill_len)
    )
    return lm_logits(params["lm"], cfg.lm, hidden[:, 0]), cache


@dataclass
class GenerationResult:
    sequences: list[list[int]]  # generated ids per sample (prompt excluded)
    texts: list[str] | None = None
    last_logits: torch.Tensor | None = None  # [N, V] of the last step run
    # host-clock seconds: "prefill_s" (vision + prefill + first token on the
    # host), "decode_s" (the decode loop); "decode_steps" run
    stats: dict = field(default_factory=dict)


class Generator:
    """Greedy generation over the port's parameters (on one device).
    kv_cache_dtype: the cache storage, cfg.dtype by default or torch.int8."""

    def __init__(self, params, cfg: TokenPackerVLMConfig, tokenizer=None,
                 kv_cache_dtype: torch.dtype | None = None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.kv_cache_dtype = kv_cache_dtype
        self.device = params["lm"]["embed"].device
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
        and the stop strings (which need a tokenizer)."""
        unported = {
            "temperature > 0": temperature > 0.0,
            "top_p": top_p is not None,
            "top_k": top_k is not None,
            "min_p": min_p is not None,
            "speculative > 0": speculative > 0,
            "num_beams > 1": num_beams > 1,
            "repetition/presence/frequency penalties": (
                repetition_penalty != 1.0 or presence_penalty != 0.0 or frequency_penalty != 0.0
            ),
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(f"not ported yet (greedy only): {', '.join(asked)}")

        cfg = self.cfg
        n, l = batch["token_ids"].shape
        t0 = time.perf_counter()
        dev = device_batch(batch, cfg.dtype, self.device)
        logits, cache = prefill(self.params, cfg, dev, l + max_new_tokens, self.kv_cache_dtype)
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
        produced, steps = 1, 0
        while not all_done and produced < max_new_tokens:
            chunk = min(check_every, max_new_tokens - produced)
            toks = []
            for i in range(chunk):
                logits, cache = decode_step(
                    self.params, cfg, cache, tok, lengths, produced - 1 + i, l, self.fused
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
        stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_steps": steps}
        return GenerationResult(out_tokens, texts, logits, stats)
