"""Beam search (counterpart of `tokenpacker_tpu/beam.py`), HF 4.57's
vectorized `_beam_search` semantics: running and finished beam sets, the
top 2k continuations a step, additive -1e9 masking, and the
early-stopping heuristic; do_sample=False, any length_penalty,
early_stopping in {False, True, "never"}, stopping at EOS or the length
limit, finished sequences that keep their EOS.

The search is batched: n requests x k beams decode as one n*k-row
`generate.decode_step` (K4 at n*k rows on an int8 fused tree), and the
candidate selection (`_select`) runs over all n samples at once. A
sample that has finished keeps its state while the others run, so each
sample's result is its batch-1 result. The beam reorder is a gather of
the cache's rows over the decoded span only (`_gather_cache`): the
prompt's rows are the same in every beam of a sample. An int8 cache's
scales move with its rows.

Selection breaks ties as the JAX package's `jax.lax.top_k` does, lower
index first (`generate.top_sorted`): the -1e9 terms make exact ties on
purpose (-1e9 + logp rounds to -1e9 in fp32, and the finished scores
start at -1e9). The loop tests on the host whether any sample is still
running once every CHECK_EVERY steps; a step past the end changes no
state. The port refuses more than MAX_BEAMS beams (ValueError).
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.generate import (
    decode_step,
    device_batch,
    fused_weights,
    prefill,
    top_sorted,
)
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.lm_api import embedding_table

NEG = -1.0e9
# the JAX eval runner lets num_beams up to 16 through (its beam batch cap
# floors to 1 above that; tokenpacker_tpu/eval/runner.py:81-85)
MAX_BEAMS = 16
CHECK_EVERY = 8  # steps between the host's tests of whether a sample still runs


def _cache_leaves(cache: KVCache) -> list[str]:
    return ["k", "v"] + (["k_scale", "v_scale"] if cache.k_scale is not None else [])


def _tile_cache(cache: KVCache, k: int) -> KVCache:
    """[L, n, ...] prefill cache -> [L, n*k, ...], sample-major (a sample's
    k beams are adjacent rows and share its prompt)."""
    for name in _cache_leaves(cache):
        setattr(cache, name, getattr(cache, name).repeat_interleave(k, dim=1))
    return cache


def _gather_cache(cache: KVCache, idx: torch.Tensor, lo: int, hi: int) -> KVCache:
    """The beam reorder, in place: rows [lo, hi) of every row of the n*k
    batch axis come from row idx of it (the decoded span; the prompt's
    rows are equal across a sample's beams and idx never leaves a
    sample)."""
    for name in _cache_leaves(cache):
        a = getattr(cache, name)
        a[:, :, lo:hi] = a[:, :, lo:hi].index_select(1, idx)
    return cache


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [n, m, ...] gathered along dim 1 by idx [n, j] -> [n, j, ...]."""
    return a.gather(1, idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(
        idx.shape + a.shape[2:]))


def _select(st: dict, logits: torch.Tensor, t: int, k: int, max_new: int, eos: int, lp: float,
            early_stopping) -> dict:
    """One selection round for every sample (HF's _get_top_k_continuations,
    _get_running_beams_for_next_iteration, _update_finished_beams and
    _check_early_stop_heuristic). logits [n, k, V]; t is the column the
    chosen tokens land in. The -1e9 masking is additive, HF's arithmetic,
    so that ties break alike."""
    n, _, vocab = logits.shape
    device = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    acc = logp + st["run_scores"][:, :, None]
    vals, idx = top_sorted(acc.reshape(n, -1), 2 * k)
    src, tok = idx // vocab, idx % vocab
    cand_seqs = _take(st["run_seqs"], src).clone()
    cand_seqs[:, :, t] = tok
    # stopping criteria of each candidate: EOS, or the length limit
    hits = (tok == eos) | (t + 1 >= max_new)

    # the finished set (only candidates ranked within the top k may finish)
    denom = torch.full((1, 1), t + 1, dtype=torch.float32, device=device) ** lp
    pen = vals / denom
    did_finish = hits & (torch.arange(2 * k, device=device) < k)
    fin = pen + (~did_finish).float() * NEG
    fin = fin + (~st["unsat"]).float()[:, None] * NEG
    if early_stopping is True:
        fin = fin + st["fin_flags"].all(dim=-1).float()[:, None] * NEG
    fvals, fidx = top_sorted(torch.cat([st["fin_scores"], fin], dim=1), k)
    fin_seqs = _take(torch.cat([st["fin_seqs"], cand_seqs], dim=1), fidx)
    fin_lens = _take(torch.cat([st["fin_lens"], torch.full_like(tok, t + 1)], dim=1), fidx)
    fin_flags = _take(torch.cat([st["fin_flags"], did_finish], dim=1), fidx)

    # the running beams of the next step (finished candidates demoted)
    rvals, ridx = top_sorted(vals + hits.float() * NEG, k)

    # can the best running beam still beat the worst finished one?
    best_len = max_new if early_stopping == "never" and lp > 0 else t + 1
    best_possible = rvals[:, :1] / (torch.full((1, 1), best_len, dtype=torch.float32,
                                               device=device) ** lp)
    worst = torch.where(fin_flags, fvals.amin(dim=-1, keepdim=True), NEG)
    unsat = st["unsat"] & (best_possible > worst).any(dim=-1)
    unfinished = unsat & ~hits.all(dim=-1)
    if early_stopping is True:
        unfinished = unfinished & ~fin_flags.all(dim=-1)
    return {"tok": _take(tok, ridx), "src": _take(src, ridx), "run_scores": rvals,
            "run_seqs": _take(cand_seqs, ridx), "fin_scores": fvals, "fin_seqs": fin_seqs,
            "fin_lens": fin_lens, "fin_flags": fin_flags, "unsat": unsat,
            "unfinished": unfinished}


def _beam_loop(params, cfg: TokenPackerVLMConfig, cache: KVCache, logits0: torch.Tensor,
               lengths: torch.Tensor, k: int, max_new: int, prefill_len: int, lp: float,
               early_stopping, fused, w8a8: bool) -> dict:
    """The search for n samples x k beams. cache: [L, n*k, ...] (the tiled
    prefill, written in place); logits0 [n, V] the prompts' next-token
    logits; lengths [n] the true prompt lengths. Returns the final state:
    fin_seqs [n, k, max_new], fin_scores [n, k], fin_lens [n, k], each
    sample's finished slots sorted by score."""
    n, vocab = logits0.shape
    device = logits0.device
    eos = cfg.lm.eos_token_id
    st = {
        "tok": torch.zeros((n, k), dtype=torch.int64, device=device),
        "src": torch.arange(k, device=device).expand(n, k),
        # beam 0 starts at 0, the others at -1e9: the k beams are the same
        # until the first selection, and this keeps the top 2k distinct
        "run_scores": torch.where(torch.arange(k, device=device) == 0, 0.0, NEG).expand(n, k),
        "run_seqs": torch.zeros((n, k, max_new), dtype=torch.int64, device=device),
        "fin_scores": torch.full((n, k), NEG, device=device),
        "fin_seqs": torch.zeros((n, k, max_new), dtype=torch.int64, device=device),
        "fin_lens": torch.zeros((n, k), dtype=torch.int64, device=device),
        "fin_flags": torch.zeros((n, k), dtype=torch.bool, device=device),
        "unsat": torch.ones((n,), dtype=torch.bool, device=device),
        "unfinished": torch.ones((n,), dtype=torch.bool, device=device),
    }
    # step 0 selects from the prompt's logits (HF forwards the prompt on k
    # identical beams: one row, broadcast)
    st = _select(st, logits0[:, None].expand(n, k, vocab), 0, k, max_new, eos, lp,
                 early_stopping)
    lengths_flat = lengths.repeat_interleave(k)  # sample-major, as the cache
    base = (torch.arange(n, device=device) * k)[:, None]
    for t in range(1, max_new):
        if t % CHECK_EVERY == 1 and not bool(st["unfinished"].any()):
            break
        _gather_cache(cache, (base + st["src"]).reshape(-1), prefill_len, prefill_len + max_new)
        logits, cache = decode_step(params, cfg, cache, st["tok"].reshape(-1), lengths_flat,
                                    t - 1, prefill_len, fused, w8a8)
        new = _select(st, logits.reshape(n, k, vocab), t, k, max_new, eos, lp, early_stopping)
        # a sample that has stopped keeps its state (its cache rows go on
        # being written and are never read back)
        live = st["unfinished"]
        st = {name: torch.where(live.reshape((n,) + (1,) * (a.dim() - 1)), a, st[name])
              for name, a in new.items()}
    return st


@torch.no_grad()
def beam_generate(params, cfg: TokenPackerVLMConfig, batch: dict, num_beams: int,
                  max_new_tokens: int = 128, length_penalty: float = 1.0,
                  early_stopping: bool | str = False, kv_cache_dtype: torch.dtype | None = None,
                  w8a8: bool = False, vit_block: bool = False,
                  fused=None) -> tuple[list[list[int]], list[float]]:
    """Beam-search a batch of requests (splice-plan numpy arrays, images
    optional) on the params' device. kv_cache_dtype / w8a8 / vit_block:
    as `generate.prefill`; fused: `generate.fused_weights` of the params
    (None decides here). Returns (per sample the generated ids, its
    terminal EOS included when the beam ended on one; per sample the
    sequence score, sum of log-probabilities / length**length_penalty)."""
    if not 1 <= num_beams <= MAX_BEAMS:
        raise ValueError(f"num_beams must lie in [1, {MAX_BEAMS}] (the port's limit), "
                         f"got {num_beams}")
    if early_stopping not in (False, True, "never"):
        raise ValueError(f"early_stopping must be False, True or 'never', got {early_stopping!r}")
    device = embedding_table(params["lm"]).device
    if fused is None:
        fused = fused_weights(params, cfg)
    n, l = batch["token_ids"].shape
    dev = device_batch(batch, cfg.dtype, device)
    logits, cache = prefill(params, cfg, dev, l + max_new_tokens, kv_cache_dtype, w8a8, vit_block)
    cache = _tile_cache(cache, num_beams)
    st = _beam_loop(params, cfg, cache, logits, dev["lengths"], num_beams, max_new_tokens, l,
                    float(length_penalty), early_stopping, fused, w8a8)
    seqs, lens = st["fin_seqs"][:, 0].cpu().numpy(), st["fin_lens"][:, 0].cpu().numpy()
    scores = st["fin_scores"][:, 0].cpu().tolist()
    return [[int(x) for x in seqs[i, : lens[i]]] for i in range(n)], [float(s) for s in scores]
