"""Paged KV pool: block-table attention for serving (counterpart of
`tokenpacker_tpu/ops/paged_kv.py`).

K/V live in a shared pool of fixed-size pages and each sequence owns a row
of the page table, so memory follows the sum of the live sequences'
lengths, not batch x maximum length. Page 0 is the null page: unmapped
logical blocks point at it and inactive slots write into it.

Layout:
  k_pages/v_pages: [L, P, page_size, Hkv, d]   (model dtype, or int8)
  k_scales/v_scales: [L, P, page_size, Hkv] f32 (int8 pools only)
  page_table:      [B, max_pages]  int32
  lengths:         [B]             int32

The pool is written **in place** (the JAX package returns updated
copies): every function here mutates the `PagedKV` it is given and
returns it. Decode attention is K5 (`ops/paged_attention`), which reads
the pages through the table; on CPU tensors its plain version gathers
them. The pool's storage dtype is an explicit argument of
`PagedKV.create`, where the JAX package reads TOKENPACKER_KV_CACHE, and
the w8a8 mode of the int8 products the explicit `w8a8` (TOKENPACKER_W8A8).
Speculation's `paged_verify_step` scores T fed tokens a sequence through
the page-gather path (`sdpa` over the gathered pages), as in the JAX
package: K5 takes one query a sequence.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.generate import prefill_chunk
from tokenpacker_tpu_torch.models.llama import (
    KVCache,
    apply_rope,
    attn_out,
    mlp_block,
    qkv_proj,
    rope_cos_sin,
    sdpa,
)
from tokenpacker_tpu_torch.models.lm_api import lm_embed, lm_logits
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from tokenpacker_tpu_torch.ops.layers import rms_norm
from tokenpacker_tpu_torch.ops.paged_attention import paged_attention
from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel import sharding


@dataclass
class PagedKV:
    k_pages: torch.Tensor  # [L, P, ps, Hkv, d]
    v_pages: torch.Tensor
    page_table: torch.Tensor  # [B, MP] int32
    lengths: torch.Tensor  # [B] int32
    k_scales: torch.Tensor | None = None  # [L, P, ps, Hkv] f32, int8 pools
    v_scales: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: LMConfig, num_pages: int, page_size: int, batch: int,
               max_pages_per_seq: int, dtype: torch.dtype,
               device: torch.device | str = "cuda") -> "PagedKV":
        shape = (cfg.num_hidden_layers, num_pages, page_size, cfg.kv_heads, cfg.head_dim)
        scales = (None, None)
        if dtype == torch.int8:
            scales = tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                           for _ in range(2))
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros((batch, max_pages_per_seq), dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
            *scales,
        )

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]


class PageAllocator:
    """Host-side refcounted free list over the physical pages. Page 0 is
    the null page and is never handed out. A prefix-cached page is held by
    the cache and by every sequence that maps it; it returns to the free
    list when the last reference is released."""

    def __init__(self, num_pages: int):
        self.free = list(range(num_pages - 1, 0, -1))
        self.refs: dict[int, int] = {}

    def alloc(self, n: int = 1) -> list[int]:
        if len(self.free) < n:
            raise RuntimeError("paged KV pool exhausted")
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def incref(self, page: int) -> None:
        p = int(page)
        if p not in self.refs:
            raise RuntimeError(f"incref of untracked page {p}")
        self.refs[p] += 1

    def release(self, pages) -> None:
        for p in pages:
            p = int(p)
            if p == 0:
                continue
            # a second release of a page would put it on the free list twice
            # and hand it to two sequences
            if p not in self.refs:
                raise RuntimeError(f"release of untracked page {p} (double free?)")
            left = self.refs[p] - 1
            if left <= 0:
                del self.refs[p]
                self.free.append(p)
            else:
                self.refs[p] = left

    def available(self) -> int:
        return len(self.free)


def _paged_layer(p, cfg: LMConfig, x, cos, sin, paged: PagedKV, layer: int, cur_lens,
                 write_page, w8a8: bool = False):
    """One decode layer over the pool. x [N, 1, D]; the new K/V row of
    sequence n goes to (write_page[n], cur_lens[n] % ps), as int8 rows and
    scales for an int8 pool; attention is K5 over cur_lens + 1 keys."""
    n = x.shape[0]
    kp, vp = paged.k_pages[layer], paged.v_pages[layer]
    off = (cur_lens % paged.page_size).long()
    p = sharding.gathered(p)
    h = comm.copy_to(rms_norm(p["input_ln"], x, cfg.rms_norm_eps), getattr(cfg, "attn_axis", None))
    q, k, v = qkv_proj(p["attn"], cfg, h, w8a8)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if paged.k_scales is not None:
        ks, vs = paged.k_scales[layer], paged.v_scales[layer]
        kp[write_page, off], ks[write_page, off] = quantize_kv(k[:, 0])
        vp[write_page, off], vs[write_page, off] = quantize_kv(v[:, 0])
    else:
        ks = vs = None
        kp[write_page, off] = k[:, 0].to(kp.dtype)
        vp[write_page, off] = v[:, 0].to(vp.dtype)
    attn = paged_attention(q[:, 0].contiguous(), kp, vp, paged.page_table, cur_lens + 1, ks, vs)
    x = x + attn_out(p["attn"], cfg, attn.reshape(n, 1, -1), w8a8)
    h2 = rms_norm(p["post_ln"], x, cfg.rms_norm_eps)
    return x + mlp_block(p["mlp"], cfg, h2, w8a8)


def paged_decode_step(params, cfg, paged: PagedKV, tokens: torch.Tensor, active: torch.Tensor,
                      w8a8: bool = False):
    """One token for every slot over the pool. tokens [N]; active [N] bool;
    paged.lengths are the current lengths (the write positions). Inactive
    slots may hold stale table rows whose pages were freed and handed out
    again, so their writes go to the null page 0. Writes the pool in place
    and advances the active slots' lengths; returns (logits [N, V],
    paged). cfg: TokenPackerVLMConfig; w8a8: `ops/layers.linear`'s w8a8
    mode (K7 for the int8 products of a step)."""
    lm_cfg = cfg.lm
    lm = params["lm"]
    n = tokens.shape[0]
    mp = paged.page_table.shape[1]
    cur_lens = paged.lengths
    rows = torch.arange(n, device=tokens.device)
    block = (cur_lens // paged.page_size).long().clamp(max=mp - 1)
    write_page = torch.where(active, paged.page_table[rows, block], 0).long()
    x = lm_embed(lm, lm_cfg, tokens[:, None])
    cos, sin = (c.to(x.dtype) for c in
                rope_cos_sin(cur_lens[:, None], lm_cfg.head_dim, lm_cfg.rope_theta))
    for i, layer in enumerate(lm["layers"]):
        x = _paged_layer(layer, lm_cfg, x, cos, sin, paged, i, cur_lens, write_page, w8a8)
    x = rms_norm(lm["norm"], x, lm_cfg.rms_norm_eps)
    logits = lm_logits(lm, lm_cfg, x[:, 0], w8a8)
    paged.lengths += active.to(paged.lengths.dtype)
    return logits, paged


def _paged_verify_layer(p, cfg: LMConfig, x, cos, sin, paged: PagedKV, layer: int, write_page,
                        write_off, bias, w8a8: bool = False):
    """One verify layer over the pool: x [N, T, D]; the T new K/V rows of
    sequence n go to (write_page[n, t], write_off[n, t]) first, then
    attention over every page of the sequence's table (gathered,
    dequantized for an int8 pool) under `bias` [N, 1, T, S]."""
    n, t, _ = x.shape
    kp, vp = paged.k_pages[layer], paged.v_pages[layer]
    p = sharding.gathered(p)
    h = comm.copy_to(rms_norm(p["input_ln"], x, cfg.rms_norm_eps), getattr(cfg, "attn_axis", None))
    q, k, v = qkv_proj(p["attn"], cfg, h, w8a8)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    table = paged.page_table.long()

    def gathered(pages, scales=None):
        rows = pages[table].reshape(n, -1, cfg.kv_heads, cfg.head_dim)
        if scales is None:
            return rows.to(q.dtype)
        return dequantize_kv(rows, scales[table].reshape(n, -1, cfg.kv_heads), q.dtype)

    if paged.k_scales is not None:
        ks, vs = paged.k_scales[layer], paged.v_scales[layer]
        kp[write_page, write_off], ks[write_page, write_off] = quantize_kv(k)
        vp[write_page, write_off], vs[write_page, write_off] = quantize_kv(v)
        kg, vg = gathered(kp, ks), gathered(vp, vs)
    else:
        kp[write_page, write_off] = k.to(kp.dtype)
        vp[write_page, write_off] = v.to(vp.dtype)
        kg, vg = gathered(kp), gathered(vp)
    attn = sdpa(q, kg, vg, bias)
    x = x + attn_out(p["attn"], cfg, attn.reshape(n, t, -1), w8a8)
    h2 = rms_norm(p["post_ln"], x, cfg.rms_norm_eps)
    return x + mlp_block(p["mlp"], cfg, h2, w8a8)


def paged_verify_step(params, cfg, paged: PagedKV, tokens: torch.Tensor, active: torch.Tensor,
                      w8a8: bool = False):
    """Speculative verify over the pool (the paged sibling of
    `speculative.verify_step_cb`): tokens [N, T], each sequence's last
    accepted token and its drafts (-1 padding). Token j is written at
    position lengths + j through the page table (the caller has mapped
    pages up to lengths + T - 1) and attends [0, lengths + j]. Inactive
    slots, and positions past the table, write into the null page 0.
    Returns (logits [N, T, V], paged) with the lengths unchanged: the
    caller advances each sequence by its own acceptance. cfg:
    TokenPackerVLMConfig; w8a8: `ops/layers.linear`'s w8a8 mode."""
    lm_cfg = cfg.lm
    lm = params["lm"]
    n, t = tokens.shape
    mp, ps = paged.page_table.shape[1], paged.page_size
    positions = paged.lengths.long()[:, None] + torch.arange(t, device=tokens.device)
    key = torch.arange(mp * ps, device=tokens.device)[None, None, :]
    bias = torch.where((key <= positions[:, :, None])[:, None], 0.0,
                       torch.finfo(torch.float32).min)
    rows = torch.arange(n, device=tokens.device)[:, None]
    blocks = positions // ps
    keep = active[:, None] & (blocks < mp)
    write_page = torch.where(keep, paged.page_table[rows, blocks.clamp(max=mp - 1)], 0).long()
    write_off = positions % ps
    x = lm_embed(lm, lm_cfg, tokens)
    cos, sin = (c.to(x.dtype) for c in
                rope_cos_sin(positions, lm_cfg.head_dim, lm_cfg.rope_theta))
    for i, layer in enumerate(lm["layers"]):
        x = _paged_verify_layer(layer, lm_cfg, x, cos, sin, paged, i, write_page, write_off, bias,
                                w8a8)
    x = rms_norm(lm["norm"], x, lm_cfg.rms_norm_eps)
    return lm_logits(lm, lm_cfg, x, w8a8), paged


def _page_rows(rows: torch.Tensor, start: int, n_pages: int, ps: int) -> torch.Tensor:
    """[L, 1, S, ...] dense rows -> [L, n_pages, ps, ...] from position start."""
    seg = rows[:, 0, start:start + n_pages * ps]
    return seg.reshape(seg.shape[0], n_pages, ps, *seg.shape[2:])


def insert_prefill(paged: PagedKV, small_cache: KVCache, seq: int, page_ids, length: int,
                   first_block: int = 0) -> PagedKV:
    """Copy a batch-1 prefilled cache (k/v [L, 1, L_pad, Hkv, d]) into
    freshly allocated pages and map them in sequence `seq`'s table.

    first_block > 0 (a prefix-cache hit): only rows [first_block * ps,
    first_block * ps + len(page_ids) * ps) are copied, into table blocks
    [first_block, ...); the caller maps the shared blocks (map_blocks).
    L_pad must cover the copied range and be a multiple of page_size."""
    ps = paged.page_size
    n_pages = len(page_ids)
    start = first_block * ps
    l_pad = small_cache.k.shape[2]
    assert l_pad % ps == 0, "prefill pad must be a multiple of page_size"
    assert start + n_pages * ps <= l_pad, "page ids exceed the prefilled range"
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=paged.k_pages.device)
    pairs = [(paged.k_pages, small_cache.k), (paged.v_pages, small_cache.v)]
    if paged.k_scales is not None:
        pairs += [(paged.k_scales, small_cache.k_scale), (paged.v_scales, small_cache.v_scale)]
    for pages, rows in pairs:
        pages[:, ids] = _page_rows(rows, start, n_pages, ps)
    paged.page_table[seq, first_block:first_block + n_pages] = ids.to(torch.int32)
    paged.lengths[seq] = length
    return paged


def map_blocks(paged: PagedKV, seq: int, start_block: int, page_ids) -> PagedKV:
    """Map a run of physical pages into a sequence's table from logical
    block `start_block` (prefix sharing: one page may sit in several
    tables; reads stop at each sequence's length and writes only go past
    the shared prefix)."""
    if len(page_ids):
        paged.page_table[seq, start_block:start_block + len(page_ids)] = torch.as_tensor(
            page_ids, dtype=torch.int32)
    return paged


def map_page(paged: PagedKV, seq: int, logical_block: int, page_id: int) -> PagedKV:
    """Map one more physical page into a sequence's table (growth)."""
    paged.page_table[seq, logical_block] = page_id
    return paged


def gather_prefix(paged: PagedKV, page_ids, l_pad: int) -> KVCache:
    """The pages' content as a batch-1 dense KVCache of width l_pad (rows
    [0, m * ps) filled, the rest zeros), so a suffix-only prefill
    (`generate.prefill_chunk` at offset m * ps) can attend the shared
    prefix. Its length is 0: the chunk call sets its own offset."""
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=paged.k_pages.device)
    m = len(page_ids)
    ps = paged.page_size

    def dense(pages):
        out = pages.new_zeros((pages.shape[0], 1, l_pad, *pages.shape[3:]))
        out[:, 0, :m * ps] = pages[:, ids].reshape(pages.shape[0], m * ps, *pages.shape[3:])
        return out

    scales = (None, None)
    if paged.k_scales is not None:
        scales = (dense(paged.k_scales), dense(paged.v_scales))
    return KVCache(dense(paged.k_pages), dense(paged.v_pages), 0, *scales)


def prefix_admit(paged: PagedKV, params, cfg, shared_ids, fresh_ids, visual, token_chunk,
                 is_image_chunk, image_slot_chunk, seq: int, true_len: int, first_block: int,
                 chunk_len: int, w8a8: bool = False):
    """Warm admission on a prefix-cache hit: gather the shared pages into a
    dense prefix, prefill only the suffix chunk [first_block * ps,
    + chunk_len) against it, write the suffix rows into the fresh pages,
    map the whole table row and set the length. cfg is the VLM config.
    Returns (last prompt token's logits [1, V], paged)."""
    ps = paged.page_size
    start = first_block * ps
    small = gather_prefix(paged, shared_ids, start + chunk_len)
    hidden, small = prefill_chunk(params, cfg, small, visual, token_chunk, is_image_chunk,
                                  image_slot_chunk, start, chunk_len, small.k.dtype, w8a8)
    idx = min(max(true_len - 1 - start, 0), chunk_len - 1)
    logits = lm_logits(params["lm"], cfg.lm, hidden[:, idx], w8a8)
    insert_prefill(paged, small, seq, fresh_ids, true_len, first_block)
    return logits, map_blocks(paged, seq, 0, shared_ids)
