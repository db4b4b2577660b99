"""Automatic prefix caching over the paged KV pool, copied from
`tokenpacker_tpu/serve/prefix_cache.py` (the port imports nothing of the
JAX package; this module never needed JAX).

vLLM-style content-addressed KV reuse: every full page of an admitted
prompt is registered under a CHAINED block hash (token ids + image-token
layout + an image-pixel digest); a later request whose prompt shares a
cached prefix maps those physical pages straight into its page table and
prefills ONLY the suffix. When every image token lands inside the cached
prefix, the ViT+projector encode is skipped entirely.

Correctness model:
- KV for a token depends only on the tokens before it (causal attention)
  and their embeddings: positions are absolute from 0, so two prompts that
  agree on tokens [0, n·ps) have IDENTICAL K/V for those positions. Image
  positions inject projector outputs, so any block containing (or following
  — via the chain) an image token mixes the image digest into its hash.
- Cached pages are immutable: decode writes land at positions >= prompt
  length, which live in later (slot-owned) blocks; the matcher never
  reuses the block containing the last prompt token (at least one token
  is always recomputed so admission has last-token logits).
- Lifetime is refcounted in ops/paged_kv.PageAllocator: the cache holds one
  reference per registered block and each mapping sequence holds another;
  pages return to the free list only when both are gone. Under pool
  pressure the batcher evicts LRU cache entries before failing an alloc.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


def image_digest(images) -> bytes:
    """Identity of a request's image payload (pixels + shape)."""
    arr = np.asarray(images)
    h = hashlib.sha1(np.ascontiguousarray(arr).tobytes())
    h.update(repr(arr.shape).encode())
    return h.digest()


def block_hashes(token_ids, is_image, image_slot, img_digest: bytes,
                 page_size: int, limit: int | None = None,
                 seed: bytes = b"") -> list[bytes]:
    """Chained content hashes for a prompt's full pages.

    token_ids/is_image/image_slot: [l] host arrays (true prompt length, no
    padding). Hash j covers tokens [0, (j+1)·ps) — the chain makes a flat
    dict lookup per level equivalent to trie matching. Blocks containing
    image positions mix in the image digest, so identical text over
    different pixels never matches (and via the chain, neither does any
    later block). `seed` namespaces the whole chain — used to isolate KV
    computed under different LoRA adapters (serve/multi_lora.py).
    """
    token_ids = np.asarray(token_ids)
    is_image = np.asarray(is_image)
    image_slot = np.asarray(image_slot)
    n = len(token_ids) // page_size
    if limit is not None:
        n = min(n, limit)
    h = hashlib.sha1(seed)
    out = []
    for j in range(n):
        s = slice(j * page_size, (j + 1) * page_size)
        h.update(np.ascontiguousarray(token_ids[s], np.int64).tobytes())
        h.update(np.ascontiguousarray(is_image[s], np.uint8).tobytes())
        h.update(np.ascontiguousarray(image_slot[s], np.int32).tobytes())
        if np.any(is_image[s]):
            h.update(img_digest)
        out.append(h.digest())
    return out


class PrefixCache:
    """LRU map of chained block hash → physical page id.

    Single-threaded by design: all calls happen on the batcher loop thread
    (admission, growth, eviction), like the PageAllocator it feeds.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.blocks: OrderedDict[bytes, int] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.vision_skipped = 0

    def match(self, hashes: list[bytes]) -> tuple[int, list[int]]:
        """Longest cached chain prefix → (n_blocks, page_ids); LRU-touches
        matched entries. The caller must incref the returned pages BEFORE
        any further alloc (eviction under pressure could otherwise free
        them between match and use)."""
        ids: list[int] = []
        for hsh in hashes:
            pid = self.blocks.get(hsh)
            if pid is None:
                break
            self.blocks.move_to_end(hsh)
            ids.append(pid)
        if ids:
            self.hits += 1
        elif hashes:
            self.misses += 1
        return len(ids), ids

    def register(self, hashes: list[bytes], page_ids: list[int], allocator) -> None:
        """Record (hash → page) for blocks not yet cached. The cache takes
        its own allocator reference per new block so pages outlive the
        admitting sequence; already-cached hashes are LRU-touched only (the
        duplicate pages stay solely slot-owned and free on completion)."""
        for hsh, pid in zip(hashes, page_ids):
            if hsh in self.blocks:
                self.blocks.move_to_end(hsh)
                continue
            allocator.incref(pid)
            self.blocks[hsh] = pid

    def evict_until_available(self, allocator, need: int) -> None:
        """Drop LRU entries until the allocator can serve `need` pages (or
        the cache is empty). Entries whose page is still mapped by an active
        sequence release only the cache's reference — the page frees later
        when that sequence completes."""
        while allocator.available() < need and self.blocks:
            _, pid = self.blocks.popitem(last=False)
            allocator.release([pid])

    def stats(self) -> dict:
        return {
            "prefix_cache_blocks": len(self.blocks),
            "prefix_cache_hits": self.hits,
            "prefix_cache_misses": self.misses,
            "prefix_tokens_reused": self.tokens_reused,
            "prefix_vision_encodes_skipped": self.vision_skipped,
        }
