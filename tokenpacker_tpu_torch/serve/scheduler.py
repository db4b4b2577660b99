"""Continuous batching over a paged KV pool (counterpart of
`PagedContinuousBatcher` in `tokenpacker_tpu/serve/scheduler.py`).

Up to `num_slots` requests decode together, one batched step per token
(`ops/paged_kv.paged_decode_step`, K5 once per layer), and new requests
are admitted into free slots between steps. KV pages are allocated as
sequences grow and freed when they finish, so the pool holds the sum of
the live lengths instead of slots x maximum length. Full prompt pages are
shared through the prefix cache (`serve/prefix_cache`): a repeated prefix
skips its share of the prefill, and the vision encode when every image
token lies in the cached part. With `prefill_chunk_size` an admission's
prompt is prefilled one chunk per loop iteration between decode steps.

    batcher = PagedContinuousBatcher(params, cfg, kv_cache_dtype=torch.int8)
    batcher.start()
    fut = batcher.submit(splice_batch, max_new_tokens=64)
    tokens = fut.result()          # list[int]
    batcher.stop()

`splice_batch` is one request's splice plan (numpy token_ids / is_image /
image_slot [1, L], lengths [1], images [views, H, W, 3] or None).
Streaming: `on_token=callable(token_id)`; `cancel(fut)` stops a request
before the next step.

The pool dtype is the explicit `kv_cache_dtype` (JAX reads
TOKENPACKER_KV_CACHE), the w8a8 mode of the int8 products the explicit
`w8a8` (JAX reads TOKENPACKER_W8A8: K8 for the tower and admission chunks
of 256 rows and more, K7 for decode steps and the first-token logits), and
the device the explicit `device` (the params
must be there; "cpu" runs every kernel's plain version). This port is
greedy: sampling, penalties, logprobs, LoRA adapters and speculation
raise NotImplementedError when the batcher is made or the request is
submitted, never inside the loop. The host keeps a copy of the lengths
beside the pool's device tensor, so the loop syncs once per step (the
argmax), not once per slot.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.generate import (
    cache_len_tile,
    device_batch,
    pick_bucket,
    prefill,
    prefill_chunk,
)
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.lm_api import lm_logits
from tokenpacker_tpu_torch.models.vlm import encode_images
from tokenpacker_tpu_torch.ops.paged_kv import (
    PageAllocator,
    PagedKV,
    gather_prefix,
    insert_prefill,
    map_blocks,
    map_page,
    paged_decode_step,
    prefix_admit,
)
from tokenpacker_tpu_torch.serve.prefix_cache import PrefixCache, block_hashes, image_digest


@dataclass
class _Request:
    batch: dict  # one request's splice-plan arrays (+ images)
    max_new_tokens: int
    future: Future
    on_token: object = None
    cancelled: bool = False  # set from any thread; honoured before the next step
    tokens: list = field(default_factory=list)


class PagedContinuousBatcher:
    """Continuous batching over a paged KV pool (module docstring)."""

    def __init__(
        self,
        params,
        cfg: TokenPackerVLMConfig,
        tokenizer=None,
        num_slots: int = 8,
        num_pages: int = 256,
        page_size: int = 64,
        max_pages_per_seq: int = 16,
        temperature: float = 0.0,
        speculative_k: int = 0,
        prefix_cache: bool = True,
        prefill_chunk_size: int | None = None,
        adapters: dict | None = None,
        kv_cache_dtype: torch.dtype | None = None,
        w8a8: bool = False,
        device: torch.device | str = "cuda",
    ):
        unported = {"temperature > 0": temperature > 0.0, "speculative_k > 0": speculative_k > 0,
                    "LoRA adapters": bool(adapters)}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(f"not ported yet (greedy only): {', '.join(asked)}")
        self.device = torch.device(device)
        have = params["lm"]["embed"].device
        if have.type != self.device.type or (self.device.index is not None
                                              and have.index != self.device.index):
            raise ValueError(f"the params are on {have}, the batcher runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.kv_cache_dtype = kv_cache_dtype or cfg.dtype
        self.w8a8 = w8a8
        self.prefill_chunk_size = prefill_chunk_size
        self.queue: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.dead: Exception | None = None
        self.paged = PagedKV.create(cfg.lm, num_pages, page_size, num_slots, max_pages_per_seq,
                                    self.kv_cache_dtype, self.device)
        self.allocator = PageAllocator(num_pages)
        self.slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self.slots: list[_Request | None] = [None] * num_slots
        self.next_tokens = np.zeros((num_slots,), np.int64)
        self.lengths = np.zeros((num_slots,), np.int64)  # host copy of paged.lengths
        self._pending = None  # the chunked admission in progress
        self.prefix: PrefixCache | None = PrefixCache(page_size) if prefix_cache else None
        # host-clock decode time (ended by the argmax's copy to the host):
        # every step, and the steps of loop iterations that ran no
        # admission work ("alone"), whose time no prefill shares; the most
        # pages ever held (slots and prefix cache together)
        self.stats = {"decode_steps": 0, "decode_s": 0.0, "alone_steps": 0, "alone_s": 0.0,
                      "pages_peak": 0}

    # -- public api --------------------------------------------------------

    def submit(self, batch: dict, max_new_tokens: int = 128, temperature: float | None = None,
               on_token=None, top_p: float | None = None, top_k: int | None = None,
               min_p: float | None = None, seed: int | None = None, adapter: str | None = None,
               repetition_penalty: float = 1.0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0, logprobs: int | None = None) -> Future:
        unported = {
            "temperature > 0": temperature is not None and temperature > 0.0,
            "top_p": top_p is not None,
            "top_k": top_k is not None,
            "min_p": min_p is not None,
            "seed": seed is not None,
            "adapter": adapter is not None,
            "repetition/presence/frequency penalties": (
                repetition_penalty != 1.0 or presence_penalty != 0.0 or frequency_penalty != 0.0),
            "logprobs": logprobs is not None,
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(f"not ported yet (greedy only): {', '.join(asked)}")
        pages = self._pad(batch["token_ids"].shape[1]) // self.page_size
        if pages > self.max_pages_per_seq:
            # refused here: inside the loop it would fail every request
            raise ValueError(f"a prompt of {batch['token_ids'].shape[1]} positions needs {pages} "
                             f"pages, max_pages_per_seq is {self.max_pages_per_seq}")
        fut: Future = Future()
        if self.dead is not None:
            fut.set_exception(RuntimeError(f"batcher loop died: {self.dead!r}"))
            return fut
        req = _Request(batch=batch, max_new_tokens=max_new_tokens, future=fut, on_token=on_token)
        fut._tp_request = req  # handle for cancel()
        self.queue.put(req)
        return fut

    def cancel(self, fut: Future) -> bool:
        """Stop generating for a submitted request; takes effect before the
        next decode step and the future resolves with the tokens so far.
        Safe from any thread; False for a future of another batcher."""
        req = getattr(fut, "_tp_request", None)
        if req is None:
            return False
        req.cancelled = True
        return True

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -- crash nets --------------------------------------------------------

    def _run(self):
        """_loop with a crash net: an error fails every in-flight and queued
        future instead of leaving clients waiting."""
        try:
            with torch.no_grad():
                self._loop()
        except Exception as e:  # noqa: BLE001
            self.dead = e
            err = RuntimeError(f"batcher loop died: {e!r}")
            for req in self.slots:
                if req is not None and not req.future.done():
                    req.future.set_exception(err)
            while True:
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    break
                if not req.future.done():
                    req.future.set_exception(err)

    def _failing(self, req: _Request, fn, *args):
        """Run an admission step; if it raises, fail `req`'s future too (it
        is in no slot and not queued when _run's net fires), then re-raise."""
        try:
            fn(*args)
        except BaseException as e:  # noqa: BLE001
            if not req.future.done():
                req.future.set_exception(RuntimeError(f"batcher loop died: {e!r}"))
            raise

    def _admit_safe(self, slot: int, req: _Request):
        self._failing(req, self._admit, slot, req)

    def _start_pending_safe(self, slot: int, req: _Request):
        self._failing(req, self._start_pending, slot, req)

    def _step_pending_safe(self):
        p = self._pending
        try:
            self._step_pending()
        except BaseException as e:  # noqa: BLE001
            self._pending = None
            if not p["req"].future.done():
                p["req"].future.set_exception(RuntimeError(f"batcher loop died: {e!r}"))
            raise

    # -- admission ---------------------------------------------------------

    def _alloc(self, n: int) -> list[int]:
        """Pool alloc, evicting LRU prefix-cache blocks under pressure."""
        if self.prefix is not None and self.allocator.available() < n:
            self.prefix.evict_until_available(self.allocator, n)
        pages = self.allocator.alloc(n)
        held = self.num_pages - 1 - self.allocator.available()
        self.stats["pages_peak"] = max(self.stats["pages_peak"], held)
        return pages

    def _padded_plan(self, b, l_pad: int) -> dict:
        """The request's per-token arrays padded out to l_pad, with its
        lengths and images, as device tensors."""
        l = b["token_ids"].shape[1]

        def padded(name):
            arr = np.zeros((1, l_pad), np.asarray(b[name]).dtype)
            arr[:, :l] = b[name]
            return arr

        plan = {name: padded(name) for name in ("token_ids", "is_image", "image_slot")}
        return device_batch({**plan, "lengths": b["lengths"], "images": b.get("images")},
                            self.cfg.dtype, self.device)

    def _pad(self, l: int) -> int:
        """The least admission pad of l positions: prefill rounds its cache
        length up to the cache tile (8 rows, 32 for int8), so the pad is
        aligned to both the page and the tile."""
        align = math.lcm(self.page_size, cache_len_tile(self.kv_cache_dtype))
        return -(-l // align) * align

    def _plan_admission(self, b):
        """Page-aligned pad and prefix-cache match. Returns (l_pad,
        true_len, m, shared, hashes): m cached blocks whose pages are
        mapped instead of prefilled."""
        ps = self.page_size
        l_pad = self._pad(b["token_ids"].shape[1])
        # snap to the engine's buckets where that fits the page budget and
        # at most doubles the pad, as the JAX batcher does (there it bounds
        # the number of compiled programs; here it keeps the shapes equal)
        bucketed = self._pad(pick_bucket(l_pad))
        if bucketed // ps <= self.max_pages_per_seq and bucketed <= 2 * l_pad:
            l_pad = max(l_pad, bucketed)
        true_len = int(np.asarray(b["lengths"])[0])

        m, shared, hashes = 0, [], []
        if self.prefix is not None:
            im_h = np.asarray(b["is_image"])[0, :true_len]
            digest = image_digest(b["images"]) if b.get("images") is not None and im_h.any() else b""
            # one prompt token is always recomputed: admission needs its logits
            hashes = block_hashes(np.asarray(b["token_ids"])[0, :true_len], im_h,
                                  np.asarray(b["image_slot"])[0, :true_len], digest, ps,
                                  limit=(true_len - 1) // ps)
            m, shared = self.prefix.match(hashes)
        return l_pad, true_len, m, shared, hashes

    def _suffix_visual(self, b, dev: dict, start: int, true_len: int) -> torch.Tensor:
        """Projector output for an admission whose positions before `start`
        are cached: the tower and projector are skipped when no image
        token falls in [start, true_len)."""
        if dev["images"] is not None and bool(np.any(np.asarray(b["is_image"])[0, start:true_len])):
            return encode_images(self.params, self.cfg, dev["images"], self.w8a8)
        if self.prefix is not None and dev["images"] is not None:
            self.prefix.vision_skipped += 1
        lm_embed = self.params["lm"]["embed"]
        return torch.zeros((1, self.cfg.tokens_per_view, self.cfg.lm.hidden_size),
                           dtype=lm_embed.dtype, device=self.device)

    def _finish_bookkeeping(self, slot: int, req: _Request, logits: torch.Tensor, true_len: int,
                            all_pages: list[int], m: int, hashes: list[bytes]):
        """Host-side admission tail: the first (greedy) token, the slot's
        pages, the full prompt blocks registered with the prefix cache."""
        tok = int(logits[0].argmax())
        self.slot_pages[slot] = all_pages
        if self.prefix is not None:
            self.prefix.register(hashes, all_pages[: len(hashes)], self.allocator)
            self.prefix.tokens_reused += m * self.page_size
        self.slots[slot] = req
        self.lengths[slot] = true_len
        self.next_tokens[slot] = tok
        self._emit(slot, tok)

    def _finish_admission(self, slot: int, req: _Request, small_cache: KVCache, logits,
                          l_pad: int, true_len: int, m: int, shared: list[int],
                          hashes: list[bytes]):
        """Move the dense prefilled rows [m * ps, l_pad) into fresh pages,
        map the m shared prefix pages, then the host bookkeeping."""
        fresh = self._alloc(l_pad // self.page_size - m)
        insert_prefill(self.paged, small_cache, slot, fresh, true_len, first_block=m)
        map_blocks(self.paged, slot, 0, shared)
        self._finish_bookkeeping(slot, req, logits, true_len, list(shared) + fresh, m, hashes)

    def _admit(self, slot: int, req: _Request):
        if req.cancelled:
            if not req.future.done():
                req.future.set_result([])
            return
        b = req.batch
        l_pad, true_len, m, shared, hashes = self._plan_admission(b)
        if m > 0:
            self._admit_with_prefix(slot, req, l_pad, true_len, m, shared, hashes)
            return
        dev = self._padded_plan(b, l_pad)
        logits, small_cache = prefill(self.params, self.cfg, dev, l_pad, self.kv_cache_dtype,
                                      self.w8a8)
        self._finish_admission(slot, req, small_cache, logits, l_pad, true_len, 0, [], hashes)

    def _admit_with_prefix(self, slot: int, req: _Request, l_pad: int, true_len: int, m: int,
                           shared: list[int], hashes: list[bytes]):
        """Suffix-only admission on a prefix-cache hit (`prefix_admit`)."""
        b = req.batch
        start = m * self.page_size
        # the slot's claim on the shared pages, taken before any alloc so
        # that eviction under pressure cannot free them mid-admission
        for pid in shared:
            self.allocator.incref(pid)
        fresh = self._alloc(l_pad // self.page_size - m)
        dev = self._padded_plan(b, l_pad)
        visual = self._suffix_visual(b, dev, start, true_len)
        logits, _ = prefix_admit(
            self.paged, self.params, self.cfg, shared, fresh, visual,
            dev["token_ids"][:, start:], dev["is_image"][:, start:], dev["image_slot"][:, start:],
            slot, true_len, m, l_pad - start, self.w8a8,
        )
        self._finish_bookkeeping(slot, req, logits, true_len, list(shared) + fresh, m, hashes)

    # -- chunked admission (prefill interleaved with decode steps) ----------

    def _start_pending(self, slot: int, req: _Request):
        """Begin a chunked admission: plan, prefix match, vision encode and
        prefix gather now; the prompt chunks run one per loop iteration
        (_step_pending) so the active slots keep decoding."""
        if req.cancelled:
            if not req.future.done():
                req.future.set_result([])
            return
        b = req.batch
        l_pad, true_len, m, shared, hashes = self._plan_admission(b)
        for pid in shared:  # claimed before any alloc, as in _admit_with_prefix
            self.allocator.incref(pid)
        start0 = m * self.page_size
        dev = self._padded_plan(b, l_pad)
        visual = self._suffix_visual(b, dev, start0, true_len)
        if m > 0:
            small = gather_prefix(self.paged, shared, l_pad)
        else:
            small = KVCache.create(self.cfg.lm, 1, l_pad, self.kv_cache_dtype, self.device)
        self._pending = {
            "req": req, "slot": slot, "cache": small, "visual": visual, "offset": start0,
            "start0": start0, "true_len": true_len, "l_pad": l_pad, "m": m, "shared": shared,
            "hashes": hashes, "dev": dev,
        }

    def _step_pending(self):
        p = self._pending
        l_pad, start0, dev = p["l_pad"], p["start0"], p["dev"]
        # a fixed chunk length, clamped so that the window never re-enters
        # the cached prefix [0, start0): those rows would need the
        # (possibly skipped) vision encode to recompute
        cs = min(self.prefill_chunk_size, l_pad - start0)
        start = max(start0, min(p["offset"], l_pad - cs))
        window = slice(start, start + cs)
        hidden, p["cache"] = prefill_chunk(
            self.params, self.cfg, p["cache"], p["visual"], dev["token_ids"][:, window],
            dev["is_image"][:, window], dev["image_slot"][:, window], start, cs,
            self.kv_cache_dtype, self.w8a8,
        )
        p["offset"] = start + cs
        if p["offset"] >= p["true_len"]:
            logits = lm_logits(self.params["lm"], self.cfg.lm, hidden[:, p["true_len"] - 1 - start],
                               self.w8a8)
            self._pending = None
            self._finish_admission(p["slot"], p["req"], p["cache"], logits, l_pad,
                                   p["true_len"], p["m"], p["shared"], p["hashes"])

    # -- decoding ----------------------------------------------------------

    def _emit(self, slot: int, tok: int):
        req = self.slots[slot]
        req.tokens.append(tok)
        if req.on_token is not None:
            req.on_token(tok)
        out_of_room = (int(self.lengths[slot]) + 1) // self.page_size >= self.max_pages_per_seq
        if tok == self.cfg.lm.eos_token_id or len(req.tokens) >= req.max_new_tokens or out_of_room:
            req.future.set_result(req.tokens)
            self._release_slot(slot)

    def _release_slot(self, slot: int):
        self.slots[slot] = None
        # unmap before releasing: the freed pages may go to a growing
        # sequence, and a stale table row would let this slot's (inactive,
        # null-page) step read them
        self.paged.page_table[slot] = 0
        self.allocator.release(self.slot_pages[slot])
        self.slot_pages[slot] = []

    def _reap_cancelled(self):
        """Free every cancelled request before the next step: its future
        resolves with the tokens so far and its pages return to the pool."""
        for slot, req in enumerate(self.slots):
            if req is not None and req.cancelled:
                if not req.future.done():
                    req.future.set_result(req.tokens)
                self._release_slot(slot)
        p = self._pending
        if p is not None and p["req"].cancelled:
            self._pending = None
            if not p["req"].future.done():
                p["req"].future.set_result([])
            if p["shared"]:  # the admission's claims on prefix pages
                self.allocator.release(list(p["shared"]))

    def _grow_pages(self):
        """Map a fresh page for every slot whose next write crosses into an
        unmapped block."""
        for slot in range(self.num_slots):
            if self.slots[slot] is None:
                continue
            target = min(int(self.lengths[slot]) // self.page_size, self.max_pages_per_seq - 1)
            while len(self.slot_pages[slot]) <= target:
                (pid,) = self._alloc(1)
                map_page(self.paged, slot, len(self.slot_pages[slot]), pid)
                self.slot_pages[slot].append(pid)

    def _decode(self, active: np.ndarray, alone: bool):
        t0 = time.perf_counter()
        logits, _ = paged_decode_step(
            self.params, self.cfg, self.paged,
            torch.as_tensor(self.next_tokens, device=self.device),
            torch.as_tensor(active, device=self.device), self.w8a8)
        toks = logits.argmax(dim=-1).cpu().numpy()
        seconds = time.perf_counter() - t0
        self.stats["decode_s"] += seconds
        self.stats["decode_steps"] += 1
        if alone:
            self.stats["alone_s"] += seconds
            self.stats["alone_steps"] += 1
        self.lengths += active
        for slot in range(self.num_slots):
            if self.slots[slot] is not None:
                self.next_tokens[slot] = int(toks[slot])
                self._emit(slot, int(toks[slot]))

    def _loop(self):
        chunked = self.prefill_chunk_size is not None
        while not self._stop.is_set():
            self._reap_cancelled()
            admitting = False  # admission work ran in this iteration
            if chunked:
                if self._pending is None:
                    for slot in range(self.num_slots):
                        if self.slots[slot] is None:
                            try:
                                req = self.queue.get_nowait()
                            except queue.Empty:
                                break
                            self._start_pending_safe(slot, req)
                            admitting = True
                            break
                if self._pending is not None:
                    self._step_pending_safe()
                    admitting = True
            else:
                for slot in range(self.num_slots):
                    if self.slots[slot] is None:
                        try:
                            req = self.queue.get_nowait()
                        except queue.Empty:
                            break
                        self._admit_safe(slot, req)
                        admitting = True
            active = np.array([r is not None for r in self.slots])
            if not active.any():
                if chunked and self._pending is not None:
                    continue  # keep chunking the admission
                try:
                    req = self.queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                if chunked:
                    self._start_pending_safe(0, req)
                    continue
                self._admit_safe(0, req)
                admitting = True
                active = np.array([r is not None for r in self.slots])
            if not active.any():
                continue
            self._grow_pages()
            self._decode(active, alone=not admitting)
