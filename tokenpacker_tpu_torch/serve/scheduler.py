"""Continuous batching (counterpart of `tokenpacker_tpu/serve/scheduler.py`):
`ContinuousBatcher` over slot-contiguous dense caches and
`PagedContinuousBatcher` over a paged KV pool.

Up to `num_slots` requests decode together, one batched step per token,
and new requests are admitted into free slots between steps. Each request
brings its own sampling: `submit`'s temperature (the batcher's
`temperature` when None), top_p, top_k, min_p, seed, the repetition,
presence and frequency penalties and logprobs, as the JAX batchers take
them. The dense
batcher gives each slot a row of one [L, slots, max_seq_len] cache: an
admission prefills the request alone (batch 1) and copies its rows into
the slot (`generate.insert_into_cache`), and a step is
`generate.decode_step_cb` (one K4 call on an int8 fused tree, else the
per-layer path with K3). The paged batcher allocates KV pages as
sequences grow and frees them when they finish, so the pool holds the sum
of the live lengths instead of slots x maximum length; its steps are
`ops/paged_kv.paged_decode_step` (K5 once per layer), and full prompt
pages are shared through the prefix cache (`serve/prefix_cache`): a
repeated prefix skips its share of the prefill, and the vision encode
when every image token lies in the cached part. With `prefill_chunk_size`
an admission's prompt is prefilled one chunk per loop iteration between
decode steps.

    batcher = ContinuousBatcher(params, cfg, kv_cache_dtype=torch.int8)
    batcher.start()
    fut = batcher.submit(splice_batch, max_new_tokens=64)
    tokens = fut.result()          # list[int]
    batcher.stop()

Over a sharded tree (`parallel/sharding.shard_params`, one process a
rank) every rank of the mesh runs the batcher, and the ranks' steps must
meet in the same collectives, in lockstep. Submissions and cancellations
reach rank 0 at times no other rank sees, so rank 0's loop decides: at
the top of each iteration it broadcasts a step plan over the mesh (every
rank: over 'data' the ZeRO gathers need them all) holding the requests
it took from its queue (their tokens, images, sampling settings and
seeds), the requests cancelled since the last plan, and whether to stop.
The other ranks replay each plan into their own slots, allocator and
prefix cache, which stay equal to rank 0's because everything else the
loop decides (admission order, chunk bounds, page allocation and
eviction, speculation's backoff, sampled tokens) follows from the plans
and the replicated logits alone: no clock or thread timing enters a
decision outside the plan. Only rank 0 takes `submit` and `cancel`; the
others `start()` and then `stop()`, which returns once rank 0 has
stopped. A KV cache or page pool holds a rank's local kv heads.

`splice_batch` is one request's splice plan (numpy token_ids / is_image /
image_slot [1, L], lengths [1], images [views, H, W, 3] or None).
Streaming: `on_token=callable(token_id)`; `cancel(fut)` stops a request
before the next step. With `logprobs=n` a request's `lp_entries` get one
`generate.token_logprob_entry` a token (raw logits, n alternatives),
appended before `on_token` fires.

Sampling (`generate.sample_tokens`, one row a slot): unseeded rows draw
from the batcher's `torch.Generator` on its device, seeded 0 (JAX's
PRNGKey(0)); a request with a `seed` draws its token k from
`generate.seeded_uniform` with the key `generate.seed_keys(seed, k)`,
so its tokens do not depend on its slot, its neighbours or the other
batcher. The penalty counts live on
the device ([slots, V] int32, made at the first penalized request, a
scatter of each step's tokens), and a step with no penalized slot
applies none.

With `speculative_k` = k > 0 a step becomes a verify round while some
active slot is plain greedy (greedy, unpenalized, no logprobs): such a
slot feeds its last token and up to k prompt-lookup drafts
(`speculative.propose_ngram_host`) and advances by its own acceptance
(`speculative.accept_greedy`), and every other slot rides along with one
token a round, sampled from its penalized position-0 logits; the dense
batcher verifies with
`speculative.verify_step_cb` (K4's verify form on an int8 fused tree),
the paged one with `ops/paged_kv.paged_verify_step` (the page-gather
path, as in the JAX package). When fewer than SPEC_EMA_THRESHOLD drafts a
plain-greedy slot are accepted on average (an EMA over rounds), the batcher decodes
plainly for SPEC_BACKOFF_ROUNDS steps (doubling on each repeat) before it
tries again.

The cache dtype is the explicit `kv_cache_dtype` (JAX reads
TOKENPACKER_KV_CACHE), the w8a8 mode of the int8 products the explicit
`w8a8` (JAX reads TOKENPACKER_W8A8: K8 for the tower and admission chunks
of 256 rows and more, K7 for decode steps and the first-token logits),
the fused tower block the explicit `vit_block` (TOKENPACKER_VIT_BLOCK),
and the device the explicit `device` (the params must be there; "cpu"
runs every kernel's plain version). The host keeps the slots' lengths
and settings, so the loop syncs once per step (the tokens' copy to the
host), not once per slot.

Both LM families serve through `ContinuousBatcher` (MPT: K2's ALiBi form
in whole-prompt admissions, `sdpa` with ALiBi for chunks and verify
rounds, K3's slopes form a step). `PagedContinuousBatcher` and `adapters=`
are llama-only, as in the JAX package, and raise NotImplementedError for
MPT.

Multi-LoRA serving: `adapters={name: serve.multi_lora.Adapter}` fixes the
adapter set when the batcher is made, and `submit(..., adapter=name)`
picks one per request (None: the base model; for a name that is not
loaded `submit` returns a future that already holds the KeyError, as the
JAX batchers do, after the dead-loop check). Steps and verify rounds run on the overlay
of `SlotLora`, whose selection row of a slot is set when a request takes
it: the dense batcher's steps and rounds through K4-LoRA on an int8
fused tree, the paged batcher's through `ops/layers.linear`'s term. An
admission runs on `SlotLora.prefill_params` (the request's row alone and
its adapter's projector, whole or in chunks), and the adapter's name
seeds the paged batcher's prefix hashes, so that equal prompts under
different adapters never share pages. Over a sharded tree each rank's
overlay holds its share of the stacks, and rank 0's plans carry each
request's adapter, so every rank selects, admits and hashes alike.
"""

from __future__ import annotations

import collections
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
    apply_penalties,
    cache_len_tile,
    decode_step_cb,
    device_batch,
    fused_weights,
    insert_into_cache,
    logprob_rows,
    pick_bucket,
    prefill,
    prefill_chunk,
    prompt_presence_mask,
    sample_tokens,
    seed_keys,
    token_logprob_entry,
)
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.lm_api import embedding_table, lm_logits
from tokenpacker_tpu_torch.models.vlm import encode_images
from tokenpacker_tpu_torch.ops.paged_kv import (
    PageAllocator,
    PagedKV,
    gather_prefix,
    insert_prefill,
    map_blocks,
    map_page,
    paged_decode_step,
    paged_verify_step,
    prefix_admit,
)
from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel.sharding import local_config, mesh_of
from tokenpacker_tpu_torch.serve.multi_lora import SlotLora
from tokenpacker_tpu_torch.serve.prefix_cache import PrefixCache, block_hashes, image_digest
from tokenpacker_tpu_torch.speculative import accept_greedy, propose_ngram_host, verify_step_cb

# speculative backoff: below SPEC_EMA_THRESHOLD accepted drafts a slot a
# round (an EMA over rounds), decode plainly for SPEC_BACKOFF_ROUNDS steps
# (doubled on each repeat, at most 512) before trying again
SPEC_EMA_THRESHOLD = 0.15
SPEC_BACKOFF_ROUNDS = 32


@dataclass
class _Request:
    batch: dict  # one request's splice-plan arrays (+ images)
    max_new_tokens: int
    future: Future
    on_token: object = None
    temperature: float = 0.0
    top_p: float | None = None
    top_k: int | None = None
    min_p: float | None = None
    seed: int | None = None  # the OpenAI `seed`: token k draws with seed_keys(seed, k)
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logprobs: int | None = None  # None: off; n: an entry a token with n alternatives
    lp_entries: list = field(default_factory=list)  # appended before on_token fires
    cancelled: bool = False  # set from any thread; honoured before the next step
    tokens: list = field(default_factory=list)
    ctx: list = field(default_factory=list)  # prompt-lookup context (speculation)
    adapter: str | None = None  # multi-LoRA serving (serve/multi_lora)
    rid: int = -1  # a lockstep batcher's request id (its plans name requests by it)

    @property
    def has_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    @property
    def plain_greedy(self) -> bool:
        """Greedy, unpenalized, without logprobs: the slots that draft and
        take bursts in verify rounds (acceptance compares drafts with the
        raw argmax, and a burst has no logits of its own)."""
        return self.temperature <= 0.0 and not self.has_penalties and self.logprobs is None


class _SlotBatcher:
    """What both batchers share: submission and cancellation, the loop
    thread and its crash nets, the admission schedule, sampling, penalties,
    logprobs, emission and speculative rounds. A subclass owns the cache: admission (`_admit`,
    `_start_pending`, `_step_pending`), `_decode_step`, `_verify`, slot
    release and its room rule."""

    def __init__(self, params, cfg: TokenPackerVLMConfig, tokenizer, num_slots: int,
                 temperature: float, speculative_k: int, prefill_chunk_size: int | None,
                 adapters: dict | None, kv_cache_dtype: torch.dtype | None, w8a8: bool,
                 vit_block: bool, device: torch.device | str):
        if adapters and cfg.lm.model_family != "llama":
            raise NotImplementedError("multi-LoRA serving (adapters=) is llama-only, as the JAX "
                                      "package's serve/multi_lora is")
        mesh = mesh_of(params)
        model_cfg, cfg = cfg, local_config(cfg, params)
        # lockstep over the mesh's ranks (module docstring)
        self.plan_axis = mesh.world_axis if mesh is not None and mesh.size > 1 else None
        self.leader = self.plan_axis is None or self.plan_axis.index == 0
        self._inbox: collections.deque = collections.deque()  # requests the plans took
        self._by_id: dict = {}  # id -> request, until it leaves the batcher
        self._next_id = 0
        self._cancel_ids: list = []  # cancellations since the last plan (rank 0)
        self._cancel_lock = threading.Lock()
        self._planned_stop = False
        self.device = torch.device(device)
        have = embedding_table(params["lm"]).device
        if have.type != self.device.type or (self.device.index is not None
                                              and have.index != self.device.index):
            raise ValueError(f"the params are on {have}, the batcher runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        self.temperature = temperature  # the default of requests that give none
        self.speculative_k = speculative_k
        self.kv_cache_dtype = kv_cache_dtype or cfg.dtype
        self.w8a8 = w8a8
        self.vit_block = vit_block
        self.prefill_chunk_size = prefill_chunk_size
        self.queue: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.dead: Exception | None = None
        self.slots: list[_Request | None] = [None] * num_slots
        self.next_tokens = np.zeros((num_slots,), np.int64)
        self.lengths = np.zeros((num_slots,), np.int64)  # the slots' sequence lengths
        self._pending = None  # the chunked admission in progress
        self._spec_accept_ema = 1.0
        self._spec_backoff = 0
        self._spec_fail_streak = 0  # doubles the backoff on each repeat
        # unseeded rows' noise: JAX's PRNGKey(0), as a generator on the device
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._pen = None  # the penalty rows on the device, made at the first penalized request
        # host-clock step time (ended by the argmax's copy to the host):
        # every plain step, and the steps of loop iterations that ran no
        # admission work ("alone"), whose time no prefill shares; verify
        # rounds and the tokens they emitted
        self.stats = {"decode_steps": 0, "decode_s": 0.0, "alone_steps": 0, "alone_s": 0.0,
                      "verify_rounds": 0, "verify_s": 0.0, "verify_tokens": 0}
        self._init_slot_lora(adapters, model_cfg)

    # -- multi-LoRA serving (serve/multi_lora) ---------------------------------

    def _init_slot_lora(self, adapters: dict | None, model_cfg):
        """With adapters, every step runs on SlotLora's overlay of the base
        params, made once (its selection tensor is updated in place). Over
        a sharded tree the stacks are this rank's shares, made from the
        model's widths (`model_cfg`), and the plans carry each request's
        adapter, so every rank selects alike."""
        self.base_params = self.params
        self.slot_lora = None
        if adapters:
            self.slot_lora = SlotLora(self.base_params, model_cfg, adapters, self.num_slots,
                                      dtype=self.cfg.dtype)
            self.params = self.slot_lora.overlay(self.base_params)

    def _admission_params(self, req: _Request):
        """Prefill-time params of one request: its adapter's selection row
        alone and its projector override (the base params without
        adapters)."""
        if self.slot_lora is None:
            return self.params
        return self.slot_lora.prefill_params(self.base_params, req.adapter)

    def _bind_slot_adapter(self, slot: int, req: _Request):
        if self.slot_lora is not None:
            self.slot_lora.set_slot(slot, req.adapter)

    # -- public api --------------------------------------------------------

    def submit(self, batch: dict, max_new_tokens: int = 128, temperature: float | None = None,
               on_token=None, top_p: float | None = None, top_k: int | None = None,
               min_p: float | None = None, seed: int | None = None, adapter: str | None = None,
               repetition_penalty: float = 1.0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0, logprobs: int | None = None) -> Future:
        fut: Future = Future()
        if self.dead is not None:
            fut.set_exception(RuntimeError(f"batcher loop died: {self.dead!r}"))
            return fut
        if adapter is not None:  # an unknown adapter: a future holding the KeyError, as in JAX
            try:
                if self.slot_lora is None:
                    raise KeyError(f"no LoRA adapters loaded (requested {adapter!r})")
                self.slot_lora.adapter_index(adapter)
            except KeyError as e:
                fut.set_exception(e)
                return fut
        if not self.leader:
            raise RuntimeError("a lockstep batcher takes requests on rank 0 only")
        self._check_prompt(batch)  # refused here: inside the loop it would fail every request
        req = _Request(batch=batch, max_new_tokens=max_new_tokens, future=fut, on_token=on_token,
                       temperature=self.temperature if temperature is None else temperature,
                       top_p=top_p, top_k=top_k, min_p=min_p, seed=seed,
                       repetition_penalty=repetition_penalty, presence_penalty=presence_penalty,
                       frequency_penalty=frequency_penalty, logprobs=logprobs, adapter=adapter)
        fut._tp_request = req  # handle for cancel()
        if self.plan_axis is not None:
            with self._cancel_lock:
                req.rid = self._next_id
                self._next_id += 1
        self.queue.put(req)
        return fut

    def cancel(self, fut: Future) -> bool:
        """Stop generating for a submitted request; takes effect before the
        next decode step and the future resolves with the tokens so far.
        Safe from any thread; False for a future of another batcher."""
        req = getattr(fut, "_tp_request", None)
        if req is None:
            return False
        if self.plan_axis is not None:  # every rank applies it from the next plan
            with self._cancel_lock:
                self._cancel_ids.append(req.rid)
            return True
        req.cancelled = True
        return True

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the loop (rank 0; on another rank of a lockstep batcher:
        wait until rank 0's plan has stopped it)."""
        if self.leader:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30 if self.leader else None)

    # -- lockstep plans (module docstring) -------------------------------------

    _PLAN_FIELDS = ("batch", "max_new_tokens", "temperature", "top_p", "top_k", "min_p", "seed",
                    "repetition_penalty", "presence_penalty", "frequency_penalty", "logprobs",
                    "adapter")

    def _running(self) -> bool:
        if self.plan_axis is None:
            return not self._stop.is_set()
        return not self._planned_stop

    def _exchange_plan(self):
        """Rank 0 makes this iteration's plan and every rank applies it:
        the new requests join the inbox in order, the cancellations mark
        their requests, a stop ends the loop. An idle rank 0 waits up to 50
        ms for a request first, as the loop does without a mesh."""
        plan = None
        if self.leader:
            new = []
            idle = (not self._inbox and self._pending is None
                    and all(r is None for r in self.slots))
            if idle and not self._stop.is_set():
                try:
                    new.append(self.queue.get(timeout=0.05))
                except queue.Empty:
                    pass
            while True:
                try:
                    new.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            with self._cancel_lock:
                cancel, self._cancel_ids = self._cancel_ids, []
            plan = {"stop": self._stop.is_set(), "cancel": cancel,
                    "new": [(r.rid, {f: getattr(r, f) for f in self._PLAN_FIELDS}) for r in new]}
            mine = new
        plan = comm.broadcast_object(plan, self.plan_axis)
        if not self.leader:
            mine = [_Request(future=Future(), **fields) for _, fields in plan["new"]]
        for (rid, _), req in zip(plan["new"], mine):
            req.rid = rid
            self._by_id[rid] = req
            self._inbox.append(req)
        for rid in plan["cancel"]:
            req = self._by_id.get(rid)
            if req is not None:
                req.cancelled = True
        self._planned_stop = plan["stop"]

    def _take(self) -> _Request:
        """The next queued request (queue.Empty when there is none): from
        the inbox the plans fill in lockstep, else from the queue."""
        if self.plan_axis is None:
            return self.queue.get_nowait()
        if not self._inbox:
            raise queue.Empty
        return self._inbox.popleft()

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

    # -- admission and emission ----------------------------------------------

    def _skip_cancelled(self, req: _Request) -> bool:
        """An admission of a request cancelled while queued resolves it with
        no tokens instead."""
        if req.cancelled and not req.future.done():
            req.future.set_result([])
        return req.cancelled

    def _seat(self, slot: int, req: _Request, logits: torch.Tensor, true_len: int):
        """An admission's tail: the request's first token from its prompt's
        logits [1, V] (penalized by the prompt alone; its logprob entry
        from the raw ones), then the slot takes the request (and its
        adapter) at its true length."""
        self._pen_setup(slot, req)
        first = logits
        if req.has_penalties:
            first = apply_penalties(logits, self._pen["counts"][slot:slot + 1],
                                    self._pen["prompt"][slot:slot + 1], req.repetition_penalty,
                                    req.presence_penalty, req.frequency_penalty)
        keys = None
        if req.seed is not None:
            keys = torch.as_tensor(seed_keys([req.seed], [0]), device=self.device)
        tok = int(sample_tokens(first, req.temperature, req.top_p, req.top_k, req.min_p,
                                self._gen, keys)[0])
        if req.has_penalties:
            self._pen["counts"][slot, tok] += 1
        if req.logprobs is not None:
            req.lp_entries.append(token_logprob_entry(logits[0], tok, req.logprobs))
        self._bind_slot_adapter(slot, req)
        self.slots[slot] = req
        self.lengths[slot] = true_len
        if self.speculative_k > 0:
            b = req.batch
            ids = np.asarray(b["token_ids"])[0, :true_len]
            im = np.asarray(b["is_image"])[0, :true_len]
            req.ctx = [-1 if m else int(t) for t, m in zip(ids, im)]
        self.next_tokens[slot] = tok
        self._emit(slot, tok)

    def _emit(self, slot: int, tok: int):
        req = self.slots[slot]
        req.tokens.append(tok)
        if self.speculative_k > 0:
            req.ctx.append(tok)
        if req.on_token is not None:
            req.on_token(tok)
        if (tok == self.cfg.lm.eos_token_id or len(req.tokens) >= req.max_new_tokens
                or self._out_of_room(slot)):
            req.future.set_result(req.tokens)
            self._release_slot(slot)

    def _reap_cancelled(self):
        """Free every cancelled request before the next step: its future
        resolves with the tokens so far and its slot is released."""
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
            self._drop_pending(p)

    def _drop_pending(self, p: dict):
        """Release what a cancelled chunked admission holds."""

    # -- sampling, penalties and logprobs (generate.sample_tokens) --------------

    def _pen_setup(self, slot: int, req: _Request):
        """The slot's penalty rows at admission: zero counts, the prompt's
        presence row. The [slots, V] rows are made at the first penalized
        request; unpenalized serving never touches them."""
        if not req.has_penalties and self._pen is None:
            return
        v = self.cfg.lm.vocab_size
        if self._pen is None:
            self._pen = {
                "counts": torch.zeros((self.num_slots, v), dtype=torch.int32, device=self.device),
                "prompt": torch.zeros((self.num_slots, v), dtype=torch.bool, device=self.device),
            }
        self._pen["counts"][slot] = 0
        self._pen["prompt"][slot] = (torch.as_tensor(prompt_presence_mask(req.batch, v)[0],
                                                     device=self.device)
                                     if req.has_penalties else False)

    def _sampling_rows(self) -> dict | None:
        """The active slots' settings as device rows, one a slot, for
        `_sample`; made before a step is launched, so that their copies to
        the device wait on no device work. None when every active slot is
        greedy and unpenalized (the step's tokens are its argmax). A
        filter that no slot uses is left off; identity penalty values
        leave a row bit-unchanged."""
        reqs = self.slots
        active = [r for r in reqs if r is not None]
        sampled = any(r.temperature > 0.0 for r in active)
        penalized = any(r.has_penalties for r in active)
        if not sampled and not penalized:
            return None

        def row(get, default, dtype):
            return np.array([get(r) if r is not None else default for r in reqs], dtype)

        def put(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        rows = {"temperature": 0.0, "top_p": None, "top_k": None, "min_p": None, "keys": None,
                "pen": None}
        if sampled:
            rows["temperature"] = put(row(lambda r: r.temperature, 0.0, np.float32))
            top_p = row(lambda r: r.top_p or 1.0, 1.0, np.float32)
            top_k = row(lambda r: r.top_k or 0, 0, np.int64)
            min_p = row(lambda r: r.min_p or 0.0, 0.0, np.float32)
            if (top_p < 1.0).any():
                rows["top_p"] = put(top_p)
            if ((top_k > 0) & (top_k < self.cfg.lm.vocab_size)).any():
                rows["top_k"] = put(top_k, torch.int64)
            if ((min_p > 0.0) & (min_p <= 1.0)).any():
                rows["min_p"] = put(min_p)
            if any(r.seed is not None for r in active):
                # token k of a seeded request draws with the key of (seed, k)
                rows["keys"] = put(seed_keys(row(lambda r: -1 if r.seed is None else r.seed, -1,
                                                 np.int64),
                                             row(lambda r: len(r.tokens), 0, np.int64)),
                                   torch.int64)
        if penalized:
            pen = [(r.repetition_penalty, r.presence_penalty, r.frequency_penalty)
                   if r is not None and r.has_penalties else (1.0, 0.0, 0.0) for r in reqs]
            rows["pen"] = [put(np.array(col, np.float32)) for col in zip(*pen)]
            rows["pen_rows"] = put(row(lambda r: int(r.has_penalties), 0, np.int32)[:, None],
                                   torch.int32)
        return rows

    def _sample(self, logits: torch.Tensor, rows: dict | None) -> torch.Tensor:
        """The step's token a slot [slots] on the device: penalties, then
        `generate.sample_tokens`; the penalized slots' counts take the
        tokens."""
        if rows is None:
            return sample_tokens(logits, 0.0)
        if rows["pen"] is not None:
            logits = apply_penalties(logits, self._pen["counts"], self._pen["prompt"],
                                     *rows["pen"])
        toks = sample_tokens(logits, rows["temperature"], rows["top_p"], rows["top_k"],
                             rows["min_p"], self._gen, rows["keys"])
        if rows["pen"] is not None:
            self._pen["counts"].scatter_add_(1, toks[:, None], rows["pen_rows"])
        return toks

    def _lp_rows(self, logits: torch.Tensor, toks: torch.Tensor):
        """The step's logprob rows on the device (raw logits), or None when
        no active slot asked."""
        asked = [r.logprobs for r in self.slots if r is not None and r.logprobs is not None]
        return logprob_rows(logits, toks, max(asked)) if asked else None

    def _lp_record(self, lp, toks: np.ndarray):
        """Append each asking slot's entry for its token toks[slot]."""
        if lp is None:
            return
        chosen, top_lps, top_ids = (x.cpu().tolist() for x in lp)
        for slot, req in enumerate(self.slots):
            if req is not None and req.logprobs is not None:
                entry = {"id": int(toks[slot]), "logprob": chosen[slot]}
                if req.logprobs > 0:
                    entry["top"] = list(zip(top_ids[slot][:req.logprobs],
                                            top_lps[slot][:req.logprobs]))
                req.lp_entries.append(entry)

    # -- decoding ----------------------------------------------------------

    def _decode(self, active: np.ndarray, alone: bool):
        t0 = time.perf_counter()
        rows = self._sampling_rows()
        logits = self._decode_step(torch.as_tensor(self.next_tokens, device=self.device),
                                   torch.as_tensor(active, device=self.device))
        toks_dev = self._sample(logits, rows)
        lp = self._lp_rows(logits, toks_dev)
        toks = toks_dev.cpu().numpy()
        seconds = time.perf_counter() - t0
        self.stats["decode_s"] += seconds
        self.stats["decode_steps"] += 1
        if alone:
            self.stats["alone_s"] += seconds
            self.stats["alone_steps"] += 1
        self.lengths += active
        self._lp_record(lp, toks)
        for slot in range(self.num_slots):
            if self.slots[slot] is not None:
                self.next_tokens[slot] = int(toks[slot])
                self._emit(slot, int(toks[slot]))

    def _propose_fed(self):
        """Per-slot verify inputs [slots, k + 1]: the last token, the drafts
        of a plain-greedy slot, -1 padding; and the draft counts."""
        k = self.speculative_k
        fed = np.full((self.num_slots, k + 1), -1, np.int64)
        dks = np.zeros(self.num_slots, np.int64)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            fed[slot, 0] = self.next_tokens[slot]
            if req.plain_greedy:
                d = propose_ngram_host(req.ctx, k)
                fed[slot, 1:1 + len(d)] = d
                dks[slot] = len(d)
        return fed, dks

    def _verify_round(self, active: np.ndarray):
        """One speculative step for every active slot: a plain-greedy slot
        feeds its drafts and advances by its own acceptance, any other
        takes one token sampled from its penalized position-0 logits (its
        logprob entry from the raw ones); the EMA of accepted drafts a
        plain-greedy slot decides the backoff."""
        t0 = time.perf_counter()
        k = self.speculative_k
        rows = self._sampling_rows()
        fed, dks = self._propose_fed()
        logits = self._verify(torch.as_tensor(fed, device=self.device),
                              torch.as_tensor(active, device=self.device))
        preds = logits.argmax(dim=-1)  # [slots, k + 1]
        lp = None
        if any(r is not None and not r.plain_greedy for r in self.slots):
            sampled0 = self._sample(logits[:, 0], rows)
            lp = self._lp_rows(logits[:, 0], sampled0)
            preds = torch.cat([preds, sampled0[:, None]], dim=1)  # one copy to the host
        preds = preds.cpu().numpy()
        self.stats["verify_s"] += time.perf_counter() - t0
        self.stats["verify_rounds"] += 1
        eos = self.cfg.lm.eos_token_id
        bursts, n_greedy, accepted = {}, 0, 0
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if req.plain_greedy:
                bursts[slot] = accept_greedy(preds[slot], fed[slot, 1:], int(dks[slot]), eos)
                n_greedy += 1
                accepted += len(bursts[slot]) - 1
            else:
                bursts[slot] = [int(preds[slot, k + 1])]
        if n_greedy:
            ratio = accepted / n_greedy
            self._spec_accept_ema = 0.9 * self._spec_accept_ema + 0.1 * ratio
            if ratio > 0.5:
                self._spec_fail_streak = 0  # drafts are landing again
            if self._spec_accept_ema < SPEC_EMA_THRESHOLD:
                self._spec_backoff = min(SPEC_BACKOFF_ROUNDS * 2**self._spec_fail_streak, 512)
                self._spec_fail_streak += 1
        # lengths advance before the emission, so that the room rule sees
        # the state after the round
        for slot, burst in bursts.items():
            self.lengths[slot] += len(burst)
        self._lengths_changed()
        if lp is not None:
            self._lp_record(lp, preds[:, k + 1])
        for slot, burst in bursts.items():
            for tok in burst:
                if self.slots[slot] is None:
                    break
                self.stats["verify_tokens"] += 1
                self._emit(slot, tok)
            if self.slots[slot] is not None:
                self.next_tokens[slot] = burst[-1]

    def _lengths_changed(self):
        """Hook: the host lengths moved other than by a decode step."""

    def _before_step(self):
        """Hook: runs before every step with at least one active slot."""

    def _loop(self):
        chunked = self.prefill_chunk_size is not None
        while True:
            if self.plan_axis is not None:
                self._exchange_plan()
            if not self._running():
                break
            self._reap_cancelled()
            admitting = False  # admission work ran in this iteration
            if chunked:
                if self._pending is None:
                    for slot in range(self.num_slots):
                        if self.slots[slot] is None:
                            try:
                                req = self._take()
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
                            req = self._take()
                        except queue.Empty:
                            break
                        self._admit_safe(slot, req)
                        admitting = True
            active = np.array([r is not None for r in self.slots])
            if not active.any():
                if chunked and self._pending is not None:
                    continue  # keep chunking the admission
                try:
                    req = self.queue.get(timeout=0.05) if self.plan_axis is None else self._take()
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
            self._before_step()
            # verify rounds run while some slot drafts: without one, a k+1-wide
            # round would cost more than a plain step for nothing
            if self.speculative_k > 0 and any(r is not None and r.plain_greedy
                                              for r in self.slots):
                if self._spec_backoff > 0:
                    self._spec_backoff -= 1
                    if self._spec_backoff == 0:
                        self._spec_accept_ema = 1.0  # an optimistic retry
                else:
                    self._verify_round(active)
                    continue
            self._decode(active, alone=not admitting)


class ContinuousBatcher(_SlotBatcher):
    """Continuous batching over slot-contiguous dense caches (module
    docstring): slot i's sequence fills positions [0, lengths[i]) of row i
    of one [L, num_slots, max_seq_len] cache. A request stops when its next
    round could pass max_seq_len (length + 1 + k >= max_seq_len)."""

    def __init__(
        self,
        params,
        cfg: TokenPackerVLMConfig,
        tokenizer=None,
        num_slots: int = 8,
        max_seq_len: int = 1024,
        temperature: float = 0.0,
        prefill_chunk_size: int | None = None,
        speculative_k: int = 0,
        adapters: dict | None = None,
        kv_cache_dtype: torch.dtype | None = None,
        w8a8: bool = False,
        vit_block: bool = False,
        device: torch.device | str = "cuda",
    ):
        super().__init__(params, cfg, tokenizer, num_slots, temperature, speculative_k,
                         prefill_chunk_size, adapters, kv_cache_dtype, w8a8, vit_block, device)
        self.max_seq_len = max_seq_len
        self.cache = KVCache.create(self.cfg.lm, num_slots, max_seq_len, self.kv_cache_dtype,
                                    self.device)
        self.fused = fused_weights(self.params, self.cfg)

    def _check_prompt(self, batch: dict):
        l = batch["token_ids"].shape[1]
        if l > self.max_seq_len:
            raise ValueError(f"a prompt of {l} positions exceeds max_seq_len {self.max_seq_len}")

    def _out_of_room(self, slot: int) -> bool:
        return int(self.lengths[slot]) + 1 + self.speculative_k >= self.max_seq_len

    def _release_slot(self, slot: int):
        # a free slot's steps write at its length: 0 keeps them in its rows
        self.slots[slot] = None
        self.lengths[slot] = 0

    def _visual(self, b, params) -> torch.Tensor:
        if b.get("images") is None:
            return torch.zeros((1, self.cfg.tokens_per_view, self.cfg.lm.hidden_size),
                               dtype=embedding_table(params["lm"]).dtype, device=self.device)
        images = torch.as_tensor(b["images"]).to(device=self.device, dtype=self.cfg.dtype)
        return encode_images(params, self.cfg, images, self.w8a8, self.vit_block)

    def _admit(self, slot: int, req: _Request):
        """Prefill the request alone and copy its rows into the slot."""
        if self._skip_cancelled(req):
            return
        b = req.batch
        dev = device_batch(b, self.cfg.dtype, self.device)
        logits, small = prefill(self._admission_params(req), self.cfg, dev,
                                b["token_ids"].shape[1], self.kv_cache_dtype, self.w8a8,
                                self.vit_block)
        insert_into_cache(self.cache, small, slot)
        self._seat(slot, req, logits, int(np.asarray(b["lengths"])[0]))

    def _start_pending(self, slot: int, req: _Request):
        """Begin a chunked admission: the vision encode now, the prompt
        chunks one per loop iteration (_step_pending)."""
        if self._skip_cancelled(req):
            return
        b = req.batch
        dev = device_batch({**b, "images": None}, self.cfg.dtype, self.device)
        small = KVCache.create(self.cfg.lm, 1, b["token_ids"].shape[1], self.kv_cache_dtype,
                               self.device)
        pp = self._admission_params(req)
        self._pending = {"req": req, "slot": slot, "cache": small, "visual": self._visual(b, pp),
                         "offset": 0, "true_len": int(np.asarray(b["lengths"])[0]), "dev": dev,
                         "params": pp}

    def _step_pending(self):
        p = self._pending
        dev = p["dev"]
        l = dev["token_ids"].shape[1]
        # a fixed chunk length, the last window clamped to the prompt's end
        # (the overlap recomputes the same rows)
        cs = min(self.prefill_chunk_size, l)
        start = max(0, min(p["offset"], l - cs))
        window = slice(start, start + cs)
        hidden, p["cache"] = prefill_chunk(
            p["params"], self.cfg, p["cache"], p["visual"], dev["token_ids"][:, window],
            dev["is_image"][:, window], dev["image_slot"][:, window], start, cs,
            self.kv_cache_dtype, self.w8a8,
        )
        p["offset"] = start + cs
        if p["offset"] >= p["true_len"]:
            logits = lm_logits(p["params"]["lm"], self.cfg.lm,
                               hidden[:, p["true_len"] - 1 - start], self.w8a8)
            self._pending = None
            insert_into_cache(self.cache, p["cache"], p["slot"])
            self._seat(p["slot"], p["req"], logits, p["true_len"])

    def _decode_step(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        cur = torch.as_tensor(self.lengths, dtype=torch.int32, device=self.device)
        logits, _ = decode_step_cb(self.params, self.cfg, self.cache, tokens, cur, active,
                                   self.fused, self.w8a8)
        return logits

    def _verify(self, fed: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        cur = torch.as_tensor(self.lengths, dtype=torch.int32, device=self.device)
        logits, _ = verify_step_cb(self.params, self.cfg, self.cache, fed, cur, self.fused,
                                   self.w8a8)
        return logits


class PagedContinuousBatcher(_SlotBatcher):
    """Continuous batching over a paged KV pool (module docstring). A
    request stops when its next round could pass its page budget."""

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
        vit_block: bool = False,
        device: torch.device | str = "cuda",
    ):
        if cfg.lm.model_family != "llama":
            raise NotImplementedError("the paged pool is llama-only (RoPE layers), as the JAX "
                                      "package's ops/paged_kv is; MPT serves through "
                                      "ContinuousBatcher")
        super().__init__(params, cfg, tokenizer, num_slots, temperature, speculative_k,
                         prefill_chunk_size, adapters, kv_cache_dtype, w8a8, vit_block, device)
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.paged = PagedKV.create(self.cfg.lm, num_pages, page_size, num_slots, max_pages_per_seq,
                                    self.kv_cache_dtype, self.device)
        self.allocator = PageAllocator(num_pages)
        self.slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self.prefix: PrefixCache | None = PrefixCache(page_size) if prefix_cache else None
        self.stats["pages_peak"] = 0  # the most pages ever held (slots and prefix cache)

    def _check_prompt(self, batch: dict):
        pages = self._pad(batch["token_ids"].shape[1]) // self.page_size
        if pages > self.max_pages_per_seq:
            raise ValueError(f"a prompt of {batch['token_ids'].shape[1]} positions needs {pages} "
                             f"pages, max_pages_per_seq is {self.max_pages_per_seq}")

    def _out_of_room(self, slot: int) -> bool:
        # a round writes up to k + 1 positions past the length
        return ((int(self.lengths[slot]) + 1 + self.speculative_k) // self.page_size
                >= self.max_pages_per_seq)

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

    def _plan_admission(self, b, adapter: str | None = None):
        """Page-aligned pad and prefix-cache match. Returns (l_pad,
        true_len, m, shared, hashes): m cached blocks whose pages are
        mapped instead of prefilled. `adapter` seeds the block hashes: the
        rows depend on the serving adapter, so equal prompts under
        different adapters never share pages."""
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
                                  limit=(true_len - 1) // ps,
                                  seed=adapter.encode() if adapter else b"")
            m, shared = self.prefix.match(hashes)
        return l_pad, true_len, m, shared, hashes

    def _suffix_visual(self, b, dev: dict, start: int, true_len: int, params) -> torch.Tensor:
        """Projector output for an admission whose positions before `start`
        are cached: the tower and projector (those of `params`, the
        admission's) are skipped when no image token falls in [start,
        true_len)."""
        if dev["images"] is not None and bool(np.any(np.asarray(b["is_image"])[0, start:true_len])):
            return encode_images(params, self.cfg, dev["images"], self.w8a8, self.vit_block)
        if self.prefix is not None and dev["images"] is not None:
            self.prefix.vision_skipped += 1
        return torch.zeros((1, self.cfg.tokens_per_view, self.cfg.lm.hidden_size),
                           dtype=embedding_table(self.params["lm"]).dtype, device=self.device)

    def _finish_bookkeeping(self, slot: int, req: _Request, logits: torch.Tensor, true_len: int,
                            all_pages: list[int], m: int, hashes: list[bytes]):
        """Host-side admission tail: the slot's pages, the full prompt
        blocks registered with the prefix cache, then `_seat`."""
        self.slot_pages[slot] = all_pages
        if self.prefix is not None:
            self.prefix.register(hashes, all_pages[: len(hashes)], self.allocator)
            self.prefix.tokens_reused += m * self.page_size
        self._seat(slot, req, logits, true_len)

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
        if self._skip_cancelled(req):
            return
        b = req.batch
        l_pad, true_len, m, shared, hashes = self._plan_admission(b, req.adapter)
        if m > 0:
            self._admit_with_prefix(slot, req, l_pad, true_len, m, shared, hashes)
            return
        dev = self._padded_plan(b, l_pad)
        logits, small_cache = prefill(self._admission_params(req), self.cfg, dev, l_pad,
                                      self.kv_cache_dtype, self.w8a8, self.vit_block)
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
        pp = self._admission_params(req)
        visual = self._suffix_visual(b, dev, start, true_len, pp)
        logits, _ = prefix_admit(
            self.paged, pp, self.cfg, shared, fresh, visual,
            dev["token_ids"][:, start:], dev["is_image"][:, start:], dev["image_slot"][:, start:],
            slot, true_len, m, l_pad - start, self.w8a8,
        )
        self._finish_bookkeeping(slot, req, logits, true_len, list(shared) + fresh, m, hashes)

    # -- chunked admission (prefill interleaved with decode steps) ----------

    def _start_pending(self, slot: int, req: _Request):
        """Begin a chunked admission: plan, prefix match, vision encode and
        prefix gather now; the prompt chunks run one per loop iteration
        (_step_pending) so the active slots keep decoding."""
        if self._skip_cancelled(req):
            return
        b = req.batch
        l_pad, true_len, m, shared, hashes = self._plan_admission(b, req.adapter)
        for pid in shared:  # claimed before any alloc, as in _admit_with_prefix
            self.allocator.incref(pid)
        start0 = m * self.page_size
        dev = self._padded_plan(b, l_pad)
        pp = self._admission_params(req)
        visual = self._suffix_visual(b, dev, start0, true_len, pp)
        if m > 0:
            small = gather_prefix(self.paged, shared, l_pad)
        else:
            small = KVCache.create(self.cfg.lm, 1, l_pad, self.kv_cache_dtype, self.device)
        self._pending = {
            "req": req, "slot": slot, "cache": small, "visual": visual, "offset": start0,
            "start0": start0, "true_len": true_len, "l_pad": l_pad, "m": m, "shared": shared,
            "hashes": hashes, "dev": dev, "params": pp,
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
            p["params"], self.cfg, p["cache"], p["visual"], dev["token_ids"][:, window],
            dev["is_image"][:, window], dev["image_slot"][:, window], start, cs,
            self.kv_cache_dtype, self.w8a8,
        )
        p["offset"] = start + cs
        if p["offset"] >= p["true_len"]:
            logits = lm_logits(p["params"]["lm"], self.cfg.lm,
                               hidden[:, p["true_len"] - 1 - start], self.w8a8)
            self._pending = None
            self._finish_admission(p["slot"], p["req"], p["cache"], logits, l_pad,
                                   p["true_len"], p["m"], p["shared"], p["hashes"])

    def _drop_pending(self, p: dict):
        if p["shared"]:  # the admission's claims on prefix pages
            self.allocator.release(list(p["shared"]))

    # -- decoding ----------------------------------------------------------

    def _release_slot(self, slot: int):
        self.slots[slot] = None
        # unmap before releasing: the freed pages may go to a growing
        # sequence, and a stale table row would let this slot's (inactive,
        # null-page) step read them
        self.paged.page_table[slot] = 0
        self.allocator.release(self.slot_pages[slot])
        self.slot_pages[slot] = []

    def _before_step(self):
        """Map a fresh page for every slot whose next writes cross into an
        unmapped block: with speculation a round writes positions
        [length, length + k], so growth looks k positions ahead."""
        for slot in range(self.num_slots):
            if self.slots[slot] is None:
                continue
            target = min((int(self.lengths[slot]) + self.speculative_k) // self.page_size,
                         self.max_pages_per_seq - 1)
            while len(self.slot_pages[slot]) <= target:
                (pid,) = self._alloc(1)
                map_page(self.paged, slot, len(self.slot_pages[slot]), pid)
                self.slot_pages[slot].append(pid)

    def _decode_step(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        logits, _ = paged_decode_step(self.params, self.cfg, self.paged, tokens, active,
                                      self.w8a8)
        return logits

    def _verify(self, fed: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        logits, _ = paged_verify_step(self.params, self.cfg, self.paged, fed, active, self.w8a8)
        return logits

    def _lengths_changed(self):
        self.paged.lengths.copy_(torch.as_tensor(self.lengths, dtype=torch.int32))
