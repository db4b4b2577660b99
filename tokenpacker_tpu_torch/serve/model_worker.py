"""Model worker (counterpart of `tokenpacker_tpu/serve/model_worker.py`):
hosts the port's model on one card behind the controller.

Parity surface of reference llava/serve/model_worker.py: registration and
15 s heartbeats, the token budget that clamps max_new_tokens against the
context window counting visual tokens ("Exceeds max token length"),
`\\0`-framed JSON streaming from /worker_generate_stream, a concurrency
semaphore (default 5) with the queue length it reports, /worker_get_status
(with the `utils/profiling` phase timings and the prefix-cache counters)
and /metrics (`serve/metrics`). `drain()` (also on SIGTERM / SIGINT)
deregisters, refuses new requests and waits for the ones in flight.

The scheduler decides how a request decodes:
- "none": `Generator.generate_stream`, one request a stream (a load_8bit
  tree decodes each step through K4, and greedy requests with
  `speculative_k` through K4's verify form);
- "continuous": `serve/scheduler.ContinuousBatcher`;
- "paged": `serve/scheduler.PagedContinuousBatcher`, its pool sized as the
  JAX worker sizes it (each decode step's attention K5).
A client that disconnects, or a stop string, cancels the request's slot.

The OpenAI `seed` follows the port's one seed rule on every scheduler:
token k of a seeded request draws with `generate.seed_keys(seed, k)`. An
unseeded sampled request on the "none" path draws a fresh seed, so two
identical requests get independent completions (the batchers draw such
requests from their own generator).

The environment switches of the JAX worker's process are read once, when
the worker is made, and passed on as explicit arguments: TOKENPACKER_KV_CACHE
(int8: `kv_cache_dtype=torch.int8`, llama only; `--kv-cache int8` sets it),
TOKENPACKER_W8A8 (`w8a8=`), TOKENPACKER_VIT_BLOCK (`vit_block=`),
TOKENPACKER_PREFIX_CACHE (the paged batcher's `prefix_cache=`) and
TOKENPACKER_WARMUP (`Generator.warmup` at start-up). An argument given to
`ModelWorker` wins over the environment; nothing below the worker reads it.

    python -m tokenpacker_tpu_torch.serve.model_worker --model-path DIR --load-8bit \\
        --scheduler paged --kv-cache int8
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import queue
import secrets
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from tokenpacker_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, WORKER_HEART_BEAT_INTERVAL
from tokenpacker_tpu_torch.data.mm_tokenize import get_model_name_from_path, tokenizer_image_token
from tokenpacker_tpu_torch.generate import Generator, pick_bucket
from tokenpacker_tpu_torch.image.processing import process_image
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.serve import metrics as mtr
from tokenpacker_tpu_torch.utils.logging_utils import build_logger
from tokenpacker_tpu_torch.utils.profiling import GLOBAL_STATS

logger = build_logger("model_worker", "model_worker.log")

SCHEDULERS = ("none", "continuous", "paged")


def _post_json(url: str, payload: dict, timeout: float = 5.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def env_settings(environ=None) -> dict:
    """The JAX worker's environment switches as the port's arguments, with
    the JAX package's defaults: kv_cache_dtype (torch.int8 or None),
    w8a8, vit_block, prefix_cache, warmup."""
    env = os.environ if environ is None else environ
    return {
        "kv_cache_dtype": torch.int8 if env.get("TOKENPACKER_KV_CACHE", "") in ("int8", "i8")
        else None,
        "w8a8": env.get("TOKENPACKER_W8A8") == "1",
        "vit_block": env.get("TOKENPACKER_VIT_BLOCK", "0") not in ("0", "off", ""),
        "prefix_cache": env.get("TOKENPACKER_PREFIX_CACHE", "1") not in ("0", "off"),
        "warmup": env.get("TOKENPACKER_WARMUP", "1") == "1",
    }


class ModelWorker:
    def __init__(
        self,
        controller_addr: str,
        worker_addr: str,
        model_path: str,
        model_base: str | None = None,
        model_name: str | None = None,
        limit_model_concurrency: int = 5,
        no_register: bool = False,
        load_8bit: bool = False,
        load_4bit: bool = False,
        scheduler: str = "none",  # none | continuous | paged
        scheduler_slots: int = 4,
        scheduler_max_len: int = 1024,
        scheduler_prefill_chunk: int | None = 256,  # chunked admission
        speculative_k: int = 0,  # prompt-lookup speculative decoding (greedy)
        lora_adapters: dict | None = None,  # {name: path} multi-LoRA serving
        device: torch.device | str = "cuda",
        **settings,
    ):
        """The JAX worker's signature, plus `device` (the card by default:
        without one the load raises, never falling back to the CPU) and
        the settings of `env_settings` as keywords (None or absent: from
        the environment)."""
        from tokenpacker_tpu_torch.api import load_pretrained_model

        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {SCHEDULERS}, got {scheduler!r}")
        model_name = model_name or get_model_name_from_path(model_path)
        logger.info(f"Loading model {model_name} ...")
        t0 = time.perf_counter()
        tokenizer, model, _, context_len = load_pretrained_model(
            model_path, model_base, model_name, load_8bit=load_8bit, load_4bit=load_4bit,
            device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.load_s = time.perf_counter() - t0
        self._serve(controller_addr, worker_addr, model_name, tokenizer, model.params,
                    model.config, context_len, limit_model_concurrency, no_register, scheduler,
                    scheduler_slots, scheduler_max_len, scheduler_prefill_chunk, speculative_k,
                    lora_adapters, **settings)

    @classmethod
    def from_params(cls, params, cfg, tokenizer, model_name: str, context_len: int,
                    controller_addr: str | None = None, worker_addr: str | None = None,
                    limit_model_concurrency: int = 5, no_register: bool | None = None,
                    scheduler: str = "none", scheduler_slots: int = 4,
                    scheduler_max_len: int = 1024, scheduler_prefill_chunk: int | None = 256,
                    speculative_k: int = 0, lora_adapters: dict | None = None,
                    **settings) -> "ModelWorker":
        """A worker over params already on their device (no checkpoint
        load); it registers only when given a controller."""
        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {SCHEDULERS}, got {scheduler!r}")
        w = cls.__new__(cls)
        w.load_s = 0.0
        w._serve(controller_addr, worker_addr, model_name, tokenizer, params, cfg, context_len,
                 limit_model_concurrency,
                 controller_addr is None if no_register is None else no_register, scheduler,
                 scheduler_slots, scheduler_max_len, scheduler_prefill_chunk, speculative_k,
                 lora_adapters, **settings)
        return w

    def _serve(self, controller_addr, worker_addr, model_name, tokenizer, params, cfg,
               context_len, limit_model_concurrency, no_register, scheduler, scheduler_slots,
               scheduler_max_len, scheduler_prefill_chunk, speculative_k, lora_adapters,
               kv_cache_dtype=None, w8a8=None, vit_block=None, prefix_cache=None, warmup=None):
        from tokenpacker_tpu_torch.api import LoadedModel

        env = env_settings()
        if kv_cache_dtype is None and cfg.lm.model_family != "mpt":  # MPT keeps float caches
            kv_cache_dtype = env["kv_cache_dtype"]
        w8a8 = env["w8a8"] if w8a8 is None else w8a8
        vit_block = env["vit_block"] if vit_block is None else vit_block
        prefix_cache = env["prefix_cache"] if prefix_cache is None else prefix_cache
        warmup = env["warmup"] if warmup is None else warmup

        self.worker_id = str(uuid.uuid4())[:6]
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.context_len = context_len
        generator = Generator(params, cfg, tokenizer, kv_cache_dtype=kv_cache_dtype, w8a8=w8a8,
                              vit_block=vit_block)
        self.model = LoadedModel(params, cfg, generator)
        self.warmup_s = 0.0
        if warmup:
            logger.info("Warming up: kernels, prefill and decode ...")
            n_crops = 1 if cfg.image_aspect_ratio != "slice" else cfg.patch_num + 1
            t0 = time.perf_counter()
            generator.warmup(n_crops=n_crops, speculative=speculative_k)
            self.warmup_s = time.perf_counter() - t0
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self.speculative_k = speculative_k
        self.adapters = {}
        if lora_adapters:
            # multi-LoRA serving (serve/multi_lora): adapters load unmerged
            # and are selected per request (by name, or by requesting the
            # adapter as the model). Batcher-only feature.
            if scheduler == "none":
                raise ValueError("--lora adapters need a continuous/paged scheduler")
            from tokenpacker_tpu_torch.serve.multi_lora import load_adapter

            for name, path in lora_adapters.items():
                logger.info(f"Loading LoRA adapter {name} from {path}")
                self.adapters[name] = load_adapter(path, cfg)
        self.batcher = None
        if scheduler != "none":
            from tokenpacker_tpu_torch.serve.scheduler import (
                ContinuousBatcher,
                PagedContinuousBatcher,
            )

            common = dict(num_slots=scheduler_slots, speculative_k=speculative_k,
                          prefill_chunk_size=scheduler_prefill_chunk,
                          adapters=self.adapters or None, kv_cache_dtype=kv_cache_dtype,
                          w8a8=w8a8, vit_block=vit_block, device=generator.device)
            if scheduler == "paged":
                pages_per_seq = max((scheduler_max_len + 63) // 64, 1)
                self.batcher = PagedContinuousBatcher(
                    params, cfg, tokenizer,
                    num_pages=max(2 * scheduler_slots * ((scheduler_max_len + 63) // 64), 16) + 1,
                    page_size=64, max_pages_per_seq=pages_per_seq, prefix_cache=prefix_cache,
                    **common)
            else:
                self.batcher = ContinuousBatcher(params, cfg, tokenizer,
                                                 max_seq_len=scheduler_max_len, **common)
            self.batcher.start()
            logger.info(f"{scheduler} batching executor: {scheduler_slots} slots")
        self.queue_length = 0
        self._ql_lock = threading.Lock()
        self.call_ct = 0
        self.draining = False
        self._beats = threading.Event()  # set by drain(): the heartbeats stop
        self.registered = not no_register
        if not no_register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
            self.heart_beat_thread.start()

    # -- controller protocol ----------------------------------------------

    def register_to_controller(self):
        logger.info("Register to controller")
        _post_json(
            self.controller_addr + "/register_worker",
            {
                "worker_name": self.worker_addr,
                "check_heart_beat": True,
                "worker_status": self.get_status(),
            },
        )

    def _heartbeat_loop(self):
        # ends with drain(): a drained worker must not re-register through
        # the "unknown worker" answer to its next beat
        while not self._beats.wait(WORKER_HEART_BEAT_INTERVAL):
            self.send_heart_beat()

    def send_heart_beat(self):
        logger.info(f"Send heart beat. Models: {[self.model_name]}. Queue: {self.queue_length}")
        try:
            ret = _post_json(
                self.controller_addr + "/receive_heart_beat",
                {"worker_name": self.worker_addr, "queue_length": self.queue_length},
            )
            if not ret.get("exist", False):
                self.register_to_controller()
        except Exception as e:
            logger.error(f"heart beat error: {e}")

    def get_status(self) -> dict:
        out = {
            # adapters are addressable as models so the controller routes
            # by adapter name too (multi-LoRA serving)
            "model_names": [self.model_name] + sorted(self.adapters),
            "speed": 1,
            "queue_length": self.queue_length,
            "call_ct": self.call_ct,
            "phase_timings": GLOBAL_STATS.summary(),
        }
        prefix = getattr(self.batcher, "prefix", None)
        if prefix is not None:
            out.update(prefix.stats())
        return out

    # -- generation --------------------------------------------------------

    def plan(self, prompt: str, images_b64) -> tuple[dict, int]:
        """A request's prompt and base64 images as the engine takes them:
        the splice plan padded to its bucket with the views [n, H, W, 3]
        (or None), and its spliced length (visual tokens included)."""
        cfg = self.cfg
        crops_list, blocks = [], []
        if images_b64:
            if len(images_b64) != prompt.count(DEFAULT_IMAGE_TOKEN):
                raise ValueError(
                    "Number of images does not match number of <image> tokens in prompt"
                )
            from PIL import Image

            for b64 in images_b64:
                img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
                crops, hb, wb = process_image(img, cfg.image_aspect_ratio, cfg.patch_num,
                                              image_size=cfg.vision.image_size)
                crops_list.append(crops)
                blocks.append((hb, wb))
        ids = np.asarray(tokenizer_image_token(prompt, self.tokenizer), dtype=np.int64)
        mode = "slice" if cfg.image_aspect_ratio == "slice" else "single"
        args = ([ids], [blocks], cfg.tokens_per_view, mode,
                self.tokenizer.convert_tokens_to_ids(","),
                self.tokenizer.convert_tokens_to_ids("\n"), self.tokenizer.pad_token_id or 0)
        spliced_len = int(build_splice_plan(*args).lengths[0])
        plan = build_splice_plan(*args, pad_to=pick_bucket(spliced_len))
        images = (np.concatenate(crops_list, axis=0).transpose(0, 2, 3, 1) if crops_list
                  else None)
        return {"token_ids": plan.token_ids, "is_image": plan.is_image,
                "image_slot": plan.image_slot, "lengths": plan.lengths,
                "images": images}, spliced_len

    def generate_stream(self, params: dict):
        """Yields '\\0'-terminated JSON chunks ({'text', 'error_code'}).

        The FINAL chunk additionally carries 'finish_reason' ('stop' |
        'length') and 'usage' {prompt_tokens, completion_tokens,
        total_tokens}, which the OpenAI-compatible gateway
        (serve/openai_api.py) reads; the other clients read only the text.
        With `logprobs` set, each token's chunk carries a "logprobs" list
        with its entry (`_lp_json`)."""
        prompt = params["prompt"]
        images_b64 = params.get("images", None)
        temperature = float(params.get("temperature", 1.0))
        top_p = float(params.get("top_p", 1.0))
        # sampling-only top-k width and min-p cutoff; 0/absent = off
        top_k = int(params.get("top_k", 0)) or None
        min_p = float(params.get("min_p", 0.0)) or None
        repetition_penalty = float(params.get("repetition_penalty", 1.0))
        presence_penalty = float(params.get("presence_penalty", 0.0))
        frequency_penalty = float(params.get("frequency_penalty", 0.0))
        logprobs = params.get("logprobs")
        logprobs = int(logprobs) if logprobs is not None else None
        seed = params.get("seed")
        seed = int(seed) if seed is not None else None
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop", None)
        # multi-LoRA: explicit "adapter" field, or requesting an adapter
        # name as the model (the worker advertises adapters as models)
        adapter = params.get("adapter")
        if adapter is None and params.get("model") in self.adapters:
            adapter = params["model"]

        t_start = time.perf_counter()
        try:
            batch, spliced_len = self.plan(prompt, images_b64)
            # clamp against the context window (model_worker.py:168-171)
            budget = self.context_len - spliced_len - 8
            if budget <= 0:
                yield json.dumps(
                    {
                        "text": prompt + "Exceeds max token length. Please start a new conversation, thanks.",
                        "error_code": 0,
                    }
                ).encode() + b"\0"
                return
            max_new_tokens = min(max_new_tokens, budget)
            if stop_str is None or isinstance(stop_str, str):
                stop_strings = (stop_str,) if stop_str else ()
            else:  # OpenAI-style list of stop strings
                stop_strings = tuple(s for s in stop_str if s)
            GLOBAL_STATS.record("preprocess", time.perf_counter() - t_start)
            mtr.WORKER_PREPROCESS.observe(time.perf_counter() - t_start)
            t_prefill = time.perf_counter()
            if adapter is not None and (self.batcher is None or adapter not in self.adapters):
                raise ValueError(f"unknown LoRA adapter: {adapter}")
            sampling = dict(temperature=temperature, top_k=top_k, min_p=min_p,
                            repetition_penalty=repetition_penalty,
                            presence_penalty=presence_penalty,
                            frequency_penalty=frequency_penalty, logprobs=logprobs)
            if self.batcher is not None:
                yield from self._stream_via_batcher(prompt, batch, max_new_tokens, top_p,
                                                    stop_strings, t_prefill, spliced_len,
                                                    adapter=adapter, seed=seed, **sampling)
                return
            if seed is None:  # independent completions for identical unseeded requests
                seed = secrets.randbits(31)
            first = True
            n_toks = 0
            generated = ""
            for item in self.model.generator.generate_stream(
                batch, max_new_tokens=max_new_tokens, top_p=top_p, stop_strings=stop_strings,
                speculative=self.speculative_k, seed=seed, **sampling,
            ):
                # with logprobs on, generate_stream yields (text, entry)
                text, entry = item if logprobs is not None else (item, None)
                if first:
                    GLOBAL_STATS.record("prefill_ttft", time.perf_counter() - t_prefill)
                    mtr.WORKER_TTFT.observe(time.perf_counter() - t_prefill)
                    t_decode = time.perf_counter()
                    first = False
                n_toks += 1
                generated = text
                payload = {"text": prompt + generated, "error_code": 0}
                if entry is not None:
                    payload["logprobs"] = [self._lp_json(entry)]
                yield json.dumps(payload).encode() + b"\0"
            if not first and n_toks > 1:
                per_tok = (time.perf_counter() - t_decode) / (n_toks - 1)
                GLOBAL_STATS.record("decode_per_token", per_tok)
                mtr.WORKER_DECODE_TOKEN.observe(per_tok)
            yield self._final_chunk(prompt + generated, spliced_len, n_toks, max_new_tokens)
        except ValueError as e:
            logger.error(f"ValueError: {e}")
            mtr.WORKER_ERRORS.inc()
            yield json.dumps(
                {"text": f"{e}\n(error_code: 1)", "error_code": 1}
            ).encode() + b"\0"
        except Exception as e:
            logger.error(f"Unknown error: {e!r}")
            mtr.WORKER_ERRORS.inc()
            yield json.dumps(
                {"text": "internal error\n(error_code: 1)", "error_code": 1}
            ).encode() + b"\0"

    def _lp_json(self, entry: dict) -> dict:
        """Wire form of a generate.token_logprob_entry record: token ids
        resolved to token strings (tokenizer piece form when the tokenizer
        exposes it, else a single-id decode); "top" becomes
        ``[[id, token, logprob], ...]``. The gateway renders these into the
        OpenAI chat/legacy logprobs shapes."""
        if hasattr(self.tokenizer, "convert_ids_to_tokens"):
            tokstr = lambda i: str(self.tokenizer.convert_ids_to_tokens(i))
        else:
            tokstr = lambda i: self.tokenizer.decode([i])
        out = {"id": entry["id"], "token": tokstr(entry["id"]),
               "logprob": entry["logprob"]}
        if "top" in entry:
            out["top"] = [[i, tokstr(i), lp] for i, lp in entry["top"]]
        return out

    def _final_chunk(self, full_text: str, prompt_tokens: int,
                     completion_tokens: int, max_new_tokens: int,
                     finish: str | None = None) -> bytes:
        """Terminal stream chunk with OpenAI-style accounting. `finish` is
        the stream's end cause when the caller knows it (EOS or a stop
        string: "stop", the cap: "length"); None infers it from the cap,
        right only where the token count excludes EOS."""
        if finish is None:
            finish = "length" if completion_tokens >= max_new_tokens else "stop"
        mtr.WORKER_PROMPT_TOKENS.inc(prompt_tokens)
        mtr.WORKER_GENERATED_TOKENS.inc(completion_tokens)
        return json.dumps({
            "text": full_text,
            "error_code": 0,
            "finish_reason": finish,
            "usage": {
                "prompt_tokens": prompt_tokens,
                "completion_tokens": completion_tokens,
                "total_tokens": prompt_tokens + completion_tokens,
            },
        }).encode() + b"\0"

    def _stream_via_batcher(self, prompt, batch, max_new_tokens, top_p, stop_strings, t_prefill,
                            spliced_len, adapter=None, seed=None, temperature=0.0, top_k=None,
                            min_p=None, repetition_penalty=1.0, presence_penalty=0.0,
                            frequency_penalty=0.0, logprobs=None):
        """Stream through the continuous-batching executor: tokens arrive via
        the slot's on_token callback while other requests decode in the same
        device step; each slot samples with its own settings."""
        q: queue.Queue = queue.Queue()
        fut = self.batcher.submit(
            batch, max_new_tokens=max_new_tokens,
            temperature=temperature if temperature > 0 else 0.0,
            top_p=top_p if 0.0 < top_p < 1.0 else None,
            top_k=top_k, min_p=min_p, seed=seed, on_token=q.put, adapter=adapter,
            repetition_penalty=repetition_penalty, presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty, logprobs=logprobs,
        )
        fut.add_done_callback(lambda f: q.put(None))
        # lp_entries are appended before on_token fires (the batcher's
        # thread), so entry lp_i - 1 exists when token lp_i arrives
        lp_req = getattr(fut, "_tp_request", None)
        lp_i = 0
        eos = self.cfg.lm.eos_token_id
        toks: list[int] = []
        first = True
        n = 0  # non-EOS emitted tokens only (OpenAI completion_tokens)
        finish = None  # why the stream actually ended
        text = ""
        t_decode = time.perf_counter()
        try:
            while True:
                try:
                    tok = q.get(timeout=600)
                except queue.Empty:
                    self.batcher.cancel(fut)
                    yield json.dumps(
                        {"text": "scheduler timeout\n(error_code: 1)", "error_code": 1}
                    ).encode() + b"\0"
                    return
                if tok is None:
                    err = fut.exception() if fut.done() else None
                    if err is not None:
                        logger.error(f"batcher error: {err}")
                        yield json.dumps(
                            {"text": f"{err}\n(error_code: 1)", "error_code": 1}
                        ).encode() + b"\0"
                        return
                    break
                if first:
                    GLOBAL_STATS.record("prefill_ttft", time.perf_counter() - t_prefill)
                    mtr.WORKER_TTFT.observe(time.perf_counter() - t_prefill)
                    t_decode = time.perf_counter()
                    first = False
                lp_i += 1
                if tok == eos:
                    # an EOS, even at max_new_tokens, is a natural stop; it
                    # is not billed and its logprob entry is skipped (OpenAI
                    # leaves the stop token out of logprobs content)
                    finish = "stop"
                    continue
                n += 1
                toks.append(int(tok))
                text = self.tokenizer.decode(toks, skip_special_tokens=True)
                stopped = False
                for s in stop_strings:
                    if s and s in text:
                        text = text.split(s)[0]
                        stopped = True
                payload = {"text": prompt + text, "error_code": 0}
                if (logprobs is not None and lp_req is not None
                        and lp_i <= len(lp_req.lp_entries)):
                    payload["logprobs"] = [self._lp_json(lp_req.lp_entries[lp_i - 1])]
                yield json.dumps(payload).encode() + b"\0"
                if stopped:
                    # free the slot now: the client has its answer
                    finish = "stop"
                    self.batcher.cancel(fut)
                    break
        except GeneratorExit:
            # client disconnected mid-stream: stop burning decode steps
            self.batcher.cancel(fut)
            raise
        if n > 1:
            per_tok = (time.perf_counter() - t_decode) / (n - 1)
            GLOBAL_STATS.record("decode_per_token", per_tok)
            mtr.WORKER_DECODE_TOKEN.observe(per_tok)
        if finish is None:
            finish = "length" if n >= max_new_tokens else "stop"
        yield self._final_chunk(prompt + text, spliced_len, n, max_new_tokens, finish=finish)

    def drain(self, timeout: float = 60.0):
        """Graceful shutdown: deregister from the controller (no new
        dispatches) and stop the heartbeats, refuse new requests, wait for
        the ones in flight, then stop the batcher."""
        self.draining = True
        self._beats.set()
        if self.controller_addr and self.registered:
            try:
                _post_json(
                    self.controller_addr + "/deregister_worker",
                    {"worker_name": self.worker_addr},
                )
            except Exception as e:
                logger.error(f"deregister failed (continuing drain): {e}")
        deadline = time.time() + timeout
        while self.queue_length > 0 and time.time() < deadline:
            time.sleep(0.25)
        if self.queue_length:
            logger.warning(
                f"drain timeout with {self.queue_length} requests in flight"
            )
        if self.batcher is not None:
            self.batcher.stop()
        logger.info("worker drained")

    def generate_stream_gate(self, params: dict):
        if self.draining:
            yield json.dumps(
                {"text": "worker is shutting down", "error_code": 1}
            ).encode() + b"\0"
            return
        mtr.WORKER_REQUESTS.inc()
        with self._ql_lock:
            self.queue_length += 1
            mtr.WORKER_QUEUE.set(self.queue_length)
        self.semaphore.acquire()
        try:
            self.call_ct += 1
            yield from self.generate_stream(params)
        finally:
            self.semaphore.release()
            with self._ql_lock:
                self.queue_length -= 1
                mtr.WORKER_QUEUE.set(self.queue_length)


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path.rstrip("/") == "/metrics":
                # refresh point-in-time gauges from live worker state
                mtr.WORKER_QUEUE.set(worker.queue_length)
                prefix = getattr(worker.batcher, "prefix", None)
                if prefix is not None:
                    for k, v in prefix.stats().items():
                        mtr.WORKER_PREFIX.set(v, stat=k.removeprefix("prefix_"))
                mtr.send_metrics_response(self)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            body = self._read_json()
            route = self.path.rstrip("/")
            if route == "/worker_get_status":
                data = json.dumps(worker.get_status()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif route == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                gen = worker.generate_stream_gate(body)
                try:
                    for chunk in gen:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client disconnected mid-stream
                finally:
                    # closing the generator raises GeneratorExit inside it,
                    # which cancels the batcher slot
                    gen.close()
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--worker-address", default="http://localhost:21002")
    parser.add_argument("--controller-address", default="http://localhost:21001")
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--scheduler", default="none", choices=list(SCHEDULERS))
    parser.add_argument("--scheduler-slots", type=int, default=4)
    parser.add_argument("--scheduler-max-len", type=int, default=1024)
    parser.add_argument("--scheduler-prefill-chunk", type=int, default=256,
                        help="0 disables chunked admission (whole-prompt prefill)")
    parser.add_argument("--lora", action="append", default=[], metavar="NAME=PATH",
                        help="load a LoRA adapter for multi-LoRA serving "
                             "(repeatable). Requests select it via the "
                             "'adapter' field or by using NAME as the model; "
                             "the worker also advertises NAME to the "
                             "controller. Needs --scheduler continuous|paged")
    parser.add_argument("--speculative-k", type=int, default=0,
                        help="prompt-lookup speculative decoding draft length "
                             "for greedy requests (direct streaming path and "
                             "both schedulers; 0 disables)")
    parser.add_argument("--kv-cache", default="auto", choices=["auto", "int8"],
                        help="KV cache storage: int8 stores K/V with "
                             "per-(position, head) absmax scales "
                             "(ops/kv_quant), halving the cache's memory; "
                             "llama-family only. auto: TOKENPACKER_KV_CACHE")
    parser.add_argument("--device", default="cuda",
                        help="the card (default); 'cpu' runs every kernel's plain version")
    args = parser.parse_args(argv)
    worker = ModelWorker(
        args.controller_address,
        args.worker_address,
        args.model_path,
        args.model_base,
        args.model_name,
        args.limit_model_concurrency,
        args.no_register,
        args.load_8bit,
        args.load_4bit,
        scheduler=args.scheduler,
        scheduler_slots=args.scheduler_slots,
        scheduler_max_len=args.scheduler_max_len,
        scheduler_prefill_chunk=args.scheduler_prefill_chunk or None,
        speculative_k=args.speculative_k,
        lora_adapters=dict(s.split("=", 1) for s in args.lora) or None,
        device=args.device,
        kv_cache_dtype=torch.int8 if args.kv_cache == "int8" else None,
    )
    server = ThreadingHTTPServer((args.host, args.port), make_handler(worker))

    import signal

    def _graceful(signum, frame):
        logger.info(f"signal {signum}: draining worker")
        # drain + shutdown off the signal handler thread (server.shutdown()
        # deadlocks if called from within serve_forever's own thread)
        threading.Thread(
            target=lambda: (worker.drain(), server.shutdown()), daemon=True
        ).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _graceful)
    logger.info(f"worker listening on {args.host}:{args.port}")
    server.serve_forever()
    logger.info("worker exited cleanly")


if __name__ == "__main__":
    main()
