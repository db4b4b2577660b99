"""The port's HTTP serving stack against the JAX package's, on the CPU:
`serve/model_worker` over each scheduler, `serve/controller`,
`serve/metrics`, `serve/web_server`, `utils/profiling`,
`utils/logging_utils`, the constants and the conversation helpers of the
web UI.

Both workers serve the same tiny fp32 weights (`init_vlm`, moved with
`params_from_jax`) through one word tokenizer (`tests/test_trainer.Tok`,
which decodes every id it has not seen to "?"); the JAX workers are made
as `tests/test_serve.py` makes them (`ModelWorker.__new__`), the port's
with `ModelWorker.from_params(..., device="cpu")`. A greedy request with
an image streams the same chunk texts, `finish_reason` and `usage` on
every scheduler, with logprob entries within LP_TOL (fp32); a seeded
sampled request gives the same ids on all three of the port's schedulers
(ROADMAP R1), read from its logprob entries' `id`, where the JAX worker's
direct path draws other ids than its batcher.
"""

import base64
import io
import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from tokenpacker_tpu import constants as jax_constants
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.data import conversation as jax_conversation
from tokenpacker_tpu.generate import Generator as JaxGenerator
from tokenpacker_tpu.models.vlm import init_vlm
from tokenpacker_tpu.serve import controller as jax_controller
from tokenpacker_tpu.serve import metrics as jax_metrics
from tokenpacker_tpu.serve import model_worker as jax_worker_mod
from tokenpacker_tpu.serve import web_server as jax_web
from tokenpacker_tpu.serve.scheduler import ContinuousBatcher as JaxDense
from tokenpacker_tpu.serve.scheduler import PagedContinuousBatcher as JaxPaged
from tokenpacker_tpu.utils import logging_utils as jax_logging
from tokenpacker_tpu_torch import constants
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.data import conversation
from tokenpacker_tpu_torch.generate import Generator
from tokenpacker_tpu_torch.io.weights import params_from_jax
from tokenpacker_tpu_torch.serve import controller, metrics, model_worker, web_server
from tokenpacker_tpu_torch.serve.model_worker import ModelWorker
from tokenpacker_tpu_torch.utils import logging_utils, profiling
from tests.test_trainer import Tok

MODEL = "tiny-tokenpacker"
CONTEXT = 512
SLOTS, MAX_LEN = 2, 128
# fp32 log_softmax of logits that two engines computed in another order
LP_TOL = 1e-4
WARM = "A chat between a curious user and an artificial intelligence assistant what is this"
SCHEDULERS = ("none", "continuous", "paged", "speculative")


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def post(url, payload, timeout=60):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def get_text(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def frames(url, payload, timeout=120) -> list:
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return [json.loads(f) for f in resp.read().split(b"\0") if f]


def serve(handler) -> tuple[str, ThreadingHTTPServer]:
    port = free_port()
    server = ThreadingHTTPServer(("localhost", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://localhost:{port}", server


def png_b64(w: int, h: int, seed: int) -> str:
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def chunks_of(worker, payload) -> list:
    return [json.loads(c[:-1]) for c in worker.generate_stream(dict(payload))]


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_tiny_config()
    params_j = init_vlm(jax.random.PRNGKey(0), cfg_j)
    cfg = tiny_vlm_config()
    tok = Tok()
    tok(WARM)
    return SimpleNamespace(cfg=cfg, cfg_j=cfg_j, params_j=params_j, tok=tok,
                           params=params_from_jax(jax.tree.map(np.asarray, params_j), cfg))


def make_jax_worker(m, scheduler: str):
    """The JAX worker as tests/test_serve.py makes it, with the batcher
    its __init__ would make for `scheduler` (SLOTS slots, MAX_LEN)."""

    class FakeLoaded:
        config = m.cfg_j
        generator = JaxGenerator(m.params_j, m.cfg_j, m.tok)
        params = m.params_j

    w = jax_worker_mod.ModelWorker.__new__(jax_worker_mod.ModelWorker)
    w.worker_id, w.controller_addr, w.worker_addr = "test", None, None
    w.model_name, w.tokenizer, w.model = MODEL, m.tok, FakeLoaded()
    w.image_processor, w.context_len, w.cfg = None, CONTEXT, m.cfg_j
    w.semaphore = threading.Semaphore(4)
    w.queue_length, w._ql_lock, w.call_ct, w.draining = 0, threading.Lock(), 0, False
    w.adapters, w.registered = {}, False
    w.speculative_k = 3 if scheduler == "speculative" else 0
    w.batcher = None
    if scheduler == "continuous":
        w.batcher = JaxDense(m.params_j, m.cfg_j, m.tok, num_slots=SLOTS, max_seq_len=MAX_LEN,
                             prefill_chunk_size=256)
    elif scheduler == "paged":
        w.batcher = JaxPaged(m.params_j, m.cfg_j, m.tok, num_slots=SLOTS,
                             num_pages=max(2 * SLOTS * ((MAX_LEN + 63) // 64), 16) + 1,
                             page_size=64, max_pages_per_seq=(MAX_LEN + 63) // 64,
                             prefill_chunk_size=256)
    if w.batcher is not None:
        w.batcher.start()
    return w


def make_port_worker(m, scheduler: str, **kw):
    spec = scheduler == "speculative"
    return ModelWorker.from_params(
        m.params, m.cfg, m.tok, MODEL, CONTEXT, scheduler="none" if spec else scheduler,
        scheduler_slots=SLOTS, scheduler_max_len=MAX_LEN, speculative_k=3 if spec else 0,
        warmup=False, **kw)


@pytest.fixture(scope="module")
def workers(model):
    """Both packages' workers on every scheduler ("speculative": the
    direct path with speculative_k 3)."""
    out = {s: (make_port_worker(model, s), make_jax_worker(model, s)) for s in SCHEDULERS}
    yield out
    for port, jax_w in out.values():
        for b in (port.batcher, jax_w.batcher):
            if b is not None:
                b.stop()


IMAGE = png_b64(80, 60, 0)
GREEDY = {"prompt": "USER: <image>\nwhat is this ASSISTANT:", "images": [IMAGE],
          "temperature": 0.0, "max_new_tokens": 6}


def assert_same_chunks(got: list, want: list):
    """Texts, error codes, finish_reason and usage equal; logprob entries
    with equal ids and token strings and values within LP_TOL."""
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g["text"] == w["text"] and g["error_code"] == w["error_code"] == 0
        assert g.get("finish_reason") == w.get("finish_reason")
        assert g.get("usage") == w.get("usage")
        assert ("logprobs" in g) == ("logprobs" in w)
        for ge, we in zip(g.get("logprobs", []), w.get("logprobs", [])):
            assert ge["id"] == we["id"] and ge["token"] == we["token"]
            assert abs(ge["logprob"] - we["logprob"]) <= LP_TOL
            assert [t[:2] for t in ge["top"]] == [t[:2] for t in we["top"]]
            np.testing.assert_allclose([t[2] for t in ge["top"]], [t[2] for t in we["top"]],
                                       atol=LP_TOL)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_greedy_stream_matches_jax(workers, scheduler):
    """One greedy request with an image: the chunks equal the JAX worker's
    on the same scheduler (with logprobs=2, except for speculation, which
    logprobs turn off in both packages)."""
    port, jax_w = workers[scheduler]
    payload = dict(GREEDY) if scheduler == "speculative" else dict(GREEDY, logprobs=2)
    got, want = chunks_of(port, payload), chunks_of(jax_w, payload)
    assert_same_chunks(got, want)
    final = got[-1]
    assert final["finish_reason"] == "length"
    assert final["usage"]["completion_tokens"] == GREEDY["max_new_tokens"]
    assert final["usage"]["prompt_tokens"] == port.plan(GREEDY["prompt"], [IMAGE])[1]


def seeded_ids(worker, seed=1234) -> list:
    payload = dict(GREEDY, temperature=1.5, max_new_tokens=8, seed=seed, logprobs=0)
    out = chunks_of(worker, payload)
    assert all(c["error_code"] == 0 for c in out)
    return [e["id"] for c in out for e in c.get("logprobs", [])]


def test_seed_rule_is_one_on_every_scheduler(workers):
    """ROADMAP R1, side by side: a seeded sampled request gives the same
    ids on the port's none, continuous and paged workers (token k draws
    with seed_keys(seed, k)), and again on a second call; another seed
    gives others. The JAX worker's direct path draws from its PRNGKey
    split chain and its batchers from fold_in(PRNGKey(seed), k), so its
    ids depend on the scheduler."""
    port = {s: seeded_ids(workers[s][0]) for s in ("none", "continuous", "paged")}
    assert len(port["none"]) > 1  # up to 8, or to the EOS drawn (its entry is not sent)
    assert port["none"] == port["continuous"] == port["paged"]
    assert seeded_ids(workers["none"][0]) == port["none"]
    assert seeded_ids(workers["paged"][0], seed=1235) != port["none"]
    jax_ids = {s: seeded_ids(workers[s][1]) for s in ("none", "continuous")}
    assert jax_ids["none"] != jax_ids["continuous"]


def test_unseeded_direct_requests_are_independent(workers):
    """Without a seed the direct path draws a fresh one per request, as the
    JAX worker does: two identical sampled requests differ."""
    payload = dict(GREEDY, temperature=1.5, max_new_tokens=8, logprobs=0)
    a, b = ([e["id"] for c in chunks_of(workers["none"][0], payload) for e in c.get("logprobs",
                                                                                     [])]
            for _ in range(2))
    assert len(a) > 1 and a != b


def test_context_clamp_and_unknown_adapter_match_jax(workers):
    """A prompt past the context window answers "Exceeds max token length"
    and an unknown adapter an error chunk, in the same bytes as the JAX
    worker (the adapter is refused before anything is submitted)."""
    long = dict(GREEDY, prompt="USER: <image>\n" + "what is this " * 200 + "ASSISTANT:")
    for s in ("none", "paged"):
        port, jax_w = workers[s]
        got, want = list(port.generate_stream(dict(long))), list(jax_w.generate_stream(dict(long)))
        assert got == want and b"Exceeds max token length" in got[0]
        bad = dict(GREEDY, adapter="nope")
        got, want = list(port.generate_stream(dict(bad))), list(jax_w.generate_stream(dict(bad)))
        assert got == want == [json.dumps({"text": "unknown LoRA adapter: nope\n(error_code: 1)",
                                           "error_code": 1}).encode() + b"\0"]


def test_stop_string_cancels_the_slot(workers):
    """A stop string ends the stream with JAX's chunks and frees the
    batcher's slot at once instead of decoding to max_new_tokens."""
    port, jax_w = workers["continuous"]
    first = chunks_of(port, GREEDY)[1]["text"][len(GREEDY["prompt"]):].split(" ")
    payload = dict(GREEDY, max_new_tokens=100, stop=" " + first[1])
    got, want = chunks_of(port, payload), chunks_of(jax_w, payload)
    assert_same_chunks(got, want)
    assert got[-1]["finish_reason"] == "stop" and got[-1]["usage"]["completion_tokens"] == 2
    deadline = time.time() + 30
    while any(port.batcher.slots) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(port.batcher.slots)
    assert port.batcher.stats["decode_steps"] < 100


def test_client_disconnect_cancels_the_slot(workers):
    """Closing the stream mid-way (what the HTTP handler does when the
    client goes) cancels the request's slot: it frees at once instead of
    decoding to max_new_tokens."""
    port = workers["paged"][0]
    stream = port.generate_stream(dict(GREEDY, max_new_tokens=100))
    next(stream), next(stream)
    steps = port.batcher.stats["decode_steps"]
    stream.close()
    deadline = time.time() + 30
    while any(port.batcher.slots) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(port.batcher.slots)
    assert port.batcher.stats["decode_steps"] - steps < 50


def test_lora_adapter_served_by_name_matches_jax(model, tmp_path):
    """--lora NAME=PATH: the adapter goes onto the batcher's `adapters=`, is
    advertised as a model, and a request naming it as its model streams
    the JAX worker's chunks under the same adapter (logprobs within
    LP_TOL) and other ids than the base model; the direct path refuses
    adapters."""
    from test_torch_checkpoint import _write_lora
    from tokenpacker_tpu.serve.multi_lora import load_adapter as jax_load_adapter

    _write_lora(tmp_path / "ad", model.cfg, 7)
    port = make_port_worker(model, "continuous", lora_adapters={"ad": str(tmp_path / "ad")})
    jax_w = make_jax_worker(model, "none")
    jax_w.adapters = {"ad": jax_load_adapter(str(tmp_path / "ad"), model.cfg_j)}
    jax_w.batcher = JaxDense(model.params_j, model.cfg_j, model.tok, num_slots=SLOTS,
                             max_seq_len=MAX_LEN, prefill_chunk_size=256, adapters=jax_w.adapters)
    jax_w.batcher.start()
    try:
        assert port.get_status()["model_names"] == [MODEL, "ad"]
        payload = dict(GREEDY, model="ad", logprobs=1)
        got = chunks_of(port, payload)
        assert_same_chunks(got, chunks_of(jax_w, payload))
        base = chunks_of(port, dict(payload, model=MODEL))
        assert [e["id"] for c in got for e in c.get("logprobs", [])] != [
            e["id"] for c in base for e in c.get("logprobs", [])]
    finally:
        port.batcher.stop()
        jax_w.batcher.stop()
    with pytest.raises(ValueError, match="continuous/paged"):
        make_port_worker(model, "none", lora_adapters={"ad": str(tmp_path / "ad")})


def test_status_and_metrics_after_a_generation(workers):
    """Over HTTP: a generation, then /worker_get_status (model names, the
    call count, the phase timings and the prefix-cache counters) and
    /metrics with the request, TTFT and token families counted."""
    port = workers["paged"][0]
    base, server = serve(model_worker.make_handler(port))
    try:
        before = {n: metrics.REGISTRY._metrics[n] for n in (
            "tokenpacker_worker_requests_total", "tokenpacker_worker_generated_tokens_total")}
        req0 = before["tokenpacker_worker_requests_total"].value()
        gen0 = before["tokenpacker_worker_generated_tokens_total"].value()
        ttft0 = metrics.WORKER_TTFT.count()
        out = frames(base + "/worker_generate_stream", GREEDY)
        assert out[-1]["error_code"] == 0 and out[-1]["finish_reason"] == "length"
        status = post(base + "/worker_get_status", {})
        assert status["model_names"] == [MODEL] and status["call_ct"] >= 1
        timings = status["phase_timings"]
        assert timings["prefill_ttft"]["count"] >= 1
        # the batcher's spans, summarised over a bounded window a name
        assert {"batcher.queue", "batcher.admit", "batcher.decode", "batcher.decode.inputs",
                "batcher.decode.launch", "batcher.decode.wait", "batcher.emit"} <= set(timings)
        assert timings["batcher.decode"]["count"] >= GREEDY["max_new_tokens"] - 1
        stats = profiling.GLOBAL_STATS
        for _ in range(stats.window + 5):
            stats.record("preprocess", 0.001)
        summ = post(base + "/worker_get_status", {})["phase_timings"]["preprocess"]
        assert summ["count"] == timings.get("preprocess", {}).get("count", 0) + stats.window + 5
        assert len(stats.samples["preprocess"]) == stats.window
        assert len(stats.records()) <= stats.capacity
        assert {"prefix_cache_hits", "prefix_tokens_reused",
                "prefix_vision_encodes_skipped"} <= set(status)
        code, text = get_text(base + "/metrics")
        assert code == 200
        assert metrics.WORKER_REQUESTS.value() == req0 + 1
        assert metrics.WORKER_GENERATED_TOKENS.value() == gen0 + GREEDY["max_new_tokens"]
        assert metrics.WORKER_TTFT.count() == ttft0 + 1
        for family in ("tokenpacker_worker_requests_total", "tokenpacker_worker_ttft_seconds_count",
                       "tokenpacker_worker_generated_tokens_total",
                       'tokenpacker_worker_prefix_cache{stat="cache_hits"}'):
            assert family in text
        with pytest.raises(urllib.error.HTTPError):
            get_text(base + "/nope")
    finally:
        server.shutdown()


def test_drain_deregisters_and_stops_the_heartbeats(model):
    """A worker made with a controller registers itself (its own register
    path), answers the controller's heartbeat protocol, and drain()
    deregisters it, stops its heartbeats and refuses new requests."""
    ctl = controller.Controller("shortest_queue")
    cbase, cserver = serve(controller.make_handler(ctl))
    try:
        w = ModelWorker.from_params(model.params, model.cfg, model.tok, MODEL, CONTEXT,
                                    controller_addr=cbase, worker_addr="http://localhost:9",
                                    warmup=False)
        assert post(cbase + "/list_models", {})["models"] == [MODEL]
        beats = metrics.CONTROLLER_HEARTBEATS.value()
        w.send_heart_beat()
        assert metrics.CONTROLLER_HEARTBEATS.value() == beats + 1
        w.drain(timeout=5.0)
        assert post(cbase + "/list_models", {})["models"] == []
        w.heart_beat_thread.join(timeout=5)
        assert not w.heart_beat_thread.is_alive()
        out = [json.loads(c[:-1]) for c in w.generate_stream_gate({"prompt": "hi"})]
        assert out == [{"text": "worker is shutting down", "error_code": 1}]
    finally:
        cserver.shutdown()
        ctl.stop()


def test_worker_on_the_card_never_falls_back_to_the_cpu(tmp_path):
    """The default device is the card: without one, making a worker raises
    (it loads nothing on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelWorker("http://localhost:1", "http://localhost:2", str(tmp_path / "missing"),
                    no_register=True, warmup=False)


def test_environment_switches_are_read_at_the_edge(model, monkeypatch):
    """TOKENPACKER_KV_CACHE / W8A8 / VIT_BLOCK / PREFIX_CACHE / WARMUP map to
    the Generator's and the batchers' arguments when the worker is made;
    an explicit argument wins."""
    assert model_worker.env_settings({}) == {
        "kv_cache_dtype": None, "w8a8": False, "vit_block": False, "prefix_cache": True,
        "warmup": True}
    env = {"TOKENPACKER_KV_CACHE": "int8", "TOKENPACKER_W8A8": "1",
           "TOKENPACKER_VIT_BLOCK": "1", "TOKENPACKER_PREFIX_CACHE": "0",
           "TOKENPACKER_WARMUP": "0"}
    assert model_worker.env_settings(env) == {
        "kv_cache_dtype": torch.int8, "w8a8": True, "vit_block": True, "prefix_cache": False,
        "warmup": False}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    w = ModelWorker.from_params(model.params, model.cfg, model.tok, MODEL, CONTEXT,
                                scheduler="paged", scheduler_slots=1, scheduler_max_len=64,
                                vit_block=False)
    try:
        gen = w.model.generator
        assert (gen.kv_cache_dtype, gen.w8a8, gen.vit_block) == (torch.int8, True, False)
        assert w.batcher.kv_cache_dtype == torch.int8 and w.batcher.prefix is None
        assert w.warmup_s == 0.0
    finally:
        w.batcher.stop()


def test_main_drops_the_compile_cache_flag():
    """The worker's flags are the JAX worker's but --compile-cache (its
    persistent XLA cache has no counterpart here)."""
    with pytest.raises(SystemExit):
        model_worker.main(["--model-path", "x", "--compile-cache", "off"])


def test_generator_warmup_runs_the_streaming_path(model):
    """`Generator.warmup` runs a prefill and a decode step at each bucket
    (and a verify step with speculative > 0) without touching any later
    request's result."""
    gen = Generator(model.params, model.cfg, model.tok)
    before = list(gen.generate_stream(_plan(model, GREEDY), max_new_tokens=4))
    gen.warmup(buckets=(64,), max_new_tokens=8, speculative=2)
    assert list(gen.generate_stream(_plan(model, GREEDY), max_new_tokens=4)) == before


def _plan(m, payload) -> dict:
    w = ModelWorker.__new__(ModelWorker)
    w.cfg, w.tokenizer = m.cfg, m.tok
    return w.plan(payload["prompt"], payload["images"])[0]


# -- the controller and the metrics -------------------------------------------


def controller_script(mod) -> list:
    """One scripted sequence against a controller of `mod` over HTTP:
    registrations with and without heartbeat checks, heartbeats of known
    and unknown workers, lists, dispatches under both methods (LOTTERY
    with np.random seeded), expiry and deregistration. Returns every
    response."""
    out = []
    for method in ("shortest_queue", "lottery"):
        np.random.seed(0)
        ctl = mod.Controller(method)
        base, server = serve(mod.make_handler(ctl))
        try:
            for name, models, speed, beat in (("http://a:1", ["m1"], 1, True),
                                              ("http://b:2", ["m1", "m2"], 3, False),
                                              ("http://c:3", ["m2"], 2, True)):
                out.append(post(base + "/register_worker", {
                    "worker_name": name, "check_heart_beat": beat,
                    "worker_status": {"model_names": models, "speed": speed,
                                      "queue_length": 0}}))
            out.append(post(base + "/list_models", {}))
            out.append(post(base + "/receive_heart_beat",
                            {"worker_name": "http://a:1", "queue_length": 2}))
            out.append(post(base + "/receive_heart_beat",
                            {"worker_name": "http://z:9", "queue_length": 1}))
            out += [post(base + "/get_worker_address", {"model": m})
                    for m in ("m1", "m2", "m1", "m2", "m1", "m1", "nope")]
            with ctl.lock:
                ctl.worker_info["http://c:3"].last_heart_beat -= 1000
                ctl.worker_info["http://b:2"].last_heart_beat -= 1000
            ctl.remove_stale_workers_by_expiration()
            out.append(post(base + "/list_models", {}))
            out.append(post(base + "/deregister_worker", {"worker_name": "http://b:2"}))
            out.append(post(base + "/deregister_worker", {"worker_name": "http://b:2"}))
            out.append(post(base + "/list_models", {}))
            try:
                post(base + "/nope", {})
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
        finally:
            server.shutdown()
            ctl.stop()
    return out


def test_controller_answers_as_jax_does():
    got, want = controller_script(controller), controller_script(jax_controller)
    assert got == want
    assert {"address": ""} in got and (404, {"error": "unknown route"}) in got


def registry_ops(mod) -> str:
    r = mod.Registry()
    c = r.counter("c_total", "a counter")
    g = r.gauge("g", "a gauge")
    h = r.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0))
    c.inc()
    c.inc(2.5, route='/v1/"chat"')
    g.set(3, stat="hits")
    g.dec(0.5)
    for v in (0.05, 0.5, 5.0):
        h.observe(v, kind="x")
    r.add_collect_hook(lambda: g.inc(1, stat="hook"))
    r.add_collect_hook(lambda: 1 / 0)
    return r.render()


def test_metrics_render_the_same_text():
    """The same operations on a registry of each package render the same
    exposition text, and the serving fleet's families have the same names,
    help and types (so /metrics scrapes are interchangeable)."""
    assert registry_ops(metrics) == registry_ops(jax_metrics)

    def schema(mod):
        return [m.header() for m in mod.REGISTRY._metrics.values()]

    assert schema(metrics) == schema(jax_metrics)
    assert metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS
    assert metrics.WORKER_DECODE_TOKEN.buckets == jax_metrics.WORKER_DECODE_TOKEN.buckets


def test_constants_and_profiling_match_jax(monkeypatch):
    for name in ("CONTROLLER_HEART_BEAT_EXPIRATION", "WORKER_HEART_BEAT_INTERVAL", "LOGDIR"):
        assert getattr(constants, name) == getattr(jax_constants, name), name
    samples = {"preprocess": [0.003, 0.001, 0.002], "prefill_ttft": [0.5],
               "decode_per_token": [0.01 * i for i in range(1, 41)]}
    ours, theirs = profiling.PhaseStats(), __import__(
        "tokenpacker_tpu.utils.profiling", fromlist=["PhaseStats"]).PhaseStats()
    for name, xs in samples.items():
        for x in xs:
            ours.record(name, x)
            theirs.record(name, x)
    assert ours.summary() == theirs.summary()
    ours.reset()
    assert ours.summary() == {}


def test_moderation_fails_open_and_logs_as_jax_does(monkeypatch, caplog):
    monkeypatch.delenv("MODERATION_URL", raising=False)
    assert logging_utils.violates_moderation("x") is jax_logging.violates_moderation("x") is False
    monkeypatch.setenv("MODERATION_URL", f"http://localhost:{free_port()}/m")
    monkeypatch.setenv("MODERATION_TIMEOUT", "1")
    with caplog.at_level("WARNING", logger="moderation"):
        assert logging_utils.violates_moderation("x") is False
    assert "failing open" in caplog.text
    assert logging_utils.MODERATION_MSG == jax_logging.MODERATION_MSG
    assert logging_utils.disable_torch_init() is None


# -- the web UI ----------------------------------------------------------------


def test_conversation_helpers_are_byte_equal():
    """`_resized_image` in every mode and the size clamp, `get_images` (PNG
    base64 and PIL), `to_gradio_chatbot` and `dict` give JAX's bytes."""
    rng = np.random.default_rng(3)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
              for w, h in ((200, 100), (90, 1000), (1200, 900), (64, 64))]
    for img in images:
        for mode in ("Pad", "Resize", "Crop", "Default"):
            a = conversation.conv_templates["vicuna_v1"]._resized_image(img, mode)
            b = jax_conversation.conv_templates["vicuna_v1"]._resized_image(img, mode)
            assert a.size == b.size and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError):
        conversation.conv_templates["vicuna_v1"]._resized_image(images[0], "Bogus")

    def build(mod):
        conv = mod.conv_templates["llava_v1"].copy()
        conv.append_message(conv.roles[0], ("<image>\nwhat is this", images[0], "Pad"))
        conv.append_message(conv.roles[1], "a picture")
        conv.append_message(conv.roles[0], ("and this?", images[1], "Default"))
        conv.append_message(conv.roles[1], None)
        return conv

    ours, theirs = build(conversation), build(jax_conversation)
    assert ours.get_images() == theirs.get_images()
    assert [i.tobytes() for i in ours.get_images(return_pil=True)] == [
        i.tobytes() for i in theirs.get_images(return_pil=True)]
    assert ours.to_gradio_chatbot() == theirs.to_gradio_chatbot()
    assert ours.dict() == theirs.dict()
    assert ours.get_prompt() == theirs.get_prompt()
    plain = conversation.conv_templates["llava_v1"].copy()
    plain.append_message(plain.roles[0], "hi")
    assert plain.dict() == jax_conversation.conv_templates["llava_v1"].copy().dict() | {
        "messages": [["USER", "hi"]]}


def test_image_process_modes_give_jax_png_bytes():
    conv = conversation.conv_templates["vicuna_v1"].copy()
    jconv = jax_conversation.conv_templates["vicuna_v1"].copy()
    for w, h in ((200, 100), (100, 900)):
        b64 = png_b64(w, h, 1)
        for mode in ("Pad", "Resize", "Crop", "Default"):
            assert (web_server._apply_process_mode(conv, b64, mode)
                    == jax_web._apply_process_mode(jconv, b64, mode))
    with pytest.raises(ValueError):
        web_server._apply_process_mode(conv, png_b64(20, 10, 2), "Bogus")


@pytest.fixture(scope="module")
def chains(workers):
    """A controller and a web server in front of each package's direct
    worker, the worker registered with its controller."""
    out, servers = {}, []
    for side, (mod_c, mod_w, mod_web, worker) in {
            "port": (controller, model_worker, web_server, workers["none"][0]),
            "jax": (jax_controller, jax_worker_mod, jax_web, workers["none"][1])}.items():
        ctl = mod_c.Controller("shortest_queue")
        cbase, cs = serve(mod_c.make_handler(ctl))
        wbase, ws = serve(mod_w.make_handler(worker))
        post(cbase + "/register_worker", {"worker_name": wbase, "check_heart_beat": False,
                                          "worker_status": {"model_names": [MODEL], "speed": 1,
                                                            "queue_length": 0}})
        webbase, webs = serve(mod_web.make_handler(cbase))
        servers += [cs, ws, webs]
        out[side] = SimpleNamespace(controller=cbase, worker=wbase, web=webbase, ctl=ctl)
    yield out
    for s in servers:
        s.shutdown()
    for side in out.values():
        side.ctl.stop()


def test_web_chat_turn_matches_jax(chains, tmp_path, monkeypatch):
    """A chat turn with an image in "Pad" mode through web server →
    controller → worker gives JAX's frames, and the turn and the image's
    md5 are logged under LOGDIR; the page and the model list answer."""
    logs = {}
    for side, mod in (("port", web_server), ("jax", jax_web)):
        monkeypatch.setattr(mod, "LOGDIR", str(tmp_path / side))
    body = {"model": MODEL, "history": [["user", "what is this"]], "image": IMAGE,
            "image_process_mode": "Pad", "temperature": 0.0, "max_new_tokens": 5}
    got, want = (frames(chains[s].web + "/chat", body) for s in ("port", "jax"))
    assert got == want and len(got) > 1 and "USER:" not in got[-1]["text"]
    for side in ("port", "jax"):
        logs[side] = sorted(p.name.split("-", 3)[-1] for p in (tmp_path / side).iterdir())
    assert logs["port"] == logs["jax"] == ["conv.json", "images.json"]
    code, page = get_text(chains["port"].web + "/")
    assert code == 200 and "<html" in page.lower()
    assert json.loads(get_text(chains["port"].web + "/list_models")[1]) == {"models": [MODEL]}


def test_controller_proxies_and_aggregates_as_jax_does(chains):
    """The controller as a worker (hierarchical deployments): its
    /worker_generate_stream proxies the chosen worker's stream, its
    /worker_get_status sums its workers' status, and /refresh_all_workers
    re-probes them, each as the JAX controller does over the JAX worker."""
    payload = dict(GREEDY, model=MODEL, logprobs=1)
    got, want = (frames(chains[s].controller + "/worker_generate_stream", payload)
                 for s in ("port", "jax"))
    assert_same_chunks(got, want)
    assert frames(chains["port"].controller + "/worker_generate_stream",
                  dict(payload, model="nope")) == [{"text": "", "error_code": 2}]
    status = [post(chains[s].controller + "/worker_get_status", {}) for s in ("port", "jax")]
    assert status[0] == status[1] == {"model_names": [MODEL], "speed": 1, "queue_length": 0}
    for side in ("port", "jax"):
        post(chains[side].controller + "/refresh_all_workers", {})
    assert (post(chains["port"].controller + "/list_models", {})
            == post(chains["jax"].controller + "/list_models", {}) == {"models": [MODEL]})


def test_web_server_forwards_what_jax_forwards(tmp_path, monkeypatch):
    """/chat sends the worker the payload the JAX web server sends: the
    rendered prompt, the template's stop, the sampling fields and the image
    after its process mode; "No available worker" without one."""
    seen = []

    class FakeWorker(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append(body)
            self.send_response(200)
            self.end_headers()
            self.wfile.write(json.dumps({"text": body["prompt"] + " ok", "error_code": 0})
                             .encode() + b"\0")

    wbase, ws = serve(FakeWorker)
    servers, out = [ws], {}
    try:
        for side, mod_c, mod_web in (("port", controller, web_server),
                                     ("jax", jax_controller, jax_web)):
            monkeypatch.setattr(mod_web, "LOGDIR", str(tmp_path / side))
            ctl = mod_c.Controller("shortest_queue")
            cbase, cs = serve(mod_c.make_handler(ctl))
            webbase, webs = serve(mod_web.make_handler(cbase))
            servers += [cs, webs]
            body = {"model": "fake-llava", "history": [["user", "what is this"]],
                    "image": png_b64(200, 100, 4), "image_process_mode": "Pad",
                    "temperature": 0.9, "top_p": 0.42, "max_new_tokens": 7}
            missing = frames(webbase + "/chat", body)
            post(cbase + "/register_worker", {"worker_name": wbase, "check_heart_beat": False,
                                              "worker_status": {"model_names": ["fake-llava"],
                                                                "speed": 1, "queue_length": 0}})
            out[side] = (missing, frames(webbase + "/chat", body), seen[-1])
            ctl.stop()
    finally:
        for s in servers:
            s.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][0] == [{"text": "No available worker", "error_code": 2}]
    assert out["port"][1] == [{"text": "ok"}] and out["port"][2]["top_p"] == 0.42


def test_web_moderation_hook(chains, monkeypatch, tmp_path):
    """MODERATION_URL gates user turns: a flagged message gets the
    moderation notice (error_code 3) and never reaches a worker."""
    seen = []

    class FakeModeration(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            text = json.loads(self.rfile.read(int(self.headers["Content-Length"])))["input"]
            seen.append(text)
            self.send_response(200)
            self.end_headers()
            self.wfile.write(json.dumps({"results": [{"flagged": "banned" in text}]}).encode())

    mbase, ms = serve(FakeModeration)
    monkeypatch.setenv("MODERATION_URL", mbase + "/moderations")
    monkeypatch.setattr(web_server, "LOGDIR", str(tmp_path))
    try:
        calls = metrics.WORKER_REQUESTS.value()
        body = {"model": MODEL, "history": [["user", "a banned request"]], "temperature": 0.0,
                "max_new_tokens": 3}
        assert frames(chains["port"].web + "/chat", body) == [
            {"text": logging_utils.MODERATION_MSG, "error_code": 3}]
        assert metrics.WORKER_REQUESTS.value() == calls
        out = frames(chains["port"].web + "/chat", dict(body, history=[["user", "what is this"]]))
        assert out and "MODERATION" not in out[-1]["text"]
        assert seen == ["a banned request", "what is this"]
    finally:
        ms.shutdown()


def test_test_message_and_register_worker_scripts(chains, capsys):
    """The copied clients: register_worker over the controller, and
    test_message listing the models and streaming one completion."""
    from tokenpacker_tpu_torch.serve import register_worker, test_message

    register_worker.main(["--controller-address", chains["port"].controller,
                          "--worker-name", chains["port"].worker])
    test_message.main(["--controller-address", chains["port"].controller, "--max-new-tokens",
                       "3", "--message", "what is this"])
    out = capsys.readouterr().out
    assert "registered" in out and f"Models: ['{MODEL}']" in out


def test_serving_modules_import_no_jax():
    code = ("import sys, tokenpacker_tpu_torch.serve.model_worker, "
            "tokenpacker_tpu_torch.serve.controller, tokenpacker_tpu_torch.serve.metrics, "
            "tokenpacker_tpu_torch.serve.openai_api, tokenpacker_tpu_torch.serve.web_server, "
            "tokenpacker_tpu_torch.serve.register_worker, "
            "tokenpacker_tpu_torch.serve.test_message, "
            "tokenpacker_tpu_torch.utils.logging_utils, tokenpacker_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tokenpacker_tpu', 'safetensors', 'transformers')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
