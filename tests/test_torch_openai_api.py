"""The port's OpenAI-compatible gateway (`serve/openai_api`) against the
JAX package's, on the CPU.

The helpers (`render_chat_prompt` over every template, `_parse_content`,
`_data_url_to_b64`, `_normalize_stop`, `Gateway.stream_request`) give
JAX's results and raise JAX's errors for the cases of
`tests/test_openai_api.py`. Two three-tier chains run side by side, the
port's gateway → controller → worker and the JAX package's, over the same
tiny fp32 weights and word tokenizer (`tests/test_torch_serve.py`'s
workers, direct path): /v1/models, chat and legacy completions, streamed
and not, n=2 with a seed, penalties and logprobs give the same JSON apart
from `id` and `created`, logprob values within LP_TOL. The two faults of
the JAX gateway that the port fixes are shown beside JAX's output:
- R2: a stream whose last content chunk adds no text (a stop string cut
  it) drops that token's logprob entry in JAX; the port sends it on the
  closing chunk, so its stream carries the non-streamed entries;
- R3: JAX's legacy `text_offset` sums the token strings' lengths, which do
  not cut the completion text; the port's offsets are where each token's
  piece of the streamed text starts, and cut it into consecutive pieces.
"""

import base64
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from tokenpacker_tpu.serve import controller as jax_controller
from tokenpacker_tpu.serve import model_worker as jax_worker_mod
from tokenpacker_tpu.serve import openai_api as jax_api
from tokenpacker_tpu_torch.serve import controller, model_worker, openai_api
from test_torch_serve import LP_TOL, MODEL, model, post, serve, workers  # noqa: F401

TEMPLATE_MODELS = ("tokenpacker-7b", "llava-v1.5-7b", "llava-llama-2-13b-chat",
                   "LLaVA-Lightning-MPT-7B", "llava-7b-v0")
B64 = base64.b64encode(b"img").decode()


def outcome(fn, *args, **kw):
    """A call's result, or its APIError as (message, status, type, code)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001
        return ("raised", type(e).__name__, str(e), getattr(e, "status", None),
                getattr(e, "err_type", None), getattr(e, "code", None))


def same_outcomes(name, cases):
    for args in cases:
        got = outcome(getattr(openai_api, name), *args)
        want = outcome(getattr(jax_api, name), *args)
        assert got == want, (name, args)


def test_render_chat_prompt_matches_jax_for_every_template():
    image_turn = [{"type": "text", "text": "describe"},
                  {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{B64}"}}]
    histories = [
        [{"role": "user", "content": "hello there"}, {"role": "assistant", "content": "hi!"},
         {"role": "user", "content": "and now?"}],
        [{"role": "system", "content": "You are terse."}, {"role": "user", "content": image_turn}],
        [{"role": "user", "content": image_turn + image_turn[1:]}],
        # the error cases: no user turn, an unknown role, an image in an
        # assistant turn, an image in a system message
        [{"role": "assistant", "content": "hi"}],
        [{"role": "tool", "content": "x"}],
        [{"role": "user", "content": "q"}, {"role": "assistant", "content": image_turn[1:]}],
        [{"role": "system", "content": image_turn}, {"role": "user", "content": "q"}],
    ]
    same_outcomes("render_chat_prompt", [(m, h) for m in TEMPLATE_MODELS for h in histories])


def test_content_url_and_stop_helpers_match_jax():
    b64 = base64.b64encode(b"notanimage").decode()
    same_outcomes("_parse_content", [
        ("hello",), (None,), (42,), ([{"type": "video"}],), ([{"type": "image_url"}],),
        ([{"type": "text", "text": "what is"},
          {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}},
          {"type": "image_url", "image_url": b64}, {"type": "text", "text": "this"}],)])
    same_outcomes("_data_url_to_b64", [
        (f"data:image/jpeg;base64,{b64}",), (b64,), ("https://example.com/cat.png",),
        ("data:image/png,rawbytes",), ("!!! not base64 !!!",)])
    same_outcomes("_normalize_stop", [(None, "</s>"), ("END", "</s>"), (["a", "b", 3], None),
                                      (17, None), ([], "###")])


def test_stream_request_validation_matches_jax():
    msgs = [{"role": "user", "content": "q"}]
    bodies = [
        ({}, True), ({"model": "m"}, True), ({"model": "m"}, False),
        ({"model": "m", "prompt": ["one"], "max_tokens": 7, "stop": ["X"]}, False),
        ({"model": "m", "prompt": ["a", "b"]}, False),
        ({"model": "m", "prompt": "x", "max_tokens": 7, "max_completion_tokens": 3}, False),
        ({"model": "m", "prompt": "x", "top_k": 40, "min_p": 0.1, "seed": 5}, False),
        ({"model": "m", "prompt": "p", "n": 9}, False),
        ({"model": "m", "prompt": "p", "n": 2, "stream": True}, False),
        ({"model": "m", "messages": msgs, "logprobs": True, "top_logprobs": 25}, True),
        ({"model": "m", "messages": msgs, "logprobs": True, "top_logprobs": 3,
          "presence_penalty": 0.5, "repetition_penalty": 1.2}, True),
        ({"model": "m", "prompt": "x", "logprobs": 21}, False),
        ({"model": "m", "prompt": "x", "logprobs": 0, "stop": 17}, False),
    ]
    for body, chat in bodies:
        got = outcome(openai_api.Gateway("http://unused").stream_request, body, chat)
        want = outcome(jax_api.Gateway("http://unused").stream_request, body, chat)
        assert got == want, body


@pytest.fixture(scope="module")
def gateways(workers):
    """Each package's chain: gateway → controller → its direct worker."""
    out, servers = {}, []
    for side, (mod_c, mod_w, mod_api, worker) in {
            "port": (controller, model_worker, openai_api, workers["none"][0]),
            "jax": (jax_controller, jax_worker_mod, jax_api, workers["none"][1])}.items():
        ctl = mod_c.Controller("shortest_queue")
        cbase, cs = serve(mod_c.make_handler(ctl))
        wbase, ws = serve(mod_w.make_handler(worker))
        post(cbase + "/register_worker", {"worker_name": wbase, "check_heart_beat": False,
                                          "worker_status": {"model_names": [MODEL], "speed": 1,
                                                            "queue_length": 0}})
        gw = mod_api.Gateway(cbase)
        gbase, gs = serve(mod_api.make_handler(gw))
        servers += [cs, ws, gs]
        out[side] = SimpleNamespace(base=gbase, gateway=gw, ctl=ctl)
    yield out
    for s in servers:
        s.shutdown()
    for side in out.values():
        side.ctl.stop()


def request(base, route, body, headers=None):
    """(status, parsed body): the JSON object, or the SSE events (None for
    [DONE]) of a streamed answer."""
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(base + route, json.dumps(body).encode(), hdrs)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw, status = resp.read(), resp.status
            if resp.headers["Content-Type"] != "text/event-stream":
                return status, json.loads(raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    events = []
    for frame in raw.split(b"\n\n"):
        if frame:
            assert frame.startswith(b"data: ")
            payload = frame[len(b"data: "):]
            events.append(None if payload == b"[DONE]" else json.loads(payload))
    return status, events


def both(gateways, route, body, headers=None):
    return (request(gateways["port"].base, route, body, headers),
            request(gateways["jax"].base, route, body, headers))


def assert_close(got, want, path="", skip=("id", "created")):
    """The same JSON apart from `id` and `created` (and the keys in
    `skip`), floats within LP_TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) - set(skip) == set(want) - set(skip), path
        for k in want:
            if k not in skip:
                assert_close(got[k], want[k], f"{path}.{k}", skip)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]", skip)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= LP_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


CHAT = {"model": MODEL, "messages": [{"role": "user", "content": "what is this"}],
        "temperature": 0.0, "max_tokens": 5}
LEGACY = {"model": MODEL, "prompt": "a curious user", "temperature": 0.0, "max_tokens": 5}


def test_v1_models_matches_jax(gateways):
    got = urllib.request.urlopen(gateways["port"].base + "/v1/models", timeout=30).read()
    want = urllib.request.urlopen(gateways["jax"].base + "/v1/models", timeout=30).read()
    assert json.loads(got) == json.loads(want)
    assert [m["id"] for m in json.loads(got)["data"]] == [MODEL]


@pytest.mark.parametrize("route,body", [
    ("/v1/chat/completions", CHAT),
    ("/v1/chat/completions", dict(CHAT, stream=True, stream_options={"include_usage": True})),
    ("/v1/chat/completions", dict(CHAT, logprobs=True, top_logprobs=2)),
    ("/v1/chat/completions", dict(CHAT, logprobs=True, top_logprobs=2, stream=True)),
    ("/v1/chat/completions", dict(CHAT, n=2, seed=42)),
    ("/v1/chat/completions", dict(CHAT, presence_penalty=-1000.0, repetition_penalty=1.5)),
    ("/v1/completions", LEGACY),
    ("/v1/completions", dict(LEGACY, stream=True)),
    ("/v1/completions", dict(LEGACY, n=2, seed=42, frequency_penalty=0.5)),
], ids=["chat", "chat-stream", "chat-logprobs", "chat-logprobs-stream", "chat-n2-seed",
        "chat-penalties", "legacy", "legacy-stream", "legacy-n2-seed"])
def test_chain_matches_jax(gateways, route, body):
    """The same JSON (or SSE events) from both chains, apart from `id` and
    `created`; greedy requests, so the seed picks no draw."""
    (code, got), (jcode, want) = both(gateways, route, body)
    assert code == jcode == 200
    assert_close(got, want)
    obj = got[0] if isinstance(got, list) else got
    assert obj["id"].startswith("chatcmpl-" if "chat" in route else "cmpl-")


def test_legacy_logprobs_match_jax_but_their_offsets(gateways):
    """Legacy `logprobs: 2`: tokens, token_logprobs and top_logprobs equal
    JAX's (values within LP_TOL), streamed and not; `text_offset` is R3's
    fix (test_r3_offsets_cut_the_completion_text)."""
    for body in (dict(LEGACY, logprobs=2), dict(LEGACY, logprobs=2, stream=True)):
        (code, got), (_, want) = both(gateways, "/v1/completions", body)
        assert code == 200
        assert_close(got, want, skip=("id", "created", "text_offset"))


def test_errors_and_auth_match_jax(gateways):
    """An unknown model (404, model_not_found), a body that is not JSON
    (400), a validation error (400) and bearer auth (401 without the key,
    200 with it) as the JAX gateway answers them."""
    got, want = both(gateways, "/v1/chat/completions", dict(CHAT, model="nope"))
    assert got == want and got[0] == 404 and got[1]["error"]["code"] == "model_not_found"
    got, want = both(gateways, "/v1/completions", dict(LEGACY, n=9))
    assert got == want and got[0] == 400
    for side in ("port", "jax"):
        req = urllib.request.Request(gateways[side].base + "/v1/chat/completions", b"{not json",
                                     {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    for g in gateways.values():
        g.gateway.api_key = "sk-test"
    try:
        got, want = both(gateways, "/v1/completions", LEGACY)
        assert got == want and got[0] == 401
        assert got[1]["error"]["type"] == "authentication_error"
        (code, body), _ = both(gateways, "/v1/completions", LEGACY,
                               {"Authorization": "Bearer sk-test"})
        assert code == 200 and body["choices"][0]["finish_reason"] == "length"
        req = urllib.request.Request(gateways["port"].base + "/v1/models",
                                     headers={"Authorization": "Bearer wrong"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 401
        # the scrape endpoint needs no key
        text = urllib.request.urlopen(gateways["port"].base + "/metrics", timeout=30).read()
        assert b'tokenpacker_gateway_requests_total{route="/v1/completions"}' in text
    finally:
        for g in gateways.values():
            g.gateway.api_key = None


def test_sampled_n_choices_with_a_seed_replay(gateways):
    """n=3 sampled with a seed on the port's chain: three indexed choices
    (seed + i each, so distinct draws), usage summed, and the same texts on
    a second call. (JAX's draws come from another generator: no equality
    with JAX is possible here.)"""
    body = dict(LEGACY, temperature=1.5, max_tokens=6, n=3, seed=42, logprobs=0)
    code, first = request(gateways["port"].base, "/v1/completions", body)
    assert code == 200 and [c["index"] for c in first["choices"]] == [0, 1, 2]
    ids = [c["logprobs"]["token_logprobs"] for c in first["choices"]]
    assert len({tuple(x) for x in ids}) > 1
    assert first["usage"]["completion_tokens"] == sum(len(x) for x in ids)
    _, again = request(gateways["port"].base, "/v1/completions", body)
    assert [c["text"] for c in again["choices"]] == [c["text"] for c in first["choices"]]


def stop_case(gateways) -> dict:
    """A legacy request that stops on " <second word>": the token that
    completes the stop string cuts the text back, so its chunk adds no
    text."""
    _, plain = request(gateways["port"].base, "/v1/completions", LEGACY)
    second = plain["choices"][0]["text"].split(" ")[1]
    return dict(LEGACY, max_tokens=20, stop=" " + second, logprobs=1)


def streamed_entries(events) -> list:
    out = []
    for ev in events:
        if ev and ev["choices"] and ev["choices"][0].get("logprobs"):
            lp = ev["choices"][0]["logprobs"]
            out += list(zip(lp["tokens"], lp["token_logprobs"]))
    return out


def test_r2_streamed_logprobs_are_flushed_on_the_closing_chunk(gateways):
    """R2 side by side: JAX's stream drops the entry of the token whose
    chunk added no text, so it carries one entry fewer than its
    non-streamed answer; the port's stream carries all of them, on the
    closing chunk, equal to both non-streamed answers."""
    body = stop_case(gateways)
    (_, got_stream), (_, want_stream) = both(gateways, "/v1/completions", dict(body, stream=True))
    (_, got), (_, want) = both(gateways, "/v1/completions", body)
    full = list(zip(want["choices"][0]["logprobs"]["tokens"],
                    want["choices"][0]["logprobs"]["token_logprobs"]))
    assert want["choices"][0]["finish_reason"] == "stop" and len(full) == 2
    jax_streamed, port_streamed = streamed_entries(want_stream), streamed_entries(got_stream)
    assert jax_streamed == full[:-1]  # the fault: the last entry is lost
    assert [t for t, _ in port_streamed] == [t for t, _ in full]
    assert [t for t, _ in port_streamed] == got["choices"][0]["logprobs"]["tokens"]
    closing = [ev for ev in got_stream if ev and ev["choices"]][-1]["choices"][0]
    assert closing["finish_reason"] == "stop" and closing["logprobs"]["tokens"] == [full[-1][0]]


def test_r3_offsets_cut_the_completion_text(gateways):
    """R3 side by side: JAX's offsets (cumulative lengths of the token
    strings) do not cut the text into its tokens' pieces, since the word
    tokenizer's text puts a space between words that its token strings
    lack; the port's are where each piece starts: consecutive pieces that
    make up the text, each holding its token's word. Streamed, the port's
    offsets are those of the non-streamed answer."""
    body = dict(LEGACY, max_tokens=6, logprobs=1)
    (_, got), (_, want) = both(gateways, "/v1/completions", body)
    text = got["choices"][0]["text"]
    assert text == want["choices"][0]["text"]
    ours, theirs = got["choices"][0]["logprobs"], want["choices"][0]["logprobs"]
    assert ours["tokens"] == theirs["tokens"] and len(ours["tokens"]) == 6

    def pieces(offs):
        return [text[a:b] for a, b in zip(offs, offs[1:] + [len(text)])]

    assert "".join(pieces(ours["text_offset"])) == text
    assert [p.strip() for p in pieces(ours["text_offset"])] == ours["tokens"]
    assert theirs["text_offset"] == [sum(len(t) for t in theirs["tokens"][:i]) for i in range(6)]
    assert [p.strip() for p in pieces(theirs["text_offset"])] != theirs["tokens"]
    _, events = request(gateways["port"].base, "/v1/completions", dict(body, stream=True))
    streamed = [o for ev in events if ev and ev["choices"] and ev["choices"][0].get("logprobs")
                for o in ev["choices"][0]["logprobs"]["text_offset"]]
    assert streamed == ours["text_offset"]


def test_stream_error_midstream_stays_sse():
    """A failure after the SSE headers travels inside the open chunked
    body as an error event (the JAX gateway's handler behaviour)."""

    class FakeGateway:
        api_key = None

        def run(self, body, chat):
            yield {"object": "chat.completion.chunk",
                   "choices": [{"index": 0, "delta": {"content": "hi"}}]}
            raise openai_api.APIError("worker exploded mid-stream", 500, "server_error")

    base, server = serve(openai_api.make_handler(FakeGateway()))
    try:
        status, events = request(base, "/v1/chat/completions",
                                 {"model": "m", "messages": [], "stream": True})
    finally:
        server.shutdown()
    assert status == 200 and events[0]["choices"][0]["delta"]["content"] == "hi"
    assert events[-1]["error"]["type"] == "server_error"
