"""OpenAI-compatible API gateway over the controller/worker serving plane
(counterpart of `tokenpacker_tpu/serve/openai_api.py`; it runs no model).

Endpoints (stdlib ThreadingHTTPServer, same 3-tier architecture as the
web UI — gateway → controller `/get_worker_address` → worker
`/worker_generate_stream`):

  GET  /v1/models            — models registered with the controller
  POST /v1/chat/completions  — chat completions; `messages` with string or
                               multi-part content (`image_url` parts must be
                               data: URLs — this deployment has no egress),
                               `temperature`, `top_p`, `top_k` / `min_p`
                               (vLLM-style extensions), `presence_penalty`,
                               `frequency_penalty` (OpenAI fields, counted
                               over generated tokens — vLLM convention),
                               `repetition_penalty` (vLLM-style extension,
                               HF processor semantics), `logprobs` +
                               `top_logprobs` (per-token logprobs of the
                               model's raw next-token distribution),
                               `max_tokens`, `stop` (string or list),
                               `stream` (SSE), and
                               `stream_options.include_usage`
  POST /v1/completions       — legacy text completions (prompt verbatim,
                               no conversation template)

This surface is BEYOND the reference (llava/serve has gradio + CLI only);
it exists so OpenAI-SDK clients can point `base_url` at a TokenPacker
deployment unchanged. Conversation rendering reuses the exact template
auto-selection the reference's gradio server applies from the model name
(reference llava/serve/gradio_web_server.py:167-193 via cli.pick_conv_mode),
so a chat request produces byte-identical prompts to the web UI for the
same history. Usage accounting and finish_reason come from the worker's
terminal stream chunk (model_worker._final_chunk): prompt_tokens is the
POST-SPLICE length (visual tokens included — that is what occupies the
context window), completion_tokens the decoded count.

Optional bearer auth: set TOKENPACKER_API_KEY (or --api-key); requests must
then carry `Authorization: Bearer <key>`.

Two faults of the JAX gateway are fixed here:
- streamed logprobs: entries whose chunk added no text (a stop string cut
  it, say) were held back and dropped at the end of the stream; they now
  go out on the closing chunk, so a stream carries every entry that the
  non-streamed response holds;
- legacy `text_offset`: it summed the lengths of the token strings (the
  tokenizer's piece form, "▁word"), which do not cut the completion text;
  each offset is now where the token's piece of the streamed completion
  text starts (the text's length before the chunk that brought it), so
  the offsets cut the text into consecutive pieces. `bytes` stays the
  UTF-8 of each entry's `token` string.
"""

from __future__ import annotations

import argparse
import base64
import hmac
import itertools
import json
import os
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tokenpacker_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from tokenpacker_tpu_torch.data.conversation import SeparatorStyle, conv_templates
from tokenpacker_tpu_torch.serve import metrics as mtr
from tokenpacker_tpu_torch.serve.cli import pick_conv_mode
from tokenpacker_tpu_torch.utils.logging_utils import build_logger

logger = build_logger("openai_api", "openai_api.log")


class APIError(Exception):
    def __init__(self, message: str, status: int = 400,
                 err_type: str = "invalid_request_error", code: str | None = None):
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.code = code

    def body(self) -> dict:
        return {"error": {"message": str(self), "type": self.err_type,
                          "param": None, "code": self.code}}


def _post_json(url: str, payload: dict, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _data_url_to_b64(url: str) -> str:
    """Accept `data:image/...;base64,<payload>` (or a bare base64 string);
    reject remote URLs — the serving host has no egress by design."""
    if url.startswith("data:"):
        if ";base64," not in url:
            raise APIError("image_url data URLs must be base64-encoded")
        return url.split(";base64,", 1)[1]
    if url.startswith(("http://", "https://")):
        raise APIError(
            "remote image URLs are not fetched by this deployment; "
            "send a data:image/...;base64,... URL"
        )
    try:  # tolerate a bare base64 payload
        base64.b64decode(url, validate=True)
    except Exception:
        raise APIError("image_url must be a base64 data: URL") from None
    return url


def _parse_content(content) -> tuple[str, list[str]]:
    """OpenAI message content → (text, [image_b64, ...]).

    Content is either a plain string or a list of typed parts
    ({'type': 'text'|'image_url', ...})."""
    if content is None:
        return "", []
    if isinstance(content, str):
        return content, []
    if not isinstance(content, list):
        raise APIError("message content must be a string or a list of parts")
    texts, images = [], []
    for part in content:
        ptype = part.get("type") if isinstance(part, dict) else None
        if ptype == "text":
            texts.append(part.get("text", ""))
        elif ptype == "image_url":
            iu = part.get("image_url")
            url = iu.get("url") if isinstance(iu, dict) else iu
            if not isinstance(url, str):
                raise APIError("image_url part missing a url")
            images.append(_data_url_to_b64(url))
        else:
            raise APIError(f"unsupported content part type: {ptype!r}")
    return "\n".join(t for t in texts if t), images


def render_chat_prompt(model_name: str, messages: list) -> tuple[str, list[str], str]:
    """Render OpenAI `messages` through the model's conversation template.

    Returns (prompt, images_b64, template_stop). The newest system message
    overrides the template's system line; each image in a user turn
    contributes one `<image>\\n` prefix to that turn (the reference's
    convention for image placement — gradio_web_server/http_bot and
    cli.py both prepend the token to the first image turn)."""
    conv = conv_templates[pick_conv_mode(model_name)].copy()
    system = [m for m in messages if m.get("role") == "system"]
    if system:
        text, imgs = _parse_content(system[-1].get("content"))
        if imgs:
            raise APIError("system messages cannot contain images")
        conv.system = text
    role_map = {"user": conv.roles[0], "assistant": conv.roles[1]}
    images: list[str] = []
    n_user = 0
    for m in messages:
        role = m.get("role")
        if role == "system":
            continue
        if role not in role_map:
            raise APIError(f"unsupported message role: {role!r}")
        text, imgs = _parse_content(m.get("content"))
        if imgs:
            if role != "user":
                raise APIError("images are only supported in user messages")
            images.extend(imgs)
            text = (DEFAULT_IMAGE_TOKEN + "\n") * len(imgs) + text
        if role == "user":
            n_user += 1
        conv.append_message(role_map[role], text)
    if n_user == 0:
        raise APIError("messages must contain at least one user message")
    conv.append_message(conv.roles[1], None)
    stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
    return conv.get_prompt(), images, stop


def _normalize_stop(user_stop, template_stop: str | None) -> list[str]:
    stops = [template_stop] if template_stop else []
    if isinstance(user_stop, str):
        stops.append(user_stop)
    elif isinstance(user_stop, list):
        stops.extend(s for s in user_stop if isinstance(s, str))
    elif user_stop is not None:
        raise APIError("stop must be a string or a list of strings")
    return stops


def _fmt_chat_lp(e: dict) -> dict:
    """Worker logprob entry → OpenAI chat `logprobs.content` element
    ({token, logprob, bytes, top_logprobs}). Entries are raw-distribution
    logprobs (see generate.token_logprob_entry); token strings come from
    the worker's tokenizer piece form."""
    def one(tok, lp):
        return {"token": tok, "logprob": lp,
                "bytes": list(str(tok).encode("utf-8", "replace"))}

    out = one(e["token"], e["logprob"])
    out["top_logprobs"] = [one(t, lp) for _i, t, lp in e.get("top", [])]
    return out


def _fmt_legacy_lp(entries: list, offsets: list, text_len: int) -> dict:
    """Worker logprob entries → the legacy completions `logprobs` object
    (tokens / token_logprobs / top_logprobs / text_offset). `offsets`: where
    each token's piece of the completion text starts, the text's length
    before the chunk that brought the token (`_with_offsets`); they are
    kept in order and within the text's `text_len` characters (a stop
    string may cut the text back), so they cut the text into consecutive
    pieces."""
    offs, last = [], 0
    for o in offsets:
        last = min(max(o, last), text_len)
        offs.append(last)
    return {
        "tokens": [e["token"] for e in entries],
        "token_logprobs": [e["logprob"] for e in entries],
        "top_logprobs": [
            {t: lp for _i, t, lp in e["top"]} if "top" in e else None
            for e in entries
        ],
        "text_offset": offs,
    }


def _with_offsets(new_lp: list, text_before: str) -> list:
    """A chunk's new logprob entries, each with the offset in the
    completion text at which its token's piece starts: the length of the
    text the worker had streamed before this chunk."""
    return [(e, len(text_before)) for e in new_lp]


def _fmt_lp(pairs: list, chat: bool, text_len: int):
    """(entry, offset) pairs → a choice's OpenAI `logprobs` object."""
    if chat:
        return {"content": [_fmt_chat_lp(e) for e, _o in pairs]}
    return _fmt_legacy_lp([e for e, _o in pairs], [o for _e, o in pairs], text_len)


def _iter_worker_chunks(worker_addr: str, payload: dict, timeout: float = 300.0):
    """Yield parsed JSON chunks from the worker's \\0-framed stream."""
    req = urllib.request.Request(
        worker_addr + "/worker_generate_stream",
        json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        buf = b""
        while True:
            data = resp.read(1)
            if not data:
                break
            if data == b"\0":
                yield json.loads(buf)
                buf = b""
            else:
                buf += data


class Gateway:
    """Controller-facing logic, separated from the HTTP handler for tests."""

    def __init__(self, controller_addr: str, api_key: str | None = None):
        self.controller_addr = controller_addr
        self.api_key = api_key

    def list_models(self) -> list[str]:
        return _post_json(self.controller_addr + "/list_models", {}).get("models", [])

    def worker_for(self, model: str) -> str:
        addr = _post_json(
            self.controller_addr + "/get_worker_address", {"model": model}
        ).get("address", "")
        if not addr:
            raise APIError(
                f"model {model!r} has no available worker", status=404,
                err_type="invalid_request_error", code="model_not_found",
            )
        return addr

    # -- request handling ---------------------------------------------------

    def stream_request(self, body: dict, chat: bool):
        """Returns (payload dict for the worker, request metadata)."""
        model = body.get("model")
        if not model or not isinstance(model, str):
            raise APIError("missing required parameter: 'model'")
        n = int(body.get("n", 1))
        if not 1 <= n <= 8:
            raise APIError("n must be in [1, 8]")
        if n > 1 and bool(body.get("stream", False)):
            raise APIError("n > 1 is not supported with stream=true")
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise APIError("missing required parameter: 'messages'")
            prompt, images, template_stop = render_chat_prompt(model, messages)
        else:
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                if len(prompt) != 1 or not isinstance(prompt[0], str):
                    raise APIError("prompt must be a string (or a 1-element list)")
                prompt = prompt[0]
            if not isinstance(prompt, str):
                raise APIError("missing required parameter: 'prompt'")
            images, template_stop = [], None
        max_tokens = body.get("max_completion_tokens", body.get("max_tokens", 256))
        payload = {
            "model": model,
            "prompt": prompt,
            "images": images or None,
            "temperature": float(body.get("temperature", 1.0)),
            "top_p": float(body.get("top_p", 1.0)),
            # vLLM-style extension fields (not in the OpenAI schema); the
            # worker treats 0/absent as unfiltered
            "top_k": int(body.get("top_k", 0)),
            "min_p": float(body.get("min_p", 0.0)),
            # OpenAI penalty fields (generated-token counts, vLLM
            # convention) + vLLM-style repetition_penalty extension
            # (HF processor semantics — prompt counts too)
            "presence_penalty": float(body.get("presence_penalty", 0.0)),
            "frequency_penalty": float(body.get("frequency_penalty", 0.0)),
            "repetition_penalty": float(body.get("repetition_penalty", 1.0)),
            "max_new_tokens": int(max_tokens),
            "stop": _normalize_stop(body.get("stop"), template_stop),
        }
        # deterministic sampling (OpenAI `seed`); with n > 1 the worker
        # seed is offset per choice (seed+i) so seeded multi-choice
        # requests still return distinct samples
        if body.get("seed") is not None:
            payload["seed"] = int(body["seed"])
        # per-token logprobs: chat uses `logprobs: true` + `top_logprobs: N`
        # (0-20); legacy completions use `logprobs: N`. The worker payload
        # carries one int: top-alternative count (0 = chosen token only).
        if chat:
            if body.get("logprobs"):
                n_top = int(body.get("top_logprobs") or 0)
                if not 0 <= n_top <= 20:
                    raise APIError("top_logprobs must be in [0, 20]")
                payload["logprobs"] = n_top
        elif body.get("logprobs") is not None:
            n_top = int(body["logprobs"])
            if not 0 <= n_top <= 20:
                raise APIError("logprobs must be in [0, 20]")
            payload["logprobs"] = n_top
        return payload

    def _multi_choice(self, payload, addr, chat, n, rid, created,
                      object_name):
        """n parallel worker requests for one completion call — the
        worker's continuous batcher co-schedules them into shared decode
        steps, so n choices cost ~one decode stream of wall clock, not n
        (the reference serves strictly one generate per request). Seeded
        requests offset the seed per choice (seed+i) so they still return
        distinct samples; usage counts the prompt once and sums completion
        tokens (OpenAI accounting)."""
        from concurrent.futures import ThreadPoolExecutor

        want_lp = "logprobs" in payload
        prompt = payload["prompt"]

        def one(i):
            p = dict(payload)
            if "seed" in p:
                p["seed"] = p["seed"] + i
            text, finish, usage, lp = "", "stop", None, []
            for chunk in _iter_worker_chunks(addr, p):
                if chunk.get("error_code", 0) != 0:
                    raise APIError(chunk.get("text", "worker error"),
                                   status=500, err_type="server_error")
                t = chunk.get("text", "")
                if t.startswith(prompt):
                    t = t[len(prompt):]
                if want_lp:
                    lp.extend(_with_offsets(chunk.get("logprobs") or [], text))
                if "finish_reason" in chunk:
                    finish = chunk["finish_reason"]
                    usage = chunk.get("usage")
                text = t
            return text, finish, usage, lp

        with ThreadPoolExecutor(n) as ex:
            results = list(ex.map(one, range(n)))
        choices, usage_sum = [], None
        for i, (text, finish, usage, lp) in enumerate(results):
            if chat:
                c = {"index": i,
                     "message": {"role": "assistant", "content": text},
                     "finish_reason": finish}
            else:
                c = {"index": i, "text": text, "finish_reason": finish}
            if want_lp:
                c["logprobs"] = _fmt_lp(lp, chat, len(text))
            choices.append(c)
            if usage:
                if usage_sum is None:
                    usage_sum = dict(usage)
                else:
                    usage_sum["completion_tokens"] += usage["completion_tokens"]
                    usage_sum["total_tokens"] += usage["completion_tokens"]
        out = {"id": rid, "object": object_name, "created": created,
               "model": payload["model"], "choices": choices}
        if usage_sum is not None:
            out["usage"] = usage_sum
        return out

    def run(self, body: dict, chat: bool):
        """Execute a (chat) completion. Yields OpenAI response events:
        for stream=False a single final object; for stream=True a sequence
        of chunk objects followed by None (the [DONE] marker)."""
        payload = self.stream_request(body, chat)
        addr = self.worker_for(payload["model"])
        stream = bool(body.get("stream", False))
        include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        created = int(time.time())
        object_name = "chat.completion" if chat else "text_completion"
        prompt = payload["prompt"]

        n = int(body.get("n", 1))
        if n > 1:  # stream_request validated stream=False for n > 1
            yield self._multi_choice(payload, addr, chat, n, rid, created,
                                     object_name)
            return

        prev = ""
        final_text, finish, usage = "", "stop", None
        first_delta = True
        want_lp = "logprobs" in payload
        lp_all: list = []  # every worker entry with its offset (non-stream assembly)
        lp_pending: list = []  # entries not yet attached to a stream chunk
        for chunk in _iter_worker_chunks(addr, payload):
            if chunk.get("error_code", 0) != 0:
                raise APIError(chunk.get("text", "worker error"), status=500,
                               err_type="server_error")
            if want_lp:
                new_lp = _with_offsets(chunk.get("logprobs") or [], final_text)
                lp_all.extend(new_lp)
                lp_pending.extend(new_lp)
            text = chunk.get("text", "")
            if text.startswith(prompt):
                text = text[len(prompt):]
            if "finish_reason" in chunk:
                finish = chunk["finish_reason"]
                usage = chunk.get("usage")
                final_text = text
                continue
            final_text = text
            if not stream:
                continue
            delta = text[len(prev):] if text.startswith(prev) else ""
            prev = text
            if not delta and not first_delta:
                continue
            if chat:
                d = {"content": delta}
                if first_delta:
                    d["role"] = "assistant"
                choice = {"index": 0, "delta": d, "finish_reason": None}
            else:
                choice = {"index": 0, "text": delta, "finish_reason": None}
            if want_lp:
                choice["logprobs"] = _fmt_lp(lp_pending, chat, len(text))
                lp_pending = []
            first_delta = False
            yield {
                "id": rid, "created": created, "model": payload["model"],
                "object": "chat.completion.chunk" if chat else "text_completion",
                "choices": [choice],
            }
        if stream:
            done_choice = (
                {"index": 0, "delta": {}, "finish_reason": finish}
                if chat else {"index": 0, "text": "", "finish_reason": finish}
            )
            if want_lp and lp_pending:
                # entries whose chunks added no text (a stop string cut it)
                # close the stream instead of being dropped
                done_choice["logprobs"] = _fmt_lp(lp_pending, chat, len(final_text))
            yield {
                "id": rid, "created": created, "model": payload["model"],
                "object": "chat.completion.chunk" if chat else "text_completion",
                "choices": [done_choice],
            }
            if include_usage and usage is not None:
                yield {
                    "id": rid, "created": created, "model": payload["model"],
                    "object": "chat.completion.chunk" if chat else "text_completion",
                    "choices": [], "usage": usage,
                }
            yield None
            return
        if chat:
            choice = {
                "index": 0,
                "message": {"role": "assistant", "content": final_text},
                "finish_reason": finish,
            }
        else:
            choice = {"index": 0, "text": final_text, "finish_reason": finish}
        if want_lp:
            choice["logprobs"] = _fmt_lp(lp_all, chat, len(final_text))
        out = {
            "id": rid, "object": object_name, "created": created,
            "model": payload["model"], "choices": [choice],
        }
        if usage is not None:
            out["usage"] = usage
        yield out


def make_handler(gateway: Gateway):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send_json(self, obj: dict, status: int = 200):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _auth_ok(self) -> bool:
            if not gateway.api_key:
                return True
            header = self.headers.get("Authorization", "")
            # constant-time compare: plain == leaks key bytes through
            # response timing on an exposed gateway
            return hmac.compare_digest(header, f"Bearer {gateway.api_key}")

        def do_GET(self):
            if self.path.rstrip("/") == "/metrics":
                # scrape endpoint (no bearer auth, like a health check —
                # Prometheus scrapers don't carry the OpenAI key)
                return mtr.send_metrics_response(self)
            if not self._auth_ok():
                return self._send_json(APIError(
                    "invalid API key", 401, "authentication_error").body(), 401)
            if self.path.rstrip("/") == "/v1/models":
                try:
                    models = gateway.list_models()
                except Exception as e:
                    return self._send_json(APIError(
                        f"controller unavailable: {e}", 502,
                        "server_error").body(), 502)
                return self._send_json({
                    "object": "list",
                    "data": [
                        {"id": m, "object": "model", "created": 0,
                         "owned_by": "tokenpacker-tpu"}
                        for m in models
                    ],
                })
            self._send_json(APIError("not found", 404).body(), 404)

        def do_POST(self):
            if not self._auth_ok():
                return self._send_json(APIError(
                    "invalid API key", 401, "authentication_error").body(), 401)
            route = self.path.rstrip("/")
            if route not in ("/v1/chat/completions", "/v1/completions"):
                return self._send_json(APIError("not found", 404).body(), 404)
            mtr.GATEWAY_REQUESTS.inc(route=route)
            chat = route == "/v1/chat/completions"
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except Exception:
                return self._send_json(
                    APIError("request body is not valid JSON").body(), 400)
            streaming = False  # True once SSE headers are on the wire

            def _sse(payload: bytes):
                self.wfile.write(f"{len(payload):x}\r\n".encode())
                self.wfile.write(payload + b"\r\n")
                self.wfile.flush()

            def _stream_error(body: dict):
                """Mid-stream failure: the status line is long gone, so the
                error must travel INSIDE the open chunked body as an SSE
                event (OpenAI's convention), followed by the chunked
                terminator; the connection is closed rather than poisoned
                with a raw 'HTTP/1.1 500' inside the body."""
                try:
                    _sse(b"data: " + json.dumps(body).encode() + b"\n\n")
                    _sse(b"")  # chunked terminator — framing stays valid
                except Exception:
                    pass  # client already gone
                self.close_connection = True

            try:
                events = gateway.run(body, chat)
                if not bool(body.get("stream", False)):
                    return self._send_json(next(events))
                # prime before sending SSE headers so validation/dispatch
                # errors still go out as JSON with a proper status
                first_ev = next(events)
                # SSE stream; chunked so the client sees tokens as they land
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                streaming = True

                for ev in itertools.chain([first_ev], events):
                    if ev is None:
                        _sse(b"data: [DONE]\n\n")
                    else:
                        _sse(b"data: " + json.dumps(ev).encode() + b"\n\n")
                _sse(b"")  # chunked terminator
            except APIError as e:
                logger.error(f"API error: {e}")
                if streaming:
                    _stream_error(e.body())
                else:
                    self._send_json(e.body(), e.status)
            except Exception as e:
                logger.error(f"gateway error: {e}")
                err = APIError(f"internal error: {e}", 500, "server_error")
                if streaming:
                    _stream_error(err.body())
                else:
                    try:
                        self._send_json(err.body(), 500)
                    except Exception:
                        pass  # client already gone

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--controller-address", default="http://localhost:21001")
    parser.add_argument("--api-key", default=os.environ.get("TOKENPACKER_API_KEY"))
    args = parser.parse_args(argv)
    gateway = Gateway(args.controller_address, api_key=args.api_key)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(gateway))
    logger.info(f"OpenAI-compatible gateway on http://{args.host}:{args.port}/v1")
    server.serve_forever()


if __name__ == "__main__":
    main()
