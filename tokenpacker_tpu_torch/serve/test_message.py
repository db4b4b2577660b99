"""Serving smoke-test client (reference llava/serve/test_message.py parity;
a copy of `tokenpacker_tpu/serve/test_message.py`): list models via the
controller, pick a worker, stream one completion."""

from __future__ import annotations

import argparse
import json
import urllib.request

from tokenpacker_tpu_torch.data.conversation import default_conversation


def post_json(url: str, payload: dict, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", default="http://localhost:21001")
    parser.add_argument("--worker-address", default=None)
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--message", default="Tell me a story with more than 1000 words.")
    args = parser.parse_args(argv)

    if args.worker_address:
        worker_addr = args.worker_address
        model_name = args.model_name
    else:
        ret = post_json(args.controller_address + "/refresh_all_workers", {})
        models = post_json(args.controller_address + "/list_models", {})["models"]
        print(f"Models: {models}")
        model_name = args.model_name or (models[0] if models else None)
        if model_name is None:
            print("No models available.")
            return
        worker_addr = post_json(
            args.controller_address + "/get_worker_address", {"model": model_name}
        )["address"]
        print(f"worker_addr: {worker_addr}")
    if worker_addr == "":
        return

    conv = default_conversation.copy()
    conv.append_message(conv.roles[0], args.message)
    prompt = conv.get_prompt()

    payload = {
        "model": model_name,
        "prompt": prompt,
        "temperature": 0.7,
        "max_new_tokens": args.max_new_tokens,
        "stop": conv.sep,
    }
    req = urllib.request.Request(
        worker_addr + "/worker_generate_stream",
        json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    print(prompt.replace(conv.sep, "\n"), end="")
    with urllib.request.urlopen(req, timeout=120) as resp:
        buf = b""
        while True:
            data = resp.read(1)
            if not data:
                break
            if data == b"\0":
                if buf:
                    chunk = json.loads(buf)
                    out = chunk["text"].split(conv.sep)[-1]
                    print(f"\r{out}", end="", flush=True)
                buf = b""
            else:
                buf += data
    print()


if __name__ == "__main__":
    main()
