"""Manually register a model worker with the controller (reference
llava/serve/register_worker.py parity; a copy of
`tokenpacker_tpu/serve/register_worker.py`)."""

from __future__ import annotations

import argparse
import json
import urllib.request


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", required=True)
    parser.add_argument("--worker-name", required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args(argv)

    payload = {
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": None,
    }
    req = urllib.request.Request(
        args.controller_address + "/register_worker",
        json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.status == 200, resp.status
    print("registered")


if __name__ == "__main__":
    main()
