"""Serving controller — worker registry + dispatch + heartbeat expiry (a copy
of `tokenpacker_tpu/serve/controller.py`; it runs no model).

Parity surface of reference llava/serve/controller.py: REST endpoints
/register_worker /refresh_all_workers /list_models /get_worker_address
/receive_heart_beat /worker_generate_stream /worker_get_status, LOTTERY
(speed-weighted random) and SHORTEST_QUEUE dispatch (controller.py:120-171),
30 s heartbeat expiration (constants.py:1, controller.py:183-191), and
controller-as-worker proxying for hierarchical deployments.

Implementation: stdlib ThreadingHTTPServer (fastapi/uvicorn are not in the
image); the wire format (JSON bodies, '\\0'-delimited streaming chunks) is
unchanged, so reference clients interoperate.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
import urllib.request
from enum import Enum, auto
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tokenpacker_tpu_torch.constants import CONTROLLER_HEART_BEAT_EXPIRATION
from tokenpacker_tpu_torch.serve import metrics as mtr
from tokenpacker_tpu_torch.utils.logging_utils import build_logger

logger = build_logger("controller", "controller.log")


class DispatchMethod(Enum):
    LOTTERY = auto()
    SHORTEST_QUEUE = auto()

    @classmethod
    def from_str(cls, name: str) -> "DispatchMethod":
        if name == "lottery":
            return cls.LOTTERY
        if name == "shortest_queue":
            return cls.SHORTEST_QUEUE
        raise ValueError(f"Invalid dispatch method: {name}")


@dataclasses.dataclass
class WorkerInfo:
    model_names: list
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


def _post_json(url: str, payload: dict, timeout: float = 5.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.worker_info: dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self.heart_beat_thread = threading.Thread(target=self._expiry_loop, daemon=True)
        self.heart_beat_thread.start()

    # -- registry ----------------------------------------------------------

    def register_worker(
        self, worker_name: str, check_heart_beat: bool, worker_status: dict | None
    ) -> bool:
        if worker_status is None:
            worker_status = self._probe_worker_status(worker_name)
        if worker_status is None:
            return False
        with self.lock:
            self.worker_info[worker_name] = WorkerInfo(
                worker_status["model_names"],
                worker_status["speed"],
                worker_status["queue_length"],
                check_heart_beat,
                time.time(),
            )
        logger.info(f"Register done: {worker_name}, {worker_status}")
        return True

    def _probe_worker_status(self, worker_name: str) -> dict | None:
        try:
            return _post_json(worker_name + "/worker_get_status", {})
        except Exception as e:
            logger.error(f"Get status fails: {worker_name}, {e}")
            return None

    def refresh_all_workers(self):
        with self.lock:
            old = dict(self.worker_info)
            self.worker_info = {}
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                logger.info(f"Remove stale worker: {name}")

    def list_models(self) -> list:
        names = set()
        with self.lock:
            for info in self.worker_info.values():
                names.update(info.model_names)
        return sorted(names)

    def deregister_worker(self, worker_name: str) -> bool:
        """Graceful-drain path (beyond the reference, whose workers only
        drop off via 30 s heartbeat expiry): a worker announcing shutdown
        is removed immediately so no new requests are dispatched to it."""
        with self.lock:
            existed = self.worker_info.pop(worker_name, None) is not None
        if existed:
            logger.info(f"Deregistered worker: {worker_name}")
        return existed

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self.lock:
            info = self.worker_info.get(worker_name)
            if info is None:
                logger.info(f"Receive unknown heart beat. {worker_name}")
                return False
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
        mtr.CONTROLLER_HEARTBEATS.inc()
        return True

    def _expiry_loop(self):
        while not self._stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION):
            self.remove_stale_workers_by_expiration()

    def remove_stale_workers_by_expiration(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        to_delete = []
        with self.lock:
            for name, info in self.worker_info.items():
                if info.check_heart_beat and info.last_heart_beat < expire:
                    to_delete.append(name)
            for name in to_delete:
                del self.worker_info[name]
        if to_delete:
            mtr.CONTROLLER_EXPIRED.inc(len(to_delete))
        for name in to_delete:
            logger.info(f"Remove stale worker: {name}")

    # -- dispatch ----------------------------------------------------------

    def get_worker_address(self, model_name: str) -> str:
        mtr.CONTROLLER_DISPATCHES.inc(model=model_name)
        if self.dispatch_method == DispatchMethod.LOTTERY:
            with self.lock:
                names, speeds = [], []
                for name, info in self.worker_info.items():
                    if model_name in info.model_names:
                        names.append(name)
                        speeds.append(info.speed)
            if not names:
                return ""
            speeds = np.asarray(speeds, dtype=np.float64)
            pt = np.random.choice(len(names), p=speeds / speeds.sum())
            return names[pt]

        # SHORTEST_QUEUE: normalize queue length by speed
        with self.lock:
            names, qps = [], []
            for name, info in self.worker_info.items():
                if model_name in info.model_names:
                    names.append(name)
                    qps.append(info.queue_length / info.speed)
        if not names:
            return ""
        idx = int(np.argmin(qps))
        with self.lock:
            if names[idx] in self.worker_info:
                self.worker_info[names[idx]].queue_length += 1
        logger.info(f"names: {names}, queue_lens: {qps}, ret: {names[idx]}")
        return names[idx]

    def worker_api_get_status(self) -> dict:
        """Aggregate status so a controller can act as a worker
        (hierarchical deployments, reference controller.py:193-236)."""
        model_names: set = set()
        speed = 0
        queue_length = 0
        with self.lock:
            workers = list(self.worker_info.items())
        for name, _ in workers:
            status = self._probe_worker_status(name)
            if status is not None:
                model_names.update(status["model_names"])
                speed += status["speed"]
                queue_length += status["queue_length"]
        return {
            "model_names": sorted(model_names),
            "speed": speed,
            "queue_length": queue_length,
        }

    def stop(self):
        self._stop.set()


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _send_json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.rstrip("/") == "/metrics":
                with controller.lock:
                    mtr.CONTROLLER_WORKERS.set(len(controller.worker_info))
                mtr.send_metrics_response(self)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            body = self._read_json()
            route = self.path.rstrip("/")
            if route == "/register_worker":
                ok = controller.register_worker(
                    body["worker_name"], body["check_heart_beat"], body.get("worker_status")
                )
                self._send_json({}, 200 if ok else 400)
            elif route == "/refresh_all_workers":
                controller.refresh_all_workers()
                self._send_json({})
            elif route == "/list_models":
                self._send_json({"models": controller.list_models()})
            elif route == "/get_worker_address":
                self._send_json({"address": controller.get_worker_address(body["model"])})
            elif route == "/deregister_worker":
                existed = controller.deregister_worker(body["worker_name"])
                self._send_json({"existed": existed})
            elif route == "/receive_heart_beat":
                exist = controller.receive_heart_beat(body["worker_name"], body["queue_length"])
                self._send_json({"exist": exist})
            elif route == "/worker_get_status":
                self._send_json(controller.worker_api_get_status())
            elif route == "/worker_generate_stream":
                # proxy-stream from the chosen worker
                addr = controller.get_worker_address(body.get("model", ""))
                if not addr:
                    chunk = json.dumps(
                        {"text": "", "error_code": 2}
                    ).encode() + b"\0"
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.end_headers()
                    self.wfile.write(chunk)
                    return
                req = urllib.request.Request(
                    addr + "/worker_generate_stream",
                    json.dumps(body).encode(),
                    {"Content-Type": "application/json"},
                )
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                try:
                    with urllib.request.urlopen(req, timeout=100) as resp:
                        while True:
                            data = resp.read(4096)
                            if not data:
                                break
                            self.wfile.write(data)
                            self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client gone: dropping the upstream connection
                    # propagates the disconnect to the worker, which
                    # cancels the slot
            else:
                self._send_json({"error": "unknown route"}, 404)

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument(
        "--dispatch-method", choices=["lottery", "shortest_queue"], default="shortest_queue"
    )
    args = parser.parse_args(argv)
    controller = Controller(args.dispatch_method)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(controller))
    logger.info(f"controller listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
