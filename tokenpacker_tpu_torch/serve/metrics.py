"""Prometheus-style serving metrics (stdlib-only text exposition; a copy of
`tokenpacker_tpu/serve/metrics.py`: the same families and names, so scrapes
of either package's processes are interchangeable).

The reference has NO metrics surface (SURVEY.md §5: the only liveness
number is queue_length inside heartbeat payloads, model_worker.py:108-120).
Here every serving process exposes `GET /metrics` in the Prometheus text
exposition format (v0.0.4) so a standard Prometheus/Grafana stack can
scrape the fleet:

- worker:     request/error/token counters, queue-length gauge, TTFT and
              per-token decode-latency histograms, prefix-cache hit/miss
              counters when the paged batcher runs with caching on
- controller: registered-worker gauge, dispatch/heartbeat/expiry counters

Implementation notes: counters/gauges/histograms are thread-safe and
support optional labels; a `Registry` renders them all. There is one
module-level `REGISTRY` (like prometheus_client's default) — handlers
pull from it, and tests may call `REGISTRY.reset()` between cases.
"""

from __future__ import annotations

import math
import threading


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n"))
        for k, v in labels
    )
    return "{" + body + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()

    def _labelset(self, labels: dict) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def header(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._labelset(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._labelset(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = self.header()
        if not items:
            items = [((), 0.0)]
        out += [f"{self.name}{_fmt_labels(ls)} {_fmt_value(v)}" for ls, v in items]
        return out

    def reset(self):
        with self._lock:
            self._values.clear()


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels):
        with self._lock:
            self._values[self._labelset(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = self._labelset(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._labelset(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = self.header()
        if not items:
            items = [((), 0.0)]
        out += [f"{self.name}{_fmt_labels(ls)} {_fmt_value(v)}" for ls, v in items]
        return out

    def reset(self):
        with self._lock:
            self._values.clear()


# Default latency buckets: 5 ms .. 10 s — from a decode step to a cold HD
# prefill (seconds).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per-labelset: (bucket counts list, sum, count)
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels):
        key = self._labelset(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * len(self.buckets), 0.0, 0]
                self._series[key] = s
            counts, _, _ = s
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            s[1] += value
            s[2] += 1

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(self._labelset(labels))
            return 0 if s is None else s[2]

    def render(self) -> list[str]:
        with self._lock:
            items = sorted((k, (list(v[0]), v[1], v[2])) for k, v in self._series.items())
        out = self.header()
        if not items:
            items = [((), ([0] * len(self.buckets), 0.0, 0))]
        for ls, (counts, total, n) in items:
            for b, c in zip(self.buckets, counts):
                bls = ls + (("le", _fmt_value(b)),)
                out.append(f"{self.name}_bucket{_fmt_labels(bls)} {c}")
            inf_ls = ls + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(inf_ls)} {n}")
            out.append(f"{self.name}_sum{_fmt_labels(ls)} {_fmt_value(total)}")
            out.append(f"{self.name}_count{_fmt_labels(ls)} {n}")
        return out

    def reset(self):
        with self._lock:
            self._series.clear()


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        # hooks run just before render — used to refresh point-in-time
        # gauges (queue depth, live batcher slots, prefix-cache stats)
        self._collect_hooks: list = []

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_text: str) -> Counter:
        return self._register(Counter(name, help_text))

    def gauge(self, name: str, help_text: str) -> Gauge:
        return self._register(Gauge(name, help_text))

    def histogram(self, name: str, help_text: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_text, buckets))

    def add_collect_hook(self, fn):
        with self._lock:
            self._collect_hooks.append(fn)

    def render(self) -> str:
        with self._lock:
            hooks = list(self._collect_hooks)
            metrics = list(self._metrics.values())
        for fn in hooks:
            try:
                fn()
            except Exception:
                pass  # a broken gauge refresher must not take down /metrics
        lines: list[str] = []
        for m in metrics:
            lines += m.render()
        return "\n".join(lines) + "\n"

    def reset(self):
        """Zero every series (metric objects stay registered) and drop
        collect hooks — for test isolation."""
        with self._lock:
            metrics = list(self._metrics.values())
            self._collect_hooks.clear()
        for m in metrics:
            m.reset()


REGISTRY = Registry()

# ---------------------------------------------------------------------------
# The serving fleet's metric set. Declared eagerly so /metrics shows the
# full schema (with zero values) from the first scrape.
# ---------------------------------------------------------------------------

WORKER_REQUESTS = REGISTRY.counter(
    "tokenpacker_worker_requests_total", "Generation requests accepted by this worker"
)
WORKER_ERRORS = REGISTRY.counter(
    "tokenpacker_worker_errors_total", "Generation requests that ended in an error chunk"
)
WORKER_PROMPT_TOKENS = REGISTRY.counter(
    "tokenpacker_worker_prompt_tokens_total",
    "Prompt tokens processed (after image-token splicing)",
)
WORKER_GENERATED_TOKENS = REGISTRY.counter(
    "tokenpacker_worker_generated_tokens_total", "Completion tokens generated"
)
WORKER_QUEUE = REGISTRY.gauge(
    "tokenpacker_worker_queue_length", "In-flight generation requests"
)
WORKER_TTFT = REGISTRY.histogram(
    "tokenpacker_worker_ttft_seconds", "Time from request start to first token"
)
WORKER_DECODE_TOKEN = REGISTRY.histogram(
    "tokenpacker_worker_decode_token_seconds",
    "Per-token decode latency after the first token",
    buckets=(0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0),
)
WORKER_PREPROCESS = REGISTRY.histogram(
    "tokenpacker_worker_preprocess_seconds",
    "Host-side request preprocessing (decode images, tokenize, splice plan)",
)
# Prefix-cache stats are owned by serve/prefix_cache.py (cumulative ints);
# they surface here as gauges refreshed by a collect hook the worker
# installs, keeping the cache itself metrics-agnostic.
WORKER_PREFIX = REGISTRY.gauge(
    "tokenpacker_worker_prefix_cache",
    "Prefix-cache stats (label stat: cache_blocks|cache_hits|cache_misses|"
    "tokens_reused|vision_encodes_skipped)",
)

GATEWAY_REQUESTS = REGISTRY.counter(
    "tokenpacker_gateway_requests_total",
    "OpenAI-compatible API requests (label route)",
)

CONTROLLER_WORKERS = REGISTRY.gauge(
    "tokenpacker_controller_workers", "Workers currently registered"
)
CONTROLLER_DISPATCHES = REGISTRY.counter(
    "tokenpacker_controller_dispatches_total", "Worker-address dispatch decisions"
)
CONTROLLER_HEARTBEATS = REGISTRY.counter(
    "tokenpacker_controller_heartbeats_total", "Heartbeats received from workers"
)
CONTROLLER_EXPIRED = REGISTRY.counter(
    "tokenpacker_controller_expired_workers_total",
    "Workers removed after missing the heartbeat window",
)


def send_metrics_response(handler):
    """Serve the registry over an http.server BaseHTTPRequestHandler."""
    data = REGISTRY.render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)
