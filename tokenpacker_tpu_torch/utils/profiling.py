"""Phase timers and tracing (counterpart of `tokenpacker_tpu/utils/profiling.py`).

- `phase(name)`: a context manager timing a pipeline phase (preprocess,
  prefill, decode), aggregated into `PhaseStats`; `GLOBAL_STATS` is the
  process's instance, whose `summary()` the model worker reports as
  `phase_timings` (the same keys as the JAX package's);
- `trace(log_dir)`: `torch.profiler` over the CPU and the card, written as
  a Chrome trace into `log_dir`;
- `annotate(name)`: `torch.profiler.record_function`, a labelled range on
  the trace's timeline.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict

import torch


class PhaseStats:
    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: torch.Tensor | None = None):
        """Times a host-side phase; pass a tensor as `block_on` to include
        the completion of its device's queued work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            self.samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.samples[name].append(seconds)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "mean_ms": 1e3 * statistics.fmean(xs),
                "p50_ms": 1e3 * xs_sorted[len(xs) // 2],
                "p95_ms": 1e3 * xs_sorted[min(len(xs) - 1, int(len(xs) * 0.95))],
                "total_s": sum(xs),
            }
        return out

    def reset(self):
        self.samples.clear()


GLOBAL_STATS = PhaseStats()
phase = GLOBAL_STATS.phase


@contextlib.contextmanager
def trace(log_dir: str):
    """A `torch.profiler` trace of the CPU and, where there is one, the
    card, written to `log_dir` as a Chrome trace (chrome://tracing or
    Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Label a region on the trace's timeline."""
    return torch.profiler.record_function(name)
