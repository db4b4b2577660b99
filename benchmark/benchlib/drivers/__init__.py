"""Cell drivers, one a kind of traffic (a traffic file names its `driver`):
`chat` (open-loop arrivals into the continuous batcher), `offline` (batches
through the generation engine) and `pretrain` (stage-1 training through the
trainer). Each builds the program's entry from the configuration, warms it
up on the cell's own traffic, measures a window, reads the program's
answers against the plain reference and returns an `Outcome`."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field


@dataclass
class Context:
    conf: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # the cell's correctness limits
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_process: float  # perf_counter at process start
    rate: float | None = None  # a rate other than the traffic file's (the knee sweep only)
    cases: object = None  # what the reference read, kept for the calibration tool


@dataclass
class Outcome:
    window_start: float  # perf_counter when the window opened
    e2e: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    checks: list  # (name, value, limit, "<=" or ">="): correct where every one holds
    memory_peak: int
    data: dict = field(default_factory=dict)  # what the per-layer readers read
    trace: object = None  # benchlib.trace.TraceSummary of the traced slice

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(holds(c) for c in self.checks)


def holds(check) -> bool:
    """A check holds where its value is on the right side of its limit; a
    limit not set (None) never holds."""
    _, value, limit, op = check
    if limit is None:
        return False
    return value <= limit if op == "<=" else value >= limit


def free_device(device) -> None:
    """Return what the program held to the device before the reference runs."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()
