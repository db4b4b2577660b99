"""A `torch.profiler` slice of a run, reduced to what the per-layer metrics
read: the device's busy time (the union of its kernels', copies' and
memsets' spans), each device operation's time and count by name, and the
idle gaps labelled by the host operation that was running through them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

SHORT_GAP_NS = 10_000


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)  # device op name -> [seconds, count]
    gaps: dict = field(default_factory=dict)  # host label -> idle seconds

    def op_seconds(self, *parts: str) -> tuple[float, int]:
        """Seconds and launches of the device ops whose name holds one of
        `parts`."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.ops.items():
            if any(p in name for p in parts):
                s, n = s + sec, n + cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v[0]] for n, v in ops], "idle_gaps": [[n, s] for n, s in gaps]}


SLICE = "benchmark.traced_slice"


class DeviceTrace:
    """`start()` turns the profiler on; `begin()` and `end()` mark the slice
    that is read, as a host event of the trace itself, so that the profiler's
    own start and stop, which hold the process for a while, lie outside it;
    `stop()` turns the profiler off; `summary()` reduces the slice to its
    `TraceSummary`."""

    def __init__(self, device):
        self.device = device
        self._slice = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        from benchlib.drivers import sync

        sync(self.device)
        cuda = self.device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.start()

    def begin(self):
        from torch.autograd.profiler import record_function

        self._slice = record_function(SLICE)
        self._slice.__enter__()

    def end(self):
        """Close the slice once the device has run what was launched in it."""
        from benchlib.drivers import sync

        sync(self.device)
        self._slice.__exit__(None, None, None)
        self._slice = None

    def stop(self):
        if self._slice is not None:
            self.end()
        self.prof.stop()

    def summary(self) -> TraceSummary:
        events = _events(self.prof.profiler.kineto_results.events())
        del self.prof
        marks = [e for e in events if not e[0] and e[1] == SLICE]
        if not marks:
            raise RuntimeError("the trace holds no slice mark")
        _, _, t0, t1 = marks[0]
        return reduce_events([e for e in events if e[1] != SLICE], t0, (t1 - t0) / 1e9)


def _events(kineto_events):
    """(is_device, name, start_ns, end_ns) of every event."""
    from torch.autograd import DeviceType

    out = []
    for e in kineto_events:
        start = e.start_ns()
        out.append((e.device_type() == DeviceType.CUDA, e.name(), start, start + e.duration_ns()))
    return out


def reduce_events(events, t0_ns: int, window_s: float) -> TraceSummary:
    """The slice's summary from (is_device, name, start_ns, end_ns) events on
    one clock, the slice starting at t0_ns and lasting window_s."""
    t1_ns = t0_ns + int(window_s * 1e9)
    dev = sorted((s, e, n) for d, n, s, e in events if d and e > t0_ns and s < t1_ns)
    host = sorted((s, e, n) for d, n, s, e in events if not d)
    ops = defaultdict(lambda: [0.0, 0])
    busy, gaps, last = 0, [], t0_ns
    for s, e, n in dev:
        ops[n][0] += (e - s) / 1e9
        ops[n][1] += 1
        s, e = max(s, t0_ns), min(e, t1_ns)
        if s > last:
            gaps.append((last, s))
        if e > last:
            busy += e - max(s, last)
            last = e
    if t1_ns > last:
        gaps.append((last, t1_ns))
    starts = [h[0] for h in host]
    labelled = defaultdict(float)
    for a, b in gaps:
        labelled[_label(host, starts, a, b)] += (b - a) / 1e9
    return TraceSummary(window_s=window_s, busy_s=busy / 1e9, ops=dict(ops),
                        gaps=dict(labelled))


def _label(host, starts, a: int, b: int) -> str:
    """The innermost host op running at the gap's midpoint (the covering one
    that started last), or what kind of gap it is."""
    if b - a < SHORT_GAP_NS:
        return "short gaps (< 10 us)"
    mid = (a + b) // 2
    i = bisect.bisect_right(starts, mid)
    for j in range(i - 1, max(-1, i - 400), -1):
        s, e, n = host[j]
        if e >= mid:
            return n
    return "no traced host op"
