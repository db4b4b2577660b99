"""Spans and phase timings (counterpart of `tokenpacker_tpu/utils/profiling.py`).

`GLOBAL_STATS.span(name, req, step, owner)` is a span: a handful per loop
iteration of a batcher. It is always kept in the ring below, on
`time.perf_counter_ns` (the benchmark's host clock), and while a torch
profiler records anywhere in the process it is also a `RecordFunction`
range on the profiler's clock. With no profiler it constructs no range: it
costs one flag read. `GLOBAL_STATS.add(name, start_ns, end_ns, ...)` keeps a
record made from two timestamps, for what crosses loop iterations (a
request's wait in the queue, its admission).

`PhaseStats` is the ring: bounded (`capacity` records, the oldest dropped
first), each record a `Span` with its name, start and end, the enclosing
span of its thread (`parent`), the request it served (`req`, shared by
every span of one request), the step count of the batcher that opened it
(`step`: its `stats["decode_steps"]` then) and that batcher (`owner`). It
holds them as tuples of numbers and names, which the garbage collector
stops tracking, so that a full ring adds nothing to a collection's pause
in a serving process. `records(name, req, steps, owner)` is its one query;
`holds_from(step, owner)` says whether the ring still holds everything of
that batcher from that step on. `record(name, seconds)` and `summary()` are
the phase timings the model worker reports as `phase_timings` (the JAX
package's keys); every ring record counts in them under its name, over the
last `window` samples a name (count and total over all of them).
`GLOBAL_STATS` is the process's instance.
"""

from __future__ import annotations

import itertools
import statistics
import threading
import time
from collections import deque

import torch.autograd.profiler as _autograd_profiler
# the RecordFunction range without `record_function`'s op dispatch (~10 us)
from torch._C._profiler import _RecordFunctionFast as _Range

_now = time.perf_counter_ns
_ids = itertools.count()  # a record's id, by which the ring names its parent


class _Local(threading.local):
    """Per thread: the innermost open span (a record's parent); None by
    default, read without the cost of a missing attribute."""

    top: Span | None = None


_local = _Local()


class Span:
    """A ring record; as a context manager (`PhaseStats.span`), a span
    that times its block and keeps itself in the ring on exit (and is a
    profiler range while a profiler records)."""

    __slots__ = ("name", "start", "end", "parent", "req", "step", "owner", "id", "_ring",
                 "_range")

    def __init__(self, name: str, start: int = 0, end: int = 0, parent: Span | None = None,
                 req: int = -1, step: int = -1, owner: int = -1, ring: PhaseStats | None = None,
                 ident: int | None = None):
        self.name, self.start, self.end, self.parent = name, start, end, parent
        self.req, self.step, self.owner = req, step, owner
        self.id = next(_ids) if ident is None else ident
        self._ring, self._range = ring, None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __repr__(self):
        return (f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, req={self.req}, "
                f"step={self.step}, owner={self.owner})")

    def __enter__(self):
        self.parent = _local.top
        _local.top = self
        # the profiler's process-wide flag, set by its start and stop on
        # whichever thread ran them: the thread-local
        # `torch._C._autograd._profiler_enabled()` is False on a thread the
        # profiler does not follow (a batcher's loop, unless the profiler was
        # made with `profile_all_threads`), where the range is a cheap no-op
        # of `_Range`'s own
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc):
        self.end = _now()
        if self._range is not None:
            try:
                self._range.__exit__(None, None, None)
            except RuntimeError:
                # entered under a profiler that did not follow this thread,
                # exited under a later one that does: torch finds no range
                # to close, and a serving loop must not die of it
                pass
            self._range = None
        _local.top = self.parent
        self._ring._keep(self, (self.end - self.start) / 1e9)
        return False


class PhaseStats:
    def __init__(self, capacity: int = 1 << 16, window: int = 4096):
        if capacity & (capacity - 1):
            raise ValueError(f"capacity {capacity} is not a power of two")
        self.capacity = capacity
        self.window = window  # samples a name kept for summary()'s quantiles
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            # (name, start, end, id, the parent's id or -1, req, step, owner)
            self._buf: list[tuple | None] = [None] * self.capacity
            self._n = 0  # records ever kept
            self._evicted: dict[int, int] = {}  # owner -> the highest step dropped
            # name -> [its last `window` seconds, the count and the total of all]
            self._names: dict[str, list] = {}

    # -- writing -----------------------------------------------------------

    def span(self, name: str, req: int = -1, step: int = -1, owner: int = -1) -> Span:
        """A span (module docstring): `with ring.span(...) as s:`."""
        return Span(name, 0, 0, None, req, step, owner, self)

    def add(self, name: str, start_ns: int, end_ns: int, req: int = -1, step: int = -1,
            owner: int = -1, parent: Span | None = None) -> Span:
        """Keep a record made from two `perf_counter_ns` readings, within
        `parent` (by default the thread's innermost open span)."""
        rec = Span(name, start_ns, end_ns, _local.top if parent is None else parent, req, step,
                   owner)
        self._keep(rec, (end_ns - start_ns) / 1e9)
        return rec

    def record(self, name: str, seconds: float):
        """A phase timing of `seconds`, ending now (the JAX package's call)."""
        end = time.perf_counter_ns()
        rec = Span(name, end - int(seconds * 1e9), end, _local.top)
        self._keep(rec, seconds)

    def _keep(self, rec: Span, seconds: float):
        row = (rec.name, rec.start, rec.end, rec.id, -1 if rec.parent is None else rec.parent.id,
               rec.req, rec.step, rec.owner)
        with self._lock:
            buf, i = self._buf, self._n & (self.capacity - 1)
            old = buf[i]
            if old is not None and old[6] > self._evicted.get(old[7], -1):
                self._evicted[old[7]] = old[6]
            buf[i] = row
            self._n += 1
            tally = self._names.get(rec.name)
            if tally is None:
                tally = self._names[rec.name] = [deque(maxlen=self.window), 0, 0]
            tally[0].append(seconds)
            tally[1] += 1
            tally[2] += seconds

    # -- reading -----------------------------------------------------------

    def records(self, name: str | None = None, req: int | None = None,
                steps: tuple[int, int] | None = None, owner: int | None = None) -> list[Span]:
        """The records held, oldest first, that match every filter given:
        `name`, `req`, `owner`, and `steps` = (lo, hi) for lo <= step < hi;
        new `Span`s, each with its parent where the ring holds it (one
        object a record within a call)."""
        with self._lock:
            n, buf, mask = self._n, self._buf, self.capacity - 1
            held = [buf[k & mask] for k in range(max(0, n - self.capacity), n)]
        lo, hi = steps if steps is not None else (0, 0)
        rows = [r for r in held
                if (name is None or r[0] == name) and (req is None or r[5] == req)
                and (owner is None or r[7] == owner) and (steps is None or lo <= r[6] < hi)]
        by_id = {r[3]: r for r in held} if any(r[4] >= 0 for r in rows) else {}
        made: dict[int, Span] = {}

        def make(row) -> Span:
            rec = made.get(row[3])
            if rec is None:
                up = by_id.get(row[4])
                rec = made[row[3]] = Span(row[0], row[1], row[2], None if up is None else make(up),
                                          row[5], row[6], row[7], ident=row[3])
            return rec

        return [make(r) for r in rows]

    @property
    def samples(self) -> dict[str, deque]:
        """Each name's last `window` seconds."""
        return {name: tally[0] for name, tally in self._names.items()}

    def holds_from(self, step: int, owner: int) -> bool:
        """Whether no record of `owner` at `step` or later has been dropped."""
        with self._lock:
            return self._evicted.get(owner, -1) < step

    def summary(self) -> dict:
        with self._lock:
            held = [(name, list(xs), count, total)
                    for name, (xs, count, total) in self._names.items()]
        out = {}
        for name, xs, count, total in held:
            xs_sorted = sorted(xs)
            out[name] = {
                "count": count,
                "mean_ms": 1e3 * statistics.fmean(xs),
                "p50_ms": 1e3 * xs_sorted[len(xs) // 2],
                "p95_ms": 1e3 * xs_sorted[min(len(xs) - 1, int(len(xs) * 0.95))],
                "total_s": total,
            }
        return out


GLOBAL_STATS = PhaseStats()
