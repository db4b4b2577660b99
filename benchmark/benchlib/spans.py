"""The program's spans as the per-layer readers read them.

`window_seconds(run, name)`: the durations of the `name` records that the
port keeps in its span ring (`tokenpacker_tpu_torch.utils.profiling
.GLOBAL_STATS`), of the batcher the cell measured (the owner of the newest
`batcher.decode` record: the chat driver runs one batcher a process), whose
step count lies in the window's decode steps (`run.data["window_step_range"]`
= (lo, hi): lo <= step < hi, the steps the window's step time counts). A
queue or admission record carries the step its admission began at.

`admission_split(run)`: where the window's admissions spent their time.
A chunked admission runs one chunk a loop iteration, and the other slots'
decode step between two chunks: of the summed `batcher.admit` records, the
seconds in the decode steps that ran inside them (their `.launch` and
`.wait`), and the seconds of the admission's own work (its
`batcher.admit.*` spans, and the `.inputs` of those steps, whose copies to
the device wait for the chunk's device work queued before them).
"""

from __future__ import annotations

import bisect


def _window(run):
    """(the ring, the window's steps, the measured batcher) or None (see
    `window_seconds`)."""
    try:
        from tokenpacker_tpu_torch.utils.profiling import GLOBAL_STATS as ring
    except ImportError:
        return None
    if not hasattr(ring, "records"):
        return None
    steps = run.data.get("window_step_range")
    if not steps or steps[1] <= steps[0]:
        return None
    decode = ring.records("batcher.decode")
    if not decode:
        return None
    owner = decode[-1].owner
    if not ring.holds_from(steps[0], owner):
        return None
    return ring, tuple(steps), owner


def window_seconds(run, name: str) -> list[float] | None:
    """Seconds of the window's `name` records (module docstring); None
    where the program keeps no span ring, the window made no step, the ring
    holds no step of a batcher or no longer holds the window's first step,
    or no such record lies in the window."""
    w = _window(run)
    if w is None:
        return None
    ring, steps, owner = w
    return [r.seconds for r in ring.records(name, steps=steps, owner=owner)] or None


def _inside(records, starts, a) -> float:
    """Seconds of the records (sorted by start) that lie within record a."""
    i = bisect.bisect_left(starts, a.start)
    total = 0
    while i < len(records) and records[i].start < a.end:
        if records[i].end <= a.end:
            total += records[i].end - records[i].start
        i += 1
    return total / 1e9


def admission_split(run) -> dict | None:
    """{"admit", "steps", "work"}: seconds summed over the window's
    admissions (module docstring); None as `window_seconds` is, or where no
    admission lies in the window."""
    w = _window(run)
    if w is None:
        return None
    ring, steps, owner = w
    admits = ring.records("batcher.admit", steps=steps, owner=owner)
    if not admits:
        return None
    sorted_by_start = {}
    for name in ("batcher.decode.launch", "batcher.decode.wait", "batcher.decode.inputs"):
        recs = sorted(ring.records(name, owner=owner), key=lambda r: r.start)
        sorted_by_start[name] = (recs, [r.start for r in recs])
    own = {}
    for r in ring.records(owner=owner):
        # an admission's outermost spans (a chunk holds the seat)
        if r.req >= 0 and r.name.startswith("batcher.admit.") and (
                r.parent is None or not r.parent.name.startswith("batcher.admit")):
            own[r.req] = own.get(r.req, 0.0) + r.seconds
    out = {"admit": 0.0, "steps": 0.0, "work": 0.0}
    for a in admits:
        out["admit"] += a.seconds
        out["steps"] += sum(_inside(*sorted_by_start[n], a)
                            for n in ("batcher.decode.launch", "batcher.decode.wait"))
        out["work"] += own.get(a.req, 0.0) + _inside(*sorted_by_start["batcher.decode.inputs"], a)
    return out if out["admit"] > 0 else None
