"""The readers of the program's spans on a synthetic span ring."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchlib import stats
from benchlib.manifest import BENCH_DIR, Manifest

READERS = ["batcher.queue_wait_p50_ms.chat", "batcher.queue_wait_p95_ms.chat",
           "batcher.admission_p50_ms.chat", "batcher.launch_ms.chat",
           "batcher.admission_steps_share.chat", "batcher.admission_work_share.chat"]
MS = 1_000_000  # ns


def ring_of(capacity=256):
    """A ring as a batcher (owner 5) leaves it over steps 0-19, after another
    batcher (owner 4) that ran earlier in the process. Step s starts at
    t = s seconds: its inputs take 1 ms, its launch 10 + s ms, its tokens'
    copy 2 ms. The request admitted at step s (one a step from step 2)
    waited 2 s ms and took 100 + s ms to its first token: its tower 4 ms,
    two chunks of 30 ms, the second holding its seat, and step s inside."""
    from tokenpacker_tpu_torch.utils.profiling import PhaseStats

    ring = PhaseStats(capacity=capacity)
    for step in range(0, 30, 3):
        ring.add("batcher.queue", 0, 999 * MS, req=step, step=step, owner=4)
        ring.add("batcher.decode", 0, 999 * MS, step=step, owner=4)
    for step in range(20):
        t, req = 1000 * MS * step, 100 + step
        if step >= 2:
            ring.add("batcher.queue", t - 2 * step * MS, t, req=req, step=step, owner=5)
            ring.add("batcher.admit", t, t + (100 + step) * MS, req=req, step=step, owner=5)
            ring.add("batcher.admit.visual", t + 14 * MS, t + 18 * MS, req=req, step=step,
                     owner=5)
            ring.add("batcher.admit.chunk", t + 20 * MS, t + 50 * MS, req=req, step=step, owner=5)
            last = ring.add("batcher.admit.chunk", t + 60 * MS, t + 90 * MS, req=req, step=step,
                            owner=5)
            ring.add("batcher.admit.seat", t + 80 * MS, t + 90 * MS, req=req, step=step, owner=5,
                     parent=last)
        ring.add("batcher.decode.inputs", t, t + MS, step=step, owner=5)
        ring.add("batcher.decode.launch", t + MS, t + (11 + step) * MS, step=step, owner=5)
        ring.add("batcher.decode.wait", t + (11 + step) * MS, t + (13 + step) * MS, step=step,
                 owner=5)
        ring.add("batcher.decode", t, t + (13 + step) * MS, step=step, owner=5)
    return ring


def run_of(steps=(5, 15)):
    return SimpleNamespace(data={"window_step_range": steps}, stats=stats)


def read(name, run):
    return Manifest(BENCH_DIR.parent).reader(name).read(run)


def test_readers_on_a_synthetic_ring(monkeypatch):
    from tokenpacker_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "GLOBAL_STATS", ring_of())
    run = run_of()
    window = range(5, 15)  # the steps of owner 5 in [5, 15)
    assert read("batcher.queue_wait_p50_ms.chat", run) == pytest.approx(
        stats.quantile([2.0 * s for s in window], 0.5))
    assert read("batcher.queue_wait_p95_ms.chat", run) == pytest.approx(
        stats.quantile([2.0 * s for s in window], 0.95))
    assert read("batcher.admission_p50_ms.chat", run) == pytest.approx(
        stats.quantile([100.0 + s for s in window], 0.5))
    assert read("batcher.launch_ms.chat", run) == pytest.approx(
        sum(10.0 + s for s in window) / len(window))
    # inside each admission: step s's launch and copy; its own work is the
    # tower, the two chunks (the seat inside one) and step s's inputs
    admit = sum(100.0 + s for s in window)
    assert read("batcher.admission_steps_share.chat", run) == pytest.approx(
        100.0 * sum(12.0 + s for s in window) / admit)
    assert read("batcher.admission_work_share.chat", run) == pytest.approx(
        100.0 * 65.0 * len(window) / admit)


@pytest.mark.parametrize("case", ["dropped", "no window", "no ring", "no records", "no steps"])
def test_readers_return_none(monkeypatch, case):
    """None where the ring has dropped the window's first step, the window
    made no step, the program keeps no ring (a checkout before it) or no
    record of the kind lies in the window, or no batcher stepped."""
    from tokenpacker_tpu_torch.utils import profiling

    ring = {"dropped": ring_of(capacity=32), "no window": ring_of(), "no records": ring_of(),
            "no ring": SimpleNamespace(summary=dict),  # phase timings alone
            "no steps": profiling.PhaseStats(capacity=8)}[case]
    monkeypatch.setattr(profiling, "GLOBAL_STATS", ring)
    run = run_of({"no window": (7, 7), "no records": (0, 2)}.get(case, (5, 15)))
    if case == "dropped":  # 32 records hold owner 5's last three steps
        assert not ring.holds_from(5, 5) and ring.holds_from(17, 5)
    for name in READERS:
        if case == "no records" and name == "batcher.launch_ms.chat":
            continue  # steps 0 and 1 launched: only the queue and admission have none
        assert read(name, run) is None, name
