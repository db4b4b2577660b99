"""`utils/profiling`: spans cost a flag read without a profiler and are
named ranges under one (also on a thread the profiler follows from
elsewhere), and one left open across two profiler sessions closes; the
ring is bounded, its queries exact and its records untracked by the
garbage collector; a request's `batcher.queue` and `batcher.admit`
records add up to its wait for the first token; and a decode step's
spans nest in the order the step runs them."""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tokenpacker_tpu_torch.config import LMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.serve.scheduler import ContinuousBatcher
from tokenpacker_tpu_torch.utils import profiling
from tokenpacker_tpu_torch.utils.profiling import GLOBAL_STATS, PhaseStats

MPT_LM = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, model_family="mpt", alibi=True, tie_word_embeddings=True)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_vlm_config(lm=LMConfig(**MPT_LM))
    return cfg, init_vlm_on_device(cfg, seed=11, device="cpu", dtype=torch.float32)


def _request(cfg, seed, words=4):
    rng = np.random.default_rng(seed)
    ids = np.array([1, 17 + seed, IMAGE_TOKEN_INDEX, *(30 + np.arange(words))], np.int64)
    plan = build_splice_plan([ids], [[(1, 1)]], cfg.tokens_per_view, "single", 7, 8, 0)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths,
            "images": rng.standard_normal((1, 56, 56, 3)).astype(np.float32)}


def _serve(cfg, params, n, **kw):
    """n requests queued at once, then served by a chunked dense batcher of
    2 slots (submitted before its loop starts, so that no other thread
    holds the interpreter between a submit() and its clock reading):
    (the batcher, [(future, the clock before submit(), first token's time)]).
    No garbage collection runs meanwhile, so that none falls between a
    record's end and the clock reading it is held against."""
    batcher = ContinuousBatcher(params, cfg, device="cpu", num_slots=2, max_seq_len=64,
                                prefill_chunk_size=8, **kw)
    out = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for i in range(n):
            first, request = [], _request(cfg, i, words=3 + 4 * i)
            t0 = time.perf_counter_ns()
            fut = batcher.submit(request, 4,
                                 on_token=lambda _t, first=first: first or first.append(
                                     time.perf_counter_ns()))
            out.append((fut, t0, first))
        batcher.start()
        try:
            for fut, _, _ in out:
                fut.result(timeout=120)
        finally:
            batcher.stop()
    finally:
        if collecting:
            gc.enable()
    return batcher, out


def test_fine_span_without_profiler_constructs_no_range(model, monkeypatch):
    """No profiler: no span of a served request (its queue wait, its
    admission, the decode steps, the emission) constructs a range, as a
    fine span would not, and every one reaches the ring."""

    def refuse(*_a, **_k):
        raise AssertionError("a range constructed with no profiler recording")

    monkeypatch.setattr(profiling, "_Range", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    batcher, served = _serve(*model, 1)
    assert served[0][0].result() and served[0][2]
    names = {r.name for r in GLOBAL_STATS.records(owner=batcher._owner)}
    assert {"batcher.queue", "batcher.admit", "batcher.admit.visual", "batcher.admit.chunk",
            "batcher.admit.seat", "batcher.decode", "batcher.decode.inputs",
            "batcher.decode.launch", "batcher.decode.wait", "batcher.emit"} <= names


def test_span_is_a_named_range_under_the_profiler():
    """Under a profiler on this thread a span is a range around its ops;
    on a thread started before the profiler, it is one where the profiler
    follows every thread (the process-wide flag)."""
    ring = PhaseStats(capacity=8)
    go, done = threading.Event(), threading.Event()

    def loop():
        go.wait(10)
        with ring.span("batcher.emit", step=4):
            torch.ones(3).sum()
        done.set()

    th = threading.Thread(target=loop)
    th.start()
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with ring.span("batcher.decode", step=3):
            torch.ones(5).sum()
        go.set()
        assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()
          if e.name() in ("batcher.decode", "batcher.emit")}
    assert set(ev) == {"batcher.decode", "batcher.emit"}
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::sum"]
    for name in ev:
        s, d = ev[name].start_ns(), ev[name].duration_ns()
        assert any(s <= o.start_ns() and o.start_ns() + o.duration_ns() <= s + d for o in ops)
    assert [(r.name, r.step) for r in ring.records()] == [("batcher.decode", 3),
                                                          ("batcher.emit", 4)]
    assert all(r.end > r.start for r in ring.records())


def test_a_span_open_across_profiler_sessions_ends_quietly():
    """A span a thread opens under a profiler that does not follow it, and
    closes under a later one that does, is kept and leaves the thread's
    next spans working (torch finds no range to close there)."""
    ring = PhaseStats(capacity=8)
    opened, close, errors = threading.Event(), threading.Event(), []

    def loop():
        try:
            with ring.span("batcher.decode", step=1):
                opened.set()
                close.wait(10)
            with ring.span("batcher.emit", step=2):
                torch.ones(2).sum()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    th = threading.Thread(target=loop)
    first = profile(activities=[ProfilerActivity.CPU])
    first.start()
    th.start()
    assert opened.wait(10)
    first.stop()
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg):
        close.set()
        th.join(10)
    assert not th.is_alive() and errors == []
    assert [(r.name, r.step) for r in ring.records()] == [("batcher.decode", 1),
                                                          ("batcher.emit", 2)]


def test_ring_is_bounded_and_its_step_query_exact():
    ring = PhaseStats(capacity=16, window=4)
    with pytest.raises(ValueError):
        PhaseStats(capacity=12)
    for step in range(40):
        with ring.span("batcher.decode", step=step, owner=1) as outer:
            inner = ring.add("batcher.queue", 10, 30, req=step % 3, step=step, owner=1)
        assert inner.parent is outer and outer.parent is None
    ring.add("batcher.decode", 0, 5, step=0, owner=2)
    held = ring.records()
    assert len(held) == 16 and held[-1].owner == 2
    assert [r.step for r in ring.records("batcher.decode", owner=1)] == list(range(32, 40))
    assert [r.step for r in ring.records(steps=(34, 37), owner=1)] == [34, 34, 35, 35, 36, 36]
    assert [r.step for r in ring.records("batcher.queue", req=0, steps=(30, 40))] == [33, 36, 39]
    assert ring.holds_from(33, 1) and not ring.holds_from(32, 1) and ring.holds_from(0, 2)
    summ = ring.summary()
    assert summ["batcher.queue"]["count"] == 40 and len(ring.samples["batcher.queue"]) == 4
    assert summ["batcher.queue"]["p50_ms"] == pytest.approx(2e-5)
    assert summ["batcher.queue"]["total_s"] == pytest.approx(40 * 2e-8)
    ring.reset()
    assert ring.records() == [] and ring.summary() == {} and ring.holds_from(0, 1)


def test_the_collector_stops_tracking_the_rings_records():
    """A full ring holds nothing the garbage collector has to walk: its
    records are tuples of names and numbers, parents named by id."""
    ring = PhaseStats(capacity=64)
    for step in range(100):
        with ring.span("batcher.decode", step=step, owner=3):
            with ring.span("batcher.decode.launch", step=step, owner=3):
                pass
    gc.collect()
    assert not any(gc.is_tracked(row) for row in ring._buf)
    launch, decode = ring.records(steps=(99, 100))
    assert launch.parent is decode and decode.parent is None


def test_queue_and_admit_add_up_to_the_first_token(model):
    """Four requests at once into two slots with chunks of 8: each one's
    `batcher.queue` runs from submit() to its admission, `batcher.admit`
    from there to its first token, and, with the sender's lateness (its
    clock reading before the call to submit()'s own), the three add up to
    the time from that reading to the first `on_token` within 1 ms."""
    batcher, served = _serve(*model, 4)
    waits = []
    for fut, t0, first in served:
        sid = fut._tp_request.sid
        (q,) = GLOBAL_STATS.records("batcher.queue", req=sid, owner=batcher._owner)
        (a,) = GLOBAL_STATS.records("batcher.admit", req=sid, owner=batcher._owner)
        assert t0 <= q.start and q.end == a.start and a.step == q.step
        chunks = GLOBAL_STATS.records("batcher.admit.chunk", req=sid, owner=batcher._owner)
        # the last chunk seats the request: its first token comes inside it
        assert chunks and all(a.start <= c.start < first[0] for c in chunks)
        assert chunks[-1].end >= first[0]
        late = q.start - t0
        assert abs((first[0] - t0) - late - (q.end - q.start) - (a.end - a.start)) < 1e6
        waits.append(q.seconds)
    assert max(waits) > waits[0]  # the later ones waited for a slot


def test_a_steps_spans_nest_in_the_order_it_runs_them(model):
    """Each decode step's record holds its input copies, then its launch,
    then the tokens' copy to the host, one after another; its emission
    follows it; and an admission's chunks lie inside its `batcher.admit`
    record, the chunk that seats it holding the seat."""
    batcher, served = _serve(*model, 3)
    mine = GLOBAL_STATS.records(owner=batcher._owner)
    steps = [r for r in mine if r.name == "batcher.decode"]
    assert len(steps) == batcher.stats["decode_steps"] > 0
    for d in steps:
        kids = [r for r in mine if r.parent is d]
        assert [k.name for k in kids] == ["batcher.decode.inputs", "batcher.decode.launch",
                                          "batcher.decode.wait"]
        assert d.start <= kids[0].start and kids[-1].end <= d.end
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert all(k.step == d.step for k in kids)
    emits = [r for r in mine if r.name == "batcher.emit"]
    assert len(emits) == len(steps)
    assert all(d.end <= e.start and e.step == d.step + 1 for d, e in zip(steps, emits))
    for fut, _, _ in served:
        sid = fut._tp_request.sid
        (a,) = [r for r in mine if r.name == "batcher.admit" and r.req == sid]
        chunks = [r for r in mine if r.name == "batcher.admit.chunk" and r.req == sid]
        (seat,) = [r for r in mine if r.name == "batcher.admit.seat" and r.req == sid]
        assert all(a.start <= c.start and c.start < a.end for c in chunks)
        assert seat.parent is chunks[-1] and seat.start <= a.end <= seat.end
