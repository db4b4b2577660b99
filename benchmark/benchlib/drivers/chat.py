"""Open-loop chat into `serve/scheduler.ContinuousBatcher`: requests arrive on a
fixed schedule whatever the system does, each timed from when it was due.

Set-up: weights, the batcher, two warm-up requests (the largest and the
smallest image of the window), then a pre-roll of the same traffic so that
the window opens on a loaded batcher. The window's requests are those due
in [0, seconds); the load goes on after it until each of them has finished,
and in a traced run through the traced slice after that.
"""

from __future__ import annotations

import time

import numpy as np

from benchlib import stats
from benchlib.checks import served_gap_checks
from benchlib.drivers import Outcome, free_device, memory_peak, now, sync
from benchlib.model import make_weights, program_config
from benchlib.trace import DeviceTrace
from benchlib.traffic import chat_schedule, subseed


def _pixels(requests, size: int, seed: int, device, dtype):
    """One [views, size, size, 3] tensor per request, all drawn in one call."""
    import torch

    total = sum(r["views"] for r in requests)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty((total, size, size, 3), dtype=dtype, device=device).normal_(0.0, 1.0,
                                                                                   generator=gen)
    out, at = [], 0
    for r in requests:
        out.append(flat[at:at + r["views"]])
        at += r["views"]
    return out


class _Tracked:
    """A request's arrival and the times and step counts of its tokens."""

    def __init__(self, req: dict, batcher):
        self.req = req
        self.times: list[float] = []
        self.steps: list[int] = []
        self.future = None
        self._batcher = batcher

    def on_token(self, _tok):
        self.times.append(now())
        self.steps.append(self._batcher.stats["decode_steps"])


def run(ctx) -> Outcome:
    from tokenpacker_tpu_torch.models.splice import build_splice_plan
    from tokenpacker_tpu_torch.serve.scheduler import ContinuousBatcher

    conf, traffic, device = ctx.conf, ctx.traffic, ctx.device
    cfg = program_config(conf)
    tok = conf["assumed"]["tokenizer"]
    tpv = cfg.tokens_per_view
    weights = make_weights(conf, subseed(ctx.seed, 100), device)
    sched = chat_schedule(traffic, conf, ctx.seed, ctx.seconds, tpv, ctx.rate)
    own = [r for r in sched if r["segment"] != "drain"]
    pix = _pixels(own, conf["vision"]["image_size"], subseed(ctx.seed, 101), device, cfg.dtype)
    for r, p in zip(own, pix):
        r["pixels"] = p
    by_source = {r["source"]: r for r in own}
    for r in sched:
        if r["segment"] == "drain":
            r["pixels"] = by_source[r["source"]]["pixels"]
        plan = build_splice_plan([r["ids"]], [[r["grid"]]], tpv, "slice", tok["sep_id"],
                                 tok["newline_id"])
        r["batch"] = {"token_ids": plan.token_ids, "is_image": plan.is_image,
                      "image_slot": plan.image_slot, "lengths": plan.lengths,
                      "images": r["pixels"]}
    b = traffic["batcher"]
    batcher = ContinuousBatcher(weights, cfg, num_slots=b["num_slots"],
                                max_seq_len=b["max_seq_len"],
                                prefill_chunk_size=b["prefill_chunk_size"], device=device)
    s = traffic["sampling"]

    def submit(r, on_token=None, max_new=None):
        kw = {} if r["greedy"] else {"temperature": s["temperature"], "top_p": s["top_p"],
                                     "seed": r["sample_seed"]}
        return batcher.submit(r["batch"], max_new_tokens=max_new or r["max_new_tokens"],
                              on_token=on_token, **kw)

    batcher.start()
    try:
        win = [r for r in sched if r["segment"] == "win"]
        warm = [max(win, key=lambda r: r["views"]), min(win, key=lambda r: r["views"])]
        for f in [submit(r, max_new=4) for r in warm]:
            f.result(timeout=1200)
        sync(device)
        tracked = [_Tracked(r, batcher) for r in sched]
        outcome = _open_loop(ctx, batcher, tracked, submit)
    finally:
        batcher.stop()
    outcome.memory_peak = memory_peak(device)
    del batcher
    free_device(device)
    outcome.checks += _check(ctx, weights, conf, tracked)
    return outcome


def _open_loop(ctx, batcher, tracked, submit) -> Outcome:
    """Send each request when it is due (the sender sleeps, holding no lock,
    between events), mark the window's edges, and wait until every request
    of the window has finished. A traced run then keeps the drain's arrivals
    coming for a slice under the profiler: its window is the untraced run's,
    so what the per-layer metrics read of the window the profiler never
    touched."""
    traffic = ctx.traffic
    win = [t for t in tracked if t.req["segment"] == "win"]
    origin = now() - tracked[0].req["due"]  # the first pre-roll request is due now
    give_up = origin + ctx.seconds + traffic["drain_limit_s"]
    marks, late = {}, []
    events = [(origin, "start"), (origin + ctx.seconds, "end")]
    tracer = DeviceTrace(ctx.device) if ctx.trace else None
    sent, shift = 0, 0.0  # shift: how long the profiler's start held the process

    def window_done():
        return all(t.future is not None and t.future.done() for t in win)

    def fire(until):
        for ev in sorted(e for e in events if e[0] <= until):
            events.remove(ev)
            marks[ev[1]] = (now(), dict(batcher.stats))
            if ev[1] == "trace0":
                tracer.begin()
                events.append((now() + traffic["trace"]["slice_s"], "trace1"))
            elif ev[1] == "trace1":
                tracer.end()

    def send(stop):
        """Send the requests in due order, from the first not yet sent,
        until `stop(next request)` holds."""
        nonlocal sent
        while sent < len(tracked):
            t = tracked[sent]
            due = origin + shift + t.req["due"]
            while True:
                nxt = min([due] + [e[0] for e in events])
                if nxt > now():
                    time.sleep(nxt - now())
                fire(now())
                if stop(t):
                    return
                if now() >= due:
                    break
            late.append(now() - due)
            t.future = submit(t.req, t.on_token)
            sent += 1

    send(lambda t: t.req["segment"] == "drain" and (window_done() or now() > give_up))
    while not window_done() and now() < give_up:
        time.sleep(0.01)
    finished = now()
    fire(finished)
    if tracer is not None and window_done():
        # the profiler's start holds the process for seconds, the batcher for
        # most of them: the arrivals due while the batcher was held (the
        # start's time less the window's mean step for each step it made)
        # come that much later, not all at once, and the load settles
        # before the slice opens
        (_, st0), (_, st1) = marks["start"], marks["end"]
        step_s = ((st1["decode_s"] - st0["decode_s"])
                  / max(st1["decode_steps"] - st0["decode_steps"], 1))
        t0, steps0 = now(), batcher.stats["decode_steps"]
        tracer.start()
        held = now() - t0
        shift = max(0.0, held - (batcher.stats["decode_steps"] - steps0) * step_s)
        events.append((now() + traffic["trace"]["settle_s"], "trace0"))
        send(lambda t: "trace1" in marks)
        while "trace1" not in marks:
            time.sleep(0.01)
            fire(now())
        tracer.stop()
    ttft, gaps, failed = [], [], 0
    for t in win:
        due = origin + t.req["due"]
        ok = t.future is not None and t.future.done() and t.future.exception() is None
        if not ok or not t.times:
            failed += 1
            ttft.append(finished - due)
            continue
        ttft.append(t.times[0] - due)
        gaps += stats.token_gaps(t.times)
    thirds = [stats.quantile(ttft[i * len(ttft) // 3:(i + 1) * len(ttft) // 3], 0.5)
              for i in range(3)] if len(ttft) >= 3 else []
    (_, st0), (_, st1) = marks["start"], marks["end"]
    traced = (marks.get("trace0", (0, {}))[1].get("decode_steps"),
              marks.get("trace1", (0, {}))[1].get("decode_steps"))
    out = Outcome(window_start=origin, attempted=len(win), failed=failed, checks=[],
                  memory_peak=0,
                  e2e={"itl_p95_ms": 1e3 * stats.quantile(gaps, 0.95) if gaps else 0.0})
    tokens = [(t.req["prompt_len"], k, s) for t in tracked for k, s in enumerate(t.steps)]
    window_steps = (st0["decode_steps"], st1["decode_steps"])
    out.data = {
        "window_steps": st1["decode_steps"] - st0["decode_steps"],
        "window_decode_s": st1["decode_s"] - st0["decode_s"],
        "window_step_range": window_steps,
        "trace_step_range": traced,
        "num_slots": ctx.traffic["batcher"]["num_slots"],
        # (prompt length, token index, step count at emission) of every token
        "tokens": tokens,
        "late_p95_ms": 1e3 * stats.quantile(late, 0.95) if late else 0.0,
        "ttft_median_by_third_ms": [1e3 * x for x in thirds],
        "ttft_s": ttft, "itl_s": gaps,
        "diagnosis": {"step_ms": 1e3 * (st1["decode_s"] - st0["decode_s"])
                      / max(st1["decode_steps"] - st0["decode_steps"], 1),
                      **{f"{name}_p{q}_ms": 1e3 * stats.quantile(xs, q / 100)
                         for name, xs in (("ttft", ttft), ("itl", gaps)) if xs
                         for q in (50, 90, 95, 99)},
                      **kv_in_use(tokens, window_steps, ctx.traffic["batcher"], ctx.conf)},
    }
    if tracer is not None and "trace1" in marks:
        out.data["diagnosis"].update(
            {f"slice_{k}": v for k, v in
             kv_in_use(tokens, traced, ctx.traffic["batcher"], ctx.conf).items()
             if k != "kv_reserved_gb"},
            slice_steps=traced[1] - traced[0], arrivals_shifted_s=shift)
    if tracer is not None and "trace1" in marks:
        out.trace = tracer.summary()
    return out


def kv_in_use(tokens, step_range, batcher: dict, conf: dict) -> dict:
    """How much of the slots' reserved cache the window's decode steps held:
    the slots that decoded at each step and the positions they had cached,
    as a mean over the steps and the peak, beside the reserved pool. From
    the tokens' step counts (token k of a prompt of P positions came from a
    step over P + k positions)."""
    s0, s1 = step_range
    per_step = {}
    for prompt, k, step in tokens:
        if k >= 1 and s0 < step <= s1:
            slots, positions = per_step.get(step, (0, 0))
            per_step[step] = (slots + 1, positions + prompt + k)
    if not per_step:
        return {}
    lm = conf["lm"]
    elem = 2 if conf["kv_cache_dtype"] in ("bfloat16", "float16") else 4
    per_position = 2 * lm["n_layers"] * lm["d_model"] * elem
    slots = [v[0] for v in per_step.values()]
    positions = [v[1] for v in per_step.values()]
    return {"kv_live_slots_mean": sum(slots) / len(slots), "kv_live_slots_peak": max(slots),
            "kv_in_use_gb_mean": per_position * sum(positions) / len(positions) / 1e9,
            "kv_in_use_gb_peak": per_position * max(positions) / 1e9,
            "kv_reserved_gb": per_position * batcher["num_slots"] * batcher["max_seq_len"] / 1e9}


def _check(ctx, weights, conf, tracked) -> list:
    """The largest gap by which a served greedy token's logit lies below the
    reference's best, over a sample of the window's finished greedy
    requests, drawn from the seed, with the longest in it."""
    from reference import exact_float32

    exact_float32()
    done = [t for t in tracked if t.req["segment"] == "win" and t.req["greedy"]
            and t.future is not None and t.future.done() and t.future.exception() is None
            and t.future.result()]
    if not done:
        return [("served_greedy_requests", 0, 1, ">=")]
    longest = max(done, key=lambda t: t.req["prompt_len"] + len(t.future.result()))
    rest = [t for t in done if t is not longest]
    rng = np.random.default_rng(subseed(ctx.seed, 102))
    n = min(ctx.traffic["check"]["requests"] - 1, len(rest))
    pick = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]
    cases = [(t.req["ids"], t.req["grid"], t.req["pixels"], t.future.result()) for t in pick]
    return served_gap_checks(ctx, weights, conf, cases, "served")
