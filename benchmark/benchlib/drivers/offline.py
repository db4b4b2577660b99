"""Offline short answers through `generate.Generator.generate`, batch after
batch, as `eval/runner.EvalRunner` drives it.

The traffic's cycle of batches (fixed compositions, the seed's order and
ids) repeats with fresh pixels each time; the window runs whole cycles until
`seconds` have passed, so every run does whole cycles of the same work.
Set-up warms one batch of each padded length the cycle uses. A traced run
profiles a few batches after the window.
"""

from __future__ import annotations

import numpy as np

from benchlib import stats
from benchlib.checks import served_gap_checks
from benchlib.drivers import Outcome, free_device, memory_peak, now, sync
from benchlib.model import make_weights, program_config
from benchlib.trace import DeviceTrace
from benchlib.traffic import offline_cycle, subseed


def _pixels(batch: dict, cycle: int, size: int, device, dtype):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(batch["pixel_seed"], cycle + 1))  # cycle -1: the warm-up
    n = sum(r["views"] for r in batch["requests"])
    return torch.empty((n, size, size, 3), dtype=dtype, device=device).normal_(0.0, 1.0,
                                                                              generator=gen)


def run(ctx) -> Outcome:
    from tokenpacker_tpu_torch.generate import Generator, pick_bucket
    from tokenpacker_tpu_torch.models.splice import build_splice_plan

    conf, traffic, device = ctx.conf, ctx.traffic, ctx.device
    cfg = program_config(conf)
    tok = conf["assumed"]["tokenizer"]
    size = conf["vision"]["image_size"]
    weights = make_weights(conf, subseed(ctx.seed, 100), device)
    batches = offline_cycle(traffic, conf, ctx.seed, 0, cfg.tokens_per_view)
    for b in batches:
        reqs = b["requests"]
        pad = pick_bucket(max(r["prompt_len"] for r in reqs))
        plan = build_splice_plan([r["ids"] for r in reqs], [[r["grid"]] for r in reqs],
                                 cfg.tokens_per_view, "slice", tok["sep_id"], tok["newline_id"],
                                 pad_to=pad)
        b["plan"] = {"token_ids": plan.token_ids, "is_image": plan.is_image,
                     "image_slot": plan.image_slot, "lengths": plan.lengths}
        b["bucket"] = pad
    gen = Generator(weights, cfg)

    def answer(b, cycle):
        batch = {**b["plan"], "images": _pixels(b, cycle, size, device, cfg.dtype)}
        return gen.generate(batch, max_new_tokens=b["max_new_tokens"])

    warmed = {}
    for b in batches:
        if b["bucket"] not in warmed:
            warmed[b["bucket"]] = answer(b, -1)
    sync(device)

    records, cycle = [], 0
    start = now()
    while now() - start < ctx.seconds:
        for b in batches:
            res = answer(b, cycle)
            records.append({"cycle": cycle, "batch": b, "sequences": res.sequences,
                            "prefill_s": res.stats["prefill_s"],
                            "decode_steps": res.stats["decode_steps"]})
        cycle += 1
    end = now()
    # a traced run then profiles the next cycle's first batches, after the
    # window: what it reads of the window the profiler never touched
    traced = []
    if ctx.trace:
        tracer = DeviceTrace(device)
        tracer.start()
        tracer.begin()
        for i in range(traffic["trace"]["batches"]):
            b, c = batches[i % len(batches)], cycle + i // len(batches)
            res = answer(b, c)
            traced.append({"cycle": c, "batch": b, "sequences": res.sequences,
                           "prefill_s": res.stats["prefill_s"]})
        tracer.stop()
    answers = sum(len(r["sequences"]) for r in records)
    failed = sum(1 for r in records for s in r["sequences"] if not s)
    out = Outcome(window_start=start, attempted=answers, failed=failed, checks=[],
                  memory_peak=memory_peak(device),
                  e2e={"answers_per_s": stats.per_second(answers - failed, start, end)})
    out.data = {"window_s": end - start, "batches": [_summary(r) for r in records],
                "traced_batches": [_summary(r) for r in traced]}
    if traced:
        out.trace = tracer.summary()
    del gen, warmed
    free_device(device)
    out.checks += _check(ctx, weights, conf, records, size, cfg.dtype)
    return out


def _summary(r: dict) -> dict:
    """What the readers need of a batch: its true prompt lengths, views and
    answers' lengths, and the engine's prefill seconds."""
    reqs = r["batch"]["requests"]
    return {"prompt_lens": [q["prompt_len"] for q in reqs], "views": [q["views"] for q in reqs],
            "answer_lens": [len(s) for s in r["sequences"]], "prefill_s": r["prefill_s"]}


def _check(ctx, weights, conf, records, size, dtype) -> list:
    """The largest gap by which an answer's token logit lies below the
    reference's best, over a sample of the window's answers drawn from the
    seed, with the longest prompt in it."""
    from reference import exact_float32

    exact_float32()
    flat = [(ri, i) for ri, r in enumerate(records) for i in range(len(r["sequences"]))]
    longest = max(flat, key=lambda x: records[x[0]]["batch"]["requests"][x[1]]["prompt_len"])
    rng = np.random.default_rng(subseed(ctx.seed, 102))
    n = min(ctx.traffic["check"]["requests"] - 1, len(flat) - 1)
    rest = [x for x in flat if x != longest]
    pick = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]
    cases = []
    for ri, i in pick:
        r = records[ri]
        b = r["batch"]
        at = sum(q["views"] for q in b["requests"][:i])
        q = b["requests"][i]
        pixels = _pixels(b, r["cycle"], size, ctx.device, dtype)[at:at + q["views"]].clone()
        cases.append((q["ids"], q["grid"], pixels, r["sequences"][i]))
    return served_gap_checks(ctx, weights, conf, cases, "answer")
