"""The host time the port's spans add to a decode step, timed on the batcher's own loop.

    python benchmark/tools/span_cost.py [--device cuda] [--rounds 64] [--tokens 300] [--same]

Runs a tiny MPT `ContinuousBatcher` (2 layers, chunked admission, 4 slots)
on the calling thread, with no profiler; each round serves 4 requests of
`--tokens` tokens. The loop's iterations take turns: one with the spans as
they are, the next with the batcher's `_span` and the module's
`GLOBAL_STATS` replaced by no-ops. Each iteration that made a decode step
is timed, from one `_running()` check to the next, so that both arms run
the same work on the same host state, and the difference of the two arms'
median iterations is the spans' cost a step (an admission's spans fall in
the iterations that run it). With `--same` both arms keep the spans: what
that reads is the tool's own resolution. On the CPU ATen runs one thread;
on the card the model is bf16 at the head sizes its kernels take (the
tower's attention 64, the ALiBi decode 128). Prints one JSON line:
microseconds a step, the difference of the arms' medians and of their
means over every round and the quartiles of the rounds' median
differences; each arm's median and mean iteration and its count; and the
ring records kept a step with the spans on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tokenpacker_tpu_torch.config import LMConfig, VisionConfig, tiny_vlm_config  # noqa: E402
from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device  # noqa: E402
from tokenpacker_tpu_torch.models.splice import build_splice_plan  # noqa: E402
from tokenpacker_tpu_torch.serve import scheduler  # noqa: E402
from tokenpacker_tpu_torch.utils.profiling import GLOBAL_STATS, Span  # noqa: E402

MPT_LM = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, model_family="mpt", alibi=True, tie_word_embeddings=True,
              eos_token_id=-1)  # every request runs to its length
# on the card: heads of 128 in the LM, of 64 in the tower
CARD_LM = dict(MPT_LM, hidden_size=256, intermediate_size=1024, num_attention_heads=2)
CARD_VISION = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                   num_attention_heads=2, image_size=56, patch_size=14, multi_layers=(1, 2, 3, 4))
SLOTS = 4


def model(device: str):
    """(config, params) of the tiny MPT VLM for `device`."""
    if device == "cpu":
        cfg = tiny_vlm_config(lm=LMConfig(**MPT_LM))
        return cfg, init_vlm_on_device(cfg, seed=11, device=device, dtype=torch.float32)
    cfg = tiny_vlm_config(lm=LMConfig(**CARD_LM), vision=VisionConfig(**CARD_VISION),
                          dtype=torch.bfloat16)
    return cfg, init_vlm_on_device(cfg, seed=11, device=device, dtype=torch.bfloat16)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _NoStats:
    """`GLOBAL_STATS` as the batcher uses it, keeping nothing."""

    def __init__(self):
        self._none, self._rec = _NoSpan(), Span("none")

    def add(self, *a, **k):
        return self._rec


def _request(cfg, seed):
    rng = np.random.default_rng(seed)
    ids = np.array([1, 17 + seed, IMAGE_TOKEN_INDEX, *(30 + np.arange(12))], np.int64)
    plan = build_splice_plan([ids], [[(1, 1)]], cfg.tokens_per_view, "single", 7, 8, 0)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths,
            "images": rng.standard_normal((1, 56, 56, 3)).astype(np.float32)}


def one_loop(cfg, params, device, tokens, same=False) -> tuple[dict, float]:
    """One loop serving SLOTS requests of `tokens` tokens, its iterations
    taking turns with the spans on and off (on in both, `same`): ({True: the
    spans-on iterations' nanoseconds, False: the others'}, ring records a
    spans-on step)."""
    batcher = scheduler.ContinuousBatcher(params, cfg, device=device, num_slots=SLOTS,
                                          max_seq_len=64 * (tokens // 64 + 2),
                                          prefill_chunk_size=8)
    left = [SLOTS * tokens]

    def on_token(_tok):
        left[0] -= 1
        if left[0] == 0:
            batcher._stop.set()

    for i in range(SLOTS):
        batcher.submit(_request(cfg, i), tokens, on_token=on_token)
    real, stub, running = scheduler.GLOBAL_STATS, _NoStats(), batcher._running
    real_span = scheduler._SlotBatcher._span
    times = {True: [], False: []}
    state = {"on": False, "t": None, "steps": 0}

    # the arms differ in values only (no attribute comes or goes), so that
    # the interpreter's specialized lookups stay the same in both
    def switched_span(self, name, req=None):
        return real_span(self, name, req) if state["spans"] else stub._none

    def timed_running():
        now = time.perf_counter_ns()
        steps = batcher.stats["decode_steps"]
        if state["t"] is not None and steps > state["steps"]:
            times[state["on"]].append(now - state["t"])
        state["steps"], state["on"] = steps, not state["on"]
        state["spans"] = state["on"] or same
        scheduler.GLOBAL_STATS = real if state["spans"] else stub
        state["t"] = time.perf_counter_ns()
        return running()

    batcher._running = timed_running
    scheduler._SlotBatcher._span = switched_span
    try:
        batcher._run()
    finally:
        scheduler.GLOBAL_STATS, scheduler._SlotBatcher._span = real, real_span
    if batcher.dead is not None or left[0]:
        raise RuntimeError(f"the loop ended with {left[0]} tokens left: {batcher.dead!r}")
    kept = len(real.records(owner=batcher._owner))
    return times, kept / max(1, len(times[True]) + same * len(times[False]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=300)
    ap.add_argument("--same", action="store_true", help="spans on in both arms")
    args = ap.parse_args()
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        card = card.stdout.strip() or "cpu"
    except FileNotFoundError:
        card = "cpu"
    if args.device == "cpu":
        torch.set_num_threads(1)
    cfg, params = model(args.device)
    one_loop(cfg, params, args.device, 32)  # builds what later loops reuse
    on, off, rounds, records = [], [], [], []
    for _ in range(args.rounds):
        times, recs = one_loop(cfg, params, args.device, args.tokens, args.same)
        on += times[True]
        off += times[False]
        rounds.append((statistics.median(times[True]) - statistics.median(times[False])) / 1e3)
        records.append(recs)
    q = statistics.quantiles(rounds, n=4) if len(rounds) > 1 else [rounds[0]] * 3
    us = [[statistics.median(x) / 1e3, statistics.fmean(x) / 1e3, len(x)] for x in (on, off)]
    print(json.dumps({"card": card, "device": args.device, "torch": torch.__version__,
                      "rounds": args.rounds, "tokens": args.tokens, "same": args.same,
                      "span_us_a_step": {"median": us[0][0] - us[1][0],
                                         "mean": us[0][1] - us[1][1],
                                         "rounds_q1_median_q3": [q[0], q[1], q[2]]},
                      "step_us": {"spans": us[0], "no_spans": us[1]},
                      "records_a_step": statistics.median(records)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
