"""Device timing on the card, shared by `chip_smoke.py` and the probes'
`main()`s, and the card's peak rates that a measured time is set against."""

from __future__ import annotations

import statistics

import torch

# NVIDIA's H100 SXM datasheet: HBM3 rate and
# the dense bf16 and int8 tensor-core rates, at a 700 W power limit
HBM_BYTES_PER_S, BF16_FLOP_PER_S, INT8_OPS_PER_S = 3.35e12, 989e12, 1979e12


def time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Device time of one call: the median over 3 runs of back-to-back calls
    (iters / 3 a run, at least 1) between one pair of CUDA events, each run
    divided by its count. With `graph` the iters calls are captured once
    into a CUDA graph whose replay is timed (3 replays, each divided by
    iters): a kernel of a few microseconds is then timed without the
    host's launch cost (the wrapper's checks, ctypes), which one event
    pair around one call would measure instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per = iters if graph else max(1, round(iters / 3))
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(per):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(per):
                fn()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)
