"""The model FLOPs of the window's plain decode steps over their time, as a
share of the card's bf16 peak. FLOPs from the published widths and each
active slot's length at each step (its products, its attention over its
keys and its head); time: the batcher's host-clock step seconds over the
same steps. Layer: the whole step."""


def read(run):
    d = run.data
    w0, w1 = d.get("window_step_range", (None, None))
    if w0 is None or not d.get("window_decode_s"):
        return None
    flops = sum(run.work.decode_flops(run.widths, prompt + k)
                for prompt, k, step in d["tokens"] if k >= 1 and w0 < step <= w1)
    return 100.0 * flops / (d["window_decode_s"] * run.peaks.BF16_FLOPS)
