"""Stage 1's model FLOPs over the window, as a share of the card's bf16
peak: for each sample of the window's steps, the tower's forward over its
view, the projector's forward and backward, and the LM's forward and
input-gradient backward over its valid positions with the head at its
caption's targets. Padding is no work. Layer: the whole step."""


def read(run):
    d = run.data
    if not d.get("steps") or d.get("window_s", 0) <= 0:
        return None
    w, wk = run.widths, run.work
    flops = sum(wk.tower_flops(w, 1) + wk.train_projector_flops(w, 1)
                + wk.train_lm_flops(w, valid, targets)
                for step in d["steps"] for valid, targets in step)
    return 100.0 * flops / (d["window_s"] * run.peaks.BF16_FLOPS)
