"""The FLOPs the window's answers need, as a share of the card's bf16 peak
over the window: each request's tower and projector over its views, the
causal prefill over its true prompt length with the head at its last
position, and a decode step for each further token. Layer: the whole
step."""


def read(run):
    d = run.data
    if not d.get("batches") or d.get("window_s", 0) <= 0:
        return None
    w, wk = run.widths, run.work
    flops = 0.0
    for b in d["batches"]:
        for p, v, a in zip(b["prompt_lens"], b["views"], b["answer_lens"]):
            flops += wk.tower_flops(w, v) + wk.projector_flops(w, v) + wk.prefill_flops(w, p)
            flops += sum(wk.decode_flops(w, p + j) for j in range(1, a))
    return 100.0 * flops / (d["window_s"] * run.peaks.BF16_FLOPS)
