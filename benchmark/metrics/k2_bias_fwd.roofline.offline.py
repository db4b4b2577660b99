"""K2-bias forward's share of its roofline in the traced batches: per
launch (one a layer and batch) the larger of the causal ALiBi attention's
operations over each prompt's true length at the bf16 peak and its q, k,
v, o bytes at the peak bandwidth, summed over the traced batches' layers,
over the profiler's time of the prefill-attention kernel."""

KERNELS = ("flash_fwd_kernel",)


def read(run):
    t, d = run.trace, run.data
    if t is None or not d.get("traced_batches"):
        return None
    seconds, launches = t.op_seconds(*KERNELS)
    if not launches:
        return None
    w = run.widths
    bound = 0.0
    for b in d["traced_batches"]:
        ops = sum(run.work.attention_fwd_work(w, n)[0] for n in b["prompt_lens"])
        nbytes = sum(run.work.attention_fwd_work(w, n)[1] for n in b["prompt_lens"])
        bound += w.layers * max(ops / run.peaks.BF16_FLOPS, nbytes / run.peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / seconds
