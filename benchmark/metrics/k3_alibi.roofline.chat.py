"""K3-ALiBi's share of its roofline in the traced slice: the least time the
K and V bytes of the slice's decode steps need at the card's peak
bandwidth, over the profiler's time of the decode-attention kernel.

Bytes a step and layer: every active slot reads its K and V rows up to its
length (the prompt and the tokens fed so far, the current one included);
an idle slot reads its one row; each slot's query in and output out. A
step's length is known from the tokens it emitted (token k of a request
with a prompt of P positions came from a step over P + k keys). The
slice's steps are averaged to a launch and multiplied by the launches the
trace holds, so a slice that cuts a step in two counts what it traced."""

KERNELS = ("decode_attention_kernel",)


def read(run):
    t, d = run.trace, run.data
    s0, s1 = d.get("trace_step_range", (None, None))
    if t is None or s0 is None or s1 is None or s1 <= s0:
        return None
    seconds, launches = t.op_seconds(*KERNELS)
    if not launches:
        return None
    w = run.widths
    per_step = {}
    for prompt, k, step in d["tokens"]:
        if k >= 1 and s0 < step <= s1:
            keys, active = per_step.get(step, (0, 0))
            per_step[step] = (keys + prompt + k, active + 1)
    if not per_step:
        return None
    total = 0.0
    for keys, active in per_step.values():
        idle = d["num_slots"] - active
        total += run.work.kv_bytes(w, keys + idle) + 2 * d["num_slots"] * w.d * w.kv_bytes
    per_launch = total / len(per_step)
    bound = per_launch * launches / run.peaks.HBM_BYTES_PER_S
    return 100.0 * bound / seconds
