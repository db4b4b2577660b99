"""The 95th percentile of the time to first token over every request due in the
window, from its due time (host clock; a request that never came counts
with the wait it had when the run gave up). A traced run profiles its slice
after the window, so this reads the same requests as an untraced run.
Layer: batcher (the admission queue and the chunked prefill). It guards the
trade against `itl_p95_ms`: an admission's chunks run between two decode
steps, so fewer or smaller chunks between steps shorten the gaps and delay
the first token."""


def read(run):
    ttft = run.data.get("ttft_s")
    if not ttft:
        return None
    return 1e3 * run.stats.quantile(ttft, 0.95)
