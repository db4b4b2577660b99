"""The generation engine's prefill (vision, prefill and the first token on
the host: `Generator.generate`'s `stats["prefill_s"]`), mean over the
window's batches. Layer: engine."""


def read(run):
    b = run.data.get("batches")
    if not b:
        return None
    return 1e3 * sum(x["prefill_s"] for x in b) / len(b)
