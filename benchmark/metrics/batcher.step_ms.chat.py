"""The dense batcher's mean decode step over the window: the host-clock
seconds `ContinuousBatcher.stats` sums over its plain steps (each ended by
the tokens' copy to the host), over the steps. Layer: batcher."""


def read(run):
    d = run.data
    if not d.get("window_steps"):
        return None
    return 1e3 * d["window_decode_s"] / d["window_steps"]
