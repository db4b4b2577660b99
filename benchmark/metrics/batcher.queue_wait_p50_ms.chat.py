"""The median wait of a request in the batcher's queue: from submit() to the
start of its admission, over the requests whose admission began in the
window's steps (the program's `batcher.queue` span records). Layer:
batcher. With `batcher.admission_p50_ms.chat` it splits the time to first
token: from its due time, a request's TTFT is the sender's lateness plus
its queue wait plus its admission."""

from benchlib.spans import window_seconds


def read(run):
    xs = window_seconds(run, "batcher.queue")
    return None if xs is None else 1e3 * run.stats.quantile(xs, 0.5)
