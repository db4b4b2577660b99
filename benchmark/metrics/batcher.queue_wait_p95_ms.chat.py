"""The 95th percentile of a request's wait in the batcher's queue: from
submit() to the start of its admission, over the requests whose admission
began in the window's steps (the program's `batcher.queue` span records).
Layer: batcher. Read beside `batcher.ttft_p95_ms.chat`: where the wait
makes most of the tail, admissions are too few at a time; where the
admission does (`batcher.admission_p50_ms.chat`), each is too slow."""

from benchlib.spans import window_seconds


def read(run):
    xs = window_seconds(run, "batcher.queue")
    return None if xs is None else 1e3 * run.stats.quantile(xs, 0.95)
