"""The median admission: from the start of a request's admission (its tower
pass and projector) to its first token (one 256-position chunk of its prompt
a loop iteration, a decode step of the other slots between two chunks), over
the requests whose admission began in the window's steps (the program's
`batcher.admit` span records). Layer: batcher."""

from benchlib.spans import window_seconds


def read(run):
    xs = window_seconds(run, "batcher.admit")
    return None if xs is None else 1e3 * run.stats.quantile(xs, 0.5)
