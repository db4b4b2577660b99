"""The share of the window's admission time (the summed `batcher.admit`
records of the admissions begun in the window's steps) that the loop spent
in the other slots' decode steps between an admission's chunks: their
launch and their tokens' copy to the host (the program's
`batcher.decode.launch` and `.wait` records inside an admission). Layer:
batcher. Where it is large, fewer loop iterations an admission (bigger
chunks, several admissions a chunk) shorten each admission, and so every
queue wait behind it; `batcher.admission_work_share.chat` is the rest's
own work."""

from benchlib.spans import admission_split


def read(run):
    split = admission_split(run)
    return None if split is None else 100.0 * split["steps"] / split["admit"]
