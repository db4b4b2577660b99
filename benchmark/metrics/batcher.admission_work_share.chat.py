"""The share of the window's admission time (the summed `batcher.admit`
records of the admissions begun in the window's steps) that the admission's
own work took: its tower and projector, its chunks and its seat (the
program's `batcher.admit.*` records of the request), and the decode steps'
copies of their inputs to the device inside it (`batcher.decode.inputs`),
which wait for the chunk's device work queued before them. Layer: batcher.
Where it is most of the admission, the chunks' device work sets the time
to first token, and a loop with fewer iterations would not shorten it;
the time in neither share is emission and the loop's own Python."""

from benchlib.spans import admission_split


def read(run):
    split = admission_split(run)
    return None if split is None else 100.0 * split["work"] / split["admit"]
