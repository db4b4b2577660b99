"""The mean host time a decode step takes to launch its work: from the end
of the copies of its inputs to the device to the start of its tokens' copy
to the host, over the window's steps (the program's `batcher.decode.launch`
span records). Layer: batcher. The input copies (`batcher.decode.inputs`)
lie outside it: a copy from pageable memory first waits for the device
work queued before it, which on an admitting iteration is the admission's
chunk. Read beside `batcher.step_ms.chat` (the same steps, inputs, launch
and copy): where the launch is close to the whole step, the card waits on
the host's launches, and the tokens' copy is short."""

from benchlib.spans import window_seconds


def read(run):
    xs = window_seconds(run, "batcher.decode.launch")
    return None if xs is None else 1e3 * sum(xs) / len(xs)
