"""The largest peak of device memory that `Trainer.history` records for a
step of the window (`peak_bytes`, reset before each step). Layer: trainer."""


def read(run):
    peaks = run.data.get("peak_bytes")
    if not peaks:
        return None
    return max(peaks) / 2**30
