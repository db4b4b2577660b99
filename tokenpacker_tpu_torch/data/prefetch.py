"""Prepare-ahead iteration (counterpart of `tokenpacker_tpu/data/prefetch.py`).

A background thread runs a host-side transform (image decode,
preprocessing, the splice plan) up to `depth` items ahead, so that the
host's work on the next batch rides under the device's work on this one.
Order is kept, and an exception raised in the worker reaches the consumer
at the item where it happened.

With `to_device=True` the worker also moves every tensor and numpy array
of the item (nested tuples, lists and dicts) to `device`. On a CUDA device
it copies on a side stream from pinned memory and records an event; the
consumer's stream waits on that event before the item is yielded, and
each moved tensor is marked as used by the consumer's stream, so the
caching allocator does not hand its memory back early. The eval runner
keeps `to_device=False`: its batches stay numpy on the host, and
`Generator.generate` moves them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def _move(item, device: torch.device, pin: bool):
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(item)
    if isinstance(item, torch.Tensor):
        if pin and item.device.type == "cpu":
            item = item.pin_memory()
        return item.to(device, non_blocking=pin)
    if isinstance(item, dict):
        return {k: _move(v, device, pin) for k, v in item.items()}
    if isinstance(item, tuple) and hasattr(item, "_fields"):  # a namedtuple
        return type(item)(*(_move(v, device, pin) for v in item))
    if isinstance(item, (list, tuple)):
        return type(item)(_move(v, device, pin) for v in item)
    return item


def _record_stream(item, stream) -> None:
    if isinstance(item, torch.Tensor):
        item.record_stream(stream)
    elif isinstance(item, dict):
        for v in item.values():
            _record_stream(v, stream)
    elif isinstance(item, (list, tuple)):
        for v in item:
            _record_stream(v, stream)


class DevicePrefetcher:
    """Iterate `source`, applying `transform` (host-side) and, with
    `to_device`, moving the result to `device` (the card by default) in a
    background thread, `depth` items ahead."""

    def __init__(
        self,
        source: Iterable,
        transform: Callable | None = None,
        depth: int = 2,
        to_device: bool = False,
        device=None,
    ):
        self._source = source
        self._transform = transform
        self._to_device = to_device
        self._device = torch.device(device if device is not None else "cuda")
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False

    def _worker(self):
        try:
            cuda = self._to_device and self._device.type == "cuda"
            stream = torch.cuda.Stream(self._device) if cuda else None
            for item in self._source:
                if self._transform is not None:
                    item = self._transform(item)
                event = None
                if cuda:
                    with torch.cuda.stream(stream):
                        item = _move(item, self._device, pin=True)
                        event = torch.cuda.Event()
                        event.record(stream)
                elif self._to_device:
                    item = _move(item, self._device, pin=False)
                self._q.put(("item", (item, event)))
        except BaseException as e:  # propagate to the consumer
            self._q.put(("error", e))
        else:
            self._q.put(("done", _SENTINEL))

    def __iter__(self) -> Iterator:
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            kind, payload = self._q.get()
            if kind == "item":
                item, event = payload
                if event is not None:
                    consumer = torch.cuda.current_stream(self._device)
                    event.wait(consumer)
                    _record_stream(item, consumer)
                yield item
            elif kind == "error":
                raise payload
            else:
                return
