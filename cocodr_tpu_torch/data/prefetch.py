"""Background-prefetching batch pipeline: the port's copy of
cocodr_tpu/data/prefetch.py.

A producer thread keeps `depth` batches of gathered host data in flight, so
that the card does not wait on the host's record gathers. With
`device_put`, every numpy array of a batch is copied to pinned memory and
sent to the device with `non_blocking=True` on the producer thread;
`encode_cache` leaves its batches on the host (device_put=False), as the
JAX package does. An exception raised while producing is raised again on
the consumer's side when it reaches that point of the stream.

Spans (utils/logging.py::span), both with the item's number as unit:
`cocodr.feed.produce` on the producer thread around producing an item (the
source's next() and, with `device_put`, the pin and copy), and
`cocodr.feed.wait` on the consumer's around taking it off the queue.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.utils.logging import span


def _to_device(item, dev):
    """numpy arrays of a (nested) tuple, list or dict -> tensors on dev;
    anything else passes as it is."""
    if isinstance(item, np.ndarray):
        t = torch.from_numpy(item)
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(x, dev) for x in item)
    if isinstance(item, dict):
        return {k: _to_device(v, dev) for k, v in item.items()}
    return item


class PrefetchIterator:
    """Wraps a batch-producing iterator; keeps `depth` batches prefetched.
    device_put: True sends batches to the card, False keeps them on the
    host."""

    _SENTINEL = object()

    def __init__(self, source: Iterator, depth: int = 2,
                 device_put: bool = True):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._taken = 0
        self._device = resolve_device("cuda") if device_put else None
        self._thread = threading.Thread(
            target=self._fill, args=(source,), daemon=True
        )
        self._thread.start()

    def _fill(self, source):
        try:
            source = iter(source)
            for n in itertools.count():
                with span("cocodr.feed.produce", n):
                    item = next(source)
                    if self._device is not None:
                        item = _to_device(item, self._device)
                self._q.put(item)
        except StopIteration:
            pass
        except BaseException as e:  # raised again on the consumer side
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        with span("cocodr.feed.wait", self._taken):
            item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                raise StopIteration
        self._taken += 1
        return item


def prefetch(source: Iterator, depth: int = 2,
             device_put: bool = True) -> PrefetchIterator:
    return PrefetchIterator(source, depth, device_put)
