"""Prefetching host-side data loader.

The port's counterpart of ``stylish_tts_tpu/data/loader.py``: a
background thread pipelines [sample -> load (scipy WAV IO) -> collate ->
host-to-device copy] ahead of the training step. The JAX package's
native C++ batch loader is not ported yet, so audio always comes through
``dataset.load_segment``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

from .collate import collate_batch
from .dataset import FilePathDataset

_SENTINEL = object()


class PrefetchLoader:
    def __init__(
        self,
        dataset: FilePathDataset,
        sampler,
        hop_length: int,
        *,
        require_pitch: bool = True,
        device_put=None,
        depth: int = 2,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.hop_length = hop_length
        self.require_pitch = require_pitch
        self.device_put = device_put
        self.depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded waits so the worker notices a consumer that stopped
            # early and never blocks forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for time_bin, idxs in self.sampler:
                    if stop.is_set():
                        break
                    items = [self.dataset.load_segment(i) for i in idxs]
                    batch, paths = collate_batch(
                        items, hop_length=self.hop_length,
                        require_pitch=self.require_pitch,
                    )
                    if self.device_put is not None:
                        batch = self.device_put(batch)
                    if not put((time_bin, batch, paths)):
                        return
            except Exception as exc:  # surface errors on the consumer side
                put(exc)
            finally:
                put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)
