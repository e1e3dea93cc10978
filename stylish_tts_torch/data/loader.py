"""Prefetching host-side data loader.

The port's counterpart of ``stylish_tts_tpu/data/loader.py``: a
background thread pipelines [sample -> load -> collate -> host-to-device
copy] ahead of the training step. Audio comes through the native C++
batch loader (``native/``) when it builds and every segment of the batch
has its time bin from the header scan, otherwise through
``dataset.load_segment`` (scipy WAV IO). ``BATCHES`` counts which path
served each batch (the trace registry's ``loader.batches``). Data
parallel, each rank draws the same global batch from its sampler and loads
only its rows (``parallel.shard_rows``).

Spans (``utils/trace.py``), each with the batch number: ``loader.load``
(reading and collating) and ``loader.put`` (``device_put``) on the worker
thread, ``loader.wait`` around the consumer's wait for the next batch.
"""

from __future__ import annotations

import itertools
import os.path as osp
import queue
import threading
from typing import Iterator

from .. import parallel
from ..utils.trace import counter, span
from .collate import collate_batch
from .dataset import FilePathDataset, get_frame_count

_SENTINEL = object()

# batches served by each audio path, bumped once per loaded batch
BATCHES = counter("loader.batches", ("native", "scipy"))


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
        use_native: bool = True,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.hop_length = hop_length
        self.require_pitch = require_pitch
        self.device_put = device_put
        self.depth = depth
        self._native = None
        if use_native:
            from .. import native

            self._native = native if native.available() else None

    def load_items(self, idxs):
        """The segments ``idxs`` of one time bin as ``load_segment`` dicts,
        their audio from the native loader where it serves."""
        use_native = self._native is not None and all(
            self.dataset.segments[i].time_bin != -1 for i in idxs
        )
        items = [
            self.dataset.load_segment(i, load_audio=not use_native)
            for i in idxs
        ]
        if use_native:
            paths = [
                osp.join(self.dataset.root_path, self.dataset.segments[i].wav_path)
                for i in idxs
            ]
            frames = get_frame_count(self.dataset.segments[idxs[0]].time_bin)
            audio = self._native.load_wav_batch(
                paths, self.dataset.sample_rate,
                frames * self.dataset.coarse_hop_length,
            )
            for k, item in enumerate(items):
                item["audio"] = audio[k]
        BATCHES["native" if use_native else "scipy"] += 1
        return items

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
                for n, (time_bin, idxs) in enumerate(self.sampler):
                    if stop.is_set():
                        break
                    with span("loader.load", n):
                        batch, paths = collate_batch(
                            self.load_items(parallel.shard_rows(idxs)),
                            hop_length=self.hop_length,
                            require_pitch=self.require_pitch,
                        )
                    if self.device_put is not None:
                        with span("loader.put", n):
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
            for n in itertools.count():
                with span("loader.wait", n):
                    item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)
