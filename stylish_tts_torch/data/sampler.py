"""Bucketed batch sampling + static batch-size planning.

The port's copy of ``stylish_tts_tpu/data/sampler.py`` (the port imports
nothing of the JAX package).

Parity targets:
  * DynamicBatchSampler (reference dataloader.py:303-381): per-bin
    shuffled queues, weighted random bin choice by remaining batch
    count, drop-incomplete, live batch-size reload.
  * BatchManager probing (reference batch_manager.py:73-163): the
    reference discovers per-bin batch sizes by provoking OOMs; on TPU
    memory use is static per compiled program, so the planner derives
    sizes from a linear HBM model (activation bytes ~ frames) clamped
    to probe_batch_max, and persists them to <stage>_batch_sizes.json
    in the same format for interop.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from .dataset import get_frame_count


class BatchSizeTable:
    def __init__(self, path: Optional[str] = None, probe_batch_max: int = 16):
        self.path = path
        self.probe_batch_max = probe_batch_max
        self.sizes: Dict[int, int] = {}
        if path and os.path.isfile(path):
            self.load()

    def load(self) -> None:
        with open(self.path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        self.sizes = {int(k): int(v) for k, v in raw.items()}

    def save(self) -> None:
        if self.path:
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump({str(k): v for k, v in self.sizes.items()}, f)

    def plan(self, bins: List[int], reference_bin: int = 9,
             reference_batch: Optional[int] = None) -> None:
        """Static memory plan: batch size inversely proportional to the
        bin's frame count, anchored at (reference_bin, reference_batch)."""
        if reference_batch is None:
            reference_batch = self.probe_batch_max
        ref_frames = get_frame_count(reference_bin)
        for b in bins:
            frames = get_frame_count(b)
            size = max(int(reference_batch * ref_frames / frames), 1)
            self.sizes[b] = min(size, self.probe_batch_max)
        self.save()

    def get(self, time_bin: int) -> int:
        return max(self.sizes.get(time_bin, 1), 1)

    def shrink(self, time_bin: int, factor: float = 0.9) -> int:
        """Durably lower a bin's batch size (reference batch_manager.py:193-233
        OOM retry path)."""
        new = max(int(self.get(time_bin) * factor), 1)
        self.sizes[time_bin] = new
        self.save()
        return new


class DynamicBatchSampler:
    """Yields (time_bin, [segment indices]) batches.

    Whole batches come from one bin; bins are drawn with probability
    proportional to their remaining batch count (reference
    dataloader.py:354-369).
    """

    def __init__(
        self,
        time_bins: Dict[int, List[int]],
        batch_sizes: BatchSizeTable,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        force_bin: Optional[int] = None,
        force_batch_size: Optional[int] = None,
    ):
        self.time_bins = time_bins
        self.batch_sizes = batch_sizes
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.force_bin = force_bin
        self.force_batch_size = force_batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _bin_batch_size(self, b: int) -> int:
        if self.force_batch_size is not None:
            return self.force_batch_size
        return self.batch_sizes.get(b)

    def __len__(self) -> int:
        total = 0
        for b, idxs in self.time_bins.items():
            if self.force_bin is not None and b != self.force_bin:
                continue
            size = self._bin_batch_size(b)
            n = len(idxs) // size
            if not self.drop_last and len(idxs) % size:
                n += 1
            total += n
        return total

    def __iter__(self) -> Iterator:
        rng = np.random.default_rng(self.seed + self.epoch)
        queues = {}
        for b, idxs in self.time_bins.items():
            if self.force_bin is not None and b != self.force_bin:
                continue
            q = list(idxs)
            if self.shuffle:
                rng.shuffle(q)
            queues[b] = q
        while queues:
            bins = list(queues.keys())
            remaining = np.array(
                [
                    max(len(queues[b]) // self._bin_batch_size(b), 1)
                    for b in bins
                ],
                np.float64,
            )
            probs = remaining / remaining.sum()
            b = bins[rng.choice(len(bins), p=probs)]
            size = self._bin_batch_size(b)
            q = queues[b]
            batch = q[:size]
            del q[:size]
            if len(q) < size:
                # not enough left for another full batch
                if len(q) == 0 or self.drop_last:
                    queues.pop(b)
            if len(batch) == size or not self.drop_last:
                yield b, batch
