"""Metrics to the logger and to TensorBoard.

The port's ``stylish_tts_tpu/trainer/loss_log.py``: a weighted reporting
total (``lr`` and the ``*_lr_mult`` diagnostics excluded), window means,
logged and written to a SummaryWriter, or to a JSONL metrics file where
``torch.utils.tensorboard`` is missing. Eval audio goes to wav files under
the stage directory (``samples/step_SSSSSSSSS/<segment>.wav``), where the
JAX writer adds it to TensorBoard; figures go to TensorBoard only. Data
parallel, rank 0 alone writes: on the other ranks the writer writes
nothing.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from .. import parallel

logger = logging.getLogger("stylish_tts_torch")


class MetricsWriter:
    """TensorBoard writer with a JSONL fallback; on the ranks but 0, a
    writer that writes nothing."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._tb = None
        self._jsonl = None
        self._off = not parallel.is_writer()
        if self._off:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._jsonl = open(
                osp.join(out_dir, "metrics.jsonl"), "a", encoding="utf-8"
            )
        else:
            self._tb = SummaryWriter(osp.join(out_dir, "tensorboard"))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._off:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": value, "step": step}) + "\n"
            )
            self._jsonl.flush()

    def add_audio(self, tag: str, audio, step: int, sample_rate: int) -> str:
        """Write ``audio`` (1-D) as a wav file named after the last part of
        ``tag``; returns its path (None on the ranks but 0)."""
        from ..data.wav import write_wav

        if self._off:
            return None
        name = osp.basename(tag)
        if not name.endswith(".wav"):
            name += ".wav"
        folder = osp.join(self.out_dir, "samples", f"step_{step:09d}")
        os.makedirs(folder, exist_ok=True)
        path = osp.join(folder, name)
        write_wav(path, np.asarray(audio, dtype=np.float32), sample_rate)
        return path

    def add_figure(self, tag: str, figure, step: int) -> None:
        """A matplotlib figure to TensorBoard (which closes it); None (no
        matplotlib) is skipped, and without TensorBoard the figure is
        closed unwritten."""
        if figure is None or self._off:
            return
        if self._tb is not None:
            self._tb.add_figure(tag, figure, step)
        else:
            import matplotlib.pyplot as plt

            plt.close(figure)

    def close(self) -> None:
        if self._off:
            return
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def combine_metrics(window: List[Dict[str, float]]) -> Dict[str, float]:
    """Per-key mean over a window of metric dicts (validation: a mean of
    batch means)."""
    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for m in window:
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v)
            counts[k] = counts.get(k, 0) + 1
    return {k: totals[k] / counts[k] for k in totals}


def weighted_total(metrics: Dict[str, float], weights: Dict[str, float]) -> float:
    # "lr" and the "*_lr_mult" gap-aware-LR diagnostics are observability
    # channels, not loss terms
    return sum(weights.get(k, 1.0) * v for k, v in metrics.items()
               if k != "lr" and not k.endswith("_lr_mult"))


def broadcast(
    metrics: Dict[str, float],
    weights: Dict[str, float],
    writer: Optional[MetricsWriter],
    step: int,
    *,
    prefix: str = "train",
    header: str = "",
) -> float:
    """Log ``metrics`` and their weighted total under ``prefix`` ("train",
    or "eval" for validation); returns the total."""
    total = weighted_total(metrics, weights)
    parts = ", ".join(f"{k}: {v:.3f}" for k, v in metrics.items())
    logger.info("%sloss: %.3f, %s", header, total, parts)
    if writer is not None:
        writer.add_scalar(f"{prefix}/loss", total, step)
        for k, v in metrics.items():
            writer.add_scalar(f"{prefix}/{k}", v, step)
    return total
