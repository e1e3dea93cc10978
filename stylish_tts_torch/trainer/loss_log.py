"""Metrics to the logger and to TensorBoard.

The part of ``stylish_tts_tpu/trainer/loss_log.py`` the alignment stage
uses: a weighted reporting total, logged and written to a SummaryWriter,
or to a JSONL metrics file where ``torch.utils.tensorboard`` is missing.
"""

from __future__ import annotations

import json
import logging
import os.path as osp
from typing import Dict, Optional

logger = logging.getLogger("stylish_tts_torch")


class MetricsWriter:
    """TensorBoard writer with a JSONL fallback."""

    def __init__(self, out_dir: str):
        self._tb = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._jsonl = open(
                osp.join(out_dir, "metrics.jsonl"), "a", encoding="utf-8"
            )
        else:
            self._tb = SummaryWriter(osp.join(out_dir, "tensorboard"))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": value, "step": step}) + "\n"
            )
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def broadcast(
    metrics: Dict[str, float],
    weights: Dict[str, float],
    writer: Optional[MetricsWriter],
    step: int,
    *,
    prefix: str = "train",
    header: str = "",
) -> float:
    """Log ``metrics`` and their weighted total; returns the total."""
    total = sum(weights.get(k, 1.0) * v for k, v in metrics.items())
    parts = ", ".join(f"{k}: {v:.3f}" for k, v in metrics.items())
    logger.info("%sloss: %.3f, %s", header, total, parts)
    if writer is not None:
        writer.add_scalar(f"{prefix}/loss", total, step)
        for k, v in metrics.items():
            writer.add_scalar(f"{prefix}/{k}", v, step)
    return total
