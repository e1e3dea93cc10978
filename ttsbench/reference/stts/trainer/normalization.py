"""Dataset normalization statistics (the port's copy of
``stylish_tts_tpu/trainer/normalization.py``).

Parity with the reference NormalizationStats / init_normalization
(reference: train/train_context.py:47-69, 190-354): dataset-wide
log-mel mean/std, energy log stats, and F0 log2 stats, persisted to
normalization.json and carried in checkpoints.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np


@dataclass
class NormalizationStats:
    mel_log_mean: float = -4.0
    mel_log_std: float = 4.0
    energy_log_mean: float = 0.0
    energy_log_std: float = 1.0
    f0_log2_mean: float = 7.0  # log2(128 Hz)
    f0_log2_std: float = 0.5

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "NormalizationStats":
        with open(path, "r", encoding="utf-8") as f:
            return cls(**json.load(f))

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


def compute_stats_streaming(mel_batches, pitch_values=None) -> NormalizationStats:
    """Welford-style accumulation over an iterator of raw (unnormalized)
    log-mel arrays; pitch_values optionally yields voiced F0 Hz arrays."""
    count = 0
    total = 0.0
    total_sq = 0.0
    for mel in mel_batches:
        logm = np.log(1e-5 + np.asarray(mel))
        count += logm.size
        total += float(logm.sum())
        total_sq += float((logm**2).sum())
    mean = total / max(count, 1)
    var = max(total_sq / max(count, 1) - mean**2, 1e-12)
    stats = NormalizationStats(mel_log_mean=mean, mel_log_std=float(np.sqrt(var)))
    if pitch_values is not None:
        vals = []
        for p in pitch_values:
            p = np.asarray(p)
            vals.append(p[p > 10])
        if vals:
            allp = np.concatenate(vals)
            if allp.size:
                logp = np.log2(allp)
                stats.f0_log2_mean = float(logp.mean())
                stats.f0_log2_std = float(max(logp.std(), 1e-6))
    return stats
