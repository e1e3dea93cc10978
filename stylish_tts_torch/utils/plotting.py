"""Validation figures: spectrograms and signed-difference heatmaps.

The port's copy of ``stylish_tts_tpu/utils/plotting.py``: a compact
equivalent of the reference plotting utilities (reference:
train/utils.py:175-570: plot_spectrogram_to_figure,
plot_mel_signed_difference_to_figure with robust color limits and
residual summaries). Figures go to TensorBoard via MetricsWriter; each
plotting function gives None where matplotlib is missing.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def robust_color_limits(arr: np.ndarray, lo_q=2.0, hi_q=98.0):
    lo, hi = np.percentile(arr, [lo_q, hi_q])
    if hi <= lo:
        hi = lo + 1e-6
    return float(lo), float(hi)


def summarize_residual(diff: np.ndarray) -> Dict[str, float]:
    return {
        "mae": float(np.mean(np.abs(diff))),
        "rmse": float(np.sqrt(np.mean(diff**2))),
        "bias": float(np.mean(diff)),
        "p95_abs": float(np.percentile(np.abs(diff), 95)),
    }


def plot_spectrogram_figure(mel: np.ndarray, title: str = ""):
    """(n_mels, frames) -> matplotlib figure (None if mpl unavailable)."""
    try:
        import matplotlib

        matplotlib.use("agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(10, 3))
    vmin, vmax = robust_color_limits(mel)
    im = ax.imshow(mel, aspect="auto", origin="lower", vmin=vmin, vmax=vmax)
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def plot_signed_difference_figure(
    target_mel: np.ndarray, pred_mel: np.ndarray, title: str = ""
):
    """Signed pred-target residual heatmap with symmetric robust limits."""
    try:
        import matplotlib

        matplotlib.use("agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    frames = min(target_mel.shape[1], pred_mel.shape[1])
    diff = pred_mel[:, :frames] - target_mel[:, :frames]
    stats = summarize_residual(diff)
    lim = max(abs(np.percentile(diff, 2)), abs(np.percentile(diff, 98)), 1e-6)
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(
        diff, aspect="auto", origin="lower", cmap="RdBu_r",
        vmin=-lim, vmax=lim,
    )
    ax.set_title(
        f"{title} mae={stats['mae']:.3f} rmse={stats['rmse']:.3f} "
        f"bias={stats['bias']:+.3f}"
    )
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig
