"""ITU-R BS.1770 integrated loudness + normalization (the port's copy of
``stylish_tts_tpu/tts/loudness.py``; numpy and scipy only).

Replaces the reference's pyloudnorm dependency for the -25 LUFS
long-form normalization (reference: tts/cli.py:60, 85-87): K-weighting
(high-shelf pre-filter + RLB high-pass) followed by gated mean-square
measurement per the BS.1770-4 two-stage gating.

Span (``utils/trace.py``): ``loudness.blocks``, the block mean squares.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
from scipy.signal import lfilter

from ..utils.trace import span


def _k_weighting_coeffs(sample_rate: float):
    # Stage 1: spherical-head high shelf (BS.1770-4 pre-filter)
    db = 3.999843853973347
    f0 = 1681.974450955533
    q = 0.7071752369554196
    k = np.tan(np.pi * f0 / sample_rate)
    vh = 10.0 ** (db / 20.0)
    vb = vh**0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b_shelf = [
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
    ]
    a_shelf = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]

    # Stage 2: RLB high-pass
    f0 = 38.13547087602444
    q = 0.5003270373238773
    k = np.tan(np.pi * f0 / sample_rate)
    a0 = 1.0 + k / q + k * k
    a_hp = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]
    b_hp = [x / a0 for x in [1.0, -2.0, 1.0]]
    return (np.array(b_shelf), np.array(a_shelf)), (
        np.array(b_hp), np.array(a_hp),
    )


def integrated_loudness(audio: np.ndarray, sample_rate: int) -> float:
    """Mono integrated loudness in LUFS (BS.1770-4 gating)."""
    (bs, as_), (bh, ah) = _k_weighting_coeffs(sample_rate)
    x = lfilter(bs, as_, audio.astype(np.float64))
    x = lfilter(bh, ah, x)

    block = int(0.4 * sample_rate)  # 400 ms blocks
    hop = int(0.1 * sample_rate)  # 75% overlap
    if x.shape[0] < block:
        ms = float(np.mean(x**2) + 1e-12)
        return -0.691 + 10.0 * np.log10(ms)
    with span("loudness.blocks"):
        # One row per block, a strided view of the squared signal: no copy of
        # the blocks, and the JAX copy's sums to the last bit.
        blocks = sliding_window_view(x * x, block)[::hop]
        ms = np.mean(blocks, axis=1) + 1e-12
    lk = -0.691 + 10.0 * np.log10(ms)

    # absolute gate at -70 LUFS
    keep = lk > -70.0
    if not keep.any():
        return -70.0
    # relative gate at -10 LU below the mean of surviving blocks
    rel = -0.691 + 10.0 * np.log10(np.mean(ms[keep])) - 10.0
    keep2 = keep & (lk > rel)
    if not keep2.any():
        keep2 = keep
    return float(-0.691 + 10.0 * np.log10(np.mean(ms[keep2])))


def normalize_loudness(
    audio: np.ndarray, sample_rate: int, target_lufs: float = -25.0
) -> np.ndarray:
    lufs = integrated_loudness(audio, sample_rate)
    gain = 10.0 ** ((target_lufs - lufs) / 20.0)
    return np.clip(audio * gain, -1.0, 1.0).astype(np.float32)
