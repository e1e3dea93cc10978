"""ITU-R BS.1770 integrated loudness + normalization (the port's copy of
``stylish_tts_tpu/tts/loudness.py``; numpy and scipy only).

Replaces the reference's pyloudnorm dependency for the -25 LUFS
long-form normalization (reference: tts/cli.py:60, 85-87): K-weighting
(high-shelf pre-filter + RLB high-pass) followed by gated mean-square
measurement per the BS.1770-4 two-stage gating.

The K-weighting filters and the square run in one native float64 pass
(``native/loudness.cpp``, built when this module is imported), bitwise
scipy's two ``lfilter`` passes; where the library cannot be built, and for
input other than 1-D float32, scipy runs them.

Spans (``utils/trace.py``): ``loudness.filter``, the K-weighted signal
squared; ``loudness.blocks``, the block mean squares. Counter
``loudness.path`` (``PATH``): the calls the native pass or scipy served.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
from scipy.signal import lfilter

from .. import native
from ..utils.trace import counter, span

PATH = counter("loudness.path", ("native", "scipy"))
# built at import, not at the first call: a caller that imports this module
# in its set-up pays no compile in its first timed call
_LIB = native.loudness_library()


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


def _k_weighted_square(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """The K-weighted signal squared, float64: bitwise
    ``lfilter(bh, ah, lfilter(bs, as_, audio.astype(np.float64))) ** 2``."""
    (bs, as_), (bh, ah) = _k_weighting_coeffs(sample_rate)
    if _LIB is not None and audio.dtype == np.float32 and audio.ndim == 1:
        # the native pass skips scipy's division by a[0]
        assert as_[0] == 1.0 and ah[0] == 1.0
        PATH["native"] += 1
        return native.k_weighted_square(
            audio, np.concatenate([bs, as_[1:], bh, ah[1:]]), _LIB)
    PATH["scipy"] += 1
    x = lfilter(bh, ah, lfilter(bs, as_, audio.astype(np.float64)))
    return x * x


def integrated_loudness(audio: np.ndarray, sample_rate: int) -> float:
    """Mono integrated loudness in LUFS (BS.1770-4 gating)."""
    with span("loudness.filter"):
        sq = _k_weighted_square(audio, sample_rate)

    block = int(0.4 * sample_rate)  # 400 ms blocks
    hop = int(0.1 * sample_rate)  # 75% overlap
    if sq.shape[0] < block:
        ms = float(np.mean(sq) + 1e-12)
        return -0.691 + 10.0 * np.log10(ms)
    with span("loudness.blocks"):
        # One row per block, a strided view of the squared signal: no copy of
        # the blocks, and the JAX copy's sums to the last bit.
        blocks = sliding_window_view(sq, block)[::hop]
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
