"""Mel spectrograms (HTK scale, torchaudio-compatible).

Counterpart of ``stylish_tts_tpu/dsp/mel.py``: the same HTK filterbank
(``norm=None``) over the port's framed-DFT ``stft``; power 2.0, centre
reflect padding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .stft import stft


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    n_mels: int,
    n_fft: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """Triangular HTK-mel filterbank, shape (freq_bins, n_mels).

    Matches torchaudio.functional.melscale_fbanks(mel_scale="htk", norm=None).
    """
    if f_max is None:
        f_max = sample_rate / 2.0
    freq_bins = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, freq_bins)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(mel_pts)
    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (freq, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


class MelSpectrogram:
    """Callable audio (B, T) -> mel power spectrogram (B, n_mels, frames)."""

    def __init__(
        self,
        *,
        n_mels: int,
        n_fft: int,
        win_length: int,
        hop_length: int,
        sample_rate: int,
    ):
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.sample_rate = sample_rate
        self._fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate))
        self._fb_on = {}  # device -> filterbank copy

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        real, imag = stft(audio, self.n_fft, self.hop_length, self.win_length)
        power_spec = real * real + imag * imag
        device = power_spec.device
        if device not in self._fb_on:
            self._fb_on[device] = self._fb.to(device)
        fb = self._fb_on[device]  # (freq, mel)
        # (B, freq, frames) x (freq, mel) -> (B, mel, frames)
        return torch.einsum("bft,fm->bmt", power_spec, fb)
