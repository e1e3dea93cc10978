"""Multi-resolution spectrogram features for the losses and the MRDs.

Counterpart of ``stylish_tts_tpu/dsp/multi_spectrogram.py``: three STFT
resolutions (512/128, 1024/256, 2048/512); per resolution

* a log1p 128-bin mel of the magnitude (the multi-resolution "mel" loss),
* the phase, zeroed where the magnitude is <= 1e-3 (the phase loss),
* the raw |FFT| magnitude (the MRD discriminators' input).

The magnitude is sqrt(re^2 + im^2 + 1e-14); the whole function is a
float32 island. The mask is data, not a gradient path: atan2 sees the
constant pair (1, 0) at a masked bin, so its phase is 0 as in the JAX
``mask * atan2`` and no 0/0 gradient (a bin of re = im = 0) can reach the
audio. The caller detaches the target side.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import torch

from .mel import mel_filterbank
from .stft import fp32_island, stft


@dataclass(frozen=True)
class Resolution:
    fft: int
    hop: int
    window: int


RESOLUTIONS = (
    Resolution(fft=512, hop=128, window=512),
    Resolution(fft=1024, hop=256, window=1024),
    Resolution(fft=2048, hop=512, window=2048),
)


class SpectrogramFeatures(NamedTuple):
    mel: List[torch.Tensor]  # each (B, 1, 128, frames)
    phase: List[torch.Tensor]  # each (B, freq, frames)
    fft_mag: List[torch.Tensor]  # each (B, 1, freq, frames)


class MultiSpectrogram:
    def __init__(self, *, sample_rate: int, resolutions=RESOLUTIONS):
        self.resolutions = resolutions
        self._fbs = [torch.from_numpy(mel_filterbank(128, item.fft, sample_rate))
                     for item in resolutions]
        self._fb_on = {}  # (index, device) -> filterbank copy

    def _fb(self, index: int, device) -> torch.Tensor:
        key = (index, device)
        if key not in self._fb_on:
            self._fb_on[key] = self._fbs[index].to(device)
        return self._fb_on[key]

    @fp32_island
    def single(self, audio: torch.Tensor, index: int):
        item = self.resolutions[index]
        real, imag = stft(audio, item.fft, item.hop, item.window, center=True)
        fft_mag = torch.sqrt(real * real + imag * imag + 1e-14)
        mask = fft_mag > 1e-3
        # atan2(0, 1) = 0 at the masked bins, whose gradient goes nowhere
        phase = torch.atan2(torch.where(mask, imag, torch.zeros_like(imag)),
                            torch.where(mask, real, torch.ones_like(real)))
        mel = torch.log1p(torch.einsum("bft,fm->bmt", fft_mag,
                                       self._fb(index, fft_mag.device)))
        return mel[:, None], phase, fft_mag[:, None]

    def __call__(self, audio: torch.Tensor) -> SpectrogramFeatures:
        mels, phases, ffts = [], [], []
        for i in range(len(self.resolutions)):
            mel, phase, fft_mag = self.single(audio, i)
            mels.append(mel)
            phases.append(phase)
            ffts.append(fft_mag)
        return SpectrogramFeatures(mel=mels, phase=phases, fft_mag=ffts)
