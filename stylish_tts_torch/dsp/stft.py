"""Forward STFT as a framed DFT: unfold the padded audio, one matmul.

Counterpart of ``stylish_tts_tpu/dsp/stft.py`` (``stft``,
``_forward_basis``, ``_hann_jnp``, ``_framed_dft``), with the same
numerics rather than ``torch.stft``'s:

* centre reflect padding by ``n_fft // 2``;
* the periodic Hann window of ``win_length`` is padded at the END to
  ``n_fft`` (``torch.stft`` centres it; with the align mel's
  n_fft=2048 / win_length=1200 the two differ);
* angles are reduced modulo ``n_fft`` before the trig, and the DC and
  (even ``n_fft``) Nyquist rows are set exactly.

Autograd through ``unfold`` + matmul gives the gradient; the JAX
package's custom VJP existed only for the TPU's transposed conv.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def hann_window_padded(win_length: int, n_fft: int) -> torch.Tensor:
    """Periodic Hann window of ``win_length``, zero-padded at the end (or
    cut) to ``n_fft`` (float64, CPU)."""
    n = torch.arange(win_length, dtype=torch.float64)
    w = 0.5 - 0.5 * torch.cos((2.0 * math.pi / win_length) * n)
    if win_length < n_fft:
        return F.pad(w, (0, n_fft - win_length))
    return w[:n_fft]


@functools.lru_cache(maxsize=16)
def forward_basis(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """(n_fft, 2*freq_bins) windowed DFT matrix, columns [real | imag],
    built once per device (the 2048-point one is 16.8 MB)."""
    freq_bins = n_fft // 2 + 1
    n = torch.arange(n_fft, dtype=torch.float64)
    k = torch.arange(freq_bins, dtype=torch.float64)
    # (k*n mod n_fft) is exact in float64; the trig sees [0, 2*pi)
    angle = (2.0 * math.pi / n_fft) * torch.remainder(k[:, None] * n[None, :], n_fft)
    cos, sin = torch.cos(angle), torch.sin(angle)
    cos[0] = 1.0
    sin[0] = 0.0
    if n_fft % 2 == 0:
        cos[-1] = torch.where(torch.arange(n_fft) % 2 == 0, 1.0, -1.0).double()
        sin[-1] = 0.0
    window = hann_window_padded(win_length, n_fft)
    # (n_fft, 2*freq_bins): columns = [real | imag]
    basis = torch.cat([cos * window, -sin * window], dim=0).T
    return basis.to(device=device, dtype=torch.float32).contiguous()


def stft(audio: torch.Tensor, n_fft: int, hop_length: int, win_length: int):
    """audio (B, T) -> (real, imag), each (B, freq_bins, frames), centred
    with reflect padding."""
    audio = audio.to(torch.float32)
    pad = n_fft // 2
    audio = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = audio.unfold(-1, n_fft, hop_length)  # (B, frames, n_fft)
    out = frames @ forward_basis(n_fft, win_length, audio.device)
    out = out.transpose(1, 2)  # (B, 2*freq_bins, frames)
    freq_bins = n_fft // 2 + 1
    return out[:, :freq_bins, :], out[:, freq_bins:, :]
