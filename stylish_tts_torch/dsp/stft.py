"""STFT and iSTFT as framed DFTs: unfold + one matmul, and one matmul +
overlap-add.

Counterpart of ``stylish_tts_tpu/dsp/stft.py`` (``stft``,
``stft_magnitude_unit_phase``, ``istft``, ``_forward_basis``,
``_inverse_basis``, ``_overlap_add``, ``_hann_jnp``, ``_framed_dft``),
with the same numerics rather than ``torch.stft``'s:

* centre padding by ``n_fft // 2``, reflect or edge (torch "replicate");
* the periodic Hann window of ``win_length`` is padded at the END to
  ``n_fft`` (``torch.stft`` centres it; with the align mel's
  n_fft=2048 / win_length=1200 the two differ);
* angles are reduced modulo ``n_fft`` before the trig, and the DC and
  (even ``n_fft``) Nyquist rows are set exactly;
* the inverse scales every bin by 1/n_fft (``uniform``, the generator
  head's convention) or doubles the symmetric bins (exact inverse with
  the window-envelope normalisation).

Autograd through ``unfold`` + matmul gives the gradient; the JAX
package's custom VJP existed only for the TPU's transposed conv.

Every transform is a float32 island: ``fp32_island`` switches autocast
off inside it, so under bf16 mixed precision the DFT matmuls still run
(and return) float32, as the JAX package's ``preferred_element_type`` /
``Precision.HIGHEST`` sites do.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def fp32_island(fn):
    """Run ``fn`` with autocast off (CUDA and CPU), so that its matmuls and
    convs compute in the float32 of their inputs."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
            return fn(*args, **kwargs)

    return wrapped


def hann_window_padded(win_length: int, n_fft: int) -> torch.Tensor:
    """Periodic Hann window of ``win_length``, zero-padded at the end (or
    cut) to ``n_fft`` (float64, CPU)."""
    n = torch.arange(win_length, dtype=torch.float64)
    w = 0.5 - 0.5 * torch.cos((2.0 * math.pi / win_length) * n)
    if win_length < n_fft:
        return F.pad(w, (0, n_fft - win_length))
    return w[:n_fft]


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)
def forward_basis(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """(n_fft, 2*freq_bins) windowed DFT matrix, columns [real | imag],
    built once per device (the 2048-point one is 16.8 MB). Built outside
    inference mode, so that a basis first made by synthesis (under
    ``torch.inference_mode``) can still be saved for a later backward."""
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


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)
def inverse_basis(n_fft: int, win_length: int, uniform: bool,
                  device: torch.device) -> torch.Tensor:
    """(2*freq_bins, n_fft) windowed inverse DFT, rows [real; imag] (built
    outside inference mode, as ``forward_basis``)."""
    freq_bins = n_fft // 2 + 1
    n = torch.arange(n_fft, dtype=torch.float64)
    k = torch.arange(freq_bins, dtype=torch.float64)
    angle = (2.0 * math.pi / n_fft) * torch.remainder(k[:, None] * n[None, :], n_fft)
    if uniform:
        scale = torch.full((freq_bins, 1), 1.0 / n_fft, dtype=torch.float64)
    else:
        scale = torch.full((freq_bins, 1), 2.0 / n_fft, dtype=torch.float64)
        scale[0] = 1.0 / n_fft
        if n_fft % 2 == 0:
            scale[-1] = 1.0 / n_fft
    window = hann_window_padded(win_length, n_fft)
    basis = torch.cat([torch.cos(angle) * scale * window,
                       -torch.sin(angle) * scale * window], dim=0)
    return basis.to(device=device, dtype=torch.float32).contiguous()


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)
def window_square(win_length: int, n_fft: int, device: torch.device) -> torch.Tensor:
    """The padded Hann window squared, float32 on ``device``, made once (so
    that ``istft`` on the card copies nothing from the host per call)."""
    return torch.square(hann_window_padded(win_length, n_fft)).to(
        device=device, dtype=torch.float32)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (B, T, n_fft) frames at ``hop`` -> (B, (T-1)*hop + n_fft).

    When ``hop`` divides ``n_fft``: n_fft/hop shifted adds of hop-wide
    chunks, as the JAX package does; otherwise ``F.fold`` (col2im)."""
    b, t, n_fft = frames.shape
    out_len = (t - 1) * hop + n_fft
    if n_fft % hop == 0:
        k = n_fft // hop
        chunks = frames.reshape(b, t, k, hop)
        wav = frames.new_zeros((b, out_len))
        for j in range(k):
            wav[:, j * hop:j * hop + t * hop] += chunks[:, :, j, :].reshape(b, t * hop)
        return wav
    return F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                  kernel_size=(1, n_fft), stride=(1, hop))[:, 0, 0, :]


@fp32_island
def stft(audio: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True, pad_mode: str = "reflect"):
    """audio (B, T) -> (real, imag), each (B, freq_bins, frames).

    ``pad_mode`` is "reflect" or "edge" (torch "replicate")."""
    audio = audio.to(torch.float32)
    if center:
        pad = n_fft // 2
        mode = {"reflect": "reflect", "edge": "replicate"}[pad_mode]
        audio = F.pad(audio[:, None, :], (pad, pad), mode=mode)[:, 0, :]
    frames = audio.unfold(-1, n_fft, hop_length)  # (B, frames, n_fft)
    out = frames @ forward_basis(n_fft, win_length, audio.device)
    out = out.transpose(1, 2)  # (B, 2*freq_bins, frames)
    freq_bins = n_fft // 2 + 1
    return out[:, :freq_bins, :], out[:, freq_bins:, :]


def stft_magnitude_unit_phase(audio: torch.Tensor, n_fft: int, hop_length: int,
                              win_length: int, center: bool = True,
                              pad_mode: str = "edge", eps: float = 1e-14):
    """(magnitude, cos_phase, sin_phase): the generator head's interface.

    The DC and (even ``n_fft``) Nyquist imaginary parts are sums of
    products with an exact 0 and may come out -0; adding +0 makes them +0
    (and changes no other value), so that atan2 of such a bin with a
    negative real part gives +pi as the JAX package does."""
    real, imag = stft(audio, n_fft, hop_length, win_length, center, pad_mode)
    imag = imag + 0.0
    magnitude = torch.sqrt(real * real + imag * imag + eps)
    return magnitude, real / magnitude, imag / magnitude


@fp32_island
def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int, center: bool = True, length: int | None = None,
          normalize_window: bool = True, uniform_scale: bool = False,
          padding: str = "center", frame_mask: torch.Tensor | None = None) -> torch.Tensor:
    """real/imag (B, freq_bins, frames) -> (B, T): one matmul synthesises the
    frames, then overlap-add; ``normalize_window`` divides by the window's
    sum-of-squares envelope (as ``torch.istft``).

    With ``center``, ``padding`` "center" trims ``n_fft // 2`` samples at
    each end (``torch.istft``'s), "same" trims ``(win_length - hop_length)
    // 2`` (Vocos's iSTFT head: ``frames * hop_length`` samples are left).
    ``frame_mask`` (B, frames), 1 on the frames that exist and 0 on a
    bucket's padding: the padding frames are neither synthesised nor
    counted in the envelope, so the existing frames' samples are those of
    an iSTFT of them alone."""
    spec = torch.cat([real.to(torch.float32), imag.to(torch.float32)], dim=1)
    basis = inverse_basis(n_fft, win_length, uniform_scale, spec.device)
    frames = torch.matmul(spec.transpose(1, 2), basis)
    if frame_mask is not None:
        frame_mask = frame_mask.to(torch.float32)[:, :, None]
        frames = frames * frame_mask
    wav = overlap_add(frames, hop_length)
    if normalize_window:
        n_frames = real.shape[-1]
        wss = window_square(win_length, n_fft, spec.device)
        if frame_mask is None:
            envelope = overlap_add(wss.expand(1, n_frames, n_fft), hop_length)
        else:
            envelope = overlap_add(frame_mask * wss, hop_length)
        wav = wav / torch.clamp_min(envelope, 1e-11)
    if center:
        if padding not in ("center", "same"):
            raise ValueError(f"padding is 'center' or 'same', not {padding!r}")
        pad = n_fft // 2 if padding == "center" else (win_length - hop_length) // 2
        wav = wav[:, pad:-pad]
    if length is not None:
        if wav.shape[-1] < length:
            wav = F.pad(wav, (0, length - wav.shape[-1]))
        else:
            wav = wav[:, :length]
    return wav
