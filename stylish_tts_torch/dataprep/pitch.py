"""Pitch cache generation: batched YIN on the device.

Counterpart of ``stylish_tts_tpu/dataprep/pitch.py`` (``yin_pitch``,
``extract_pitch_for_dataset``, which takes RMVPE in YIN's place where
given one, ``dataprep/rmvpe.py``). YIN: centered 2W-sample frames, the squared
difference function over lags 0..tau_max, cumulative-mean normalisation,
the lag pick (first under-threshold run, then its minimum; the global
minimum where nothing crosses), parabolic refinement, and voicing by the
threshold and an energy gate relative to the utterance's 95th-percentile
frame energy. Plain PyTorch; the difference function is summed over
chunks of lags so that no (B, F, lags, W) tensor larger than
``CHUNK_ELEMENTS`` exists at once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

F0_MIN = 50.0
F0_MAX = 600.0
YIN_THRESHOLD = 0.15
WINDOW = 1024  # analysis window per frame (samples)
CHUNK_ELEMENTS = 1 << 26  # 256 MB of float32 per lag chunk


def _frame_signal(audio: torch.Tensor, hop: int, frames: int) -> torch.Tensor:
    """(B, S) -> (B, frames, 2*WINDOW) centered windows (a strided view)."""
    padded = F.pad(audio, (WINDOW, WINDOW))
    return padded.unfold(1, 2 * WINDOW, hop)[:, :frames]


def _first_true(mask: torch.Tensor, idx: torch.Tensor, none: int) -> torch.Tensor:
    """Index of the first True along the last axis, ``none`` where no True."""
    big = torch.full_like(idx, none)
    return torch.where(mask, idx, big).amin(dim=-1)


def yin_pitch(audio: torch.Tensor, *, hop: int, frames: int,
              sample_rate: int) -> torch.Tensor:
    """(B, S) float32 -> (B, frames) F0 in Hz (0 where unvoiced), on the
    device of ``audio``."""
    audio = audio.to(torch.float32)
    tau_min = max(int(sample_rate / F0_MAX), 2)
    tau_max = min(int(sample_rate / F0_MIN), WINDOW - 1)
    device = audio.device

    x = _frame_signal(audio, hop, frames)  # (B, F, 2W)
    w = x[:, :, :WINDOW]
    b, f = x.shape[0], x.shape[1]
    # difference function d(tau) = sum_t (x[t] - x[t+tau])^2, tau <= tau_max
    lagged = x.unfold(2, WINDOW, 1)  # (B, F, W+1, W) view: lagged[..., tau, :]
    d = torch.empty((b, f, tau_max + 1), dtype=torch.float32, device=device)
    chunk = max(CHUNK_ELEMENTS // max(b * f * WINDOW, 1), 1)
    for t0 in range(0, tau_max + 1, chunk):
        t1 = min(t0 + chunk, tau_max + 1)
        d[:, :, t0:t1] = torch.square(w[:, :, None, :] - lagged[:, :, t0:t1]).sum(-1)

    # cumulative mean normalized difference, tau=0 -> 1
    taus = torch.arange(tau_max + 1, device=device)
    denom = torch.cumsum(d[:, :, 1:], dim=-1) / torch.arange(
        1, tau_max + 1, dtype=torch.float32, device=device)
    cmnd = torch.cat([torch.ones_like(d[:, :, :1]), d[:, :, 1:] / (denom + 1e-9)],
                     dim=-1)
    inf = torch.full_like(cmnd, float("inf"))
    cmnd_v = torch.where(taus >= tau_min, cmnd, inf)

    # lag pick: first tau under threshold, then the minimum of that
    # under-threshold run; the global minimum when nothing crosses
    under = cmnd_v < YIN_THRESHOLD
    any_under = under.any(dim=-1)
    first_under = torch.where(any_under, _first_true(under, taus, tau_max + 1),
                              torch.zeros_like(taus[0]))
    after = taus >= first_under[..., None]
    first_rise = _first_true(after & ~under, taus, tau_max + 1)
    run_mask = after & (taus < first_rise[..., None])
    run_min = torch.argmin(torch.where(run_mask, cmnd_v, inf), dim=-1)
    best_min = torch.argmin(cmnd_v, dim=-1)
    tau_star = torch.where(any_under, run_min, best_min)

    # parabolic refinement around tau_star
    def gather(idx):
        return torch.gather(cmnd, -1, idx[..., None])[..., 0]

    y0 = gather(torch.clamp(tau_star - 1, 0, tau_max))
    y1 = gather(tau_star)
    y2 = gather(torch.clamp(tau_star + 1, 0, tau_max))
    denom_p = y0 - 2 * y1 + y2
    shift = torch.where(denom_p.abs() > 1e-12, 0.5 * (y0 - y2) / (denom_p + 1e-12),
                        torch.zeros_like(denom_p))
    tau_ref = tau_star.to(torch.float32) + torch.clamp(shift, -1.0, 1.0)
    f0 = sample_rate / torch.clamp(tau_ref, min=1.0)

    # voicing: threshold crossing + energy gate 40 dB under the utterance's
    # 95th-percentile frame energy (linear interpolation, as jnp.percentile)
    energy = torch.mean(torch.square(w), dim=-1)  # (B, F)
    ref_energy = torch.quantile(energy, 0.95, dim=-1, keepdim=True)
    voiced = any_under & (energy > torch.clamp(ref_energy * 1e-4, min=1e-12))
    zero = torch.zeros_like(f0)
    f0 = torch.where(voiced, f0, zero)
    return torch.where((f0 >= F0_MIN) & (f0 <= F0_MAX), f0, zero)


def extract_pitch_for_dataset(
    dataset, hop_length: int, sample_rate: int, batch_size: int = 8,
    device="cuda", extractor=None,
) -> Dict[str, np.ndarray]:
    """Whole-dataset pitch cache {wav filename: (frames,) F0 Hz}, batched
    per duration bin: YIN on ``device`` (``cuda`` unless the caller asks
    for ``cpu``), or ``extractor`` (an ``RMVPEPitchExtractor``,
    ``dataprep/rmvpe.py``) where given."""
    device = resolve_device(device)
    bins, _ = dataset.time_bins()
    cache: Dict[str, np.ndarray] = {}
    for _bin, idxs in sorted(bins.items()):
        for i in range(0, len(idxs), batch_size):
            chunk = idxs[i: i + batch_size]
            items = [dataset.load_segment(j) for j in chunk]
            audio = np.stack([it["audio"] for it in items])
            frames = audio.shape[1] // hop_length
            if extractor is not None:
                f0 = extractor.infer(audio)[:, :frames]
            else:
                f0 = yin_pitch(torch.from_numpy(audio).to(device), hop=hop_length,
                               frames=frames, sample_rate=sample_rate).cpu().numpy()
            for k, it in enumerate(items):
                cache[it["path"]] = f0[k]
    return cache
