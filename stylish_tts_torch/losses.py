"""The losses of the acoustic, textual and duration stages.

Counterpart of ``stylish_tts_tpu/losses.py``:

* multi-resolution spectral convergence over the log-mels ("mel");
* the anti-wrapping multi-phase loss ("multi_phase");
* LSGAN + TPRLS discriminator / generator pair losses over the score
  heads, with the waveform disc weighted by ``DISC_AUDIO_WEIGHT``;
* the gap-aware discriminator LR multiplier;
* the loss-normalised ``backwards_loss`` (each term but ``generator`` and
  ``align_loss`` enters as w * L / stop_grad(L), unit magnitude) and the
  raw weighted ``reporting_total``;
* the prosody and duration losses: ``smooth_l1`` and
  ``pitch_energy_losses`` (textual), the class-weighted
  ``duration_ce_loss`` and ``masked_smooth_l1_per_sequence`` (duration);
  their targets are stop-gradient;
* the ringformer's ``magphase_loss``: the head's log-amplitude and phase
  against the target STFT at the head's resolution ("mag", "phase").

Every batch-wide statistic is taken over the global batch when the step
runs data-parallel, as JAX's sharded ``jit`` takes it: a batch mean is the
mean of the ranks' means (equal shares), spectral convergence's sums, the
TPRLS lower median (over the ranks' differences gathered in rank order,
the global batch's order), its element count and ``sum(keep)`` go through
``parallel``'s differentiable collectives. At world size 1 these are the
identity, and every loss is what it was.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence

import torch

from . import parallel
from .models.common import sequence_mask

TWO_PI = 2.0 * math.pi

DISC_AUDIO_WEIGHT = 3.0

# losses that keep their raw magnitude in the backward pass
UNNORMALIZED_KEYS = ("generator", "align_loss")


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of ``x`` (this rank's rows)."""
    return parallel.global_mean(torch.mean(x))


def spectral_convergence_loss(target_list: Sequence[torch.Tensor],
                              pred_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean over resolutions of sum|t - p| / (sum|t| + 1e-6), each sum over
    the global batch; the target side carries no gradient."""
    loss = 0.0
    for target, pred in zip(target_list, pred_list):
        target = target.detach()
        loss = loss + parallel.global_sum(torch.sum(torch.abs(target - pred))) / (
            parallel.global_sum(torch.sum(torch.abs(target))) + 1e-6)
    return loss / len(target_list)


def _anti_wrapping(phase_diff: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return torch.abs(phase_diff - TWO_PI * torch.round(phase_diff / TWO_PI)) * weights


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)
def phase_weights(freq_size: int, device: torch.device) -> torch.Tensor:
    """(1, freq, 1) weights rising to 2.5 at half the band, made once per
    size and device (so that a step copies nothing from the host)."""
    base = math.exp(math.log(2.5) / (freq_size // 2))
    weights = torch.pow(torch.tensor(base, dtype=torch.float32),
                        torch.arange(freq_size, dtype=torch.float32))
    return weights.to(device)[None, :, None]


def differential_phase_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Frequency-weighted anti-wrapping |dphi| + d/df + d/dt terms over
    (B, freq, frames)."""
    target = target.detach()
    weights = phase_weights(target.shape[1], pred.device)
    loss = _mean(_anti_wrapping(pred - target, weights))
    loss = loss + _mean(_anti_wrapping(
        torch.diff(pred, dim=1) - torch.diff(target, dim=1), weights[:, :-1, :]))
    loss = loss + _mean(_anti_wrapping(
        torch.diff(pred, dim=2) - torch.diff(target, dim=2), weights))
    return loss


def multi_phase_loss(pred_list: Sequence[torch.Tensor],
                     target_list: Sequence[torch.Tensor]) -> torch.Tensor:
    loss = 0.0
    for pred, target in zip(pred_list, target_list):
        loss = loss + differential_phase_loss(pred, target)
    return loss / len(pred_list)


def magphase_loss(pred_magnitude: torch.Tensor, pred_phase: torch.Tensor,
                  target_real: torch.Tensor, target_imag: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Log-magnitude L1 and the differential phase loss of (B, freq, frames)
    predictions against a target STFT; the phases count only where the
    target's magnitude exceeds 1e-3 (a mask without gradient)."""
    target_mag = torch.sqrt(target_real ** 2 + target_imag ** 2) + 1e-14
    mask = (target_mag > 1e-3).to(torch.float32).detach()
    target_phase = mask * torch.atan2(target_imag, target_real)
    mag = _mean(torch.abs(pred_magnitude - torch.log(target_mag + 1e-9)))
    phase = differential_phase_loss(mask * pred_phase, target_phase)
    return {"mag": mag, "phase": phase}


def _median_lower(x: torch.Tensor) -> torch.Tensor:
    """The lower of the two middle order statistics of the global batch's
    ``x`` for an even-sized input. ``torch.median`` already returns that one
    (the JAX package sorts to get it, since ``jnp.median`` averages the
    two)."""
    return torch.median(parallel.gather_rows(x).reshape(-1))


def _tprls(real: torch.Tensor, fake: torch.Tensor, tau: float = 0.04) -> torch.Tensor:
    """Relativistic truncated pairing loss, discriminator side (masked sum
    over the total size)."""
    diff = real - fake
    m = _median_lower(diff)
    keep = (real < fake + m).to(torch.float32)
    sq = torch.square(diff - m) * keep
    l_rel = parallel.global_sum(torch.sum(sq)) / (sq.numel() * parallel.world_size() + 1e-9)
    return tau - torch.relu(tau - l_rel)


def _tprls_gen(real: torch.Tensor, fake: torch.Tensor, tau: float = 0.04) -> torch.Tensor:
    """Generator side: roles swapped, masked mean."""
    diff = fake - real
    m = _median_lower(diff)
    keep = (fake < real + m).to(torch.float32)
    sq = torch.square(diff - m) * keep
    l_rel = parallel.global_sum(torch.sum(sq)) / (parallel.global_count(torch.sum(keep)) + 1e-9)
    return tau - torch.relu(tau - l_rel)


def discriminator_pair_loss(real_scores: List[torch.Tensor],
                            fake_scores: List[torch.Tensor]):
    """(LSGAN (1-real)^2 + fake^2 summed over the score heads + TPRLS, the raw
    LSGAN term that feeds the gap-aware LR EMA); scores in float32."""
    loss = 0.0
    tprls = 0.0
    for dr, dg in zip(real_scores, fake_scores):
        dr, dg = dr.float(), dg.float()
        loss = loss + _mean(torch.square(1.0 - dr)) + _mean(torch.square(dg))
        tprls = tprls + _tprls(dr, dg)
    return loss + tprls, loss


def generator_pair_loss(real_scores: List[torch.Tensor],
                        fake_scores: List[torch.Tensor]) -> torch.Tensor:
    """LSGAN (1-fake)^2 + TPRLS, generator side; scores in float32."""
    loss = 0.0
    for dr, dg in zip(real_scores, fake_scores):
        dr, dg = dr.float(), dg.float()
        loss = loss + _mean(torch.square(1.0 - dg)) + _tprls_gen(dr, dg)
    return loss


def disc_lr_multiplier(last_loss: torch.Tensor, sub_count: float, f_max: float = 4.0,
                       h_min: float = 0.01) -> torch.Tensor:
    """Gap-aware discriminator LR multiplier: the ideal loss is 0.5 per score
    head; above it the multiplier rises towards ``f_max``, below it falls
    towards ``h_min``, saturating 5 % of the ideal away."""
    ideal = 0.5 * sub_count
    x_band = 0.05 * sub_count
    x = torch.abs(last_loss - ideal)
    above = torch.clamp_max(torch.pow(f_max, x / x_band), f_max)
    below = torch.clamp_min(torch.pow(h_min, x / x_band), h_min)
    mult = torch.where(last_loss > ideal, above, below)
    mult = torch.where(last_loss > ideal + x_band, torch.full_like(mult, f_max), mult)
    return torch.where(last_loss < ideal - x_band, torch.full_like(mult, h_min), mult)


def backwards_loss(metrics: Dict[str, torch.Tensor], weights: Dict[str, float]) -> torch.Tensor:
    """Loss-magnitude-normalised weighted total: each loss but
    ``generator``/``align_loss`` contributes w * L / (stop_grad(L) + 1e-9)."""
    total = 0.0
    for key, value in metrics.items():
        term = value if key in UNNORMALIZED_KEYS else value / (value.detach() + 1e-9)
        total = total + weights.get(key, 1.0) * term
    return total


def reporting_total(metrics: Dict[str, torch.Tensor], weights: Dict[str, float]):
    """Raw weighted sum, for logging."""
    total = 0.0
    for key, value in metrics.items():
        total = total + weights.get(key, 1.0) * value
    return total


# --------------------------------------------------------------------------
# Prosody / duration losses
# --------------------------------------------------------------------------


def _smooth_l1_elem(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    diff = pred - target.detach()
    abs_diff = torch.abs(diff)
    return torch.where(abs_diff < 1.0, 0.5 * diff * diff, abs_diff - 0.5)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean Huber loss (delta 1) against a stop-gradient target."""
    return _mean(_smooth_l1_elem(pred, target))


def pitch_energy_losses(pred_pitch, pitch, pred_energy, energy) -> Dict[str, torch.Tensor]:
    """Smooth-L1 of each curve plus smooth-L1 of its frame-to-frame delta."""
    def curve(pred, target):
        return smooth_l1(pred, target) + smooth_l1(torch.diff(pred, dim=-1),
                                                   torch.diff(target, dim=-1))

    return {"pitch": curve(pred_pitch, pitch), "energy": curve(pred_energy, energy)}


def duration_ce_loss(pred: torch.Tensor, target_classes: torch.Tensor,
                     text_lengths: torch.Tensor, class_weights: torch.Tensor) -> torch.Tensor:
    """Per-sequence class-weighted cross entropy, sum(w * nll) / sum(w) over
    the sequence's tokens, averaged over the batch. ``pred`` (B, T, classes)
    logits, ``target_classes`` (B, T)."""
    logz = torch.log_softmax(pred, dim=-1)
    target = target_classes.long()
    picked = torch.gather(logz, -1, target[..., None])[..., 0]
    w = class_weights.to(logz)[target]
    mask = sequence_mask(text_lengths, pred.shape[1]).to(torch.float32)
    num = torch.sum(-picked * w * mask, dim=1)
    den = torch.sum(w * mask, dim=1) + 1e-9
    return _mean(num / den)


def masked_smooth_l1_per_sequence(pred: torch.Tensor, target: torch.Tensor,
                                  lengths: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 averaged over each sequence's valid positions, then over
    the batch."""
    mask = sequence_mask(lengths, pred.shape[1]).to(torch.float32)
    per_seq = torch.sum(_smooth_l1_elem(pred, target) * mask, dim=1) / torch.clamp_min(
        torch.sum(mask, dim=1), 1.0)
    return _mean(per_seq)
