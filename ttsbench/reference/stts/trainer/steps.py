"""Train steps: the acoustic and textual stages of
``stylish_tts_tpu/trainer/steps.py``, on one device.

acoustic: ground-truth prosody -> speech_predictor (style from the mel
style encoder) -> audio; the generator loss is mel spectral convergence +
multi-phase + adversarial over the three MRDs and the waveform disc (+ slm
through the frozen WavLM; + the MagPhase "mag" and "phase" terms against
the target STFT at the head's resolution when the generator emits its
log-amplitude and phase, the ringformer), combined by the loss-normalised
``backwards_loss``; AdamW on the two trained modules; then a discriminator
step on the detached outputs, its loss scaled by sqrt(B): the sampled MRD
and the waveform disc are updated at lr x their gap-aware multiplier
(read from the EMAs before the step); the MRDs not sampled take no AdamW
step at all (weights, moments and step count untouched). With
``sampled_mrd_only`` (the default) only the sampled MRD runs and only its
EMA moves; without it all three run and their EMAs move.

textual: the pitch style encoder and the pitch/energy predictor (dropout
on) predict F0 and energy, which drive the frozen speech predictor (eval
mode: no dropout, no decoder smoothing; its sine source still draws from
the model generator, as the JAX ``training=False, rng=r_model`` call does)
and the frozen ``pitch_disc``; the loss is mel spectral convergence +
adversarial + the curves' smooth-L1; gradients reach the predicted curves
through the frozen modules' activations, never their weights. Then the
``pitch_disc`` step on the detached curves (F0 masked by the ground
truth's voicing at 10 Hz).

Every stage updates each trained module and discriminator
through the nonfinite guard, and only the stage's trained modules hold
``requires_grad`` during its generator phase.

Precision: with ``mixed_precision`` each generator phase runs under bf16
autocast on the card (master weights and AdamW float32); the DSP, the
generator head's atan2/exp, the WavLM logits and resampler, the predicted
curves and durations, and the losses stay float32; the acoustic
discriminators run in bf16 only when ``generator.remat`` is set too (the
JAX ``disc_dtype`` rule), the pitch and duration discriminators always in
float32 (as the JAX steps run them). ``generator.remat`` also
rematerialises the generator's ConvNeXt blocks and the MRD and waveform
disc forwards in the backward (``models/common.py`` ``remat_call``).

The JAX key's per-step splits become the state's generators; the
``parity_deterministic`` / ``parity_prior`` / ``forced_disc_index``
switches are the JAX package's.

"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import losses as L
from ..dsp.mel import MelSpectrogram
from ..dsp.multi_spectrogram import MultiSpectrogram
from ..dsp.stft import fp32_island, stft
from ..models.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS
from ..ops.duration import DurationProcessor
from .optim import (
    DISC_SUB_COUNT,
    apply_module_update,
    cosine_lr,
    modules_finite,
    update_disc_ema,
)
from .state import StageTrainState


class Batch(NamedTuple):
    """One fixed-shape (bucketed) training batch, numpy or torch."""

    audio_gt: object  # (B, S) float32, S = frames*hop
    text: object  # (B, L) int32
    text_lengths: object  # (B,)
    pitch: object  # (B, F) float32 F0 Hz
    durations: object  # (B, L) int32 frames per token
    slm_gt: Optional[object] = None


def batch_to_device(batch: Batch, device) -> Batch:
    return Batch(*(
        None if x is None else torch.as_tensor(np.asarray(x)).to(device)
        for x in batch
    ))


class StepContext:
    """Static step-construction context: the JAX ``StepContext``
    (normalization, the mel transforms, the multi-resolution spectrogram,
    the duration processor, blank id, LR schedule constants, precision and
    the parity switches). ``slm_loss_fn`` (WavLM, target, prediction) ->
    scalar is set when the slm term is on; the WavLM rides the state."""

    def __init__(self, model_config, loss_weights, normalization,
                 stage_steps: int = 10_000, base_lr: float = 1e-4,
                 slm_loss_fn=None, mixed_precision: bool = False,
                 parity_deterministic: bool = False, parity_prior=None,
                 sampled_mrd_only: bool = True,
                 forced_disc_index: Optional[int] = None):
        # parity_deterministic: no dropout, no decoder smoothing, a
        # deterministic sine source; parity_prior: an injected excitation;
        # forced_disc_index: a fixed MRD. For holding the step against the
        # JAX package; never used in production training.
        self.parity_deterministic = parity_deterministic
        self.parity_prior = parity_prior
        self.sampled_mrd_only = sampled_mrd_only
        self.forced_disc_index = forced_disc_index
        self.slm_loss_fn = slm_loss_fn
        self.mixed_precision = mixed_precision
        # the benchmark's control: a context that replaces the generator
        # phases' bf16 autocast (``generator_precision``)
        self.generator_mode = None
        self.disc_bf16 = mixed_precision and model_config.generator.remat
        mc = model_config
        self.mc = mc
        self.weights = loss_weights
        self.norm = normalization
        self.stage_steps = stage_steps
        self.base_lr = base_lr
        self.to_mel = MelSpectrogram(
            n_mels=mc.n_mels, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length, sample_rate=mc.sample_rate,
        )
        se = mc.style_encoder
        self.to_style_mel = MelSpectrogram(
            n_mels=se.n_mels, n_fft=se.n_fft, win_length=se.win_length,
            hop_length=se.hop_length, sample_rate=mc.sample_rate,
        )
        self.multi_spec = MultiSpectrogram(sample_rate=mc.sample_rate)
        self.duration_processor = DurationProcessor(
            mc.duration_predictor.duration_classes, mc.duration_predictor.max_duration)

    def norm_mel(self, audio, transform):
        mel = transform(audio)
        mel = (torch.log(1e-5 + mel) - self.norm.mel_log_mean) / self.norm.mel_log_std
        frames = mel.shape[-1] - (mel.shape[-1] % 2)
        return mel[:, :, :frames]

    def energy_from_mel(self, mel):
        """log L2 norm over the mel bins of the denormalized mel."""
        denorm = torch.exp(mel * self.norm.mel_log_std + self.norm.mel_log_mean)
        return torch.log(torch.linalg.vector_norm(denorm, dim=1) + 1e-9)

    def generator_precision(self, device: torch.device):
        """The generator phases' precision: bf16 autocast with mixed
        precision, or the context of ``generator_mode`` where it is set."""
        if self.generator_mode is not None:
            return self.generator_mode(device)
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.mixed_precision)

    def disc_autocast(self, device: torch.device):
        """The discriminators' precision (the JAX ``disc_dtype``): bf16 only
        with mixed precision and ``generator.remat``, float32 otherwise,
        whatever the enclosing autocast."""
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=self.disc_bf16)


# ==========================================================================
# Acoustic stage
# ==========================================================================


def _acoustic_features(ctx: StepContext, batch: Batch):
    """(mel, style_mel, energy, pitch, alignment, frames) of the batch, no
    gradient."""
    with torch.no_grad():
        mel = ctx.norm_mel(batch.audio_gt, ctx.to_mel)
        style_mel = ctx.norm_mel(batch.audio_gt, ctx.to_style_mel)
        energy = ctx.energy_from_mel(mel)
        frames = mel.shape[-1]
        pitch = batch.pitch[:, :frames].to(torch.float32)
        alignment = ctx.duration_processor.duration_to_alignment(batch.durations, frames)
    return mel, style_mel, energy, pitch, alignment, frames


def _adv_generator_metrics(ctx, models, feats_t, feats_p, audio_t, audio_p):
    """Generator-side adversarial loss over the 3 MRDs + the waveform disc
    (whose parameters the caller has frozen)."""
    total = 0.0
    with ctx.disc_autocast(audio_p.device):
        for i in range(3):
            mrd = models[f"mrd{i}"]
            total = total + L.generator_pair_loss(mrd(feats_t.fft_mag[i]),
                                                  mrd(feats_p.fft_mag[i]))
        disc = models["disc"]
        total = total + L.DISC_AUDIO_WEIGHT * L.generator_pair_loss(disc(audio_t),
                                                                     disc(audio_p))
    return total


def _generator_phase_grads(state: StageTrainState, stage: str) -> None:
    """Only the modules ``stage`` trains form weight gradients; their old
    ones are cleared."""
    trained = STAGE_TRAIN_MODELS[stage]
    for name, module in state.models.items():
        module.requires_grad_(name in trained)
    for name in trained:
        state.optimizers[name].zero_grad(set_to_none=True)


def _update_trained(state: StageTrainState, stage: str, lr: float) -> None:
    """AdamW on the modules ``stage`` trains, each through the nonfinite
    guard (one host sync)."""
    names = STAGE_TRAIN_MODELS[stage]
    flags = modules_finite([state.models[n] for n in names])
    for name, flag in zip(names, flags):
        apply_module_update(state.models[name], state.optimizers[name], lr, finite=flag)


def _begin_disc_phase(state: StageTrainState, stage: str) -> None:
    for name in STAGE_DISCRIMINATORS[stage]:
        state.models[name].requires_grad_(True)
        state.optimizers[name].zero_grad(set_to_none=True)


def _update_discriminators(state: StageTrainState, stage: str, total, raws, stepped,
                           lr: float, sqrt_b: float) -> dict:
    """Backward of the discriminator loss ``total`` x sqrt(B); AdamW on the
    ``stepped`` discriminators at lr x their gap-aware multiplier, read from
    the EMAs before the step (host syncs: their finite flags, then the raw
    LSGAN terms ``raws`` that move the EMAs). Returns the multipliers
    of every discriminator of ``stage`` as ``<name>_lr_mult``."""
    (total * sqrt_b).backward()
    lr_mults = {f"{name}_lr_mult": float(L.disc_lr_multiplier(state.disc_ema[name],
                                                              DISC_SUB_COUNT[name]))
                for name in STAGE_DISCRIMINATORS[stage]}
    raw_names = sorted(raws)
    flags = modules_finite([state.models[n] for n in stepped])
    host = torch.stack([raws[n].detach() for n in raw_names]).cpu()
    for name, flag in zip(stepped, flags):
        apply_module_update(state.models[name], state.optimizers[name],
                            lr * lr_mults[f"{name}_lr_mult"], finite=flag)
    for name, raw in zip(raw_names, host):
        state.disc_ema[name] = update_disc_ema(state.disc_ema[name], raw)
    return lr_mults


def _disc_phase_mrd(ctx, state: StageTrainState, feats_t_fft, pred_fft_detached,
                    audio_t, audio_p_detached, disc_index: int, lr: float,
                    sqrt_b: float):
    """Discriminator step on the detached generator outputs; returns
    (d_loss, lr_mults). Updates the sampled MRD and the waveform disc."""
    models = state.models
    active = [disc_index] if ctx.sampled_mrd_only else [0, 1, 2]
    _begin_disc_phase(state, "acoustic")
    total = 0.0
    raws = {}
    with ctx.disc_autocast(audio_t.device):
        for i in active:
            mrd = models[f"mrd{i}"]
            pair, raws[f"mrd{i}"] = L.discriminator_pair_loss(
                mrd(feats_t_fft[i]), mrd(pred_fft_detached[i]))
            total = total + pair
        disc = models["disc"]
        pair, raws["disc"] = L.discriminator_pair_loss(disc(audio_t), disc(audio_p_detached))
        total = total + L.DISC_AUDIO_WEIGHT * pair
    lr_mults = _update_discriminators(state, "acoustic", total, raws,
                                      [f"mrd{disc_index}", "disc"], lr, sqrt_b)
    return total.detach(), lr_mults


def _prosody_disc_phase(state: StageTrainState, stage: str, real, fake_detached,
                        lr: float, sqrt_b: float):
    """The textual / duration discriminator step (float32); returns
    (d_loss, lr_mults)."""
    name, = STAGE_DISCRIMINATORS[stage]
    disc = state.models[name]
    _begin_disc_phase(state, stage)
    pair, raw = L.discriminator_pair_loss(disc(real), disc(fake_detached))
    lr_mults = _update_discriminators(state, stage, pair, {name: raw}, [name], lr, sqrt_b)
    return pair.detach(), lr_mults


@fp32_island
def _magphase_metrics(ctx: StepContext, pred, audio_t) -> dict:
    """The MagPhase terms of a generator that emits its head's
    log-amplitude and phase, against the target STFT at the head's
    n_fft / hop, both cut to the common frame count (float32)."""
    gc = ctx.mc.generator
    with torch.no_grad():
        t_real, t_imag = stft(audio_t, gc.gen_istft_n_fft, gc.gen_istft_hop_size,
                              gc.gen_istft_n_fft)
    n = min(pred.magnitude.shape[-1], t_real.shape[-1])
    return L.magphase_loss(pred.magnitude[:, :, :n], pred.phase[:, :, :n],
                           t_real[:, :, :n], t_imag[:, :, :n])


def make_acoustic_step(ctx: StepContext):
    """(state, batch on the state's device) -> metrics; updates ``state``
    in place. Metrics: device scalars ``mel``, ``multi_phase``,
    ``generator``, ``mag`` and ``phase`` (ringformer), ``slm`` (when on) and
    ``discriminator``; floats ``lr`` and ``<disc>_lr_mult``."""

    def step(state: StageTrainState, batch: Batch):
        models = state.models
        sp, se = models["speech_predictor"], models["speech_style_encoder"]
        device = batch.audio_gt.device
        mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
        with torch.no_grad():
            audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length].to(torch.float32)
            feats_t = ctx.multi_spec(audio_t)
        if ctx.forced_disc_index is not None:
            disc_index = int(ctx.forced_disc_index)
        else:
            disc_index = int(torch.randint(3, (1,), generator=state.disc_index_generator))
        sqrt_b = math.sqrt(batch.text.shape[0])
        lr = cosine_lr(ctx.base_lr, state.step, ctx.stage_steps)

        # --- generator phase; the discriminators are frozen ---
        training = not ctx.parity_deterministic
        sp.train(training)
        se.train(training)
        _generator_phase_grads(state, "acoustic")
        with ctx.generator_precision(device):
            style = se(style_mel)
            voiced = (pitch > 20.0).to(torch.float32)
            pred = sp(
                batch.text, batch.text_lengths, alignment, pitch, energy, voiced, style,
                pitch, generator=state.model_generator if training else None,
                prior=ctx.parity_prior, deterministic_prior=ctx.parity_deterministic,
                dropout_generator=state.dropout_generator,
            )
            pred_audio = pred.audio.float()
            feats_p = ctx.multi_spec(pred_audio)
            metrics = {
                "mel": L.spectral_convergence_loss(feats_t.mel, feats_p.mel),
                "multi_phase": L.multi_phase_loss(feats_p.phase, feats_t.phase),
                "generator": _adv_generator_metrics(ctx, models, feats_t, feats_p,
                                                    audio_t, pred_audio),
            }
            if pred.magnitude is not None:
                metrics.update(_magphase_metrics(ctx, pred, audio_t))
            if ctx.slm_loss_fn is not None:
                metrics["slm"] = ctx.slm_loss_fn(state.wavlm, audio_t, pred_audio)
        L.backwards_loss(metrics, ctx.weights).backward()
        _update_trained(state, "acoustic", lr)

        # --- discriminator phase on the detached outputs ---
        d_loss, lr_mults = _disc_phase_mrd(
            ctx, state, feats_t.fft_mag, [f.detach() for f in feats_p.fft_mag],
            audio_t, pred_audio.detach(), disc_index, lr, sqrt_b,
        )
        state.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["discriminator"] = d_loss
        out["lr"] = lr
        out.update(lr_mults)
        return out

    return step


# ==========================================================================
# Textual and duration stages
# ==========================================================================


def make_textual_step(ctx: StepContext):
    """(state, batch on the state's device) -> metrics; updates ``state``
    in place. Metrics: device scalars ``mel``, ``generator``, ``pitch``,
    ``energy`` and ``discriminator``; floats ``lr`` and
    ``pitch_disc_lr_mult``."""

    def step(state: StageTrainState, batch: Batch):
        models = state.models
        pe, pse = models["pitch_energy_predictor"], models["pe_style_encoder"]
        sp, se = models["speech_predictor"], models["speech_style_encoder"]
        pitch_disc = models["pitch_disc"]
        device = batch.audio_gt.device
        mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
        with torch.no_grad():
            audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length].to(torch.float32)
            feats_t = ctx.multi_spec(audio_t)
            voiced = (pitch > 10.0).to(torch.float32)
            pitchcat = torch.stack([pitch * voiced, energy], dim=1)
        sqrt_b = math.sqrt(batch.text.shape[0])
        lr = cosine_lr(ctx.base_lr, state.step, ctx.stage_steps)

        # --- generator phase; the acoustic modules and pitch_disc frozen ---
        training = not ctx.parity_deterministic
        pe.train(training)
        pse.train(training)
        sp.eval()
        se.eval()
        _generator_phase_grads(state, "textual")
        with ctx.generator_precision(device):
            pe_style = pse(style_mel, pitch, energy)
            pred_pitch, pred_energy = pe(batch.text, batch.text_lengths, alignment,
                                         pe_style, generator=state.dropout_generator)
            pred_pitch, pred_energy = pred_pitch.float(), pred_energy.float()
            pred = sp(
                batch.text, batch.text_lengths, alignment, pred_pitch, pred_energy,
                (pred_pitch > 20.0).to(torch.float32), se(style_mel), pred_pitch,
                generator=None if ctx.parity_deterministic else state.model_generator,
                prior=ctx.parity_prior, deterministic_prior=ctx.parity_deterministic,
            )
            feats_p = ctx.multi_spec(pred.audio.float())
        pred_pitchcat = torch.stack([pred_pitch * voiced, pred_energy], dim=1)
        metrics = {
            "mel": L.spectral_convergence_loss(feats_t.mel, feats_p.mel),
            "generator": L.generator_pair_loss(pitch_disc(pitchcat),
                                               pitch_disc(pred_pitchcat)),
            **L.pitch_energy_losses(pred_pitch, pitch, pred_energy, energy),
        }
        L.backwards_loss(metrics, ctx.weights).backward()
        _update_trained(state, "textual", lr)

        d_loss, lr_mults = _prosody_disc_phase(state, "textual", pitchcat,
                                               pred_pitchcat.detach(), lr, sqrt_b)
        state.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["discriminator"] = d_loss
        out["lr"] = lr
        out.update(lr_mults)
        return out

    return step
