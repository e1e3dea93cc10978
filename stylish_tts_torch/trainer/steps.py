"""Train steps: the alignment, acoustic, textual and duration stages of
``stylish_tts_tpu/trainer/steps.py``.

alignment: log-mel of the batch audio -> TextAligner (with dropout) ->
CTC with label priors (scale 0.3) through the CUDA kernels on the card
(the plain version on the CPU) -> AdamW with the nonfinite guard; the
label priors accumulate from the detached posteriors and are refreshed
at each epoch's end.

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

duration: the duration style encoder and predictor (dropout on) give
class logits; the loss is the smooth-L1 of the expected durations, the
class-weighted cross entropy and the adversarial loss of the frozen
``dur_disc``; then the ``dur_disc`` step.

Every stage but alignment updates each trained module and discriminator
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

The first optimizer update of a step sets ``state.update_begun``: an
out-of-memory failure after it leaves a partly updated state, which the
loop does not carry on from.

The JAX key's per-step splits become the state's generators; the
``parity_deterministic`` / ``parity_prior`` / ``forced_disc_index``
switches are the JAX package's.

Data parallel (``parallel``): each rank holds its rows of the global batch;
the losses take their batch-wide statistics over the global batch (see
``losses.py``; the CTC mean, the slm term and the raw LSGAN terms that move
the discriminator EMAs included), the discriminator loss is scaled by the
square root of the global B, the label priors merge by log-sum-exp and
their counts by sum, and ``pmean_grads`` averages the gradients after every
backward and before the nonfinite guard, so that every rank takes the same
update and skips the same one. The sampled MRD is drawn alike on every rank
and checked equal. At world size 1 all of this is the identity.

Spans (``utils/trace.py``), each with the step number: ``train.step``
around every stage's step; in the acoustic and textual steps
``train.features``, ``train.gen.forward`` and ``train.gen.backward``; in
those and the duration step ``train.gen.update``, ``train.disc.forward``,
``train.disc.backward`` and ``train.disc.update``; and a
``train.sync.<what>`` span at each host read:
``finite`` (the nonfinite guard's flags, ``optim.modules_finite``),
``lr_mult`` (a discriminator's gap-aware multiplier, from the host's EMAs:
no device sync) and ``ema`` (the raw LSGAN terms that move the EMAs).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import losses as L
from .. import parallel
from ..dsp.mel import MelSpectrogram
from ..dsp.multi_spectrogram import MultiSpectrogram
from ..dsp.stft import fp32_island, stft
from ..models.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS
from ..ops import ctc as ctc_ops
from ..ops.ctc_cuda import ctc_loss_with_priors_cuda
from ..ops.duration import DurationProcessor
from ..utils.trace import span
from .optim import (
    DISC_SUB_COUNT,
    apply_module_update,
    cosine_lr,
    modules_finite,
    update_disc_ema,
)
from .state import StageTrainState, TrainState

PRIOR_SCALE = 0.3


def _traced(step):
    """``step`` inside the span ``train.step`` of its step number."""

    def traced(state, batch):
        with span("train.step", state.step):
            return step(state, batch)

    return traced


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
        self.disc_bf16 = mixed_precision and model_config.generator.remat
        mc = model_config
        self.mc = mc
        self.weights = loss_weights
        self.norm = normalization
        self.stage_steps = stage_steps
        self.base_lr = base_lr
        self.to_align_mel = MelSpectrogram(
            n_mels=mc.text_aligner.n_mels, n_fft=mc.text_aligner.n_fft,
            win_length=mc.text_aligner.win_length,
            hop_length=mc.hop_length * mc.coarse_multiplier,
            sample_rate=mc.sample_rate,
        )
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
        self.blank_id = mc.text_encoder.tokens

    def norm_mel(self, audio, transform):
        mel = transform(audio)
        mel = (torch.log(1e-5 + mel) - self.norm.mel_log_mean) / self.norm.mel_log_std
        frames = mel.shape[-1] - (mel.shape[-1] % 2)
        return mel[:, :, :frames]

    def energy_from_mel(self, mel):
        """log L2 norm over the mel bins of the denormalized mel."""
        denorm = torch.exp(mel * self.norm.mel_log_std + self.norm.mel_log_mean)
        return torch.log(torch.linalg.vector_norm(denorm, dim=1) + 1e-9)

    def disc_autocast(self, device: torch.device):
        """The discriminators' precision (the JAX ``disc_dtype``): bf16 only
        with mixed precision and ``generator.remat``, float32 otherwise,
        whatever the enclosing autocast."""
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=self.disc_bf16)


def make_alignment_step(ctx: StepContext):
    """(state, batch on the state's device) -> metrics; updates ``state``
    in place."""

    def step(state: TrainState, batch: Batch):
        aligner = state.aligner
        with torch.no_grad():
            mel = ctx.norm_mel(batch.audio_gt, ctx.to_align_mel)
            mel = mel.transpose(1, 2).contiguous()  # (B, F, 80)
        frames = mel.shape[1]
        mel_lengths = torch.full((mel.shape[0],), frames, dtype=torch.int32,
                                 device=mel.device)

        aligner.train()
        log_probs = aligner(mel, mel_lengths, generator=state.generator)
        loss = parallel.global_mean(ctc_loss_with_priors_cuda(
            log_probs, mel_lengths, batch.text.to(torch.int32).contiguous(),
            batch.text_lengths.to(torch.int32).contiguous(),
            blank_id=ctx.blank_id, log_priors=state.log_priors,
            prior_scale=PRIOR_SCALE,
        )) * ctx.weights.get("align_loss", 1.0)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        parallel.pmean_grads([aligner])
        lr = cosine_lr(ctx.base_lr, state.step, ctx.stage_steps)
        state.update_begun = True
        apply_module_update(aligner, state.optimizer, lr)

        # label-prior accumulation (logsumexp-merge; across the ranks too)
        with torch.no_grad():
            lse, count = ctc_ops.accumulate_label_priors(
                log_probs.detach(), mel_lengths
            )
            if parallel.world_size() > 1:
                lse = torch.logsumexp(parallel.gather_rows(lse[None]), dim=0)
                count = parallel.global_count(count)
            state.log_priors_sum = torch.logaddexp(state.log_priors_sum, lse)
            state.prior_count = state.prior_count + count
        state.step += 1
        return {"align_loss": loss.detach(), "lr": lr}

    return _traced(step)


def finish_alignment_epoch(ctx: StepContext, state: TrainState) -> TrainState:
    """End-of-epoch label-prior update."""
    state.log_priors = ctc_ops.update_log_priors(
        state.log_priors_sum, state.prior_count
    )
    state.log_priors_sum = torch.full_like(state.log_priors_sum, -1e30)
    state.prior_count = torch.zeros_like(state.prior_count)
    return state


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
    """AdamW on the modules ``stage`` trains, their gradients averaged over
    the ranks, each through the nonfinite guard (one host sync): the step's
    first optimizer update."""
    names = STAGE_TRAIN_MODELS[stage]
    with span("train.gen.update"):
        parallel.pmean_grads([state.models[n] for n in names])
        state.update_begun = True
        flags = modules_finite([state.models[n] for n in names])
        for name, flag in zip(names, flags):
            apply_module_update(state.models[name], state.optimizers[name], lr,
                                finite=flag)


def _begin_disc_phase(state: StageTrainState, stage: str) -> None:
    for name in STAGE_DISCRIMINATORS[stage]:
        state.models[name].requires_grad_(True)
        state.optimizers[name].zero_grad(set_to_none=True)


def _update_discriminators(state: StageTrainState, stage: str, total, raws, stepped,
                           lr: float, sqrt_b: float) -> dict:
    """Backward of the discriminator loss ``total`` x sqrt(B); AdamW on the
    ``stepped`` discriminators (their gradients averaged over the ranks) at
    lr x their gap-aware multiplier, read from the EMAs before the step (host
    syncs: their finite flags, then the raw LSGAN terms ``raws``, global-batch
    means alike on every rank, that move the EMAs). Returns the multipliers
    of every discriminator of ``stage`` as ``<name>_lr_mult``."""
    with span("train.disc.backward"):
        (total * sqrt_b).backward()
        parallel.pmean_grads([state.models[n] for n in stepped])
    with span("train.disc.update"):
        lr_mults = {}
        for name in STAGE_DISCRIMINATORS[stage]:
            with span("train.sync.lr_mult"):
                lr_mults[f"{name}_lr_mult"] = float(L.disc_lr_multiplier(
                    state.disc_ema[name], DISC_SUB_COUNT[name]))
        raw_names = sorted(raws)
        flags = modules_finite([state.models[n] for n in stepped])
        with span("train.sync.ema"):
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
    with span("train.disc.forward"), ctx.disc_autocast(audio_t.device):
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
    with span("train.disc.forward"):
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
        with span("train.features"):
            mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
            with torch.no_grad():
                audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length].to(torch.float32)
                feats_t = ctx.multi_spec(audio_t)
        if ctx.forced_disc_index is not None:
            disc_index = int(ctx.forced_disc_index)
        else:
            disc_index = int(torch.randint(3, (1,), generator=state.disc_index_generator))
            parallel.check_same("disc_index", disc_index)
        sqrt_b = math.sqrt(batch.text.shape[0] * parallel.world_size())
        lr = cosine_lr(ctx.base_lr, state.step, ctx.stage_steps)

        # --- generator phase; the discriminators are frozen ---
        training = not ctx.parity_deterministic
        sp.train(training)
        se.train(training)
        _generator_phase_grads(state, "acoustic")
        with span("train.gen.forward"), torch.autocast(device.type, dtype=torch.bfloat16,
                                                        enabled=ctx.mixed_precision):
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
                if batch.slm_gt is not None:
                    from ..models.slm import wavlm_loss_cached

                    slm = wavlm_loss_cached(state.wavlm, batch.slm_gt, pred_audio)
                else:
                    slm = ctx.slm_loss_fn(state.wavlm, audio_t, pred_audio)
                metrics["slm"] = parallel.global_mean(slm)
        with span("train.gen.backward"):
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

    return _traced(step)


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
        with span("train.features"):
            mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
            with torch.no_grad():
                audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length].to(torch.float32)
                feats_t = ctx.multi_spec(audio_t)
                voiced = (pitch > 10.0).to(torch.float32)
                pitchcat = torch.stack([pitch * voiced, energy], dim=1)
        sqrt_b = math.sqrt(batch.text.shape[0] * parallel.world_size())
        lr = cosine_lr(ctx.base_lr, state.step, ctx.stage_steps)

        # --- generator phase; the acoustic modules and pitch_disc frozen ---
        training = not ctx.parity_deterministic
        pe.train(training)
        pse.train(training)
        sp.eval()
        se.eval()
        _generator_phase_grads(state, "textual")
        with span("train.gen.forward"):
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=ctx.mixed_precision):
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
        with span("train.gen.backward"):
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

    return _traced(step)


def make_duration_step(ctx: StepContext, duration_class_weights: torch.Tensor):
    """(state, batch on the state's device) -> metrics; updates ``state``
    in place. ``duration_class_weights`` (classes,) weigh the cross entropy
    (the trainer passes sqrt of the train split's inverse class
    frequencies). Metrics: device scalars ``duration``, ``duration_ce``,
    ``generator`` and ``discriminator``; floats ``lr`` and
    ``dur_disc_lr_mult``."""

    def step(state: StageTrainState, batch: Batch):
        models = state.models
        dp, dse = models["duration_predictor"], models["duration_style_encoder"]
        dur_disc = models["dur_disc"]
        device = batch.audio_gt.device
        with torch.no_grad():
            style_mel = ctx.norm_mel(batch.audio_gt, ctx.to_style_mel)
            target_dur = batch.durations.to(torch.float32)
            targets = ctx.duration_processor.dur_to_class(batch.durations)
        sqrt_b = math.sqrt(batch.text.shape[0] * parallel.world_size())
        lr = cosine_lr(ctx.base_lr, state.step, ctx.stage_steps)

        training = not ctx.parity_deterministic
        dp.train(training)
        dse.train(training)
        _generator_phase_grads(state, "duration")
        with torch.autocast(device.type, dtype=torch.bfloat16,
                            enabled=ctx.mixed_precision):
            duration_raw = dp(batch.text, batch.text_lengths, dse(style_mel),
                              generator=state.dropout_generator).float()
        duration = ctx.duration_processor.prediction_to_duration(duration_raw,
                                                                 batch.text_lengths)
        metrics = {
            "duration": L.masked_smooth_l1_per_sequence(duration, target_dur,
                                                        batch.text_lengths),
            "duration_ce": L.duration_ce_loss(duration_raw, targets, batch.text_lengths,
                                              duration_class_weights),
            "generator": L.generator_pair_loss(dur_disc(target_dur[:, None]),
                                               dur_disc(duration[:, None])),
        }
        L.backwards_loss(metrics, ctx.weights).backward()
        _update_trained(state, "duration", lr)

        d_loss, lr_mults = _prosody_disc_phase(state, "duration", target_dur[:, None],
                                               duration.detach()[:, None], lr, sqrt_b)
        state.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["discriminator"] = d_loss
        out["lr"] = lr
        out.update(lr_mults)
        return out

    return _traced(step)
