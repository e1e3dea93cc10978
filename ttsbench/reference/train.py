"""The reference of a training stage's first steps, and the weights both
sides start from.

``make_weights`` builds every module of the configuration with the
reference's constructors on the device, seeded, so both sides start from
the same weights that neither side's own code made for it. ``load_batch``
assembles a batch from the corpus files as the program's loader should.
``run_steps`` runs the stage's step on those batches from those weights
and returns the readings that ``ttsbench.checks`` compares.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional

import numpy as np
import torch
from scipy.io import wavfile
from safetensors.numpy import load_file

from . import precision
from .stts.config import Config, ModelConfig
from .stts.data.collate import collate_batch
from .stts.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS, build_models
from .stts.models.slm import random_wavlm, wavlm_loss
from .stts.text import TextCleaner
from .stts.trainer.normalization import NormalizationStats
from .stts.trainer.state import create_stage_train_state
from .stts.trainer.steps import (
    Batch,
    StepContext,
    make_acoustic_step,
    make_textual_step,
)

STEPS = {"acoustic": make_acoustic_step, "textual": make_textual_step}


def model_config(model: dict) -> ModelConfig:
    return ModelConfig.model_validate(model)


def loss_weights() -> dict:
    return Config().loss_weight.model_dump()


def make_models(model: dict, device, seed: int, f0_bias_hz: float,
                with_wavlm: bool, duration_head: Optional[dict] = None) -> tuple:
    """(every module of ``build_models`` by name, the frozen WavLM or None),
    built with the reference's constructors on ``device`` from ``seed``.
    ``duration_head`` ({"weight_scale", "bias"}) scales the duration head's
    projection and sets its bias."""
    mc = model_config(model)
    with torch.device(device):
        torch.manual_seed(seed)
        models = build_models(mc)
        with torch.no_grad():
            # a voice's F0 out of the random pitch head, so that the harmonic
            # source runs its harmonics
            models["pitch_energy_predictor"].f0_proj.bias.fill_(f0_bias_hz)
            # a voice's pace out of the random duration head (its ordinal
            # logits peak where the bias's cumulative sum crosses zero), so
            # that every seed's lines last as long
            if duration_head:
                proj = models["duration_predictor"].duration_proj
                proj.weight.mul_(duration_head["weight_scale"])
                proj.bias.copy_(torch.tensor(duration_head["bias"]))
        wavlm = random_wavlm(seed).eval().requires_grad_(False) if with_wavlm else None
    return models, wavlm


def make_weights(model: dict, device, seed: int, f0_bias_hz: float,
                 with_wavlm: bool, duration_head: Optional[dict] = None) -> tuple:
    """(state dict of each module of ``build_models``, WavLM state dict or
    None): the weights both sides start from."""
    models, wavlm = make_models(model, device, seed, f0_bias_hz, with_wavlm,
                                duration_head)
    return ({k: m.state_dict() for k, m in models.items()},
            None if wavlm is None else wavlm.state_dict())


def trained_modules(stage: str) -> tuple:
    """The modules a stage's step updates: its trained modules and its
    discriminators."""
    return STAGE_TRAIN_MODELS[stage] + STAGE_DISCRIMINATORS[stage]


def read_clip(path: str) -> np.ndarray:
    sr, data = wavfile.read(path)
    if data.dtype != np.int16:
        raise ValueError(f"{path}: the corpus is 16-bit PCM")
    return data.astype(np.float32) / 32768.0


def load_batch(corpus: dict, idxs: List[int], mc: ModelConfig) -> Batch:
    """The batch of corpus rows ``idxs``: each clip centre-padded to its
    0.25 s bin, tokens, the cached pitch and durations, collated."""
    cleaner = TextCleaner(mc.symbol)
    pitch = load_file(corpus["pitch"])
    align = load_file(corpus["alignment"])
    coarse = mc.hop_length * mc.coarse_multiplier
    items = []
    for i in idxs:
        name, phonemes = corpus["names"][i], corpus["phonemes"][i]
        audio = read_clip(osp.join(corpus["wav_dir"], name))
        frames = audio.shape[0] // coarse
        total = (((frames - 20) // 20) * 20 + 60) * coarse
        start = (total - audio.shape[0]) // 2
        audio = np.pad(audio, (start, total - audio.shape[0] - start))
        items.append({"audio": audio, "tokens": np.asarray(cleaner(phonemes), np.int32),
                      "pitch": np.asarray(pitch[name], np.float32),
                      "durations": np.asarray(align[name][0], np.float32),
                      "slm": None, "path": name})
    batch, _ = collate_batch(items, hop_length=mc.hop_length, require_pitch=True)
    return batch


def to_device(batch: Batch, device) -> Batch:
    return Batch(*(None if x is None else torch.as_tensor(np.asarray(x)).to(device)
                   for x in batch))


def build_state(stage: str, model: dict, device, seed: int, f0_bias_hz: float,
                state_seed: int):
    models, wavlm = make_models(model, device, seed, f0_bias_hz,
                                with_wavlm=stage == "acoustic")
    state = create_stage_train_state(models, device, stage, seed=state_seed)
    state.wavlm = wavlm
    return model_config(model), state


def make_context(stage: str, mc: ModelConfig, training: dict) -> StepContext:
    return StepContext(mc, loss_weights(), NormalizationStats(),
                       stage_steps=training["stage_steps"], base_lr=training["lr"],
                       slm_loss_fn=wavlm_loss if stage == "acoustic" else None,
                       mixed_precision=False)


def run_steps(stage: str, model: dict, training: dict, seed: int, f0_bias_hz: float,
              corpus: dict, batches: List[List[int]], device, control: bool = False,
              flops_disc_indices: Optional[List[int]] = None) -> dict:
    """The stage's first ``len(batches)`` steps from the seed's weights (the
    state's generators seeded with ``training["state_seed"]``), in
    float32 with TF32 off (``control``: TF32 on and the generator phases at
    e4m3 inputs under bf16 autocast). Returns the readings that
    ``ttsbench.checks.training_numbers`` compares; with ``flops_disc_indices``, also
    the FLOPs of one more step for each of those MRD indices (``None`` for a
    stage without them), as ``flops``."""
    from ttsbench import checks
    from ttsbench.flops import count_flops

    device = torch.device(device)
    ctx_precision = precision.tf32() if control else precision.exact()
    with ctx_precision:
        mc, state = build_state(stage, model, device, seed, f0_bias_hz,
                                training["state_seed"])
        ctx = make_context(stage, mc, training)
        if control:
            ctx.generator_mode = precision.fp8_autocast
        step = STEPS[stage](ctx)
        start = checks.leaf_snapshot(state.models, trained_modules(stage))
        losses, grads = [], None
        first = checks.FirstCalls(checks.first_step_modules(state.models, stage))
        for i, idxs in enumerate(batches):
            batch = to_device(load_batch(corpus, idxs, mc), device)
            metrics = step(state, batch)
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                grads = checks.first_grad_norms(state, trained_modules(stage))
                first.close()
        readings = {"losses": losses, "grads": grads, "first_calls": first.outputs,
                    "changes": checks.change_norms(state, trained_modules(stage), start)}
        if flops_disc_indices is not None:
            readings["flops"] = {}
            for k in flops_disc_indices:
                ctx.forced_disc_index = k
                readings["flops"][k] = count_flops(lambda: step(state, batch))
    return readings
