"""One acoustic step of a ringformer model against the JAX package's
``make_acoustic_step`` (the textual step: tests/test_torch_ringformer_textual.py,
with the helpers of this file).

Both sides start from the same weights (flax values from a seed, moved
with the bridge) at ``small_model_config()`` with ``generator.type:
ringformer`` (``upsample_initial_channel`` 64, rates (4, 5), iSTFT n_fft
60 / hop 15, as tests/test_models.py), one conformer block per scale and
one resblock kernel (3, dilations 1, 3, 5): the JAX step's CPU compile
takes ~5 minutes at the default two blocks and three kernels and ~2 at
these; the full generator is held in tests/test_torch_ringformer.py. In
float32, one step on the same batch (numpy, from a seed) with the parity
switches: no dropout or smoothing, a fixed MRD, and an injected broadband
excitation. The JAX speech predictor drops ``prior`` for the ringformer
and draws its pcph prior from its key; these tests patch
``stylish_tts_tpu.models.ringformer.generate_pcph`` to return the same
excitation while the step traces (the JAX package is not changed). The
``conv_post`` kernel is scaled by 0.1, as in tests/test_torch_ringformer.py:
at seeded N(0, 1/fan_in) weights the head's log-amplitude reaches 17 and
the tanh of its audio saturates, so the few unsaturated samples carry the
whole gradient and float32 round-off moves it by 0.5 %.

Tolerances: every metric (with the ringformer's ``mag`` and ``phase``)
rtol 1e-4 (measured ~2e-7); the step's gradients of the trained modules
(AdamW's first moments after it, (1 - beta1) g) within 1e-3 of JAX's
(relative L2; measured 2e-5 to 6e-5); after the step no element of a
trained module off by more than AdamW moves it in one step (2 x 4 lr),
and the trained modules' weights within 0.05 of their move (L2; measured
0.027 and 0.0075), as tests/test_torch_acoustic_step.py holds them. One
AdamW step moves each element by lr x sign(g), so the elements whose
gradient vanishes by symmetry move +-lr at random on either side; the
textual step's pitch/energy predictor, which has many of them (0.06 of its
move), is held by its gradient alone, as tests/test_torch_textual_step.py
holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.models import ringformer as jax_ringformer
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.state import create_train_state as jax_state
from stylish_tts_tpu.trainer.steps import Batch as JaxBatch
from stylish_tts_tpu.trainer.steps import StepContext as JaxContext
from stylish_tts_tpu.trainer.steps import make_acoustic_step as jax_acoustic_step
from stylish_tts_tpu.trainer.steps import make_textual_step as jax_textual_step
from stylish_tts_torch.convert.from_jax import module_from_jax
from stylish_tts_torch.models import build_models
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import (
    Batch, StepContext, make_acoustic_step, make_textual_step,
)
from test_torch_synth_common import jax_params, port_config
from test_torch_textual_step import _Shim
from test_train_steps import small_model_config

B, L, F, HOP = 2, 10, 40, 300
STAGE_STEPS, FORCED = 50, 1
MAX_LR_MULT = 4.0
NORM = dict(mel_log_mean=-3.5, mel_log_std=3.0)
STAGES = {
    "acoustic": dict(
        names=("speech_predictor", "speech_style_encoder", "mrd0", "mrd1", "mrd2", "disc"),
        trained=("speech_predictor", "speech_style_encoder"), lr=1e-4),
    "textual": dict(
        names=("pitch_energy_predictor", "pe_style_encoder", "speech_predictor",
               "speech_style_encoder", "pitch_disc"),
        trained=("pitch_energy_predictor", "pe_style_encoder"), lr=3e-5),
}


def ringformer_config():
    mc = small_model_config()
    mc.generator.type = "ringformer"
    mc.generator.upsample_initial_channel = 64
    mc.generator.upsample_rates = [4, 5]
    mc.generator.gen_istft_n_fft = 60
    mc.generator.gen_istft_hop_size = 15
    mc.generator.depth = 1
    mc.generator.resblock_kernel_sizes = [3]
    mc.generator.resblock_dilation_sizes = [[1, 3, 5]]
    return mc


MC = ringformer_config()


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(F * HOP) / 24000.0
    f0 = rng.uniform(100, 220, (B, 1))
    audio = 0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((B, F * HOP))
    text = rng.integers(1, 170, (B, L))
    lengths = np.array([L, L - 3])
    pitch = rng.uniform(90, 250, (B, F))
    pitch[:, 5:8] = 0.0
    durs = np.full((B, L), F // L)
    durs[:, 0] += F - durs.sum(1)
    return (audio.astype(np.float32), text.astype(np.int32), lengths.astype(np.int32),
            pitch.astype(np.float32), durs.astype(np.int32))


def _jax_variables(models):
    texts = jnp.ones((1, L), jnp.int32)
    lengths = jnp.full((1,), L, jnp.int32)
    align = jnp.ones((1, L, F)) / L
    curve = jnp.full((1, F), 100.0)
    style = jnp.zeros((1, MC.style_dim))
    mel = jnp.zeros((1, MC.style_encoder.n_mels, F))
    inits = {
        "speech_predictor": lambda k: models["speech_predictor"].init(
            {"params": k}, texts, lengths, align, curve, curve, curve, style, curve, rng=k),
        "speech_style_encoder": lambda k: models["speech_style_encoder"].init(k, mel),
        "disc": lambda k: models["disc"].init(k, jnp.zeros((1, F * HOP))),
        **{f"mrd{i}": (lambda k: models["mrd0"].init(k, jnp.zeros((1, 1, 64, 16))))
           for i in range(3)},
        "pitch_energy_predictor": lambda k: models["pitch_energy_predictor"].init(
            {"params": k}, texts, lengths, align, style),
        "pe_style_encoder": lambda k: models["pe_style_encoder"].init(k, mel, curve, curve),
        "pitch_disc": lambda k: models["pitch_disc"].init(k, jnp.zeros((1, 2, F))),
    }
    params = {n: jax_params(fn, seed=31 + i) for i, (n, fn) in enumerate(inits.items())}
    conv_post = params["speech_predictor"]["params"]["generator"]["conv_post"]["Conv_0"]
    conv_post["kernel"] = conv_post["kernel"] * 0.1
    return params


def _run_jax(stage, params, prior):
    models = dict(jax_build_model(MC))
    if stage == "textual":
        models["pitch_energy_predictor"] = _Shim(models["pitch_energy_predictor"],
                                                 training=False)
        models["speech_predictor"] = _Shim(models["speech_predictor"], training=False)
    ctx = JaxContext(models, MC, JaxConfig().loss_weight.model_dump(), JaxNorm(**NORM),
                     stage_steps=STAGE_STEPS, base_lr=STAGES[stage]["lr"],
                     parity_deterministic=True, forced_disc_index=FORCED)
    names = STAGES[stage]["names"]
    state = jax_state({n: params[n] for n in names}, MC.text_encoder.tokens + 1)
    make = jax_acoustic_step if stage == "acoustic" else jax_textual_step
    step = jax.jit(make(ctx))
    saved_pcph = jax_ringformer.generate_pcph
    saved_opt = jax.config.read("jax_disable_most_optimizations")
    # the injected excitation in place of the pcph draw, while the step
    # traces; XLA's CPU optimisation passes cost more than they save here
    jax_ringformer.generate_pcph = lambda *args, **kwargs: jnp.asarray(prior)
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        state, m = step(state, JaxBatch(*(jnp.asarray(x) for x in _batch())))
        metrics = {k: float(v) for k, v in m.items()}
    finally:
        jax_ringformer.generate_pcph = saved_pcph
        jax.config.update("jax_disable_most_optimizations", saved_opt)
    moments = {n: jax.device_get(state.opt_state[n][0].mu) for n in STAGES[stage]["trained"]}
    return jax.device_get(state.params), metrics, moments


def _run_port(stage, params, prior):
    torch.manual_seed(0)
    pm = build_models(port_config(MC))
    names = STAGES[stage]["names"]
    for n in names:
        pm[n].load_state_dict(module_from_jax(pm[n], params[n]))
    state = create_stage_train_state(pm, "cpu", stage)
    ctx = StepContext(port_config(MC), JaxConfig().loss_weight.model_dump(),
                      NormalizationStats(**NORM), stage_steps=STAGE_STEPS,
                      base_lr=STAGES[stage]["lr"], parity_deterministic=True,
                      parity_prior=torch.from_numpy(prior), forced_disc_index=FORCED)
    make = make_acoustic_step if stage == "acoustic" else make_textual_step
    m = make(ctx)(state, Batch(*(torch.from_numpy(x) for x in _batch())))
    moments = {n: {k: state.optimizers[n].state[p]["exp_avg"].clone()
                   for k, p in state.models[n].named_parameters()}
               for n in STAGES[stage]["trained"]}
    return state, {k: float(v) for k, v in m.items()}, moments


@pytest.fixture(scope="module")
def start():
    params = _jax_variables(jax_build_model(MC))
    prior = np.tanh(np.random.default_rng(5).standard_normal((B, F * HOP)) * 0.3)
    return params, prior.astype(np.float32)


def check_step(stage, start, held_to_move):
    """Run ``stage`` on both sides and hold metrics, gradients and weights;
    returns the port's state."""
    params, prior = start
    j_params, j_metrics, j_moments = _run_jax(stage, params, prior)
    pstate, p_metrics, p_moments = _run_port(stage, params, prior)
    assert set(j_metrics) <= set(p_metrics), (j_metrics.keys(), p_metrics.keys())
    for k in j_metrics:
        np.testing.assert_allclose(p_metrics[k], j_metrics[k], rtol=1e-4, err_msg=k)
    lr = STAGES[stage]["lr"]
    for n in STAGES[stage]["trained"]:
        module = pstate.models[n]
        ref = module_from_jax(module, j_moments[n])
        err = sum(float(((p_moments[n][k].double() - r.double()) ** 2).sum())
                  for k, r in ref.items())
        norm = sum(float((r.double() ** 2).sum()) for r in ref.values())
        assert norm > 0 and np.sqrt(err / norm) <= 1e-3, (n, np.sqrt(err / norm))

        ref = module_from_jax(module, j_params[n])
        begin = module_from_jax(module, params[n])
        err = move = 0.0
        for key, w in module.state_dict().items():
            r = ref[key].numpy().astype(np.float64)
            d = np.abs(w.numpy() - r)
            err += float(np.sum(d ** 2))
            move += float(np.sum((r - begin[key].numpy()) ** 2))
            assert d.max() <= 2 * MAX_LR_MULT * lr, (n, key, d.max())
        assert move > 0
        if n in held_to_move:
            assert np.sqrt(err) <= 0.05 * np.sqrt(move), (n, np.sqrt(err / move))
    return pstate, p_metrics


def test_ringformer_acoustic_step_matches_jax(start):
    _state, metrics = check_step("acoustic", start, STAGES["acoustic"]["trained"])
    assert {"mag", "phase"} <= set(metrics)
