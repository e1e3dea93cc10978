"""The port's textual step against the JAX package's ``make_textual_step``.

Both start from the same weights of the five modules the step reads
(``pitch_energy_predictor``, ``pe_style_encoder``, ``speech_predictor``,
``speech_style_encoder``, ``pitch_disc``; flax values from a seed, moved
with the bridge) at ``small_model_config()``, in float32, and take 3 steps
on the same batches (numpy, from a seed).

The JAX step hard-codes ``training=True`` for the pitch/energy predictor
(dropout from its key) and draws the speech predictor's harmonic prior
from its key; no RNG stream is shared between the frameworks. So this
test hands the JAX step a shim of those two modules whose ``apply`` runs
them with ``training=False``, the speech predictor with the injected
broadband ``parity_prior``; the JAX package is not changed. The port's
step takes the same through its ``parity_deterministic`` /
``parity_prior`` switches.

Tolerances: every metric rtol 1e-4 over the 3 steps; the ``pitch_disc``
EMA rtol 1e-5 and its lr multiplier at each step rtol 1e-6 against the JAX
EMA's; the first step's gradients of the trained modules (AdamW's first
moments after it, (1 - beta1) g) within 2e-3 of JAX's (relative L2;
measured 5.1e-4, 2.2e-4, 1.7e-7); after 3 steps ``pitch_disc``'s weights
within 0.05 of their move (L2; measured 7e-6), as
tests/test_torch_acoustic_step.py holds the acoustic modules, and every
element of every trained module within what AdamW can move it in 3
steps. The two generator-phase modules' weights are not held to their
3-step move: at these seeded random weights the mel term's gradient
through the frozen speech predictor is chaotic in them (moving 5 % of the
pitch/energy predictor's elements by 1e-6 moves the second step's mel
gradient by 1.6 %, by one lr 44 %), so AdamW's +-lr on the elements whose
gradient vanishes by symmetry (the AdaIN-fed conv biases, the attention
key biases) sends the two float32 trajectories apart from the second step
on (the port against itself with another thread count: 0.057 of the move;
against JAX: 0.085). No predicted F0 lies within 1e-2 Hz of the 20 Hz
voicing threshold, so both sides voice the same frames.

Also: the frozen speech predictor and speech style encoder stay bitwise,
with no gradient formed; a NaN gradient in one trained module leaves its
weights and AdamW state bitwise while the others step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.state import create_train_state as jax_state
from stylish_tts_tpu.trainer.steps import Batch as JaxBatch
from stylish_tts_tpu.trainer.steps import StepContext as JaxContext
from stylish_tts_tpu.trainer.steps import make_textual_step as jax_textual_step
from stylish_tts_torch.convert.from_jax import module_from_jax
from stylish_tts_torch.models import build_models
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.optim import DISC_SUB_COUNT
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, make_textual_step
from test_torch_checkpoint import _assert_tree_equal
from test_torch_synth_common import jax_params, port_config
from test_train_steps import small_model_config

NAMES = ("pitch_energy_predictor", "pe_style_encoder", "speech_predictor",
         "speech_style_encoder", "pitch_disc")
TRAINED = ("pitch_energy_predictor", "pe_style_encoder", "pitch_disc")
FROZEN = ("speech_predictor", "speech_style_encoder")
B, L, F, HOP = 2, 10, 40, 300
STAGE_STEPS, BASE_LR = 50, 3e-5
N_STEPS = 3
MAX_LR_MULT = 4.0
NORM = dict(mel_log_mean=-3.5, mel_log_std=3.0)

MC = small_model_config()


def _batch(seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(F * HOP) / 24000.0
    f0 = rng.uniform(100, 220, (B, 1))
    audio = 0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((B, F * HOP))
    text = rng.integers(1, 170, (B, L))
    lengths = np.array([L, L - 3])
    pitch = rng.uniform(90, 250, (B, F))
    pitch[:, 5:8] = 0.0
    pitch[1, 20:22] = 5.0  # below the 10 Hz voicing of the disc input
    durs = np.full((B, L), F // L)
    durs[:, 0] += F - durs.sum(1)
    return (audio.astype(np.float32), text.astype(np.int32), lengths.astype(np.int32),
            pitch.astype(np.float32), durs.astype(np.int32))


class _Shim:
    """A flax module whose ``apply`` always gets ``force`` (here
    ``training=False``, and the speech predictor's injected prior)."""

    def __init__(self, module, **force):
        self.module, self.force = module, force

    def apply(self, variables, *args, **kwargs):
        return self.module.apply(variables, *args, **{**kwargs, **self.force})


def _jax_variables(models):
    texts = jnp.ones((1, L), jnp.int32)
    lengths = jnp.full((1,), L, jnp.int32)
    align = jnp.ones((1, L, F)) / L
    curve = jnp.full((1, F), 100.0)
    style = jnp.zeros((1, MC.style_dim))
    mel = jnp.zeros((1, MC.style_encoder.n_mels, F))
    inits = {
        "pitch_energy_predictor": lambda k: models["pitch_energy_predictor"].init(
            {"params": k}, texts, lengths, align, style),
        "pe_style_encoder": lambda k: models["pe_style_encoder"].init(k, mel, curve, curve),
        "speech_predictor": lambda k: models["speech_predictor"].init(
            {"params": k}, texts, lengths, align, curve, curve, curve, style, curve, rng=k),
        "speech_style_encoder": lambda k: models["speech_style_encoder"].init(k, mel),
        "pitch_disc": lambda k: models["pitch_disc"].init(k, jnp.zeros((1, 2, F))),
    }
    return {n: jax_params(inits[n], seed=21 + i) for i, n in enumerate(NAMES)}


def _run_jax(params, prior):
    models = dict(jax_build_model(MC))
    models["pitch_energy_predictor"] = _Shim(models["pitch_energy_predictor"], training=False)
    models["speech_predictor"] = _Shim(models["speech_predictor"], training=False,
                                       prior=jnp.asarray(prior))
    ctx = JaxContext(models, MC, JaxConfig().loss_weight.model_dump(), JaxNorm(**NORM),
                     stage_steps=STAGE_STEPS, base_lr=BASE_LR)
    state = jax_state(params, MC.text_encoder.tokens + 1)
    step = jax.jit(jax_textual_step(ctx))
    metrics, emas, first_moments = [], [], None
    # XLA's CPU optimisation passes cost more than they save on 3 steps
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for s in range(N_STEPS):
            emas.append(float(state.disc_ema["pitch_disc"]))
            state, m = step(state, JaxBatch(*(jnp.asarray(x) for x in _batch(s))))
            metrics.append({k: float(v) for k, v in m.items()})
            if s == 0:
                first_moments = {n: jax.device_get(state.opt_state[n][0].mu)
                                 for n in TRAINED}
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)
    return state, metrics, emas, first_moments


def _port_state(params):
    torch.manual_seed(0)
    pm = build_models(port_config(MC))
    for n in NAMES:
        pm[n].load_state_dict(module_from_jax(pm[n], params[n]))
    return create_stage_train_state(pm, "cpu", "textual")


def _run_port(params, prior, n_steps=N_STEPS, state=None):
    ctx = StepContext(port_config(MC), JaxConfig().loss_weight.model_dump(),
                      NormalizationStats(**NORM), stage_steps=STAGE_STEPS, base_lr=BASE_LR,
                      parity_deterministic=True, parity_prior=torch.from_numpy(prior))
    state = state or _port_state(params)
    step = make_textual_step(ctx)
    pitches, first_moments = [], None
    hook = state.models["pitch_energy_predictor"].register_forward_hook(
        lambda m, a, out: pitches.append(out[0].detach().clone()))
    metrics = []
    try:
        for s in range(n_steps):
            m = step(state, Batch(*(torch.from_numpy(x) for x in _batch(s))))
            metrics.append({k: float(v) for k, v in m.items()})
            if s == 0:
                first_moments = {
                    n: {k: state.optimizers[n].state[p]["exp_avg"].clone()
                        for k, p in state.models[n].named_parameters()}
                    for n in TRAINED}
    finally:
        hook.remove()
    return state, metrics, pitches, first_moments


@pytest.fixture(scope="module")
def runs():
    params = _jax_variables(jax_build_model(MC))
    prior = np.tanh(np.random.default_rng(5).standard_normal((B, F * HOP)) * 0.3)
    prior = prior.astype(np.float32)
    jax_run = _run_jax(params, prior)
    port_run = _run_port(params, prior)
    return params, prior, jax_run, port_run


def test_textual_trajectory_matches_jax(runs):
    params, _prior, jax_run, port_run = runs
    jstate, j_metrics, j_emas, j_moments = jax_run
    pstate, p_metrics, pitches, p_moments = port_run
    for pred_pitch in pitches:
        assert float((pred_pitch - 20.0).abs().min()) > 1e-2
    for s, (jm, pm) in enumerate(zip(j_metrics, p_metrics)):
        assert set(pm) == set(jm) | {"pitch_disc_lr_mult"}, (jm.keys(), pm.keys())
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=f"step {s} {k}")
        mult = float(JL.disc_lr_multiplier(jnp.float32(j_emas[s]),
                                           DISC_SUB_COUNT["pitch_disc"]))
        np.testing.assert_allclose(pm["pitch_disc_lr_mult"], mult, rtol=1e-6)
    np.testing.assert_allclose(float(pstate.disc_ema["pitch_disc"]),
                               float(jstate.disc_ema["pitch_disc"]), rtol=1e-5)
    assert float(pstate.disc_ema["pitch_disc"]) != 2.5  # moved from its init
    for n in TRAINED:
        ref = module_from_jax(pstate.models[n], j_moments[n])
        err = sum(float(((p_moments[n][k].double() - r.double()) ** 2).sum())
                  for k, r in ref.items())
        norm = sum(float((r.double() ** 2).sum()) for r in ref.values())
        assert norm > 0 and np.sqrt(err / norm) <= 2e-3, (n, np.sqrt(err / norm))

        ref = module_from_jax(pstate.models[n], jax.device_get(jstate.params[n]))
        start = module_from_jax(pstate.models[n], params[n])
        err = move = 0.0
        for key, w in pstate.models[n].state_dict().items():
            r = ref[key].numpy().astype(np.float64)
            d = np.abs(w.numpy() - r)
            err += float(np.sum(d ** 2))
            move += float(np.sum((r - start[key].numpy()) ** 2))
            assert d.max() <= 2 * N_STEPS * MAX_LR_MULT * BASE_LR, (n, key, d.max())
        assert move > 0
        if n == "pitch_disc":
            assert np.sqrt(err) <= 0.05 * np.sqrt(move), (n, np.sqrt(err / move))


def test_frozen_modules_bitwise_and_without_gradients(runs):
    params, _prior, _jax_run, (pstate, *_rest) = runs
    for n in FROZEN:
        start = module_from_jax(pstate.models[n], params[n])
        for key, w in pstate.models[n].state_dict().items():
            assert torch.equal(w, start[key]), (n, key)
        assert all(p.grad is None for p in pstate.models[n].parameters()), n
        assert n not in pstate.optimizers
    assert set(pstate.optimizers) == set(TRAINED)


def test_nonfinite_gradient_skips_the_module_update(runs):
    """A NaN in the pitch/energy predictor's gradient: its weights and AdamW
    state stay bitwise, the pitch style encoder and pitch_disc still step."""
    params, prior, _jax_run, _port_run = runs
    state, *_ = _run_port(params, prior, n_steps=1)
    module = state.models["pitch_energy_predictor"]
    w0 = copy.deepcopy(module.state_dict())
    opt0 = copy.deepcopy(state.optimizers["pitch_energy_predictor"].state_dict())
    others = {n: copy.deepcopy(state.models[n].state_dict())
              for n in ("pe_style_encoder", "pitch_disc")}
    hook = next(module.parameters()).register_hook(lambda g: g * float("nan"))
    try:
        state, metrics, *_ = _run_port(params, prior, n_steps=1, state=state)
    finally:
        hook.remove()
    assert all(np.isfinite(list(metrics[0].values())))
    assert all(torch.equal(v, w0[k]) for k, v in module.state_dict().items())
    _assert_tree_equal(state.optimizers["pitch_energy_predictor"].state_dict(), opt0)
    for n, sd in others.items():
        assert any(not torch.equal(v, sd[k]) for k, v in state.models[n].state_dict().items())
