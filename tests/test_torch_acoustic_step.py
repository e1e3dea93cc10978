"""The port's acoustic step against the JAX package's ``make_acoustic_step``.

Both start from the same weights of the six modules (``speech_predictor``,
``speech_style_encoder``, ``mrd0``-``mrd2``, ``disc``; flax values from a
seed, moved with the bridge) at ``small_model_config()`` (as
tests/test_train_steps.py), in float32, and take 3 steps on the same
batches (numpy, from a seed) with the parity switches set: no dropout or
smoothing (``parity_deterministic``), an injected broadband excitation
(``parity_prior``), a fixed MRD (``forced_disc_index``); in both MRD
modes. The slm term is off here (WavLM is held apart, in
tests/test_torch_wavlm.py).

Tolerances: every metric (mel, multi_phase, generator, discriminator,
lr, the four lr multipliers) rtol 1e-4 (measured: ~1e-6); the weights of
each module after 3 steps within 0.05 of their move over the 3 steps
(L2 norms of the differences), as chip_smoke.py holds a resume, and no
element off by more than AdamW can move it in 3 steps (2 x 3 x 4 lr: an
AdamW step moves an element by about lr x mult x sign(g), and an element
whose gradient is far below the float32 noise of the sum that forms it,
such as the attention key biases, whose gradient the softmax's shift
invariance makes vanish, can take either sign). The batches' scores are
not near the TPRLS medians' ties, so the masks agree.

Also: the MRDs that were not sampled keep their weights, AdamW moments
and step count bitwise (also in the all-three mode, where their
gradients exist); with the nonfinite guard, a NaN gradient leaves a
module's weights and AdamW state bitwise too.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.state import create_train_state as jax_state
from stylish_tts_tpu.trainer.steps import Batch as JaxBatch
from stylish_tts_tpu.trainer.steps import StepContext as JaxContext
from stylish_tts_tpu.trainer.steps import make_acoustic_step as jax_acoustic_step
from stylish_tts_torch.convert.from_jax import module_from_jax
from stylish_tts_torch.models import STAGE_DISCRIMINATORS, build_models
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, make_acoustic_step
from test_torch_synth_common import jax_params, port_config
from test_train_steps import small_model_config

NAMES = ("speech_predictor", "speech_style_encoder", "mrd0", "mrd1", "mrd2", "disc")
B, L, F, HOP = 2, 10, 40, 300
STAGE_STEPS, BASE_LR, FORCED = 50, 1e-4, 1
N_STEPS = 3
MAX_LR_MULT = 4.0  # the discriminators' gap-aware LR reaches 4 lr


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
    durs = np.full((B, L), F // L)
    durs[:, 0] += F - durs.sum(1)
    return (audio.astype(np.float32), text.astype(np.int32), lengths.astype(np.int32),
            pitch.astype(np.float32), durs.astype(np.int32))


def _jax_variables():
    models = jax_build_model(MC)
    texts = jnp.ones((1, L), jnp.int32)
    lengths = jnp.full((1,), L, jnp.int32)
    align = jnp.ones((1, L, F)) / L
    curve = jnp.full((1, F), 100.0)
    style = jnp.zeros((1, MC.style_dim))
    inits = {
        "speech_predictor": lambda k: models["speech_predictor"].init(
            {"params": k}, texts, lengths, align, curve, curve, curve, style, curve, rng=k),
        "speech_style_encoder": lambda k: models["speech_style_encoder"].init(
            k, jnp.zeros((1, MC.style_encoder.n_mels, F))),
        "disc": lambda k: models["disc"].init(k, jnp.zeros((1, F * HOP))),
        **{f"mrd{i}": (lambda k: models["mrd0"].init(k, jnp.zeros((1, 1, 64, 16))))
           for i in range(3)},
    }
    params = {n: jax_params(inits[n], seed=11 + i) for i, n in enumerate(NAMES)}
    return models, params


@pytest.fixture(scope="module")
def start():
    models, params = _jax_variables()
    prior = np.tanh(np.random.default_rng(5).standard_normal((B, F * HOP)) * 0.3)
    return models, params, prior.astype(np.float32)


def _port_state(params):
    torch.manual_seed(0)
    pm = build_models(port_config(MC))
    for n in NAMES:
        pm[n].load_state_dict(module_from_jax(pm[n], params[n]))
    return create_stage_train_state(pm, "cpu", "acoustic")


def _run_jax(models, params, prior, sampled):
    weights = JaxConfig().loss_weight.model_dump()
    ctx = JaxContext(models, MC, weights, JaxNorm(), stage_steps=STAGE_STEPS,
                     base_lr=BASE_LR, parity_deterministic=True,
                     parity_prior=jnp.asarray(prior), sampled_mrd_only=sampled,
                     forced_disc_index=FORCED)
    state = jax_state(params, MC.text_encoder.tokens + 1)
    step = jax.jit(jax_acoustic_step(ctx))
    metrics = []
    # XLA's CPU optimisation passes cost more than they save on 3 steps
    # (the compile is ~2 of this test's 3 minutes); restored after
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for s in range(N_STEPS):
            state, m = step(state, JaxBatch(*(jnp.asarray(x) for x in _batch(s))))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)
    return state, metrics


def _run_port(params, prior, sampled, n_steps=N_STEPS, state=None):
    weights = JaxConfig().loss_weight.model_dump()
    ctx = StepContext(port_config(MC), weights, NormalizationStats(),
                      stage_steps=STAGE_STEPS, base_lr=BASE_LR,
                      parity_deterministic=True, parity_prior=torch.from_numpy(prior),
                      sampled_mrd_only=sampled, forced_disc_index=FORCED)
    state = state or _port_state(params)
    step = make_acoustic_step(ctx)
    metrics = []
    for s in range(n_steps):
        m = step(state, Batch(*(torch.from_numpy(x) for x in _batch(s))))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled_mrd", "all_mrds"])
def test_acoustic_trajectory_matches_jax(start, sampled):
    models, params, prior = start
    jstate, j_metrics = _run_jax(models, params, prior, sampled)
    pstate, p_metrics = _run_port(params, prior, sampled)
    for s, (jm, pm) in enumerate(zip(j_metrics, p_metrics)):
        assert jm.keys() == pm.keys(), (jm.keys(), pm.keys())
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=f"step {s} {k}")
    for n in NAMES:
        ref = module_from_jax(pstate.models[n], jax.device_get(jstate.params[n]))
        start = module_from_jax(pstate.models[n], params[n])
        err = move = 0.0
        for key, w in pstate.models[n].state_dict().items():
            r = ref[key].numpy().astype(np.float64)
            d = np.abs(w.numpy() - r)
            err += float(np.sum(d ** 2))
            move += float(np.sum((r - start[key].numpy()) ** 2))
            assert d.max() <= 2 * N_STEPS * MAX_LR_MULT * BASE_LR, (n, key, d.max())
        assert np.sqrt(err) <= 0.05 * np.sqrt(move), (n, np.sqrt(err / move))
    for n in ("mrd0", "mrd1", "mrd2", "disc"):
        np.testing.assert_allclose(float(pstate.disc_ema[n]),
                                   float(jstate.disc_ema[n]), rtol=1e-5)


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled_mrd", "all_mrds"])
def test_unsampled_mrds_bitwise_unchanged(start, sampled):
    _models, params, prior = start
    state = _port_state(params)
    before = {n: (copy.deepcopy(state.models[n].state_dict()),
                  copy.deepcopy(state.optimizers[n].state_dict())) for n in NAMES}
    state, _ = _run_port(params, prior, sampled, n_steps=2, state=state)
    for n in ("mrd0", "mrd2"):  # FORCED is 1
        for k, v in state.models[n].state_dict().items():
            assert torch.equal(v, before[n][0][k]), (n, k)
        assert state.optimizers[n].state_dict() == before[n][1]
        assert not state.optimizers[n].state  # no moments, no step count
    assert state.optimizers["mrd1"].state and state.optimizers["disc"].state
    ema_moved = {n: float(state.disc_ema[n]) != 2.5 for n in ("mrd0", "mrd1", "mrd2")}
    assert ema_moved == {"mrd0": not sampled, "mrd1": True, "mrd2": not sampled}


def test_nonfinite_gradient_skips_the_module_update(start):
    """A NaN in one module's gradient: that module's weights and AdamW
    state stay bitwise, the other modules still step."""
    from stylish_tts_torch.trainer.optim import apply_module_update, modules_finite

    _models, params, _prior = start
    state = _port_state(params)
    mods = [state.models[n] for n in STAGE_DISCRIMINATORS["acoustic"]]
    for m in mods:
        for p in m.parameters():
            p.grad = torch.ones_like(p)
    next(mods[0].parameters()).grad[0] = float("nan")
    flags = modules_finite(mods)
    assert flags == [False, True, True, True]
    w0 = copy.deepcopy(mods[0].state_dict())
    for name, m, flag in zip(STAGE_DISCRIMINATORS["acoustic"], mods, flags):
        assert apply_module_update(m, state.optimizers[name], 1e-3, finite=flag) == flag
    assert all(torch.equal(v, w0[k]) for k, v in mods[0].state_dict().items())
    assert not state.optimizers["mrd0"].state and state.optimizers["mrd1"].state
