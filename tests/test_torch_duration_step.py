"""The port's duration step against the JAX package's ``make_duration_step``.

Both start from the same weights of the three modules the step reads
(``duration_predictor``, ``duration_style_encoder``, ``dur_disc``; flax
values from a seed, moved with the bridge) at ``small_model_config()``, in
float32, and take 3 steps on the same batches (numpy, from a seed: ragged
text lengths, durations of 0-12 frames, non-uniform class weights).

The JAX step hard-codes ``training=True`` for the duration predictor
(dropout from its key), and no RNG stream is shared between the
frameworks; so this test hands the JAX step a shim of the predictor whose
``apply`` runs it with ``training=False`` (the JAX package is not changed),
and the port's step runs with ``parity_deterministic``.

Tolerances, as tests/test_torch_acoustic_step.py holds the acoustic step:
every metric rtol 1e-4; each trained module's weights after 3 steps
within 0.05 of their move (L2), and no element off by more than AdamW can
move it in 3 steps; the ``dur_disc`` EMA rtol 1e-5 and its lr multiplier
at each step rtol 1e-6 against the JAX EMA's.

Also: every module but the duration pair and ``dur_disc`` stays bitwise,
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
from stylish_tts_tpu.trainer.steps import make_duration_step as jax_duration_step
from stylish_tts_torch.convert.from_jax import module_from_jax
from stylish_tts_torch.models import build_models
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.optim import DISC_SUB_COUNT
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, make_duration_step
from test_torch_checkpoint import _assert_tree_equal
from test_torch_synth_common import jax_params, port_config
from test_train_steps import small_model_config

TRAINED = ("duration_predictor", "duration_style_encoder", "dur_disc")
B, L, F, HOP = 2, 12, 40, 300
STAGE_STEPS, BASE_LR = 50, 1e-4
N_STEPS = 3
MAX_LR_MULT = 4.0
NORM = dict(mel_log_mean=-3.5, mel_log_std=3.0)
CLASS_WEIGHTS = np.sqrt(np.random.default_rng(3).uniform(0.2, 3.0, 16)).astype(np.float32)

MC = small_model_config()


def _batch(seed):
    rng = np.random.default_rng(seed)
    audio = 0.1 * rng.standard_normal((B, F * HOP))
    text = rng.integers(1, 170, (B, L))
    lengths = np.array([L, L - 5])
    durs = rng.integers(0, 13, (B, L))
    durs[1, lengths[1]:] = 0
    return (audio.astype(np.float32), text.astype(np.int32), lengths.astype(np.int32),
            np.full((B, F), 120.0, np.float32), durs.astype(np.int32))


class _Shim:
    """A flax module whose ``apply`` always runs with ``training=False``."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, **kwargs):
        return self.module.apply(variables, *args, **{**kwargs, "training": False})


def _jax_variables(models):
    texts = jnp.ones((1, L), jnp.int32)
    inits = {
        "duration_predictor": lambda k: models["duration_predictor"].init(
            {"params": k}, texts, jnp.full((1,), L, jnp.int32), jnp.zeros((1, MC.style_dim))),
        "duration_style_encoder": lambda k: models["duration_style_encoder"].init(
            k, jnp.zeros((1, MC.style_encoder.n_mels, F))),
        "dur_disc": lambda k: models["dur_disc"].init(k, jnp.zeros((1, 1, L))),
    }
    return {n: jax_params(inits[n], seed=31 + i) for i, n in enumerate(TRAINED)}


def _run_jax(params):
    models = dict(jax_build_model(MC))
    models["duration_predictor"] = _Shim(models["duration_predictor"])
    ctx = JaxContext(models, MC, JaxConfig().loss_weight.model_dump(), JaxNorm(**NORM),
                     stage_steps=STAGE_STEPS, base_lr=BASE_LR)
    state = jax_state(params, MC.text_encoder.tokens + 1)
    step = jax.jit(jax_duration_step(ctx, jnp.asarray(CLASS_WEIGHTS)))
    metrics, emas = [], []
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for s in range(N_STEPS):
            emas.append(float(state.disc_ema["dur_disc"]))
            state, m = step(state, JaxBatch(*(jnp.asarray(x) for x in _batch(s))))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)
    return state, metrics, emas


def _port_state(params):
    torch.manual_seed(0)
    pm = build_models(port_config(MC))
    for n in TRAINED:
        pm[n].load_state_dict(module_from_jax(pm[n], params[n]))
    return create_stage_train_state(pm, "cpu", "duration")


def _run_port(params, n_steps=N_STEPS, state=None):
    ctx = StepContext(port_config(MC), JaxConfig().loss_weight.model_dump(),
                      NormalizationStats(**NORM), stage_steps=STAGE_STEPS, base_lr=BASE_LR,
                      parity_deterministic=True)
    state = state or _port_state(params)
    step = make_duration_step(ctx, torch.from_numpy(CLASS_WEIGHTS))
    metrics = []
    for s in range(n_steps):
        m = step(state, Batch(*(torch.from_numpy(x) for x in _batch(s))))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def runs():
    params = _jax_variables(jax_build_model(MC))
    start = _port_state(params)
    before = {n: copy.deepcopy(m.state_dict()) for n, m in start.models.items()}
    return params, _run_jax(params), _run_port(params, state=start), before


def test_duration_trajectory_matches_jax(runs):
    params, (jstate, j_metrics, j_emas), (pstate, p_metrics), _ = runs
    for s, (jm, pm) in enumerate(zip(j_metrics, p_metrics)):
        assert set(pm) == set(jm) | {"dur_disc_lr_mult"}, (jm.keys(), pm.keys())
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=f"step {s} {k}")
        mult = float(JL.disc_lr_multiplier(jnp.float32(j_emas[s]),
                                           DISC_SUB_COUNT["dur_disc"]))
        np.testing.assert_allclose(pm["dur_disc_lr_mult"], mult, rtol=1e-6)
    np.testing.assert_allclose(float(pstate.disc_ema["dur_disc"]),
                               float(jstate.disc_ema["dur_disc"]), rtol=1e-5)
    assert float(pstate.disc_ema["dur_disc"]) != 2.5
    for n in TRAINED:
        ref = module_from_jax(pstate.models[n], jax.device_get(jstate.params[n]))
        start = module_from_jax(pstate.models[n], params[n])
        err = move = 0.0
        for key, w in pstate.models[n].state_dict().items():
            r = ref[key].numpy().astype(np.float64)
            d = np.abs(w.numpy() - r)
            err += float(np.sum(d ** 2))
            move += float(np.sum((r - start[key].numpy()) ** 2))
            assert d.max() <= 2 * N_STEPS * MAX_LR_MULT * BASE_LR, (n, key, d.max())
        assert move > 0 and np.sqrt(err) <= 0.05 * np.sqrt(move), (n, np.sqrt(err / move))


def test_frozen_modules_bitwise_and_without_gradients(runs):
    _params, _jax_run, (pstate, _m), before = runs
    for n, module in pstate.models.items():
        if n in TRAINED:
            continue
        for key, w in module.state_dict().items():
            assert torch.equal(w, before[n][key]), (n, key)
        assert all(p.grad is None for p in module.parameters()), n
    assert set(pstate.optimizers) == set(TRAINED)


def test_nonfinite_gradient_skips_the_module_update(runs):
    """A NaN in the duration predictor's gradient: its weights and AdamW
    state stay bitwise, the style encoder and dur_disc still step."""
    params, *_ = runs
    state, _ = _run_port(params, n_steps=1)
    module = state.models["duration_predictor"]
    w0 = copy.deepcopy(module.state_dict())
    opt0 = copy.deepcopy(state.optimizers["duration_predictor"].state_dict())
    others = {n: copy.deepcopy(state.models[n].state_dict())
              for n in ("duration_style_encoder", "dur_disc")}
    hook = next(module.parameters()).register_hook(lambda g: g * float("nan"))
    try:
        state, metrics = _run_port(params, n_steps=1, state=state)
    finally:
        hook.remove()
    assert all(np.isfinite(list(metrics[0].values())))
    assert all(torch.equal(v, w0[k]) for k, v in module.state_dict().items())
    _assert_tree_equal(state.optimizers["duration_predictor"].state_dict(), opt0)
    for n, sd in others.items():
        assert any(not torch.equal(v, sd[k]) for k, v in state.models[n].state_dict().items())
