"""The port's alignment step against the JAX package's.

JAX ``make_alignment_step(ctx, use_pallas=False)`` with a ``models`` dict
holding ``TextAligner(hidden_dim=48, dropout=0.0)`` and the port's step
start from the same weights (moved with the bridge) and see the same
batches (numpy, from a seed): 3 steps, ``finish_alignment_epoch``, 2
more steps. Tolerances: losses rtol 1e-4, params atol 1e-5, log_priors
atol 1e-5 (float32 on both sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_tpu.trainer import optim as joptim
from stylish_tts_tpu.trainer import steps as jsteps
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.state import create_train_state as jax_state
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.convert.from_jax import text_aligner_from_jax
from stylish_tts_torch.models.text_aligner import TextAligner
from stylish_tts_torch.trainer import optim as toptim
from stylish_tts_torch.trainer import steps as tsteps
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_train_state

HIDDEN = 48
BASE_LR = 1e-4
STAGE_STEPS = 40
WEIGHTS = {"align_loss": 1.0}


def _batch(seed, b=2, frames=40, text_len=16, hop=300):
    rng = np.random.default_rng(seed)
    t = np.arange(frames * hop) / 24000.0
    audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (b, 1)) * t)
             + 0.05 * rng.standard_normal((b, frames * hop))).astype(np.float32)
    text = rng.integers(1, 178, (b, text_len)).astype(np.int32)
    lengths = np.array([12, 9][:b], np.int32)
    for i in range(b):
        text[i, lengths[i]:] = 0
    zeros_f = np.zeros((b, frames), np.float32)
    zeros_l = np.zeros((b, text_len), np.int32)
    return (audio, text, lengths, zeros_f, zeros_l)


def _compare_params(jparams, aligner):
    ref = text_aligner_from_jax(jax.tree.map(np.asarray, jparams))
    ours = aligner.state_dict()
    assert sorted(ref) == sorted(ours)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_five_steps_and_prior_update_match_jax():
    mc = JaxModelConfig()
    jmodel = JaxAligner(hidden_dim=HIDDEN, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                         jnp.full((1,), 16, jnp.int32))
    jctx = jsteps.StepContext(
        {"text_aligner": jmodel}, mc, WEIGHTS, JaxNorm(),
        stage_steps=STAGE_STEPS, base_lr=BASE_LR,
    )
    jstep = jax.jit(jsteps.make_alignment_step(jctx, use_pallas=False))
    jstate = jax_state({"text_aligner": params}, mc.text_encoder.tokens + 1)

    port = TextAligner(hidden_dim=HIDDEN, dropout=0.0)
    port.load_state_dict(text_aligner_from_jax(jax.tree.map(np.asarray, params)))
    tctx = tsteps.StepContext(ModelConfig(), WEIGHTS, NormalizationStats(),
                              stage_steps=STAGE_STEPS, base_lr=BASE_LR)
    tstep = tsteps.make_alignment_step(tctx)
    tstate = create_train_state(port, 179, "cpu")

    j_losses, t_losses = [], []
    for i in range(5):
        if i == 3:
            jstate = jsteps.finish_alignment_epoch(jctx, jstate)
            tstate = tsteps.finish_alignment_epoch(tctx, tstate)
            np.testing.assert_allclose(tstate.log_priors.numpy(),
                                       np.asarray(jstate.log_priors), atol=1e-5)
        fields = _batch(seed=10 + i)
        jstate, jm = jstep(jstate, jsteps.Batch(*map(jnp.asarray, fields)))
        tm = tstep(tstate, tsteps.batch_to_device(tsteps.Batch(*fields), "cpu"))
        j_losses.append(float(jm["align_loss"]))
        t_losses.append(float(tm["align_loss"]))
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert tstate.step == int(jstate.step) == 5
    _compare_params(jstate.params["text_aligner"], tstate.aligner)
    np.testing.assert_allclose(tstate.log_priors_sum.numpy(),
                               np.asarray(jstate.log_priors_sum), atol=1e-5)
    assert float(tstate.prior_count) == float(jstate.prior_count)
    # priors moved away from the zeros they start at
    assert np.abs(tstate.log_priors.numpy()).max() > 0


def test_adamw_matches_optax_chain():
    """optax scale_by_adam + add_decayed_weights, scaled by -lr, equals
    torch.optim.AdamW with the same constants (checked, not assumed)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    tx = joptim.make_optimizer()
    jp = {"w": jnp.asarray(p0)}
    jopt = tx.init(jp)
    layer = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(p0))
    opt = toptim.make_optimizer(layer.parameters())
    for step, lr in enumerate([1e-3, 5e-4, 2e-3, 1e-3]):
        g = rng.standard_normal((5, 7)).astype(np.float32)
        jp, jopt = joptim.apply_module_update(jp, jopt, {"w": jnp.asarray(g)},
                                              jnp.float32(lr))
        layer.weight.grad = torch.from_numpy(g)
        assert toptim.apply_module_update(layer, opt, lr)
    np.testing.assert_allclose(layer.weight.detach().numpy(),
                               np.asarray(jp["w"]), atol=1e-6)


def test_nonfinite_gradient_skips_the_whole_update():
    layer = torch.nn.Linear(4, 3)
    opt = toptim.make_optimizer(layer.parameters())
    layer.weight.grad = torch.ones_like(layer.weight)
    layer.bias.grad = torch.ones_like(layer.bias)
    assert toptim.apply_module_update(layer, opt, 1e-3)
    params = {k: v.clone() for k, v in layer.state_dict().items()}
    moments = {
        id(p): {k: v.clone() for k, v in opt.state[p].items()}
        for p in layer.parameters()
    }
    layer.weight.grad = torch.ones_like(layer.weight)
    layer.bias.grad = torch.tensor([0.0, float("nan"), 1.0])
    assert not toptim.apply_module_update(layer, opt, 1e-3)
    for k, v in layer.state_dict().items():
        assert torch.equal(v, params[k])
    for p in layer.parameters():
        for k, v in opt.state[p].items():
            assert torch.equal(v, moments[id(p)][k]), k


@pytest.mark.parametrize("step,stage_steps", [
    (0, 100), (1, 100), (37, 100), (89, 100), (90, 100), (99, 100),
    (100, 100), (250, 100), (7, 3), (123_456, 1000), (5, 0),
])
def test_cosine_lr_matches_jax(step, stage_steps):
    ours = toptim.cosine_lr(1e-4, step, stage_steps)
    ref = float(joptim.cosine_lr(1e-4, jnp.int32(step), jnp.int32(stage_steps)))
    assert ours == pytest.approx(ref, rel=1e-6, abs=1e-12)
