"""``generator.remat`` on the port: the audio-rate ConvNeXt blocks of the
FreeGAN generator (``amp_convnext_i``, ``upblock_i``, ``phase_convnext_i``)
and the MRDs and waveform disc, rematerialised in the backward through
``torch.utils.checkpoint`` (``models/common.py`` ``remat_call``), as the JAX
package wraps them in ``nn.remat``.

* At ``small_model_config()`` the generator's output and gradients with
  remat equal those without (CPU; tolerance 1e-6 relative, measured
  bitwise), and the ``state_dict`` keys are the same.
* At the tiny generator config of ``tests/test_torch_generator.py``
  (n_fft 128, 100 frames, an injected prior) the port's gradients with
  remat match JAX's ``MultiGenerator`` with ``remat`` on, for every
  parameter and the input, within that file's tolerance: 1e-4 of the
  largest magnitude of JAX's gradient of the module, and of the input
  (measured 3.7e-5, the same as without remat on both sides).
* One acoustic step with ``generator.remat: true`` (training mode:
  dropout, the sine source) gives the metrics and weights of the port's
  step with ``remat: false`` (CPU, float32 on both, the discriminators'
  precision rule unchanged; 1e-6 relative, measured bitwise), and it went
  through the checkpoint; the step without remat is held against JAX's by
  ``tests/test_torch_acoustic_step.py``.
* Synthesis (``torch.inference_mode``, as ``InferencePackage`` runs) and
  ``torch.no_grad`` never call the checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.models.generator import MultiGenerator as JaxMultiGenerator
from stylish_tts_torch.config import Config
from stylish_tts_torch.convert.from_jax import flatten, module_to_jax_flat
from stylish_tts_torch.models import build_inference_models, build_models, common
from stylish_tts_torch.models.generator import MultiGenerator
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, make_acoustic_step
from test_torch_acoustic_step import _batch
from test_torch_synth_common import (
    HOP, SR, bct, f0_contour, jax_params, j, port_config, randn, t, tiny_jax_config,
    to_port,
)
from test_train_steps import small_model_config

REL = 1e-6


@pytest.fixture
def checkpoint_calls(monkeypatch):
    """Counts the calls that go through ``torch.utils.checkpoint``."""
    calls = []
    real = common.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(getattr(fn, "__name__", type(fn).__name__))
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(common, "checkpoint", counted)
    return calls


def _port_mc(remat: bool):
    mc = port_config(small_model_config())
    mc.generator.remat = remat
    return mc


def _multi_generator(mc):
    torch.manual_seed(0)
    return MultiGenerator(mc.decoder.hidden_dim, mc.style_dim, mc.n_fft, mc.hop_length,
                          mc.sample_rate, mc.generator)


def _generator_inputs(mc, frames, seed):
    pitch = t(f0_contour(frames, seed)[:1])
    return dict(mel=t(randn((1, mc.decoder.hidden_dim, frames), seed + 1)),
                style=t(randn((1, mc.style_dim), seed + 2)), pitch=pitch,
                voiced=(pitch > 0).float(),
                prior=t(np.tanh(randn((1, frames * mc.hop_length), seed + 3, 0.3))))


def _grads(module, inputs, weight):
    module.zero_grad(set_to_none=True)
    mel = inputs["mel"].clone().requires_grad_(True)
    audio = module(**{**inputs, "mel": mel}).audio
    (audio * weight).sum().backward()
    # the sine source's weights get no gradient past the injected prior
    return audio.detach(), mel.grad, {k: p.grad.clone() for k, p in module.named_parameters()
                                      if p.grad is not None}


def _rel_equal(ours, ref, what):
    err = float((ours - ref).abs().max())
    assert err <= REL * float(ref.abs().max()), (what, err)


def test_generator_remat_equals_no_remat(checkpoint_calls):
    frames = 30
    plain, remat = _multi_generator(_port_mc(False)), _multi_generator(_port_mc(True))
    assert list(remat.state_dict()) == list(plain.state_dict())
    remat.load_state_dict(plain.state_dict())
    mc = _port_mc(True)
    inputs = _generator_inputs(mc, frames, 0)
    weight = t(randn((1, frames * mc.hop_length), 9))
    a0, g0, p0 = _grads(plain.eval(), inputs, weight)
    assert not checkpoint_calls
    a1, g1, p1 = _grads(remat.eval(), inputs, weight)
    gen = mc.generator
    # every ConvNeXt block of the amplitude trunk, the upsampling and the
    # phase branch, once each in the forward
    assert len(checkpoint_calls) == (gen.conv_layers - 3) + 3 + gen.conv_layers
    _rel_equal(a1, a0, "audio")
    _rel_equal(g1, g0, "mel grad")
    assert p1.keys() == p0.keys()
    for k in p0:
        _rel_equal(p1[k], p0[k], k)


def test_state_dict_keys_unchanged_by_remat():
    keys = {}
    for remat in (False, True):
        torch.manual_seed(0)
        keys[remat] = {n: list(m.state_dict()) for n, m in build_models(_port_mc(remat)).items()}
    assert keys[True] == keys[False]


def test_generator_remat_gradients_match_jax(checkpoint_calls):
    """The port's ``MultiGenerator`` with remat against JAX's with remat:
    the audio and the gradients of every parameter and of the input."""
    jmc = tiny_jax_config()
    jmc.generator.remat = True
    frames = 100
    rng = np.random.default_rng(20)
    style = randn((1, jmc.style_dim), 21)
    pitch = f0_contour(frames, 22)[:1]
    voiced = (pitch > 0).astype(np.float32)
    prior = np.tanh(randn((1, frames * HOP), 23, 0.3))
    mel = randn((1, frames, jmc.decoder.hidden_dim), 24)
    weight = rng.standard_normal((1, frames * HOP)).astype(np.float32)
    jmod = JaxMultiGenerator(style_dim=jmc.style_dim, n_fft=jmc.n_fft,
                             win_length=jmc.win_length, hop_length=HOP, sample_rate=SR,
                             config=jmc.generator)
    fixed = dict(style=j(style), pitch=j(pitch), energy=j(np.zeros_like(pitch)),
                 voiced=j(voiced), prior=j(prior))
    variables = jax_params(lambda k: jmod.init({"params": k}, rng=k, mel=j(mel), **fixed))

    def loss(v, x):
        audio = jmod.apply(v, rng=jax.random.PRNGKey(3), mel=x, **fixed).audio
        return jnp.sum(audio * j(weight)), audio

    (_, ref_audio), (ref_pgrads, ref_xgrad) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(variables, j(mel))

    pmc = port_config(jmc)
    port = to_port(MultiGenerator(pmc.decoder.hidden_dim, pmc.style_dim, pmc.n_fft, HOP,
                                  SR, pmc.generator), variables)
    x = bct(mel).requires_grad_(True)
    audio = port(mel=x, style=t(style), pitch=t(pitch), voiced=t(voiced),
                 prior=t(prior)).audio
    (audio * t(weight)).sum().backward()
    assert len(checkpoint_calls) == 2 * pmc.generator.conv_layers
    np.testing.assert_allclose(audio.detach().numpy(), np.asarray(ref_audio), rtol=0,
                               atol=1e-4)
    # the sine source's weights get no gradient past the injected prior:
    # None on the port's side, zeros on JAX's
    ours = module_to_jax_flat(port, {k: torch.zeros_like(p) if p.grad is None else p.grad
                                     for k, p in port.named_parameters()})
    ref = flatten(ref_pgrads)
    assert set(ref) == set(ours)
    # of the largest gradient of the module: a conv bias ahead of an
    # instance norm has a gradient of zero plus round-off on both sides
    scale = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        err = np.abs(ours[k] - r).max()
        assert err <= 1e-4 * scale, (k, err, scale)
    ref_x = np.asarray(ref_xgrad).transpose(0, 2, 1)
    assert np.abs(x.grad.numpy() - ref_x).max() <= 1e-4 * np.abs(ref_x).max()


def _acoustic_run(remat: bool, n_steps: int = 2):
    mc = _port_mc(remat)
    torch.manual_seed(0)
    state = create_stage_train_state(build_models(mc), "cpu", "acoustic", seed=0)
    ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                      stage_steps=50, base_lr=1e-4)
    assert not ctx.disc_bf16  # float32 on the CPU, with remat or without
    step = make_acoustic_step(ctx)
    metrics = [{k: float(v) for k, v in step(state, Batch(*map(torch.from_numpy,
                                                                 _batch(s)))).items()}
               for s in range(n_steps)]
    return metrics, {n: m.state_dict() for n, m in state.models.items()}


def test_acoustic_step_with_remat_equals_without(checkpoint_calls):
    m0, w0 = _acoustic_run(False)
    assert not checkpoint_calls
    m1, w1 = _acoustic_run(True)
    # the generator's blocks and the MRD and waveform disc forwards
    assert {"GeneratorConvNeXtBlock", "_scores"} <= set(checkpoint_calls)
    for a, b in zip(m1, m0):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= REL * max(abs(b[k]), 1e-12), (k, a[k], b[k])
    for n in w0:
        for k in w0[n]:
            _rel_equal(w1[n][k].float(), w0[n][k].float(), f"{n}/{k}")


def test_synthesis_never_checkpoints(checkpoint_calls):
    mc = _port_mc(True)
    models = build_inference_models(mc)
    sp = models["speech_predictor"].eval()
    gen = sp.generator
    inputs = _generator_inputs(mc, 12, 30)
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            out = gen(**inputs).audio
        assert out.shape == (1, 12 * mc.hop_length)
    for name in ("mrd0", "disc"):
        disc = build_models(mc)[name]
        x = torch.randn((1, 1, 64, 16)) if name == "mrd0" else torch.randn((1, 4096))
        with torch.inference_mode():
            disc(x)
    assert checkpoint_calls == []
