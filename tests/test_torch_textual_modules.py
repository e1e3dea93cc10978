"""The textual stage's modules against the JAX package's, at the tiny
config: ``PitchStyleEncoder`` (with the curves' linear resize),
``PitchDiscriminator`` (both kernels ``build_model`` uses), the prosody
losses, and the pitch/energy predictor as the registry builds it, in
``eval()`` against JAX ``training=False``; then its ``train()``-mode
dropout.

Tolerances: the resize, the style encoder and the discriminator rtol
1e-5 (atol 1e-5 x max; the resize's float32 source coordinates alone put
it ~2e-6 off at 87 -> 43 -> 45); the losses and their gradients
rtol 1e-6; the predictor 1e-4 x max |JAX| (its float32 AdaIN stack is
that far off float64 on both sides, tests/test_torch_text_predictors.py).
Dropout: the keep rate within 3 sigma of 1 - p, the kept values scaled by
1/(1 - p) (rtol 1e-6).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.ops.duration import DurationProcessor as JaxDurationProcessor
from stylish_tts_torch import losses as L
from stylish_tts_torch.models import build_models
from stylish_tts_torch.models.discriminators import PitchDiscriminator
from stylish_tts_torch.models.style_encoder import PitchStyleEncoder, resize_linear
from test_torch_synth_common import (
    f0_contour, j, jax_params, port_config, randn, t, tiny_jax_config, to_port,
)

L_TEXT = 24
LENGTHS = np.array([L_TEXT, L_TEXT - 9], np.int32)


def _close(ours, ref, tol):
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("sizes", [(440, 220, 221), (41, 20, 23), (87, 43, 45),
                                   (10, 37, 8)])
def test_resize_matches_jax_image_resize(sizes):
    """Half-pixel linear resize with held edges, at ratios that are not
    integers, down and up."""
    n, first, second = sizes
    x = randn((2, n), n)
    ref = jax.image.resize(j(x), (2, first), "linear", antialias=False)
    ref = np.asarray(jax.image.resize(ref, (2, second), "linear", antialias=False))
    ours = resize_linear(resize_linear(t(x), first), second).numpy()
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("t_frames,coarse,mel_frames", [(440, 2, 221), (87, 2, 45),
                                                        (60, 1, 41)])
def test_pitch_style_encoder_matches_jax(t_frames, coarse, mel_frames):
    mc = tiny_jax_config()
    mc.coarse_multiplier = coarse
    jmod = jax_build_model(mc)["pe_style_encoder"]
    style_mel = randn((2, mc.style_encoder.n_mels, mel_frames), 1)
    pitch = f0_contour(t_frames, 2)
    energy = randn((2, t_frames), 3)
    args = (j(style_mel), j(pitch), j(energy))
    variables = jax_params(lambda k: jmod.init(k, *args), seed=4)
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, *args))(variables))
    port = to_port(build_models(port_config(mc))["pe_style_encoder"], variables)
    assert isinstance(port, PitchStyleEncoder)
    with torch.no_grad():
        ours = port(t(style_mel), t(pitch), t(energy)).numpy()
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("name,channels", [("pitch_disc", 2), ("dur_disc", 1)])
def test_pitch_discriminator_matches_jax(name, channels):
    mc = tiny_jax_config()
    jmod = jax_build_model(mc)[name]
    y = randn((2, channels, 57), 5, scale=50.0)
    variables = jax_params(lambda k: jmod.init(k, j(y)), seed=6)
    ref = [np.asarray(a) for a in jax.jit(lambda v: jmod.apply(v, j(y)))(variables)]
    port = to_port(build_models(port_config(mc))[name], variables)
    assert isinstance(port, PitchDiscriminator)
    with torch.no_grad():
        ours = port(t(y))
    assert len(ours) == len(ref) == 5
    for o, r in zip(ours, ref):
        _close(o.numpy(), r, 1e-5)


def test_prosody_losses_and_gradients_match_jax():
    rng = np.random.default_rng(7)
    pitch, energy = f0_contour(50, 8), rng.normal(-2.0, 1.0, (2, 50)).astype(np.float32)
    # differences on both sides of the Huber knee at 1
    pred_pitch = (pitch + rng.normal(0.0, 2.0, pitch.shape)).astype(np.float32)
    pred_energy = (energy + rng.normal(0.0, 0.7, energy.shape)).astype(np.float32)

    def jax_total(pp, pe, p, e):
        m = JL.pitch_energy_losses(pp, p, pe, e)
        return m["pitch"] + 2.0 * m["energy"], m

    (ref_total, ref_m), ref_grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2, 3),
                                                        has_aux=True)(
        j(pred_pitch), j(pred_energy), j(pitch), j(energy))
    args = [t(a).requires_grad_(True) for a in (pred_pitch, pred_energy, pitch, energy)]
    m = L.pitch_energy_losses(args[0], args[2], args[1], args[3])
    (m["pitch"] + 2.0 * m["energy"]).backward()
    for k in ("pitch", "energy"):
        np.testing.assert_allclose(float(m[k].detach()), float(ref_m[k]), rtol=1e-6)
    for a, g in zip(args, ref_grads):
        got = np.zeros_like(np.asarray(g)) if a.grad is None else a.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-6, atol=1e-9)
    # the targets are stop-gradient on both sides
    assert not np.asarray(ref_grads[2]).any() and args[2].grad is None
    np.testing.assert_allclose(
        float(L.smooth_l1(args[0], args[2]).detach()),
        float(JL.smooth_l1(j(pred_pitch), j(pitch))), rtol=1e-6)


def _predictor_inputs(mc, seed=0):
    rng = np.random.default_rng(seed)
    texts = rng.integers(1, mc.text_encoder.tokens, (2, L_TEXT)).astype(np.int32)
    texts[1, LENGTHS[1]:] = 0
    style = randn((2, mc.style_dim), seed + 1)
    durations = rng.uniform(1.0, 4.0, (2, L_TEXT)).astype(np.float32)
    durations[1, LENGTHS[1]:] = 0.0
    alignment = np.asarray(JaxDurationProcessor().duration_to_alignment(j(durations), 100))
    return texts, style, alignment


@pytest.fixture(scope="module")
def predictor():
    mc = tiny_jax_config()
    texts, style, alignment = _predictor_inputs(mc, 10)
    jmod = jax_build_model(mc)["pitch_energy_predictor"]
    args = (j(texts), j(LENGTHS), j(alignment), j(style))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args), seed=12)
    ref = [np.asarray(a) for a in jax.jit(
        lambda v: jmod.apply(v, *args, training=False))(variables)]
    port = to_port(build_models(port_config(mc))["pitch_energy_predictor"], variables)
    inputs = (t(texts).long(), t(LENGTHS).long(), t(alignment), t(style))
    return mc, port, inputs, ref


def test_pitch_energy_predictor_eval_matches_jax(predictor):
    _mc, port, inputs, ref = predictor
    port.eval()
    with torch.no_grad():
        ours = port(*inputs, generator=torch.Generator().manual_seed(0))
    for o, r in zip(ours, ref):
        _close(o.numpy(), r, 1e-4)


def _capture(port, inputs, generator):
    """A train()-mode forward; each dropout site's input and output: the
    f0 head's first block (after its first leaky ReLU) and the prosody
    encoder's first FFN (after its ReLU)."""
    seen = {}
    hooks = [
        port.f0_0.norm1.register_forward_hook(
            lambda m, a, out: seen.__setitem__("block_in", F.leaky_relu(out, 0.2))),
        port.f0_0.conv1.register_forward_pre_hook(
            lambda m, a: seen.__setitem__("block_out", a[0])),
        port.prosody_encoder.ffn_0.conv1.register_forward_hook(
            lambda m, a, out: seen.__setitem__("ffn_in", torch.relu(out))),
        port.prosody_encoder.ffn_0.conv2.register_forward_pre_hook(
            lambda m, a: seen.__setitem__("ffn_out", a[0])),
    ]
    port.train()
    try:
        with torch.no_grad():
            out = port(*inputs, generator=generator)
    finally:
        for h in hooks:
            h.remove()
        port.eval()
    return out, seen


def test_pitch_energy_predictor_train_mode_dropout(predictor):
    mc, port, inputs, ref = predictor
    out, seen = _capture(port, inputs, torch.Generator().manual_seed(3))
    x_mask = (torch.arange(L_TEXT)[None, :] < inputs[1][:, None])[:, None]
    for site, p in (("block", mc.pitch_energy_predictor.dropout), ("ffn", 0.2)):
        before, after = seen[site + "_in"], seen[site + "_out"]
        live = before != 0
        if site == "ffn":
            live &= x_mask
        kept = (after != 0) & live
        n = int(live.sum())
        rate = float(kept.sum()) / n
        assert abs(rate - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n), (site, rate, n)
        np.testing.assert_allclose(after[kept].numpy(), (before[kept] / (1 - p)).numpy(),
                                   rtol=1e-6)
    # the same generator seed gives the same output, another seed another one;
    # eval() is the identity whatever the generator
    again, _ = _capture(port, inputs, torch.Generator().manual_seed(3))
    other, _ = _capture(port, inputs, torch.Generator().manual_seed(4))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert not torch.equal(out[0], other[0])
    assert not np.allclose(out[0].numpy(), ref[0], atol=1e-4 * np.abs(ref[0]).max())
    with torch.no_grad():
        e1 = port(*inputs, generator=torch.Generator().manual_seed(3))
        e2 = port(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(e1, e2))
