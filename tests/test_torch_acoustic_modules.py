"""The acoustic stage's modules in the port against the JAX package.

Each module gets the same weights through the bridge
(``convert/from_jax.py``), both ways (flax -> port and port -> flax), and
the same numpy inputs from a seed:

* ``spectral_normalize`` (the stateless 3-iteration power method, sigma
  stop-gradient) on conv and dense kernels, and its gradient: 1e-5
  relative;
* ``MelStyleEncoder`` (spectral-normed 2D convs, raw kernels on both
  sides), ``SpecDiscriminator`` (explicit (1,1)/(4,4) pads) and
  ``ContextFreeDiscriminator`` (waveform windows, grouped convs,
  GroupNorm): 1e-4 of the output's largest magnitude;
* ``MultiSpectrogram`` (mel, masked phase, |FFT|) at the three
  resolutions: 1e-4 of the largest magnitude (the phase: its wrapped
  error times the bin's magnitude, off the 1e-3 mask edge; a bin of
  magnitude ~1e-3 carries ~1e-4 rad from float32 round-off alone);
* the gradient of a loss of the three resolutions' features with respect
  to the audio, torch autograd of unfold + matmul against the JAX custom
  VJP ``_framed_dft_bwd``: 1e-4 of the gradient's largest magnitude; the
  phase's gradient is finite at digital silence, where the JAX package's
  is NaN (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.dsp.multi_spectrogram import MultiSpectrogram as JaxMultiSpectrogram
from stylish_tts_tpu.models.common import spectral_normalize as jax_spectral_normalize
from stylish_tts_tpu.models.discriminators import (
    ContextFreeDiscriminator as JaxContextFree,
)
from stylish_tts_tpu.models.discriminators import SpecDiscriminator as JaxSpec
from stylish_tts_tpu.models.style_encoder import MelStyleEncoder as JaxMelStyleEncoder
from stylish_tts_torch.convert.from_jax import module_from_jax, module_to_jax_flat
from stylish_tts_torch.dsp.multi_spectrogram import MultiSpectrogram
from stylish_tts_torch.models.common import spectral_normalize
from stylish_tts_torch.models.discriminators import (
    ContextFreeDiscriminator,
    SpecDiscriminator,
)
from stylish_tts_torch.models.style_encoder import MelStyleEncoder
from stylish_tts_torch.utils.params_io import unflatten
from test_torch_synth_common import jax_params, randn, t

SR = 24000


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("shape", [(3, 3, 4, 8), (1, 1, 16, 32), (3, 9, 1, 32), (24, 7)])
def test_spectral_normalize_matches_jax(shape):
    kernel = randn(shape, 1)
    ref = np.asarray(jax_spectral_normalize(jnp.asarray(kernel)))
    if len(shape) == 4:  # flax (H, W, I, O) -> torch (O, I, H, W)
        w = t(kernel.transpose(3, 2, 0, 1))
        out = spectral_normalize(w).numpy().transpose(2, 3, 1, 0)
    else:  # Dense (in, out) -> Linear (out, in)
        w = t(kernel.T)
        out = spectral_normalize(w).numpy().T
    assert _rel(out, ref) < 1e-5
    # sigma is a constant of the backward: d sum(w / sigma * c) / dw = c / sigma
    c = randn(shape, 2)
    g_ref = np.asarray(jax.grad(
        lambda k: jnp.sum(jax_spectral_normalize(k) * jnp.asarray(c)))(jnp.asarray(kernel)))
    w.requires_grad_(True)
    c_t = t(c.transpose(3, 2, 0, 1)) if len(shape) == 4 else t(c.T)
    (spectral_normalize(w) * c_t).sum().backward()
    g = w.grad.numpy()
    g = g.transpose(2, 3, 1, 0) if len(shape) == 4 else g.T
    assert _rel(g, g_ref) < 1e-5


def _style_encoder_pair():
    # 80 mels: three halvings leave 10 rows for the 5x5 valid conv
    jm = JaxMelStyleEncoder(dim_in=80, style_dim=8, max_conv_dim=32)
    x = randn((2, 80, 45), 3)
    return jm, MelStyleEncoder(80, 8, 32), x, (jnp.asarray(x),), (t(x),)


def _spec_pair():
    x = np.abs(randn((2, 1, 65, 23), 4))
    return JaxSpec(), SpecDiscriminator(), x, (jnp.asarray(x),), (t(x),)


def _context_free_pair():
    x = randn((2, 3000), 5, 0.1)
    return (JaxContextFree(dim=16), ContextFreeDiscriminator(dim=16), x,
            (jnp.asarray(x),), (t(x),))


PAIRS = {"mel_style_encoder": _style_encoder_pair, "spec_disc": _spec_pair,
         "context_free_disc": _context_free_pair}


def _outputs(y):
    return [np.asarray(v) for v in (y if isinstance(y, (list, tuple)) else [y])]


@pytest.mark.parametrize("direction", ["flax_to_port", "port_to_flax"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_module_matches_jax_through_the_bridge(name, direction):
    jm, pm, _x, jargs, pargs = PAIRS[name]()
    if direction == "flax_to_port":
        variables = jax_params(lambda key: jm.init(key, *jargs), seed=7)
        pm.load_state_dict(module_from_jax(pm, variables))
    else:
        torch.manual_seed(7)
        for p in pm.parameters():  # move every leaf off its init constant
            p.data += 0.1 * torch.randn_like(p)
        variables = unflatten(module_to_jax_flat(pm))
        jm.init(jax.random.PRNGKey(0), *jargs)  # the tree must fit the module
        assert module_from_jax(pm, variables).keys() == pm.state_dict().keys()
    ref = _outputs(jax.jit(jm.apply)(variables, *jargs))
    with torch.no_grad():
        out = _outputs(pm(*pargs))
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4, (name, _rel(a, b))


def _audio(seed, n=7200):
    """Harmonics with a noise floor and a silent stretch (masked bins)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / SR
    a = sum(np.sin(2 * np.pi * f * tt + rng.uniform(0, 6)) / k
            for k, f in enumerate((150.0, 300.0, 450.0, 1200.0), 1))
    a = a * 0.3 + 0.01 * rng.standard_normal(n)
    a[n // 2: n // 2 + 2500] = 0.0
    return np.stack([a, a[::-1] * 0.5]).astype(np.float32)


def test_multi_spectrogram_matches_jax():
    audio = _audio(0)
    ref = JaxMultiSpectrogram(sample_rate=SR)(jnp.asarray(audio))
    out = MultiSpectrogram(sample_rate=SR)(t(audio))
    for i in range(3):
        assert _rel(out.mel[i].numpy(), ref.mel[i]) < 1e-4
        assert _rel(out.fft_mag[i].numpy(), ref.fft_mag[i]) < 1e-4
        mag = np.asarray(ref.fft_mag[i])[:, 0]
        # the phase's error times the bin's magnitude is the complex value's
        # error across it: held at 1e-4 of the largest magnitude, off the
        # mask's edge (where the two sides' masks may differ)
        d = out.phase[i].numpy() - np.asarray(ref.phase[i])
        d = np.abs(d - 2 * np.pi * np.round(d / (2 * np.pi)))
        clear = np.abs(mag - 1e-3) > 1e-5
        err = (mag * d)[clear].max() / mag.max()
        assert err < 1e-4, (i, err)
        masked = mag <= 1e-3
        assert masked.any() and (out.phase[i].numpy()[masked] == 0).all()


def test_stft_gradient_matches_the_jax_custom_vjp():
    audio = _audio(1)
    weights = [randn(f.shape, 10 + i) for i, f in
               enumerate(JaxMultiSpectrogram(sample_rate=SR)(jnp.asarray(audio)).fft_mag)]
    mel_w = [randn(f.shape, 20 + i) for i, f in
             enumerate(JaxMultiSpectrogram(sample_rate=SR)(jnp.asarray(audio)).mel)]

    def jax_loss(a):
        f = JaxMultiSpectrogram(sample_rate=SR)(a)
        return sum(jnp.sum(m * jnp.asarray(w)) for m, w in zip(f.fft_mag, weights)) \
            + sum(jnp.sum(m * jnp.asarray(w)) for m, w in zip(f.mel, mel_w))

    g_ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(audio)))
    a = t(audio).requires_grad_(True)
    f = MultiSpectrogram(sample_rate=SR)(a)
    loss = sum((m * t(w)).sum() for m, w in zip(f.fft_mag, weights)) \
        + sum((m * t(w)).sum() for m, w in zip(f.mel, mel_w))
    loss.backward()
    assert _rel(a.grad.numpy(), g_ref) < 1e-4
    # the masked phase sends no NaN to the audio; the JAX package's
    # mask * atan2 does at a bin of re = im = 0 (digital silence: 0 * NaN)
    a.grad = None
    sum(p.sum() for p in MultiSpectrogram(sample_rate=SR)(a).phase).backward()
    assert torch.isfinite(a.grad).all()
    g_phase = jax.grad(lambda x: sum(jnp.sum(p) for p in
                                     JaxMultiSpectrogram(sample_rate=SR)(x).phase))
    assert not np.isfinite(np.asarray(g_phase(jnp.asarray(audio)))).all()
