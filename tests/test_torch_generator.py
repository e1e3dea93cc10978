"""The port's FreeGAN generator path against the JAX package's, at the
tiny config (n_fft 128: conformer width 64, head n_fft 16 / hop 4).

No two frameworks share an RNG stream. The sine source alone is held
against JAX with ``deterministic_prior=True`` (zero initial phases and
noise); it integrates its phase in float32 over frames, where both sides
round differently (ROADMAP Queue 3), so at a tolerance that scales with
max |phase| * 2^-23. The generator and everything above it are held
against JAX with an injected broadband prior: the deterministic harmonic
prior is constant over the first and last hop/2 samples (the linear
resize clamps there) and in unvoiced stretches, so most of the head
STFT's bins hold round-off noise there, whose atan2 phase no two STFT
implementations share (the JAX package says so for its own parity runs,
``trainer/steps.py`` ``parity_prior``; ROADMAP Queue 3 has the error). The
deterministic path is held against the port's own source injected as the
prior, exactly.

Tolerances: the sine source 0.1 * sum |merge weights| * 16 ulp(max
|phase|); the generator before its tanh max |port - JAX| <= 1e-4 * max
|JAX|; audio after the tanh 1e-4 absolute.
"""

import math

import numpy as np
import pytest
import torch

import jax

from stylish_tts_tpu.models.generator import Generator as JaxGenerator
from stylish_tts_tpu.models.generator import MultiGenerator as JaxMultiGenerator
from stylish_tts_tpu.models.generator import SineSource as JaxSineSource
from stylish_tts_torch.models.generator import (
    Generator, MultiGenerator, SineSource, pixel_shuffle_1d,
)
from test_torch_synth_common import (
    HOP, SR, bct, f0_contour, jax_params, j, port_config, randn, t, tiny_jax_config,
    to_port,
)

def _gen_kwargs(mc, jax=False):
    extra = dict(win_length=mc.win_length) if jax else {}
    return dict(style_dim=mc.style_dim, n_fft=mc.n_fft, hop_length=HOP, **extra,
                sample_rate=SR, scale=8, scalehop=75, start_fft=0,
                hidden_dim=mc.n_fft // 16, input_dim=mc.n_fft // 2,
                io_conv_kernel_size=mc.generator.io_conv_kernel_size,
                conv_layers=mc.generator.conv_layers, upsample_rates=(3, 5, 5))


def _rel_close(ours, ref, rel=1e-4):
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("frames", [40, 1000])
def test_sine_source_deterministic_matches_jax(frames):
    f0 = f0_contour(frames, 0)
    jmod = JaxSineSource(sample_rate=SR, hop_length=HOP, deterministic=True)
    key = jax.random.PRNGKey(1)
    variables = jax_params(lambda k: jmod.init({"params": k}, j(f0), key))
    ref = np.asarray(jmod.apply(variables, j(f0), key))
    port = to_port(SineSource(SR, HOP), variables)
    with torch.no_grad():
        ours = port(t(f0), None, deterministic=True).numpy()
    assert ours.shape == (2, frames * HOP)
    max_phase = float((np.cumsum(np.mod(f0[:, None, :] * np.arange(1, 10)[None, :, None]
                                        / SR, 1.0), axis=-1) * 2 * math.pi * HOP).max())
    weights = np.abs(variables["params"]["merge"]["kernel"]).sum()
    tol = 0.1 * weights * 16 * max_phase * 2.0 ** -23
    err = np.abs(ours - ref).max()
    assert err <= tol, (err, tol, max_phase)


def test_pixel_shuffle_is_c_major():
    h = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    out = pixel_shuffle_1d(h, 3)
    assert out.shape == (2, 2, 12)
    for c in range(2):
        for s in range(3):
            torch.testing.assert_close(out[:, c, s::3], h[:, c * 3 + s, :])


def _generator_case(mc, frames, seed):
    mel = randn((1, frames, mc.n_fft // 2), seed)
    style = randn((1, mc.style_dim), seed + 1)
    pitch = f0_contour(frames, seed + 2)[:1]
    voiced = (pitch > 0).astype(np.float32)
    prior = np.tanh(randn((1, frames * HOP), seed + 3, 0.3))
    return mel, style, pitch, voiced, prior


def test_generator_matches_jax():
    """Base generator, injected prior, one frame bucket (100 frames)."""
    mc = tiny_jax_config()
    mel, style, pitch, voiced, prior = _generator_case(mc, 100, 10)
    jmod = JaxGenerator(**_gen_kwargs(mc, jax=True))
    args = (j(mel), j(style), j(pitch), j(voiced))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args, rng=k,
                                              prior=j(prior)))
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, *args, rng=jax.random.PRNGKey(2),
                                                  prior=j(prior)))(variables))
    port = to_port(Generator(**_gen_kwargs(port_config(mc))), variables)
    with torch.no_grad():
        ours = port(bct(mel), t(style), t(pitch), t(voiced), prior=t(prior)).numpy()
    assert ours.shape == (1, 100 * HOP)
    _rel_close(ours, ref)


def test_multi_generator_matches_jax():
    """Conformer front end + base generator, injected prior, 100 frames."""
    mc = tiny_jax_config()
    _, style, pitch, voiced, prior = _generator_case(mc, 100, 20)
    mel = randn((1, 100, mc.decoder.hidden_dim), 24)
    jmod = JaxMultiGenerator(style_dim=mc.style_dim, n_fft=mc.n_fft,
                             win_length=mc.win_length, hop_length=HOP, sample_rate=SR,
                             config=mc.generator)
    args = dict(mel=j(mel), style=j(style), pitch=j(pitch),
                energy=j(np.zeros_like(pitch)), voiced=j(voiced), prior=j(prior))
    variables = jax_params(lambda k: jmod.init({"params": k}, rng=k, **args))
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, rng=jax.random.PRNGKey(3),
                                                  **args).audio)(variables))
    pmc = port_config(mc)
    port = to_port(MultiGenerator(pmc.decoder.hidden_dim, pmc.style_dim, pmc.n_fft, HOP,
                                  SR, pmc.generator), variables)
    with torch.no_grad():
        ours = port(mel=bct(mel), style=t(style), pitch=t(pitch), voiced=t(voiced),
                    prior=t(prior)).audio.numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_deterministic_prior_is_the_deterministic_source():
    """``deterministic_prior=True`` runs the generator on the sine
    source's deterministic output (held against JAX above), exactly."""
    torch.manual_seed(0)
    mc = port_config(tiny_jax_config())
    gen = MultiGenerator(mc.decoder.hidden_dim, mc.style_dim, mc.n_fft, HOP, SR,
                         mc.generator).eval()
    _, style, pitch, voiced, _ = _generator_case(tiny_jax_config(), 12, 50)
    mel = t(randn((1, mc.decoder.hidden_dim, 12), 51))
    pitch, voiced, style = t(pitch), t(voiced), t(style)
    with torch.no_grad():
        det = gen(mel=mel, style=style, pitch=pitch, voiced=voiced,
                  deterministic_prior=True).audio
        prior = gen.basegen.source(pitch * voiced, None, deterministic=True)
        injected = gen(mel=mel, style=style, pitch=pitch, voiced=voiced,
                       prior=prior).audio
    torch.testing.assert_close(det, injected, rtol=0, atol=0)
