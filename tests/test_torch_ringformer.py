"""The port's ringformer generator family against the JAX package's, and
the modules of the same slice: the period discriminators, the text style
encoder, and a ``generator.scan_stacks`` tree through the weight bridge.

Sizes are those of tests/test_models.py's ringformer case:
``upsample_initial_channel`` 64, rates (4, 5), iSTFT n_fft 60 / hop 15
(300 samples per frame), two conformer blocks per scale. Weights are
flax values from a seed moved with the bridge; inputs are seeded numpy.

The pcph prior is held alone with zero initial phase (``rng=None`` /
``generator=None``), at a tolerance that scales with its largest phase:
its phase reaches P_h = 2 pi h hop c_max at harmonic h (c_max the
largest frame-start cycle count, a float32 cumulative sum over frames),
and two implementations round it differently (ROADMAP Queue 3). With a
per-harmonic amplitude a = 0.1 sqrt(2 / n_harm) (n_harm the fewest
harmonics under Nyquist in the batch), the tolerance is
a * sum_h 4 ulp(P_h): 4 ulps of each harmonic's largest phase. The
generator is held with an injected broadband prior (a harmonic prior's
near-zero STFT bins make its atan2 phase round-off): audio, log-amplitude
and phase at atol 1e-4, in both ``faithful`` modes.

Other tolerances: ``TransposeConv1d`` and the discriminators' scores and
feature maps, the text style encoder and the scan-stacks generator
(before its tanh) at 1e-4 relative to the largest JAX value;
``magphase_loss`` and its gradient rtol 1e-5.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.models import build_model
from stylish_tts_tpu.models.discriminators import (
    MultiPeriodDiscriminator as JaxMPD,
)
from stylish_tts_tpu.models.generator import Generator as JaxGenerator
from stylish_tts_tpu.dsp import stft as jstft
from stylish_tts_tpu.models import ringformer as jax_ringformer
from stylish_tts_tpu.models.ringformer import TransposeConv1d as JaxTransposeConv1d
from stylish_tts_tpu.models.ringformer import UpsampleGenerator as JaxUpsampleGenerator
from stylish_tts_tpu.models.ringformer import generate_pcph as jax_pcph
from stylish_tts_tpu.models.text_style_encoder import TextStyleEncoder as JaxTextStyleEncoder
from stylish_tts_torch import losses as L
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.dsp import stft as pstft
from stylish_tts_torch.convert.from_jax import module_from_jax, module_to_jax_flat
from stylish_tts_torch.models import build_inference_models
from stylish_tts_torch.models.discriminators import MultiPeriodDiscriminator
from stylish_tts_torch.models.generator import Generator
from stylish_tts_torch.models.ringformer import (
    TransposeConv1d, UpsampleGenerator, generate_pcph,
)
from stylish_tts_torch.models.text_style_encoder import TextStyleEncoder
from test_torch_generator import _gen_kwargs
from test_torch_synth_common import (
    bct, btc, f0_contour, j, jax_params, port_config, randn, t, tiny_jax_config, to_port,
)

SR = 24000
RATES, N_FFT, ISTFT_HOP, CH = (4, 5), 60, 15, 64
PRIOR_HOP = math.prod(RATES) * ISTFT_HOP
STYLE, IN_DIM = 16, 32

# the full-width ringformer speech predictor: (leaves, parameters) of the
# whole tree and of its generator
FULL_WIDTH = {"speech_predictor": (571, 12_969_192), "generator": (373, 8_059_774)}


def _ulp(x: float) -> float:
    return float(np.spacing(np.float32(x)))


def _rel_close(ours, ref, rel=1e-4):
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("frames", [40, 600])
def test_generate_pcph_zero_phase_matches_jax(frames):
    f0 = f0_contour(frames, 3)
    f0[1, :5] = 1300.0  # harmonics above Nyquist are masked
    voiced = (f0 > 0).astype(np.float32)
    ref = np.asarray(jax_pcph(j(f0), j(voiced), PRIOR_HOP, SR, None))
    ours = generate_pcph(t(f0), t(voiced), PRIOR_HOP, SR, None).numpy()
    assert ours.shape == (2, frames * PRIOR_HOP)
    c_max = float(np.cumsum(f0 / SR, axis=1).max())
    n_harm = min(16, int(SR / 2 // f0.max()))
    amplitude = 0.1 * math.sqrt(2.0 / n_harm)
    tol = amplitude * sum(4 * _ulp(2 * math.pi * h * PRIOR_HOP * c_max) for h in range(1, 17))
    err = np.abs(ours - ref).max()
    assert err <= tol, (err, tol)


def test_pcph_rows_draw_their_own_phase():
    """One generator per row: a row's prior is the same alone or in a batch,
    and two rows seeded alike start alike; generator=None starts at zero."""
    f0 = f0_contour(30, 4)
    voiced = (f0 > 0).astype(np.float32)

    def gens(n):
        return [torch.Generator().manual_seed(7) for _ in range(n)]

    both = generate_pcph(t(f0), t(voiced), PRIOR_HOP, SR, gens(2))
    for r in range(2):
        alone = generate_pcph(t(f0[r:r + 1]), t(voiced[r:r + 1]), PRIOR_HOP, SR, gens(1))
        torch.testing.assert_close(both[r:r + 1], alone, rtol=0, atol=0)
    zero = generate_pcph(t(f0), t(voiced), PRIOR_HOP, SR, None)
    assert not torch.equal(both, zero)


@pytest.mark.parametrize("kernel,stride,padding", [(8, 4, 2), (10, 5, 2), (3, 2, 0)])
def test_transpose_conv_matches_jax(kernel, stride, padding):
    x = randn((2, 13, 6), 8)
    jmod = JaxTransposeConv1d(5, kernel, stride, padding)
    variables = jax_params(lambda k: jmod.init(k, j(x)))
    ref = np.asarray(jmod.apply(variables, j(x)))
    port = to_port(TransposeConv1d(6, 5, kernel, stride, padding), variables)
    with torch.no_grad():
        ours = btc(port(bct(x)))
    assert ours.shape[1] == (13 - 1) * stride + kernel - 2 * padding
    _rel_close(ours, ref)


def _upsample_kwargs(faithful):
    return dict(upsample_rates=RATES, upsample_initial_channel=CH, gen_istft_n_fft=N_FFT,
                gen_istft_hop_size=ISTFT_HOP, sample_rate=SR, faithful=faithful)


@pytest.mark.parametrize("faithful", [False, True], ids=["default", "faithful"])
def test_upsample_generator_matches_jax(faithful, monkeypatch):
    """With ``faithful`` the prior's STFT is reflect-padded: its first
    frame is then symmetric about its centre (the periodic Hann window is
    0 at sample 0), so that frame's spectrum is real and its imaginary
    part round-off, whose sign picks +pi or -pi in the atan2. That STFT is
    held here on its own (magnitude, real and imaginary parts atol 1e-4;
    the first frame's imaginary parts under 1e-5 on both sides),
    and the JAX generator is then handed the port's STFT, so that both
    sides take the same atan2 of the same numbers.

    The ``conv_post`` kernel is scaled by 0.1, both sides, so that the
    log-amplitude stays within a few units, as a trained head's does:
    seeded N(0, 1/fan_in) weights give |logamp| up to 17, whose exp makes
    float32 round-off of the head as large as the audio's tolerance."""
    frames = 24
    mel = randn((2, frames, IN_DIM), 30)
    style = randn((2, STYLE), 31)
    pitch = f0_contour(frames, 32)
    voiced = (pitch > 0).astype(np.float32)
    prior = np.tanh(randn((2, frames * PRIOR_HOP), 33, 0.3))
    jmod = JaxUpsampleGenerator(style_dim=STYLE, **_upsample_kwargs(faithful))
    args = dict(mel=j(mel), style=j(style), pitch=j(pitch), energy=j(np.zeros_like(pitch)),
                voiced=j(voiced), prior=j(prior))
    variables = jax_params(lambda k: jmod.init({"params": k}, rng=k, **args))
    conv_post = variables["params"]["conv_post"]["Conv_0"]
    conv_post["kernel"] = conv_post["kernel"] * 0.1
    if faithful:
        ours_stft = pstft.stft_magnitude_unit_phase(t(prior), N_FFT, ISTFT_HOP, N_FFT,
                                                    pad_mode="reflect")
        ref_stft = jstft.stft_magnitude_unit_phase(j(prior), N_FFT, ISTFT_HOP, N_FFT,
                                                   pad_mode="reflect")
        (pm, px, py), (jm, jx, jy) = ([np.asarray(a) for a in v]
                                      for v in (ours_stft, ref_stft))
        for ours, ref in ((pm, jm), (px * pm, jx * jm), (py * pm, jy * jm)):
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
        for m, y in ((pm, py), (jm, jy)):  # the first frame's spectrum is real
            assert np.abs(y[:, :, 0] * m[:, :, 0]).max() < 1e-5
        shared = tuple(j(a.numpy()) for a in ours_stft)
        monkeypatch.setattr(jax_ringformer, "stft_lib", SimpleNamespace(
            stft_magnitude_unit_phase=lambda *a, **k: shared, istft=jstft.istft))
    ref = jax.jit(lambda v: jmod.apply(v, rng=jax.random.PRNGKey(1), **args))(variables)
    port = to_port(UpsampleGenerator(IN_DIM, STYLE, **_upsample_kwargs(faithful)), variables)
    with torch.no_grad():
        ours = port(mel=bct(mel), style=t(style), pitch=t(pitch), voiced=t(voiced),
                    prior=t(prior))
    assert ours.audio.shape == (2, frames * PRIOR_HOP)
    for name in ("audio", "magnitude", "phase"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_magphase_loss_and_gradient_match_jax():
    frames = 50
    audio = randn((2, frames * ISTFT_HOP), 40, 0.3)
    audio[1, 200:400] = 0.0  # bins under the 1e-3 mask
    t_real, t_imag = jstft.stft(j(audio), N_FFT, ISTFT_HOP, N_FFT)
    p_real, p_imag = pstft.stft(t(audio), N_FFT, ISTFT_HOP, N_FFT)
    n = t_real.shape[-1]
    mag = randn((2, N_FFT // 2 + 1, n), 41)
    phase = randn((2, N_FFT // 2 + 1, n), 42, 2.0)

    def jloss(m, p):
        out = JL.magphase_loss(m, p, t_real, t_imag)
        return out["mag"] + 8.0 * out["phase"], out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        j(mag), j(phase))
    pm, pp = t(mag).requires_grad_(), t(phase).requires_grad_()
    pout = L.magphase_loss(pm, pp, p_real, p_imag)
    (pout["mag"] + 8.0 * pout["phase"]).backward()
    for k in ("mag", "phase"):
        np.testing.assert_allclose(pout[k].item(), float(jout[k]), rtol=1e-5, err_msg=k)
    for ours, ref in ((pm.grad, jgrads[0]), (pp.grad, jgrads[1])):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-9)


def test_multi_period_discriminator_matches_jax():
    audio = randn((2, 1001), 50, 0.3)  # pads to a multiple of every period
    jmod = JaxMPD()
    variables = jax_params(lambda k: jmod.init(k, j(audio)))
    ref_score, ref_fmaps = jax.jit(jmod.apply)(variables, j(audio))
    port = to_port(MultiPeriodDiscriminator(), variables)
    with torch.no_grad():
        score, fmaps = port(t(audio))
    _rel_close(score.numpy(), np.asarray(ref_score))
    assert len(fmaps) == len(ref_fmaps) == 5 * 6
    for ours, ref in zip(fmaps, ref_fmaps):
        _rel_close(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def test_text_style_encoder_matches_jax():
    x = randn((2, 17, IN_DIM), 60)
    lengths = np.array([17, 9], np.int32)
    jmod = JaxTextStyleEncoder(inter_dim=IN_DIM, style_dim=STYLE)
    variables = jax_params(lambda k: jmod.init(k, j(x), j(lengths)))
    ref = np.asarray(jmod.apply(variables, j(x), j(lengths)))
    port = to_port(TextStyleEncoder(IN_DIM, STYLE), variables)
    with torch.no_grad():
        ours = port(bct(x), t(lengths)).numpy()
    assert ours.shape == (2, STYLE)
    _rel_close(ours, ref)


def test_full_width_ringformer_tree_maps_both_ways():
    """The default ``ModelConfig()`` with ``generator.type: ringformer``:
    every flax leaf of the speech predictor (shapes from ``jax.eval_shape``)
    maps to a port tensor, none is left over, and the round trip gives
    the same keys and shapes."""
    mc = JaxModelConfig()
    mc.generator.type = "ringformer"
    model = build_model(mc)["speech_predictor"]
    n_t, n_f = 12, 8
    texts, lengths = jnp.ones((1, n_t), jnp.int32), jnp.full((1,), n_t, jnp.int32)
    pitch, zeros = jnp.full((1, n_f), 100.0), jnp.zeros((1, n_f))
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, texts, lengths, jnp.ones((1, n_t, n_f)) / n_t, pitch, zeros,
        jnp.ones((1, n_f)), jnp.zeros((1, mc.style_dim)), pitch, rng=k),
        jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}
    gen = {k: s for k, s in want.items() if k.startswith("params/generator/")}
    for name, tree in (("speech_predictor", want), ("generator", gen)):
        assert (len(tree), sum(int(np.prod(s)) for s in tree.values())) == FULL_WIDTH[name]
    module = build_inference_models(ModelConfig.model_validate(mc.model_dump()))[
        "speech_predictor"]
    sd = module_from_jax(module, {k: np.zeros(s, np.float32) for k, s in want.items()})
    assert set(sd) == set(module.state_dict())
    assert sum(v.numel() for v in sd.values()) == FULL_WIDTH["speech_predictor"][1]
    back = module_to_jax_flat(module)
    assert {k: v.shape for k, v in back.items()} == want


def test_scan_stacks_tree_loads_and_writes_back():
    """A FreeGAN base generator with ``scan_stacks``: its rolled ConvNeXt
    stacks load into the port's unrolled blocks, the forward matches the
    JAX scan forward, and the port writes the stacked tree back bitwise."""
    mc = tiny_jax_config()
    frames, hop = 30, 300
    mel = randn((1, frames, mc.n_fft // 2), 70)
    style = randn((1, mc.style_dim), 71)
    pitch = f0_contour(frames, 72)[:1]
    voiced = (pitch > 0).astype(np.float32)
    prior = np.tanh(randn((1, frames * hop), 73, 0.3))
    jmod = JaxGenerator(**_gen_kwargs(mc, jax=True), scan_stacks=True)
    args = (j(mel), j(style), j(pitch), j(voiced))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args, rng=k,
                                              prior=j(prior)))
    flat = flatten_dict(variables, sep="/")
    assert any("amp_convnext_scan/block/" in k for k in flat)
    assert any("phase_convnext_scan/block/" in k for k in flat)
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, *args, rng=jax.random.PRNGKey(2),
                                                  prior=j(prior)))(variables))
    port = to_port(Generator(**_gen_kwargs(port_config(mc))), variables)
    assert hasattr(port, "amp_convnext_0") and hasattr(port, "phase_convnext_0")
    with torch.no_grad():
        ours = port(bct(mel), t(style), t(pitch), t(voiced), prior=t(prior)).numpy()
    _rel_close(ours, ref)
    back = module_to_jax_flat(port, scan_stacks=True)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
