"""The port's SpeechPredictor (text encoder -> alignment -> decoder ->
generator) against the JAX package's, at the tiny config, and the port's
stochastic sine source.

As in tests/test_torch_generator.py, parity runs with an injected
broadband prior (no shared RNG stream; the deterministic harmonic prior's
round-off phases are not comparable). Tolerance: audio after the tanh
1e-4 absolute. The random source: the same seed gives the same audio
(exactly), another seed other audio.
"""

import numpy as np
import torch

import jax

from stylish_tts_tpu.models.speech_predictor import SpeechPredictor as JaxSpeechPredictor
from stylish_tts_tpu.ops.duration import DurationProcessor as JaxDurationProcessor
from stylish_tts_torch.models.speech_predictor import SpeechPredictor
from test_torch_synth_common import (
    HOP, f0_contour, jax_params, j, port_config, randn, t, tiny_jax_config, to_port,
)


def _speech_case(mc, frames, seed):
    rng = np.random.default_rng(seed)
    n, L = 14, 32
    texts = np.zeros((1, L), np.int32)
    texts[0, :n] = rng.integers(1, mc.text_encoder.tokens, n)
    lengths = np.array([n], np.int32)
    durations = np.zeros((1, L), np.float32)
    durations[0, :n] = rng.uniform(0.5, 1.5, n) * frames / (n * 1.1)
    alignment = np.asarray(JaxDurationProcessor().duration_to_alignment(j(durations),
                                                                        frames))
    pitch = f0_contour(frames, seed + 1, unvoiced=False)[:1]
    energy = randn((1, frames), seed + 2)
    voiced = (pitch > 20.0).astype(np.float32)
    style = randn((1, mc.style_dim), seed + 3)
    return texts, lengths, alignment, pitch, energy, voiced, style


def test_speech_predictor_matches_jax():
    """Text encoder -> alignment -> decoder -> generator, injected prior,
    40 frames."""
    mc = tiny_jax_config()
    texts, lengths, alignment, pitch, energy, voiced, style = _speech_case(mc, 40, 30)
    prior = np.tanh(randn((1, 40 * HOP), 35, 0.3))
    jmod = JaxSpeechPredictor(model_config=mc)
    args = (j(texts), j(lengths), j(alignment), j(pitch), j(energy), j(voiced),
            j(style), j(pitch))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args, rng=k))
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, *args, rng=jax.random.PRNGKey(4),
                                                  prior=j(prior)).audio)(variables))
    port = to_port(SpeechPredictor(port_config(mc)), variables)
    with torch.no_grad():
        ours = port(t(texts).long(), t(lengths).long(), t(alignment), t(pitch),
                    t(energy), t(voiced), t(style), t(pitch),
                    prior=t(prior)).audio.numpy()
    assert ours.shape == (1, 40 * HOP)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_random_source_reproducible_from_its_seed():
    """The port's stochastic source: the same seed gives the same audio,
    another seed other audio."""
    torch.manual_seed(0)
    mc = port_config(tiny_jax_config())
    sp = SpeechPredictor(mc).eval()
    case = [t(a) for a in _speech_case(tiny_jax_config(), 12, 40)]
    case[0], case[1] = case[0].long(), case[1].long()

    def run(seed):
        gen = [torch.Generator().manual_seed(seed)]
        with torch.no_grad():
            return sp(*case, case[3], generator=gen).audio

    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
