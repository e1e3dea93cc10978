"""The port's text encoder, duration predictor, prosody encoder and
pitch/energy predictor against the JAX package's, at the tiny config.

A padded batch: lengths L and L - 9 in a bucket of L tokens, so the
additive -1e4 mask, the masked convs and the padded rows all count; both
the valid and the padded rows are compared. Tolerance: max |port - JAX|
<= 1e-4 * max |JAX| for a whole module, 1e-5 for the RoPE rotation alone.
(The float32 pitch/energy predictor itself is ~1e-4 * max off its own
float64 result on both sides: AdaIN over frames and the stacked norms
amplify the last bits, so an elementwise 1e-4 would test float32, not the
port.)
"""

import numpy as np
import pytest
import torch

import jax

from stylish_tts_tpu.models.duration_predictor import DurationPredictor as JaxDP
from stylish_tts_tpu.models.pitch_energy_predictor import PitchEnergyPredictor as JaxPE
from stylish_tts_tpu.models.prosody_encoder import ProsodyEncoder as JaxProsody
from stylish_tts_tpu.models.text_encoder import TextEncoder as JaxTextEncoder
from stylish_tts_tpu.models.text_encoder import rope_rotate as jax_rope
from stylish_tts_tpu.ops.duration import DurationProcessor as JaxDurationProcessor
from stylish_tts_torch.models.duration_predictor import DurationPredictor
from stylish_tts_torch.models.pitch_energy_predictor import PitchEnergyPredictor
from stylish_tts_torch.models.prosody_encoder import ProsodyEncoder
from stylish_tts_torch.models.text_encoder import TextEncoder, rope_rotate
from test_torch_synth_common import (
    bct, btc, jax_params, j, port_config, randn, t, tiny_jax_config, to_port,
)

L = 24
LENGTHS = np.array([L, L - 9], np.int32)
TOL = 1e-4


def _texts(mc, seed=0):
    rng = np.random.default_rng(seed)
    texts = rng.integers(1, mc.text_encoder.tokens, (2, L)).astype(np.int32)
    texts[1, LENGTHS[1]:] = 0
    return texts


def _close(ours, ref):
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_rope_rotate_matches_jax():
    x = randn((2, L, 4, 32), 1)
    ref = np.asarray(jax_rope(j(x), 16))
    ours = rope_rotate(t(x), 16).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["main", "pitch_energy"])
def test_text_encoder_matches_jax(which):
    mc = tiny_jax_config()
    inter = mc.inter_dim if which == "main" else 48
    texts = _texts(mc)
    jmod = JaxTextEncoder(inter_dim=inter, config=mc.text_encoder)
    variables = jax_params(lambda k: jmod.init({"params": k}, j(texts), j(LENGTHS)))
    ref = [np.asarray(a) for a in
           jax.jit(lambda v: jmod.apply(v, j(texts), j(LENGTHS)))(variables)]
    port = to_port(TextEncoder(inter, port_config(mc).text_encoder), variables)
    with torch.no_grad():
        mu, hidden, mask = port(t(texts).long(), t(LENGTHS).long())
    _close(btc(mu), ref[0])
    _close(btc(hidden), ref[1])
    _close(btc(mask), ref[2])
    assert (btc(mu)[1, LENGTHS[1]:] == 0).all()


def test_duration_predictor_matches_jax():
    mc = tiny_jax_config()
    texts = _texts(mc, 1)
    style = randn((2, mc.style_dim), 2)
    jmod = JaxDP(style_dim=mc.style_dim, inter_dim=mc.inter_dim,
                 text_config=mc.text_encoder, duration_config=mc.duration_predictor)
    args = (j(texts), j(LENGTHS), j(style))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args))
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, *args))(variables))
    pmc = port_config(mc)
    port = to_port(DurationPredictor(pmc.style_dim, pmc.inter_dim, pmc.text_encoder,
                                     pmc.duration_predictor), variables)
    with torch.no_grad():
        ours = port(t(texts).long(), t(LENGTHS).long(), t(style)).numpy()
    _close(ours, ref)
    assert (ours[1, LENGTHS[1]:] == 0).all()
    assert (ours <= 0).all()


def test_prosody_encoder_matches_jax():
    mc = tiny_jax_config()
    x = randn((2, L, mc.inter_dim), 3)
    style = randn((2, mc.style_dim), 4)
    jmod = JaxProsody(style_dim=mc.style_dim, d_model=mc.inter_dim)
    args = (j(x), j(style), j(LENGTHS))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args))
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, *args))(variables))
    port = to_port(ProsodyEncoder(mc.style_dim, mc.inter_dim), variables)
    with torch.no_grad():
        ours = btc(port(bct(x), t(style), t(LENGTHS).long()))
    _close(ours, ref)


def test_pitch_energy_predictor_matches_jax():
    mc = tiny_jax_config()
    texts = _texts(mc, 5)
    style = randn((2, mc.style_dim), 6)
    durations = np.random.default_rng(7).uniform(1.0, 4.0, (2, L)).astype(np.float32)
    durations[1, LENGTHS[1]:] = 0.0
    alignment = np.asarray(JaxDurationProcessor().duration_to_alignment(j(durations), 100))
    jmod = JaxPE(style_dim=mc.style_dim, inter_dim=mc.pitch_energy_predictor.inter_dim,
                 text_config=mc.text_encoder, duration_config=mc.duration_predictor,
                 pe_config=mc.pitch_energy_predictor)
    args = (j(texts), j(LENGTHS), j(alignment), j(style))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args))
    ref_pitch, ref_energy = (np.asarray(a) for a in
                             jax.jit(lambda v: jmod.apply(v, *args))(variables))
    pmc = port_config(mc)
    port = to_port(PitchEnergyPredictor(pmc.style_dim, pmc.pitch_energy_predictor.inter_dim,
                                        pmc.text_encoder), variables)
    with torch.no_grad():
        pitch, energy = port(t(texts).long(), t(LENGTHS).long(), t(alignment), t(style))
    _close(pitch.numpy(), ref_pitch)
    _close(energy.numpy(), ref_energy)
