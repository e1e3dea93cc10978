"""The port's edge-padded STFT, magnitude/unit-phase and iSTFT against
the JAX package's.

Tolerances: max |port - JAX| <= 1e-5 * max |JAX| for the STFT and the
iSTFT (float32 matmuls of another summation order), the same for the
unit phase weighted by the magnitude (x / |X| is ill-conditioned where
|X| is small), and exact for the sign case: the phase of a bin whose
imaginary part is an exact zero (DC, and Nyquist for even n_fft) and
whose real part is negative is +pi on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stylish_tts_tpu.dsp import stft as jstft
from stylish_tts_torch.dsp import stft as tstft
from test_torch_synth_common import j, randn, t

REL = 1e-5


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("n_fft,hop", [(64, 4), (16, 4), (24, 5)])
def test_edge_padded_stft_matches_jax(n_fft, hop):
    audio = randn((2, 1200), 0)
    jr, ji = jstft.stft(j(audio), n_fft, hop, n_fft, center=True, pad_mode="edge")
    tr, ti = tstft.stft(t(audio), n_fft, hop, n_fft, center=True, pad_mode="edge")
    _close(tr, jr)
    _close(ti, ji)


def test_magnitude_unit_phase_matches_jax():
    audio = randn((2, 1200), 1) + 0.3
    jm, jx, jy = jstft.stft_magnitude_unit_phase(j(audio), 64, 4, 64)
    tm, tx, ty = tstft.stft_magnitude_unit_phase(t(audio), 64, 4, 64)
    _close(tm, jm)
    _close((tx * tm).numpy(), np.asarray(jx * jm))
    _close((ty * tm).numpy(), np.asarray(jy * jm))
    assert np.abs(tx.numpy() - np.asarray(jx)).max() < 1e-3


@pytest.mark.parametrize("n_fft", [16, 15])
def test_dc_and_nyquist_phase_of_a_negative_frame(n_fft):
    """A signal below zero everywhere: the DC bin's real part is negative
    and its imaginary part an exact zero; atan2 must give +pi (not -pi)
    on both sides, and so must Nyquist where it is negative."""
    rng = np.random.default_rng(2)
    audio = (-0.5 - np.abs(rng.standard_normal((1, 400)))).astype(np.float32)
    jm, jx, jy = jstft.stft_magnitude_unit_phase(j(audio), n_fft, 4, n_fft)
    j_phase = np.asarray(jnp.arctan2(jy * jm, jx * jm))
    tm, tx, ty = tstft.stft_magnitude_unit_phase(t(audio), n_fft, 4, n_fft)
    t_phase = torch.atan2(ty * tm, tx * tm).numpy()
    np.testing.assert_array_equal(t_phase[:, 0], np.float32(np.pi))
    np.testing.assert_array_equal(t_phase[:, 0], j_phase[:, 0])
    assert not np.signbit(ty.numpy()[:, 0]).any()
    if n_fft % 2 == 0:
        neg = tx.numpy()[:, -1] < 0
        assert neg.any()
        np.testing.assert_array_equal(t_phase[:, -1][neg], np.float32(np.pi))
        np.testing.assert_array_equal(t_phase[:, -1], j_phase[:, -1])


@pytest.mark.parametrize("uniform,normalize", [(True, False), (False, True)])
@pytest.mark.parametrize("n_fft,hop", [(64, 4), (24, 5)])
def test_istft_matches_jax(uniform, normalize, n_fft, hop):
    """Both inverse scalings, with and without the window envelope, and
    both overlap-add branches (hop divides n_fft, and not)."""
    freq = n_fft // 2 + 1
    real, imag = randn((2, freq, 50), 3), randn((2, freq, 50), 4)
    ref = jstft.istft(j(real), j(imag), n_fft, hop, n_fft, center=True,
                      normalize_window=normalize, uniform_scale=uniform)
    ours = tstft.istft(t(real), t(imag), n_fft, hop, n_fft, center=True,
                       normalize_window=normalize, uniform_scale=uniform)
    _close(ours, ref)


@pytest.mark.parametrize("n_fft,hop", [(64, 4), (24, 5)])
def test_overlap_add_matches_jax(n_fft, hop):
    frames = randn((2, 30, n_fft), 5)
    ref = jstft._overlap_add(j(frames), hop)
    ours = tstft.overlap_add(t(frames), hop)
    assert ours.shape == (2, 29 * hop + n_fft)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_istft_inverts_stft():
    """stft -> istft with the envelope normalisation gives the audio back
    away from the edges (the port alone)."""
    audio = randn((1, 2000), 6)
    real, imag = tstft.stft(t(audio), 64, 16, 64)
    back = tstft.istft(real, imag, 64, 16, 64, length=2000)
    np.testing.assert_allclose(back.numpy()[:, 64:-64], audio[:, 64:-64], atol=1e-5)
