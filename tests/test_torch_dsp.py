"""The port's framed-DFT STFT and mel against the JAX package's.

Same audio (numpy, from a seed) at the align mel (n_fft 2048, win 1200,
hop 300: the padded Hann window differs from torch.stft's centred one)
and at the main mel (512, 512, 300). Tolerance: max |port - JAX| <=
1e-4 * max |JAX| on the power spectrum and the mel (float32 matmuls of
different summation order; near-empty bins make an elementwise rtol
meaningless).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stylish_tts_tpu.dsp import mel as jmel
from stylish_tts_tpu.dsp import stft as jstft
from stylish_tts_torch.dsp import mel as tmel
from stylish_tts_torch.dsp import stft as tstft

REL = 1e-4
CONFIGS = [(2048, 1200, 300), (512, 512, 300)]


def _audio(seed=0, b=2, samples=24000):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 24000.0
    tone = 0.4 * np.sin(2 * np.pi * 440.0 * t)
    return (tone + 0.1 * rng.standard_normal((b, samples))).astype(np.float32)


def _close(ours, ref):
    err = np.abs(ours - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("n_fft,win,hop", CONFIGS)
def test_stft_power_matches_jax(n_fft, win, hop):
    audio = _audio()
    jr, ji = jstft.stft(jnp.asarray(audio), n_fft, hop, win)
    tr, ti = tstft.stft(torch.from_numpy(audio), n_fft, hop, win)
    assert tuple(tr.shape) == tuple(jr.shape)
    j_pow = np.asarray(jr) ** 2 + np.asarray(ji) ** 2
    t_pow = (tr * tr + ti * ti).numpy()
    _close(t_pow, j_pow)


def test_stft_window_is_end_padded_not_centred():
    """A unit impulse at the first sample of frame 1 sees window[0] = 0 of
    the end-padded window; torch.stft's centred window would put the
    impulse at its zero padding too, so probe the last window sample."""
    n_fft, win, hop = 2048, 1200, 300
    audio = np.zeros((1, 6000), np.float32)
    # frame 1 starts at padded index 300 = audio index 300 - 1024 < 0, so
    # use frame 5: padded start 1500 -> audio index 476; window index 1199
    audio[0, 476 + 1199] = 1.0
    tr, ti = tstft.stft(torch.from_numpy(audio), n_fft, hop, win)
    jr, ji = jstft.stft(jnp.asarray(audio), n_fft, hop, win)
    t_mag = torch.sqrt(tr[0, :, 5] ** 2 + ti[0, :, 5] ** 2).numpy()
    j_mag = np.sqrt(np.asarray(jr)[0, :, 5] ** 2 + np.asarray(ji)[0, :, 5] ** 2)
    expected = 0.5 - 0.5 * np.cos(2 * np.pi * 1199 / 1200)  # periodic Hann
    np.testing.assert_allclose(t_mag, expected, rtol=1e-4)
    np.testing.assert_allclose(t_mag, j_mag, rtol=1e-4)


@pytest.mark.parametrize("n_fft,win,hop", CONFIGS)
def test_mel_matches_jax(n_fft, win, hop):
    audio = _audio(seed=1)
    kw = dict(n_mels=80, n_fft=n_fft, win_length=win, hop_length=hop,
              sample_rate=24000)
    j = np.asarray(jmel.MelSpectrogram(**kw)(jnp.asarray(audio)))
    t = tmel.MelSpectrogram(**kw)(torch.from_numpy(audio)).numpy()
    assert t.shape == j.shape == (2, 80, 24000 // hop + 1)
    _close(t, j)
    np.testing.assert_array_equal(
        tmel.mel_filterbank(80, n_fft, 24000), jmel.mel_filterbank(80, n_fft, 24000)
    )
