"""The port's YIN (``dataprep/pitch.py``) against the JAX package's
``yin_pitch`` on the same seeded signals, and the port's ``pitch`` command
on the CPU.

Tolerances: voicing equal on >= 99.5 % of frames; F0 within 1e-4
relative on the frames voiced on both sides. The summation order of the
difference function differs (XLA against PyTorch), so a frame whose
normalised difference sits at the threshold may flip.
"""

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

import jax.numpy as jnp

from fixtures import make_micro_dataset
from stylish_tts_tpu.data.caches import load_cache as jax_load_cache
from stylish_tts_tpu.dataprep.pitch import yin_pitch as jax_yin
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.dataprep import pitch as pitch_mod

torch.set_num_threads(1)  # one per test worker, as tests/test_torch_synth_common.py

SR, HOP = 24000, 300
VOICING_AGREE = 0.995
F0_RTOL = 1e-4


def _signals(seed=0, seconds=1.0):
    """Harmonic sweep 80 -> 400 Hz, white noise, silence, and a quiet
    voiced phrase (-60 dB, with a pause) in one batch."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 80.0 * (400.0 / 80.0) ** (t / seconds)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sweep = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.3
    noise = 0.2 * rng.standard_normal(n)
    silence = np.zeros(n)
    quiet = 1e-3 * np.sin(2 * np.pi * np.cumsum(150 + 20 * np.sin(2 * np.pi * 2 * t)) / SR)
    quiet[int(0.4 * n):int(0.6 * n)] = 0.0
    quiet += 1e-6 * rng.standard_normal(n)
    return np.stack([sweep, noise, silence, quiet]).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    audio = _signals()
    frames = audio.shape[1] // HOP
    ref = np.asarray(jax_yin(jnp.asarray(audio), hop=HOP, frames=frames, sample_rate=SR))
    return audio, frames, ref


@pytest.mark.parametrize("chunk_taus", [481, 50])
def test_yin_matches_jax(both, monkeypatch, chunk_taus):
    """Whole lag range at once, and in chunks of 50 lags (not a divisor of
    481)."""
    audio, frames, ref = both
    monkeypatch.setattr(pitch_mod, "CHUNK_ELEMENTS", chunk_taus * frames * 4 * 1024)
    ours = pitch_mod.yin_pitch(torch.from_numpy(audio), hop=HOP, frames=frames,
                               sample_rate=SR).numpy()
    assert ours.shape == ref.shape == (4, frames)
    agree = np.mean((ours > 0) == (ref > 0))
    assert agree >= VOICING_AGREE, agree
    both_voiced = (ours > 0) & (ref > 0)
    assert both_voiced[0].sum() > 0.8 * frames  # the sweep is voiced
    assert both_voiced[3].sum() > 0.3 * frames  # and so is the quiet phrase
    np.testing.assert_allclose(ours[both_voiced], ref[both_voiced], rtol=F0_RTOL)
    assert not (ours[2] > 0).any()  # silence


def test_yin_tracks_the_sweep(both):
    """The sweep's F0 within 2 % on its voiced frames (the window trails
    the frame by W / 2 samples, where the sweep is ~1 % lower)."""
    audio, frames, _ = both
    ours = pitch_mod.yin_pitch(torch.from_numpy(audio[:1]), hop=HOP, frames=frames,
                               sample_rate=SR).numpy()[0]
    centre = (np.arange(frames) * HOP - pitch_mod.WINDOW / 2) / SR
    truth = 80.0 * 5.0 ** centre
    ok = (ours > 0) & (centre > 0.05) & (centre < 0.95)
    assert ok.sum() > 0.8 * frames
    assert np.median(np.abs(ours[ok] / truth[ok] - 1)) < 0.02


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("pitch")
    data = make_micro_dataset(str(root / "data"), n_train=3, n_val=2,
                              with_caches=False)
    cfg = root / "config.yml"
    cfg.write_text(yaml.safe_dump({"dataset": {"path": data}}), encoding="utf-8")
    return root, data, cfg


def test_pitch_cli_on_cpu(dataset):
    """``pitch --device cpu`` writes an F0 for every segment of both splits
    at its padded frame count, readable by the JAX package."""
    root, data, cfg = dataset
    result = CliRunner().invoke(train_cli, [
        "pitch", "--config", str(cfg), "--out", str(root / "out"), "--device", "cpu"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    cache = jax_load_cache(f"{data}/pitch.safetensors")
    assert sorted(cache) == sorted([f"tr{i}.wav" for i in range(3)]
                                   + [f"va{i}.wav" for i in range(2)])
    for f0 in cache.values():
        assert f0.dtype == np.float32 and np.isfinite(f0).all()
        assert (f0 > 0).mean() > 0.5  # the chirps are voiced


def test_pitch_rmvpe_is_not_ported(dataset):
    """RMVPE is ported (``tests/test_torch_rmvpe.py``) but has no weights of
    its own: without a local ``--rmvpe-weights`` file the command refuses
    and names the option (the JAX command's hub download is not ported)."""
    root, _, cfg = dataset
    result = CliRunner().invoke(train_cli, [
        "pitch", "--config", str(cfg), "--out", str(root / "o"), "--method", "rmvpe",
        "--device", "cpu"])
    assert result.exit_code != 0
    assert "--rmvpe-weights" in result.output and "downloads nothing" in result.output


def test_pitch_cuda_without_a_card_raises(dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, _, cfg = dataset
    result = CliRunner().invoke(train_cli, [
        "pitch", "--config", str(cfg), "--out", str(root / "o")])
    assert isinstance(result.exception, RuntimeError)
    assert "CUDA is not available" in str(result.exception)


def test_extract_pitch_defaults_to_cuda():
    """Called as the JAX function is (no device), the port's asks for CUDA
    and raises where there is none, before it reads the dataset."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pitch_mod.extract_pitch_for_dataset(None, HOP, SR)
