"""The port's RMVPE (``dataprep/rmvpe.py``) against the JAX package's.

The weights are the port's seeded ``random_rmvpe_state_dict`` (BatchNorm
affine and running statistics drawn away from 0 and 1); the JAX side gets
the same state_dict through its ``convert_rmvpe_torch`` (BatchNorm folded,
the transposed conv as an input-dilated conv, the GRU as two scans), or the
same safetensors file through its ``RMVPEPitchExtractor``. Inputs are made
with numpy from a seed:

* the network at T = 64 frames: salience within 1e-4 absolute;
* ``rmvpe_log_mel``: 1e-4 relative to each value (the log-mel of 0.5 s of
  16 kHz audio, clamp included);
* ``decode_f0``: 1e-5 relative, the unvoiced frames (peak under 0.03) 0 on
  both sides;
* the extractor on two 24 kHz clips: the voicing agrees on >= 99 % of the
  frames and F0 within 1e-3 relative where both are voiced;
* ``pitch --method rmvpe --rmvpe-weights`` through the CLI on the CPU
  writes the extractor's F0 for every segment; without ``--rmvpe-weights``
  it raises naming the option, and without ``--device cpu`` it needs CUDA;
  so does ``RMVPEPitchExtractor`` called without a device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from safetensors.torch import save_file

from fixtures import make_micro_dataset
from stylish_tts_tpu.dataprep import rmvpe as jrmvpe
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.data.caches import load_cache
from stylish_tts_torch.data.wav import read_wav
from stylish_tts_torch.dataprep import rmvpe

torch.set_num_threads(1)

VOICING_AGREE = 0.99


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The seeded state_dict, the port's network and its safetensors file."""
    sd = rmvpe.random_rmvpe_state_dict(0)
    model = rmvpe.E2E0()
    model.load_state_dict(sd)
    path = tmp_path_factory.mktemp("rmvpe") / "rmvpe.safetensors"
    save_file(sd, str(path))
    return sd, model.eval(), str(path)


def _audio(shape, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_network_matches_jax(weights):
    """Salience at T = 64 within 1e-4 absolute."""
    sd, model, _ = weights
    params = jrmvpe.convert_rmvpe_torch({k: v.numpy() for k, v in sd.items()})
    mel = _audio((2, rmvpe.N_MELS, 64), 1, scale=1.0) - 4.0
    ref = np.asarray(jax.jit(jrmvpe.rmvpe_forward)(params, jnp.asarray(mel)))
    with torch.no_grad():
        ours = model(torch.from_numpy(mel)).numpy()
    assert ours.shape == ref.shape == (2, 64, rmvpe.N_CLASS)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_log_mel_matches_jax():
    """1e-4 relative per value, at the 16 kHz hop of a 24 kHz / 300 model."""
    audio = _audio((2, 8000), 2)
    audio[1, 2000:3000] = 0.0  # a silent stretch: the clamp at 1e-5
    ref = np.asarray(jrmvpe.rmvpe_log_mel(jnp.asarray(audio), 200))
    ours = rmvpe.rmvpe_log_mel(torch.from_numpy(audio), 200).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=0)


def test_decode_matches_jax():
    """1e-5 relative; frames whose peak is under 0.03 are 0 on both sides."""
    rng = np.random.default_rng(3)
    sal = (0.5 * rng.random((2, 40, rmvpe.N_CLASS)) ** 4).astype(np.float32)
    sal[:, 5:9] *= 0.02  # unvoiced
    sal[0, 20, :3] = 0.9  # a peak at the lower edge
    sal[1, 30, -2:] = 0.9  # and at the upper one
    ref = np.asarray(jrmvpe.decode_f0(jnp.asarray(sal)))
    ours = rmvpe.decode_f0(torch.from_numpy(sal)).numpy()
    assert (ref[:, 5:9] == 0).all() and (ours[:, 5:9] == 0).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=0)


def test_extractor_matches_jax(weights):
    """Two 24 kHz clips of 0.8 s: voicing agrees on >= 99 % of the frames,
    F0 within 1e-3 relative where both are voiced."""
    _, _, path = weights
    t = np.arange(19200) / 24000
    audio = np.stack([0.4 * np.sin(2 * np.pi * 140 * t), 0.3 * np.sin(2 * np.pi * 220 * t)])
    audio = (audio + _audio(audio.shape, 4, scale=0.02)).astype(np.float32)
    ref = jrmvpe.RMVPEPitchExtractor(path, 24000, 300).infer(audio)
    ours = rmvpe.RMVPEPitchExtractor(path, 24000, 300, device="cpu").infer(audio)
    assert ours.shape == ref.shape
    agree = np.mean((ours > 0) == (ref > 0))
    assert agree >= VOICING_AGREE
    both = (ours > 0) & (ref > 0)
    assert both.any()
    np.testing.assert_allclose(ours[both], ref[both], rtol=1e-3, atol=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("rmvpe_cli")
    data = make_micro_dataset(str(root / "data"), n_train=3, n_val=1,
                              uniform_duration=True, with_caches=False)
    (root / "config.yml").write_text(yaml.safe_dump({"dataset": {"path": data}}),
                                     encoding="utf-8")
    return root, data


def _pitch(root, *extra):
    return CliRunner().invoke(train_cli, [
        "pitch", "--config", str(root / "config.yml"), "--out", str(root / "out"),
        *extra], standalone_mode=False)


def test_pitch_command_runs_rmvpe(weights, corpus):
    """Every segment's F0 is the extractor's on that segment's padded audio."""
    _, _, path = weights
    root, data = corpus
    result = _pitch(root, "--method", "rmvpe", "--rmvpe-weights", path, "--device", "cpu")
    assert result.exit_code == 0, result.output + repr(result.exception)
    cache = load_cache(f"{data}/pitch.safetensors")
    assert len(cache) == 4
    extractor = rmvpe.RMVPEPitchExtractor(path, 24000, 300, device="cpu")
    name = sorted(cache)[0]
    audio = read_wav(f"{data}/wav-dir/{name}", 24000)
    frames = cache[name].shape[0]
    pad = frames * 300 - audio.shape[0]
    audio = np.pad(audio, (pad // 2, pad - pad // 2))[None]
    np.testing.assert_allclose(cache[name], extractor.infer(audio)[0, :frames],
                               rtol=1e-5, atol=0)


def test_pitch_rmvpe_needs_weights_and_a_device(weights, corpus):
    root, _ = corpus
    result = _pitch(root, "--method", "rmvpe", "--device", "cpu")
    assert result.exit_code != 0 and "--rmvpe-weights" in str(result.exception)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    result = _pitch(root, "--method", "rmvpe", "--rmvpe-weights", weights[2])
    assert isinstance(result.exception, RuntimeError)
    assert "CUDA is not available" in str(result.exception)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present")
def test_extractor_defaults_to_cuda(weights):
    """Called as the JAX extractor is (no device), the port's asks for CUDA
    and raises where there is none, instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rmvpe.RMVPEPitchExtractor(weights[2], 24000, 300)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rmvpe.load_rmvpe(weights[2])
