"""The port's ``train-align`` CLI end to end on the CPU, and the aligner
it writes read back by the JAX package.

The CLI runs with ``--device cpu`` at full width (aligner 640, 80 mels,
179 classes: ~4.9M parameters) on ``tests/fixtures.py::make_micro_dataset``
for one epoch. ``alignment_model.safetensors`` is in the JAX flat layout:
``stylish_tts_tpu.utils.params_io.load_params_safetensors`` loads it and
JAX ``TextAligner.apply`` matches the port's forward (atol 1e-5).
"""

import re

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

import jax.numpy as jnp

from fixtures import make_micro_dataset
from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_tpu.utils.params_io import load_params_safetensors
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.models.text_aligner import TextAligner
from stylish_tts_torch.utils.params_io import load_text_aligner_safetensors


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("align")
    data = make_micro_dataset(str(root / "data"), n_train=6, n_val=2)
    cfg = {
        "training": {"log_interval": 1, "data_workers": 2},
        "training_plan": {"alignment": {"epochs": 1, "probe_batch_max": 128,
                                        "lr": 1e-5}},
        "dataset": {"path": data},
    }
    cfg_path = root / "config.yml"
    cfg_path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    out = root / "out"
    result = CliRunner().invoke(train_cli, [
        "train-align", "--config", str(cfg_path), "--out", str(out),
        "--device", "cpu",
    ])
    return root, data, out, result


def test_train_align_cli_on_cpu(trained):
    root, data, out, result = trained
    assert result.exit_code == 0, result.output + repr(result.exception)
    log = (out / "alignment" / "train.log").read_text(encoding="utf-8")
    losses = [float(x) for x in re.findall(r"align_loss: ([-\w.+]+)", log)]
    assert losses and all(np.isfinite(losses)), losses
    assert (root / "data" / "alignment_model.safetensors").is_file()
    assert (out / "normalization.json").is_file()


def test_saved_aligner_loads_in_jax_and_matches_port(trained):
    _, data, _, result = trained
    assert result.exit_code == 0
    path = f"{data}/alignment_model.safetensors"
    params = load_params_safetensors(path)
    port = TextAligner()
    load_text_aligner_safetensors(path, port)
    port.eval()

    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 40, 80)).astype(np.float32)
    lengths = np.array([40, 31], np.int32)
    ref = np.asarray(JaxAligner().apply(params, jnp.asarray(mel),
                                        jnp.asarray(lengths)))
    with torch.no_grad():
        ours = port(torch.from_numpy(mel), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_cuda_without_a_card_raises(tmp_path):
    """``--device cuda`` never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg_path = tmp_path / "config.yml"
    cfg_path.write_text("dataset: {path: .}\n", encoding="utf-8")
    result = CliRunner().invoke(train_cli, [
        "train-align", "--config", str(cfg_path), "--out", str(tmp_path / "o"),
    ])
    assert result.exit_code != 0
    assert isinstance(result.exception, RuntimeError)
    assert "CUDA is not available" in str(result.exception)
