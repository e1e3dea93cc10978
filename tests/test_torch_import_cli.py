"""``import-torch`` through the port's CLI, and on to ``convert``,
``voicepack --device cpu`` and ``speak --device cpu``; the JAX
``import-torch`` and ``convert`` on the same reference checkpoint.

The checkpoint is ``convert/reference_layout.py``'s seeded fixture at the
JAX import test's widths (``_small_mc`` of
tests/test_torch_checkpoint_import.py) with the default 178 text tokens,
so that the micro dataset's phonemes and the spoken lines tokenize, and
the default 16 duration classes, the width of both packages' fixed
class-to-duration table, which synthesis reads. Held:

* the port's checkpoint: stage ``duration``, ``imported_weights`` and the
  affine ``norm_mode`` in its ``model_config.json``, every module of
  ``state.pt`` the port's import bitwise, fresh optimizers, and the aligner
  beside it in the JAX flat layout;
* ``convert``, ``voicepack`` and ``speak`` on it unchanged: finite styles,
  finite and non-silent speech;
* the two packages' ``params.safetensors``: the same six modules, every
  leaf bitwise. The JAX ``convert`` restores its orbax checkpoint into an
  abstract tree of the import's shapes (zeros) in place of its eager
  ``init_all_params``, which takes over a minute on the CPU.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from safetensors.numpy import load_file

from fixtures import make_micro_dataset
from stylish_tts_tpu import cli as jcli
from stylish_tts_tpu.trainer import init as jax_init
from stylish_tts_torch.cli import train_cli, tts_cli
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.convert.checkpoint_import import import_torch_checkpoint, imported_models
from stylish_tts_torch.convert.from_jax import flatten
from stylish_tts_torch.convert.reference_layout import random_reference_checkpoint
from stylish_tts_torch.data.wav import read_wav
from stylish_tts_torch.models import INFERENCE_MODULES
from stylish_tts_torch.trainer.checkpoint import ALIGNER_FILE, STATE_FILE, read_manifest
from test_torch_checkpoint_import import _small_mc


def _mc():
    mc = _small_mc(ModelConfig())
    default = ModelConfig()
    mc.text_encoder.tokens = default.text_encoder.tokens
    mc.duration_predictor.duration_classes = default.duration_predictor.duration_classes
    return mc


def _invoke(cli, *args):
    result = CliRunner().invoke(cli, list(args), standalone_mode=False)
    assert result.exit_code == 0, result.output + repr(result.exception)
    return result.return_value


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Both packages' ``import-torch`` -> ``convert`` on one reference
    checkpoint; the port's chain goes on to ``voicepack`` and ``speak``."""
    root = tmp_path_factory.mktemp("import_cli")
    data = make_micro_dataset(str(root / "data"), n_train=3, n_val=1)
    (root / "config.yml").write_text(yaml.safe_dump({"dataset": {"path": data}}),
                                     encoding="utf-8")
    (root / "model.yml").write_text(yaml.safe_dump(_mc().model_dump()), encoding="utf-8")
    random_reference_checkpoint(str(root / "reference"), _mc(), seed=4)
    common = ["--config", str(root / "config.yml")]
    ckpt = _invoke(train_cli, "import-torch", *common, "--model-config",
                   str(root / "model.yml"), "--checkpoint", str(root / "reference"),
                   "--out", str(root / "imported"))
    _invoke(train_cli, "convert", *common, "--checkpoint", ckpt, "--out", str(root / "pkg"))
    styles = _invoke(train_cli, "voicepack", *common, "--checkpoint", ckpt, "--out",
                     str(root / "voice.safetensors"), "--device", "cpu")
    (root / "lines.txt").write_text("ðə kˈæt sˈæt\nhˈɛloʊ wˈɜːld\n", encoding="utf-8")
    _invoke(tts_cli, "speak", "--model", str(root / "pkg"), "--voicepack",
            str(root / "voice.safetensors"), "--text", str(root / "lines.txt"), "--out",
            str(root / "speech.wav"), "--device", "cpu")
    # the JAX convert restores into an abstract tree from an eager
    # init_all_params of all 13 modules (~75 s on the CPU); zeros of the
    # import's shapes serve as that tree: every value comes from the restore
    shapes = import_torch_checkpoint(str(root / "reference"), _mc())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STYLISH_TPU_CACHE", "0")  # no compile cache under the home directory
        mp.setattr(jax_init, "init_all_params", lambda models, mc, rng: jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32), shapes))
        _invoke(jcli.train_cli, "import-torch", *common, "--model-config",
                str(root / "model.yml"), "--checkpoint", str(root / "reference"),
                "--out", str(root / "jax_imported"))
        jax_ckpt = sorted((root / "jax_imported").glob("checkpoint_*"))[-1]
        _invoke(jcli.train_cli, "convert", *common, "--checkpoint", str(jax_ckpt),
                "--out", str(root / "jax_pkg"))
    return {"root": root, "ckpt": ckpt, "styles": styles}


def test_import_writes_a_duration_checkpoint(chains):
    ckpt = Path(chains["ckpt"])
    assert read_manifest(str(ckpt)).stage == "duration"
    saved_mc = json.loads((ckpt / "model_config.json").read_text(encoding="utf-8"))
    assert saved_mc["imported_weights"] and saved_mc["generator"]["norm_mode"] == "affine"
    saved = torch.load(ckpt / STATE_FILE, weights_only=True)
    assert all(not o["state"] for o in saved["optimizers"].values())  # fresh AdamW
    assert saved["step"] == 0
    mc = _mc()
    params = import_torch_checkpoint(str(chains["root"] / "reference"), mc)
    models = imported_models(params, mc)
    aligner = models.pop("text_aligner")
    assert set(saved["models"]) == set(models)
    for name, module in models.items():
        for k, v in module.state_dict().items():
            assert torch.equal(saved["models"][name][k], v), (name, k)
    aligner_flat = load_file(str(ckpt / ALIGNER_FILE))
    ours = {f"params/{k}": v for k, v in flatten(params["text_aligner"]["params"]).items()}
    assert aligner_flat.keys() == ours.keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(aligner_flat[k], v, err_msg=k)
    assert aligner.tdnn_norm[0].mode == "affine"


def test_voicepack_and_speak_run_on_the_import(chains):
    styles = chains["styles"]
    assert styles["lengths"].shape[0] == 3
    for k in ("speech", "pe", "duration"):
        assert np.isfinite(styles[k]).all() and np.abs(styles[k]).max() > 0
    wav = read_wav(str(chains["root"] / "speech.wav"), 24000)
    assert wav.shape[0] > 0 and np.isfinite(wav).all()
    assert float(np.sqrt(np.mean(wav ** 2))) > 1e-3


def test_both_packages_convert_to_the_same_params_bitwise(chains):
    ours = load_file(str(chains["root"] / "pkg" / "params.safetensors"))
    theirs = load_file(str(chains["root"] / "jax_pkg" / "params.safetensors"))
    assert {k.split("/")[0] for k in ours} == set(INFERENCE_MODULES)
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        assert v.dtype == theirs[k].dtype
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)
