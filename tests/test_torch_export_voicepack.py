"""Export of a trained voice on the port: ``convert`` and ``voicepack``,
against the JAX package.

A later-stage checkpoint of the port (the twelve modules of ``build_models``
at the tiny config, seeded; normalization stats away from the defaults) on
``tests/fixtures.py::make_micro_dataset`` with its pitch and alignment
caches goes through the port's CLI on the CPU: ``convert``, then
``voicepack`` and ``voicepack --dynamic``.

* The package holds the six ``INFERENCE_MODULES``; the JAX
  ``load_params_safetensors`` tree of each equals the port's flat export of
  the checkpoint's module bitwise, and goes back into the port bitwise; the
  JAX ``InferencePackage`` loads the package. A card run's checkpoint (CUDA
  generator states) converts on the CPU to the same package; an alignment
  checkpoint is refused.
* ``convert``'s pitch stats equal a numpy transcription of the JAX
  command's (the F0 values above 10 Hz, their log2 mean and std floored at
  1e-6, in float32; 7.0 / 1.0 without them), and its duration stats the
  JAX ``duration_stats_from_cache`` of the alignment cache.
* ``encode_all_styles`` (the styles ``voicepack`` returns) against the JAX
  ``encode_all_styles`` with the package's weights: each style within 1e-4
  of its largest magnitude, the token counts equal.
* The JAX ``load_voicepack`` reads both packs: the static rows equal the
  port's bitwise, the dynamic pack's embeddings are the hashed embedder's
  of the segments' texts in the styles' order; the port reads a pack the
  JAX package wrote.
* ``voicepack`` without ``--device cpu`` needs CUDA.
"""

import json
import shutil

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from safetensors.numpy import load_file

from fixtures import make_micro_dataset
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.data.dataset import FilePathDataset as JaxDataset
from stylish_tts_tpu.export.package import INFERENCE_MODULES as JAX_MODULES
from stylish_tts_tpu.export.package import InferencePackage as JaxPackage
from stylish_tts_tpu.export.package import duration_stats_from_cache as jax_duration_stats
from stylish_tts_tpu.models import build_model
from stylish_tts_tpu.text import TextCleaner as JaxTextCleaner
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.tts import voicepack as jvoicepack
from stylish_tts_tpu.utils.params_io import load_params_safetensors
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.config import Config
from stylish_tts_torch.convert.from_jax import flatten, module_from_jax, module_to_jax_flat
from stylish_tts_torch.data.caches import load_cache
from stylish_tts_torch.export.package import pitch_log2_stats
from stylish_tts_torch.models import INFERENCE_MODULES, build_models
from stylish_tts_torch.textproc.embed import get_embedder
from stylish_tts_torch.trainer.checkpoint import STATE_FILE, Manifest, save_checkpoint
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.tts import voicepack
from test_torch_synth_common import port_config, tiny_jax_config

STYLE_RTOL = 1e-4


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    # two time bins, so that the styles' order (sorted bins) is not the list's
    data = make_micro_dataset(str(root / "data"), n_train=5, n_val=2)
    cfg = {"dataset": {"path": data}}
    (root / "config.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    mc = port_config(tiny_jax_config())
    torch.manual_seed(0)
    state = create_stage_train_state(build_models(mc), "cpu", "duration")
    norm = NormalizationStats(mel_log_mean=-3.0, mel_log_std=2.5)
    ckpt = save_checkpoint(str(root / "duration"), state, Manifest(stage="duration"),
                           Config.model_validate(cfg), mc, norm)
    runner = CliRunner()

    def run(*args):
        result = runner.invoke(train_cli, [*args, "--config", str(root / "config.yml"),
                                           "--checkpoint", ckpt], standalone_mode=False)
        assert result.exit_code == 0, result.output + repr(result.exception)
        return result.return_value

    run("convert", "--out", str(root / "pkg"))
    styles = run("voicepack", "--out", str(root / "static.safetensors"), "--device", "cpu")
    run("voicepack", "--out", str(root / "dynamic.safetensors"), "--device", "cpu",
        "--dynamic")
    return {"root": root, "data": data, "state": state, "norm": norm, "styles": styles,
            "ckpt": ckpt}


def test_export_round_trips_to_the_jax_tree(exported):
    """Six modules; each JAX leaf equals the port's flat export bitwise, and
    goes back into the port bitwise."""
    tree = load_params_safetensors(str(exported["root"] / "pkg" / "params.safetensors"))
    assert set(tree) == set(INFERENCE_MODULES) == set(JAX_MODULES)
    models = exported["state"].models
    for name in INFERENCE_MODULES:
        ours = module_to_jax_flat(models[name])
        theirs = flatten(tree[name])
        assert set(theirs) == set(ours)
        for k, v in ours.items():
            assert theirs[k].dtype == v.dtype
            np.testing.assert_array_equal(theirs[k], v)
        back = module_from_jax(models[name], tree[name])
        for k, v in models[name].state_dict().items():
            assert torch.equal(back[k], v), (name, k)


def test_convert_reads_a_card_checkpoint(exported, tmp_path):
    """A card run's checkpoint (its two device generators' states are a CUDA
    generator's 16 bytes) converts on the CPU to the same package: convert
    reads the weights alone, not the optimizers or the generator streams."""
    card = tmp_path / "card_checkpoint"
    shutil.copytree(exported["ckpt"], card)
    saved = torch.load(card / STATE_FILE, weights_only=True)
    for g in ("dropout_generator", "model_generator"):
        saved["generators"][g] = torch.zeros(16, dtype=torch.uint8)
    torch.save(saved, card / STATE_FILE)
    result = CliRunner().invoke(train_cli, [
        "convert", "--config", str(exported["root"] / "config.yml"), "--checkpoint",
        str(card), "--out", str(tmp_path / "pkg")], standalone_mode=False)
    assert result.exit_code == 0, result.output + repr(result.exception)
    ours = load_file(str(tmp_path / "pkg" / "params.safetensors"))
    ref = load_file(str(exported["root"] / "pkg" / "params.safetensors"))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_convert_refuses_an_alignment_checkpoint(exported, tmp_path):
    """A checkpoint without the later stages' modules (an alignment one)
    is refused with the trainer's message, not exported at random init."""
    align = tmp_path / "alignment_checkpoint"
    shutil.copytree(exported["ckpt"], align)
    saved = torch.load(align / STATE_FILE, weights_only=True)
    torch.save({k: v for k, v in saved.items() if k != "models"}, align / STATE_FILE)
    result = CliRunner().invoke(train_cli, [
        "convert", "--config", str(exported["root"] / "config.yml"), "--checkpoint",
        str(align), "--out", str(tmp_path / "pkg")], standalone_mode=False)
    assert isinstance(result.exception, ValueError)
    assert "holds no module of the acoustic" in str(result.exception)
    assert not (tmp_path / "pkg" / "params.safetensors").exists()


def test_jax_package_loads_the_port_package(exported):
    pkg = exported["root"] / "pkg"
    jpkg = JaxPackage(str(pkg))
    assert set(jpkg.params) == set(JAX_MODULES)
    meta = json.loads((pkg / "metadata.json").read_text(encoding="utf-8"))
    assert meta["framework"] == "stylish_tts_torch"
    assert jpkg.normalization.mel_log_mean == exported["norm"].mel_log_mean == -3.0
    assert jpkg.duration_stats == meta["duration_stats"]


def _jax_pitch_stats(cache):
    """The JAX ``convert``'s lines (``stylish_tts_tpu/cli.py`` ``convert``),
    transcribed."""
    pitch_log2_mean, pitch_log2_std = 7.0, 1.0
    vals = []
    for arr in cache.values():
        arr = np.asarray(arr)
        vals.append(arr[arr > 10])
    allp = np.concatenate(vals) if vals else np.array([128.0])
    if allp.size:
        pitch_log2_mean = float(np.log2(allp).mean())
        pitch_log2_std = float(max(np.log2(allp).std(), 1e-6))
    return pitch_log2_mean, pitch_log2_std


def test_convert_stats_equal_jax(exported):
    data = exported["data"]
    meta = json.loads((exported["root"] / "pkg" / "metadata.json").read_text(encoding="utf-8"))
    pitch = load_cache(f"{data}/pitch.safetensors")
    assert (meta["pitch_log2_mean"], meta["pitch_log2_std"]) == _jax_pitch_stats(pitch)
    assert np.isfinite(meta["pitch_log2_mean"]) and meta["pitch_log2_std"] > 0
    assert meta["duration_stats"] == jax_duration_stats(
        load_cache(f"{data}/alignment.safetensors"))
    assert set(meta["duration_stats"]) == {"frames_per_token_p05", "frames_per_token_p50",
                                           "frames_per_token_p95"}
    assert pitch_log2_stats(None) == (7.0, 1.0)
    unvoiced = {"a": np.zeros(5, np.float32), "b": np.full(3, 9.0, np.float32)}
    for cache in (pitch, unvoiced, {}):
        assert pitch_log2_stats(cache) == _jax_pitch_stats(cache)


def _jax_dataset(data, list_name):
    with open(f"{data}/{list_name}", encoding="utf-8") as f:
        lines = f.readlines()
    return JaxDataset(data_list=lines, root_path=f"{data}/wav-dir",
                      text_cleaner=JaxTextCleaner(JaxModelConfig().symbol), sample_rate=24000,
                      coarse_hop_length=300 * tiny_jax_config().coarse_multiplier,
                      pitch_path=f"{data}/pitch.safetensors")


def test_styles_match_jax(exported):
    """Each style within 1e-4 of its largest magnitude; token counts equal."""
    jmc = tiny_jax_config()
    params = load_params_safetensors(str(exported["root"] / "pkg" / "params.safetensors"))
    ref = jvoicepack.encode_all_styles(
        _jax_dataset(exported["data"], "train-list.txt"), build_model(jmc), params,
        JaxNorm(**exported["norm"].state_dict()), jmc)
    ours = exported["styles"]
    np.testing.assert_array_equal(ours["lengths"], ref["lengths"])
    for key in ("speech", "pe", "duration"):
        r = np.asarray(ref[key])
        assert ours[key].shape == r.shape == (5, jmc.style_dim)
        np.testing.assert_allclose(ours[key], r, rtol=0,
                                   atol=STYLE_RTOL * float(np.abs(r).max()))


def test_voicepacks_read_by_jax(exported):
    root, styles = exported["root"], exported["styles"]
    static = jvoicepack.load_voicepack(str(root / "static.safetensors"))
    assert static["kind"] == "static"
    ours = voicepack.build_static_pack(styles)
    for key in ("speech", "pe", "duration"):
        np.testing.assert_array_equal(static[key], ours[key])

    dynamic = jvoicepack.load_voicepack(str(root / "dynamic.safetensors"))
    assert dynamic["kind"] == "dynamic"
    ds = _jax_dataset(exported["data"], "train-list.txt")
    bins, _ = ds.time_bins()
    assert len(bins) > 1
    texts = [ds.segments[i].text for _b, idxs in sorted(bins.items()) for i in idxs]
    np.testing.assert_array_equal(dynamic["embedding"], get_embedder()(texts))
    for key in ("speech", "pe", "duration"):
        np.testing.assert_array_equal(dynamic[key], styles[key])

    # a pack the JAX package wrote
    path = str(root / "jax_static.safetensors")
    jvoicepack.save_static_voicepack(path, jvoicepack.build_static_pack(styles))
    loaded = voicepack.load_voicepack(path)
    assert loaded["kind"] == "static"
    for key in ("speech", "pe", "duration"):
        np.testing.assert_array_equal(loaded[key], ours[key])


def test_voicepack_without_a_device_needs_cuda(exported):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root = exported["root"]
    result = CliRunner().invoke(train_cli, [
        "voicepack", "--config", str(root / "config.yml"), "--checkpoint", exported["ckpt"],
        "--out", str(root / "x.safetensors")], standalone_mode=False)
    assert isinstance(result.exception, RuntimeError)
    assert "CUDA is not available" in str(result.exception)
