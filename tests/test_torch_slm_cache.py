"""The slm cache (``dataprep/slm_cache.py``, ``slm-cache``) against the JAX
package's, and its use in the port's acoustic stage.

* ``wavlm_fingerprint`` of the port's seeded WavLM is byte-equal to the JAX
  ``wavlm_fingerprint`` of ``convert_torch_wavlm`` of its state_dict, and
  the port's own layout map (``convert/wavlm.py``) gives the JAX tree
  bitwise; back through ``wavlm_from_jax`` the weights are the same (the
  weight-normed positional conv to 1e-6 of its largest magnitude);
* ``compute_slm_cache`` on two 0.5 s clips against the JAX
  ``compute_slm_cache`` with the same weights: the same keys and fingerprint,
  every float16 state within 1e-3 of its largest magnitude;
* ``check_fingerprint`` warns on a cache without a fingerprint and raises on
  one of other weights;
* ``train --stage acoustic`` (tiny config, slm on, the seeded random WavLM)
  after ``slm-cache`` through the CLI: every acoustic step takes its slm
  term from the cache (``wavlm_loss_cached``, finite) and never embeds the
  target in-line; with one fingerprint byte flipped the stage raises before
  its first step; ``slm-cache`` without ``--device cpu`` needs CUDA.
"""

import logging

import jax
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from fixtures import make_micro_dataset
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.data.dataset import FilePathDataset as JaxDataset
from stylish_tts_tpu.dataprep import slm_cache as jcache
from stylish_tts_tpu.models.slm import convert_torch_wavlm
from stylish_tts_tpu.text import TextCleaner as JaxTextCleaner
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.convert.wavlm import jax_leaves, wavlm_from_jax, wavlm_to_jax
from stylish_tts_torch.data.caches import load_cache, save_cache
from stylish_tts_torch.data.dataset import FilePathDataset
from stylish_tts_torch.data.wav import write_wav
from stylish_tts_torch.dataprep import slm_cache
from stylish_tts_torch.models import slm as pslm
from stylish_tts_torch.text import TextCleaner
from stylish_tts_torch.trainer import loop as loop_mod
from test_torch_synth_common import port_config, tiny_jax_config

torch.set_num_threads(1)

SR, COARSE_HOP = 24000, 300


@pytest.fixture(scope="module")
def wavlm():
    model = pslm.random_wavlm(0).eval().requires_grad_(False)
    return model, convert_torch_wavlm({k: v.numpy() for k, v in model.state_dict().items()})


def test_fingerprint_and_layout_match_jax(wavlm):
    model, jax_tree = wavlm
    np.testing.assert_array_equal(slm_cache.wavlm_fingerprint(model),
                                  jcache.wavlm_fingerprint(jax_tree))
    ref = {str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    ours = dict(jax_leaves(wavlm_to_jax(model.state_dict())))
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    back = pslm.WavLMEncoder()
    back.load_state_dict(wavlm_from_jax(jax_tree))
    again = dict(jax_leaves(wavlm_to_jax(back.state_dict())))
    for k in ref:
        np.testing.assert_allclose(again[k], ref[k], rtol=0,
                                   atol=1e-6 * float(np.abs(ref[k]).max()))


def _two_clips(root):
    """Two 0.5 s clips (one time bin) and their list."""
    rng = np.random.default_rng(0)
    (root / "wav-dir").mkdir()
    lines = []
    for i in range(2):
        write_wav(str(root / "wav-dir" / f"c{i}.wav"),
                  0.3 * rng.standard_normal(SR // 2).astype(np.float32), SR)
        lines.append(f"c{i}.wav|hɛlˈoʊ|0|hello\n")
    return lines


def test_cache_matches_jax(wavlm, tmp_path):
    model, jax_tree = wavlm
    lines = _two_clips(tmp_path)
    mc = ModelConfig()
    kw = dict(data_list=lines, root_path=str(tmp_path / "wav-dir"), sample_rate=SR,
              coarse_hop_length=COARSE_HOP)
    ours = slm_cache.compute_slm_cache(
        FilePathDataset(text_cleaner=TextCleaner(mc.symbol), **kw), model)
    ref = jcache.compute_slm_cache(
        JaxDataset(text_cleaner=JaxTextCleaner(JaxModelConfig().symbol), **kw), jax_tree)
    assert set(ours) == set(ref) == {"c0.wav", "c1.wav", slm_cache.FINGERPRINT_KEY}
    np.testing.assert_array_equal(ours[slm_cache.FINGERPRINT_KEY],
                                  ref[slm_cache.FINGERPRINT_KEY])
    for k in ("c0.wav", "c1.wav"):
        assert ours[k].dtype == ref[k].dtype == np.float16
        assert ours[k].shape == ref[k].shape and ours[k].shape[::2] == (13, 768)
        a, b = ours[k].astype(np.float32), ref[k].astype(np.float32)
        for i in range(13):
            np.testing.assert_allclose(a[i], b[i], rtol=0,
                                       atol=1e-3 * float(np.abs(b[i]).max()))


def test_check_fingerprint(wavlm, caplog):
    model, _ = wavlm
    with caplog.at_level(logging.WARNING, logger="stylish_tts_torch"):
        slm_cache.check_fingerprint({"a.wav": np.zeros(1)}, model)
    assert "no WavLM fingerprint" in caplog.text
    good = {slm_cache.FINGERPRINT_KEY: slm_cache.wavlm_fingerprint(model)}
    slm_cache.check_fingerprint(good, model)
    other = pslm.random_wavlm(1)
    with pytest.raises(RuntimeError, match="DIFFERENT WavLM weights"):
        slm_cache.check_fingerprint(good, other)


@pytest.fixture(scope="module")
def acoustic_run(tmp_path_factory):
    """``slm-cache`` then the acoustic stage alone (the later stages cut off
    by the test), one epoch of 2 steps at B = 2, slm at 0.2 with the seeded
    random WavLM."""
    root = tmp_path_factory.mktemp("slm_run")
    data = make_micro_dataset(str(root / "data"), n_train=4, n_val=2,
                              uniform_duration=True)
    cfg = {
        "training": {"log_interval": 1, "val_interval": 100, "save_interval": 100},
        "training_plan": {"acoustic": {"epochs": 1, "probe_batch_max": 2, "lr": 1e-4}},
        "dataset": {"path": data},
        "validation": {"sample_count": 1},
        "loss_weight": {"slm": 0.2},
    }
    mc = port_config(tiny_jax_config()).model_dump()
    mc["slm"]["allow_random_fallback"] = True
    (root / "config.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    (root / "model.yml").write_text(yaml.safe_dump(mc), encoding="utf-8")
    args = ["--config", str(root / "config.yml"), "--model-config", str(root / "model.yml"),
            "--out", str(root / "out")]
    result = CliRunner().invoke(train_cli, ["slm-cache", *args, "--device", "cpu"],
                                standalone_mode=False)
    assert result.exit_code == 0, result.output + repr(result.exception)
    return root, data, args


def _train(args, monkeypatch):
    """The acoustic stage; counts of the cached and the in-line slm calls."""
    calls = {"cached": 0, "inline": 0}
    cached, inline = pslm.wavlm_loss_cached, loop_mod.wavlm_loss

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pslm, "wavlm_loss_cached", count("cached", cached))
    monkeypatch.setattr(loop_mod, "wavlm_loss", count("inline", inline))
    monkeypatch.setattr(loop_mod, "NEXT_STAGE", {})
    result = CliRunner().invoke(train_cli, ["train", "--stage", "acoustic", *args,
                                            "--device", "cpu", "--record-steps"],
                                standalone_mode=False)
    return result, calls


def test_acoustic_stage_reads_a_matching_cache(acoustic_run, monkeypatch):
    root, data, args = acoustic_run
    cache = load_cache(f"{data}/slm.safetensors")
    assert len(cache) == 7  # 6 segments and the fingerprint
    result, calls = _train(args, monkeypatch)
    assert result.exit_code == 0, result.output + repr(result.exception)
    metrics = result.return_value.step_metrics
    assert len(metrics) == 2 and all(np.isfinite(m["slm"]) for m in metrics)
    assert calls == {"cached": 2, "inline": 0}


def test_acoustic_stage_raises_on_a_foreign_cache(acoustic_run, monkeypatch, tmp_path):
    root, data, args = acoustic_run
    path = f"{data}/slm.safetensors"
    cache = load_cache(path)
    (tmp_path / "good.safetensors").write_bytes(open(path, "rb").read())
    cache[slm_cache.FINGERPRINT_KEY][0] ^= 1
    save_cache(path, cache)
    try:
        result, calls = _train(args, monkeypatch)
    finally:
        open(path, "wb").write((tmp_path / "good.safetensors").read_bytes())
    assert isinstance(result.exception, RuntimeError)
    assert "DIFFERENT WavLM weights" in str(result.exception)
    assert calls == {"cached": 0, "inline": 0}


def test_slm_cache_without_a_device_needs_cuda(acoustic_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, args = acoustic_run
    result = CliRunner().invoke(train_cli, ["slm-cache", *args], standalone_mode=False)
    assert isinstance(result.exception, RuntimeError)
    assert "CUDA is not available" in str(result.exception)
