"""The port's ``align`` (``dataprep/align.py``) against the JAX package's,
its CLI (``align``, ``align-textgrid``) on the CPU, and the caches that
the acoustic stage reads: port-made pitch and alignment caches read and
collated by the JAX package, JAX-made ones by the port.

Tolerances: durations equal on every row; confidences within 1e-4
relative. The aligner is the same on both sides (JAX weights moved across
with ``convert/from_jax.py``); the Viterbi itself is exact
(``tests/test_torch_forced_align.py``), so a row could only differ where
the two frameworks' float32 posteriors put two paths within round-off of
each other.
"""

import re

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

import jax
import jax.numpy as jnp

from fixtures import make_micro_dataset
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.data.caches import load_cache as jax_load_cache
from stylish_tts_tpu.data.collate import collate_batch as jax_collate
from stylish_tts_tpu.data.dataset import FilePathDataset as JaxDataset
from stylish_tts_tpu.dataprep.align import calculate_alignments as jax_calculate
from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_tpu.text import TextCleaner as JaxTextCleaner
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.convert.from_jax import text_aligner_from_jax
from stylish_tts_torch.data.collate import collate_batch
from stylish_tts_torch.data.dataset import FilePathDataset
from stylish_tts_torch.dataprep.align import calculate_alignments
from stylish_tts_torch.models import build_text_aligner
from stylish_tts_torch.models.text_aligner import TextAligner
from stylish_tts_torch.ops.duration import DurationProcessor
from stylish_tts_torch.text import TextCleaner
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.utils.params_io import save_text_aligner_safetensors

torch.set_num_threads(1)  # one per test worker, as tests/test_torch_synth_common.py

CONF_RTOL = 1e-4
HIDDEN = 48
NORM = dict(mel_log_mean=-3.5, mel_log_std=3.0)


def _lines(data, name):
    with open(f"{data}/{name}", encoding="utf-8") as f:
        return f.readlines()


def _dataset(cls, cleaner, data, split, **caches):
    return cls(data_list=_lines(data, f"{split}-list.txt"), root_path=f"{data}/wav-dir",
               text_cleaner=cleaner, sample_rate=24000, coarse_hop_length=300,
               **caches)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = tmp_path_factory.mktemp("align")
    data = make_micro_dataset(str(root / "data"), n_train=6, n_val=2,
                              uniform_duration=True, with_caches=False)
    return root, data


@pytest.mark.parametrize("method", ["k2", "torch"])
def test_calculate_alignments_matches_jax(micro, method):
    _, data = micro
    model = JaxAligner(hidden_dim=HIDDEN, dropout=0.0)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 80)), jnp.full((1,), 16, jnp.int32)))
    jax_mc = JaxModelConfig()
    ref_d, ref_c = jax_calculate(
        _dataset(JaxDataset, JaxTextCleaner(jax_mc.symbol), data, "train"),
        model, params, jax_mc, JaxNorm(**NORM), batch_size=4, method=method)

    port = TextAligner(hidden_dim=HIDDEN, dropout=0.0)
    port.load_state_dict(text_aligner_from_jax(params))
    mc = ModelConfig()
    ours_d, ours_c = calculate_alignments(
        _dataset(FilePathDataset, TextCleaner(mc.symbol), data, "train"),
        port, mc, NormalizationStats(**NORM), batch_size=4, method=method)
    assert sorted(ours_d) == sorted(ref_d)
    for path in ref_d:
        assert ours_d[path].dtype == np.float32 and ours_d[path].shape == ref_d[path].shape
        np.testing.assert_array_equal(ours_d[path], ref_d[path], err_msg=path)
        assert ours_c[path] == pytest.approx(ref_c[path], rel=CONF_RTOL)


@pytest.fixture(scope="module")
def caches(micro):
    """``pitch``, then ``align`` and ``align-textgrid`` with a full-width
    aligner of random weights, each through the port's CLI on the CPU."""
    root, data = micro
    torch.manual_seed(0)
    save_text_aligner_safetensors(f"{data}/alignment_model.safetensors",
                                  build_text_aligner(ModelConfig()))
    cfg = root / "config.yml"
    cfg.write_text(yaml.safe_dump({"dataset": {"path": data}}), encoding="utf-8")
    runner = CliRunner()
    out = root / "out"
    results = {}
    for name, extra in (("pitch", []), ("align", []),
                        ("align-textgrid", ["--segment", "tr1.wav"])):
        results[name] = runner.invoke(train_cli, [
            name, "--config", str(cfg), "--out", str(out), "--device", "cpu", *extra])
    return root, data, cfg, out, results


def test_align_cli_on_cpu_writes_the_cache(caches):
    _, data, _, out, results = caches
    for name, result in results.items():
        assert result.exit_code == 0, name + result.output + repr(result.exception)
    cache = jax_load_cache(f"{data}/alignment.safetensors")
    cleaner = TextCleaner(ModelConfig().symbol)
    lines = _lines(data, "train-list.txt") + _lines(data, "val-list.txt")
    assert len(cache) == len(lines)
    for line in lines:
        name, phonemes = line.split("|")[:2]
        durs = cache[name]
        assert durs.dtype == np.float32
        assert durs.shape == (1, len(cleaner(phonemes)))
        assert durs.sum() == 100  # the bin's frame count
    for split, n in (("train", 6), ("val", 2)):
        rows = (out / f"scores_{split}.txt").read_text().splitlines()
        assert len(rows) == n
        scores = [float(r.split()[0]) for r in rows]
        assert scores == sorted(scores) and all(0 < s <= 1 for s in scores)


def test_align_textgrid_cli_on_cpu(caches):
    _, data, _, out, results = caches
    assert results["align-textgrid"].exit_code == 0
    text = (out / "tr1.TextGrid").read_text()
    phonemes = _lines(data, "train-list.txt")[1].split("|")[1]
    assert f"intervals: size = {len(phonemes) + 2}" in text
    xmax = float(re.search(r"^xmax = ([\d.]+)$", text, re.M).group(1))
    assert xmax == pytest.approx(100 * 300 / 24000)


def test_jax_reads_and_collates_port_caches(caches):
    _, data, _, _, _ = caches
    jax_mc = JaxModelConfig()
    ds = _dataset(JaxDataset, JaxTextCleaner(jax_mc.symbol), data, "train",
                  pitch_path=f"{data}/pitch.safetensors",
                  alignment_path=f"{data}/alignment.safetensors")
    bins, _ = ds.time_bins()
    (idxs,) = bins.values()
    batch, paths = jax_collate([ds.load_segment(i) for i in idxs[:3]], hop_length=300,
                               require_pitch=True)
    assert batch.pitch.shape == (3, 100) and (batch.pitch > 0).any()
    assert (batch.durations.sum(1) == 100).all()


def test_port_reads_jax_caches_and_is_ready_for_the_acoustic_stage(caches, tmp_path):
    """JAX-made caches (the fixture's) and the port-made ones both collate
    with ``require_pitch=True``; the durations cover the frames, and each
    frame's soft alignment peaks on a token whose span lies within the
    window's 3 frames of it."""
    _, data, _, _, _ = caches
    jax_made = make_micro_dataset(str(tmp_path / "jax"), n_train=3, n_val=1,
                                  uniform_duration=True)
    cleaner = TextCleaner(ModelConfig().symbol)
    for root in (jax_made, data):
        ds = _dataset(FilePathDataset, cleaner, root, "train",
                      pitch_path=f"{root}/pitch.safetensors",
                      alignment_path=f"{root}/alignment.safetensors")
        bins, _ = ds.time_bins()
        (idxs,) = bins.values()
        batch, _ = collate_batch([ds.load_segment(i) for i in idxs[:3]],
                                 hop_length=300, require_pitch=True)
        frames = batch.pitch.shape[1]
        assert (batch.durations.sum(1) == frames).all()
        alignment = DurationProcessor().duration_to_alignment(
            torch.from_numpy(batch.durations), frames)
        assert alignment.shape == (3, batch.text.shape[1], frames)
        torch.testing.assert_close(alignment.sum(1), torch.ones(3, frames))
        upper = torch.cumsum(torch.from_numpy(batch.durations).float(), 1)
        lower = upper - torch.from_numpy(batch.durations).float()
        owner = alignment.argmax(1)
        f = torch.arange(frames, dtype=torch.float32)[None, :]
        assert ((torch.gather(lower, 1, owner) - 3 < f)
                & (f < torch.gather(upper, 1, owner) + 3)).all()


@pytest.mark.parametrize("command", ["align", "align-textgrid"])
def test_cuda_without_a_card_raises(caches, command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, _, cfg, _, _ = caches
    result = CliRunner().invoke(train_cli, [
        command, "--config", str(cfg), "--out", str(root / "o"), "--segment", "tr1.wav"]
        if command == "align-textgrid" else
        [command, "--config", str(cfg), "--out", str(root / "o")])
    assert isinstance(result.exception, RuntimeError)
    assert "CUDA is not available" in str(result.exception)
