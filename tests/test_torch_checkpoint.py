"""Checkpoint and resume of the port (``trainer/checkpoint.py``, the
alignment path of ``trainer/loop.py``, ``train-align --checkpoint``).

On the CPU everything is bitwise: a save/load round trip; and a run
resumed from a mid-run checkpoint against the uninterrupted run (the
remaining losses, the batch order, the final weights, AdamW state, priors
and dropout generator). The manifest keeps the JAX ``Manifest``'s fields
and JSON, and pruning keeps the newest four checkpoints.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from fixtures import make_micro_dataset
from stylish_tts_tpu.trainer.checkpoint import Manifest as JaxManifest
from stylish_tts_tpu.trainer.checkpoint import checkpoint_dir_name as jax_dir_name
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.config import Config, ModelConfig
from stylish_tts_torch.models.text_aligner import TextAligner
from stylish_tts_torch.trainer.checkpoint import (
    STATE_FILE,
    Manifest,
    checkpoint_dir_name,
    find_latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_train_state
from stylish_tts_torch.trainer.steps import (
    Batch,
    StepContext,
    batch_to_device,
    make_alignment_step,
)

torch.set_num_threads(1)  # one per test worker, as tests/test_torch_synth_common.py


def _assert_tree_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a.cpu(), b.cpu()), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _trained_state(seed):
    torch.manual_seed(seed)
    state = create_train_state(TextAligner(hidden_dim=32), 179, "cpu", seed=seed)
    ctx = StepContext(ModelConfig(), {}, NormalizationStats())
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 178, (2, 32)).astype(np.int32)
    batch = Batch(0.1 * rng.standard_normal((2, 60 * 300)).astype(np.float32), text,
                  np.array([20, 12], np.int32), np.zeros((2, 60), np.float32),
                  np.zeros_like(text))
    step = make_alignment_step(ctx)
    for _ in range(2):
        step(state, batch_to_device(batch, "cpu"))
    return state


def test_round_trip_is_bitwise(tmp_path):
    state = _trained_state(0)
    manifest = Manifest(current_epoch=2, current_step=3, current_total_step=7,
                        steps_per_epoch=4, best_loss=1.25)
    norm = NormalizationStats(mel_log_mean=-3.25, mel_log_std=2.5)
    path = save_checkpoint(str(tmp_path), state, manifest, Config(), ModelConfig(), norm)
    assert os.path.basename(path) == checkpoint_dir_name(2, 7) == jax_dir_name(2, 7)
    for name in (STATE_FILE, "manifest.json", "config.json", "model_config.json",
                 "normalization.json"):
        assert os.path.isfile(os.path.join(path, name)), name

    other = _trained_state(1)
    loaded, manifest2, norm2 = load_checkpoint(path, other)
    assert loaded is other
    _assert_tree_equal(state.state_dict(), loaded.state_dict())
    assert loaded.step == state.step == 2
    assert manifest2 == manifest and norm2 == norm
    # the dropout stream continues where the saved one would
    assert torch.equal(torch.rand(5, generator=state.generator),
                       torch.rand(5, generator=loaded.generator))


def test_manifest_keeps_the_jax_fields_and_json():
    ours = Manifest(current_epoch=3, current_total_step=11, stage="alignment",
                    best_loss=0.5, training_log=[{"a": 1}])
    assert json.loads(ours.to_json()).keys() == {
        f.name for f in dataclasses.fields(JaxManifest)}
    assert dataclasses.asdict(JaxManifest.from_json(ours.to_json())) == \
        dataclasses.asdict(ours)
    assert Manifest.from_json(JaxManifest().to_json()) == Manifest()


def test_pruning_keeps_the_newest_four(tmp_path):
    state = _trained_state(2)
    for step in range(1, 8):
        manifest = Manifest(current_epoch=1 + step // 3, current_total_step=step)
        save_checkpoint(str(tmp_path), state, manifest, Config(), ModelConfig(),
                        NormalizationStats())
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint_"))
    assert kept == [checkpoint_dir_name(1 + s // 3, s) for s in range(4, 8)]
    assert find_latest_checkpoint(str(tmp_path)) == str(tmp_path / kept[-1])
    assert find_latest_checkpoint(str(tmp_path / "missing")) is None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted train-align of 3 epochs (a checkpoint every step,
    validation every 2), then one resumed from its oldest kept checkpoint
    (total step 9, one batch into epoch 3) into another directory, both
    through the CLI on the CPU."""
    root = tmp_path_factory.mktemp("resume")
    data = make_micro_dataset(str(root / "data"), n_train=5, n_val=2,
                              with_caches=False)
    cfg = {
        "training": {"log_interval": 1, "data_workers": 2, "val_interval": 2,
                     "save_interval": 1},
        "training_plan": {"alignment": {"epochs": 3, "probe_batch_max": 2,
                                        "lr": 1e-4}},
        "dataset": {"path": data},
    }
    cfg_path = root / "config.yml"
    cfg_path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    runner = CliRunner()

    def run(out, *extra):
        result = runner.invoke(train_cli, [
            "train-align", "--config", str(cfg_path), "--out", str(root / out),
            "--device", "cpu", "--record-steps", *extra], standalone_mode=False)
        assert result.exit_code == 0, result.output + repr(result.exception)
        return result.return_value

    full = run("full")
    stage_dir = root / "full" / "alignment"
    ckpts = sorted(d for d in os.listdir(stage_dir) if d.startswith("checkpoint_"))
    assert ckpts[0] == checkpoint_dir_name(3, 9)
    resumed = run("resumed", "--checkpoint", str(stage_dir / ckpts[0]))
    return root, full, resumed, ckpts


def test_checkpoints_are_named_and_pruned(runs):
    _, full, _, ckpts = runs
    total = full.manifest.current_total_step
    assert total >= 6 and len(ckpts) == 4
    assert ckpts[-1] == checkpoint_dir_name(3, total)
    assert all(d.startswith("checkpoint_") for d in ckpts)


def test_resume_equals_the_uninterrupted_run_bitwise(runs):
    root, full, resumed, _ = runs
    n = len(resumed.losses)
    assert 0 < n < len(full.losses)
    assert resumed.losses == full.losses[-n:]
    assert resumed.batches == full.batches[-n:]
    assert resumed.manifest.current_total_step == full.manifest.current_total_step
    assert resumed.validations == full.validations[-len(resumed.validations):]
    last = checkpoint_dir_name(3, full.manifest.current_total_step)
    saved = [torch.load(root / run / "alignment" / last / STATE_FILE, weights_only=True)
             for run in ("full", "resumed")]
    _assert_tree_equal(saved[0], saved[1])
    with open(root / "resumed" / "alignment" / last / "manifest.json") as f:
        assert Manifest.from_json(f.read()) == full.manifest


def test_another_stage_or_reset_starts_fresh_counters(tmp_path, monkeypatch):
    """A checkpoint of another stage, or ``reset_stage``, keeps the
    weights and starts the counters (and the LR schedule's step) at 0."""
    from stylish_tts_torch.trainer import loop as loop_mod

    data = make_micro_dataset(str(tmp_path / "data"), n_train=2, n_val=1,
                              uniform_duration=True, with_caches=False)
    config = Config()
    config.dataset.path = data
    config.training_plan.alignment.epochs = 1
    state = _trained_state(3)
    ckpt = save_checkpoint(str(tmp_path), state, Manifest(stage="acoustic",
                                                          current_total_step=9),
                           config, ModelConfig(), NormalizationStats())
    seen = {}

    def fake_run(self, state, *args):
        seen["step"], seen["skip"] = state.step, args[-1]
        seen["manifest"] = self.manifest
        return state

    monkeypatch.setattr(loop_mod.Trainer, "run_alignment", fake_run)
    monkeypatch.setattr(loop_mod, "build_text_aligner",
                        lambda mc: TextAligner(hidden_dim=32))
    trainer = loop_mod.Trainer(config, ModelConfig(), str(tmp_path / "o"), device="cpu")
    trainer.train("alignment", checkpoint=ckpt)
    assert seen["step"] == 0 and seen["skip"] == 0
    assert seen["manifest"] == Manifest(stage="alignment")

    same = save_checkpoint(str(tmp_path / "same"), state,
                           Manifest(current_epoch=1, current_step=2, current_total_step=2),
                           config, ModelConfig(), NormalizationStats())
    trainer.train("alignment", checkpoint=same)
    assert seen["step"] == 2 and seen["skip"] == 2
    trainer.train("alignment", checkpoint=same, reset_stage=True)
    assert seen["step"] == 0 and seen["skip"] == 0
