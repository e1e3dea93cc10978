"""``train --stage acoustic --device cpu`` through the CLI on
``tests/fixtures.py::make_micro_dataset`` at the tiny config, one epoch of
2 steps per stage (validation every 2 steps, a checkpoint every step, the
slm term off):

* the run trains acoustic, then advances into textual and duration, each
  stage with its own directory, batch plan, manifests and checkpoints,
  finite metrics and validations;
* ``--stage textual --checkpoint <the acoustic stage's last checkpoint>``
  starts from the acoustic weights bitwise, with fresh AdamW moments and
  step 0, and retraces the full run's textual and duration stages bitwise;
  the frozen acoustic modules leave textual as they entered it;
* an acoustic checkpoint that holds only the acoustic stage's six modules
  (the layout before the merged state) loads: the six bitwise, the other
  modules at their seeded init;
* a resume inside textual and inside duration equals the uninterrupted
  run bitwise (metrics, batch order, validations, final state);
* without ``--record-steps`` the trainer holds no per-step list.
"""

import os

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from fixtures import make_micro_dataset
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.config import load_config_yaml, load_model_config_yaml
from stylish_tts_torch.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS, build_models
from stylish_tts_torch.trainer import loop as loop_mod
from stylish_tts_torch.trainer.checkpoint import STATE_FILE, checkpoint_dir_name, read_manifest
from test_torch_checkpoint import _assert_tree_equal
from test_torch_synth_common import port_config, tiny_jax_config

STAGES = ("acoustic", "textual", "duration")
ACOUSTIC = STAGE_TRAIN_MODELS["acoustic"] + STAGE_DISCRIMINATORS["acoustic"]
LAST = checkpoint_dir_name(1, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("recipe")
    data = make_micro_dataset(str(root / "data"), n_train=4, n_val=2,
                              uniform_duration=True)
    plan = {"epochs": 1, "probe_batch_max": 2, "lr": 1e-4}
    cfg = {
        "training": {"log_interval": 1, "data_workers": 2, "val_interval": 2,
                     "save_interval": 1},
        "training_plan": {stage: plan for stage in STAGES},
        "dataset": {"path": data},
        "validation": {"sample_count": 1},
        "loss_weight": {"slm": 0.0},
    }
    (root / "config.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    (root / "model.yml").write_text(
        yaml.safe_dump(port_config(tiny_jax_config()).model_dump()), encoding="utf-8")
    runner = CliRunner()

    def run(out, *extra):
        result = runner.invoke(train_cli, [
            "train", "--config", str(root / "config.yml"),
            "--model-config", str(root / "model.yml"), "--out", str(root / out),
            "--device", "cpu", *extra], standalone_mode=False)
        assert result.exit_code == 0, result.output + repr(result.exception)
        return result.return_value

    full = run("full", "--stage", "acoustic", "--record-steps")
    from_acoustic = run("from_acoustic", "--stage", "textual", "--checkpoint",
                        str(root / "full" / "acoustic" / LAST))
    resumed = {stage: run(f"resumed_{stage}", "--stage", stage, "--record-steps",
                          "--checkpoint",
                          str(root / "full" / stage / checkpoint_dir_name(1, 1)))
               for stage in ("textual", "duration")}
    return root, full, from_acoustic, resumed


def _state(path):
    return torch.load(path / STATE_FILE, weights_only=True)


def test_train_advances_through_the_three_stages(runs):
    root, full, *_ = runs
    keys = {
        "acoustic": {"mel", "multi_phase", "generator", "discriminator", "lr",
                     "mrd0_lr_mult", "mrd1_lr_mult", "mrd2_lr_mult", "disc_lr_mult"},
        "textual": {"mel", "generator", "pitch", "energy", "discriminator", "lr",
                    "pitch_disc_lr_mult"},
        "duration": {"duration", "duration_ce", "generator", "discriminator", "lr",
                     "dur_disc_lr_mult"},
    }
    assert len(full.step_metrics) == 6 and len(full.batches) == 6
    for i, stage in enumerate(STAGES):
        manifest = full.stage_manifests[stage]
        assert manifest.stage == stage and manifest.current_total_step == 2
        stage_dir = root / "full" / stage
        assert read_manifest(str(stage_dir / LAST)) == manifest
        assert sorted(d for d in os.listdir(stage_dir) if d.startswith("checkpoint_")) == [
            checkpoint_dir_name(1, 1), LAST]
        assert (stage_dir / f"{stage}_batch_sizes.json").is_file()
        for m in full.step_metrics[2 * i: 2 * i + 2]:
            assert set(m) == keys[stage] and all(np.isfinite(list(m.values())))
        saved = _state(stage_dir / LAST)
        assert set(saved["models"]) == set(build_models(port_config(tiny_jax_config())))
        assert set(saved["optimizers"]) == set(STAGE_TRAIN_MODELS[stage]
                                               + STAGE_DISCRIMINATORS[stage])
        assert saved["step"] == 2
    assert [(v["stage"], v["step"]) for v in full.validations] == [
        (stage, 2) for stage in STAGES]
    assert all(np.isfinite(v[k]) for v in full.validations for k in v
               if k not in ("stage", "step", "batches"))
    # the frozen modules leave each stage as they entered it
    stage_end = {stage: _state(root / "full" / stage / LAST)["models"] for stage in STAGES}
    for name in ACOUSTIC:
        _assert_tree_equal(stage_end["acoustic"][name], stage_end["textual"][name])
    for name, weights in stage_end["textual"].items():
        if name not in STAGE_TRAIN_MODELS["duration"] + STAGE_DISCRIMINATORS["duration"]:
            _assert_tree_equal(weights, stage_end["duration"][name])


def test_textual_from_the_acoustic_checkpoint(runs, monkeypatch):
    """The later stages, started from the acoustic stage's last checkpoint,
    retrace the full run's bitwise; the start itself: the acoustic weights
    bitwise, fresh moments, step 0."""
    root, full, from_acoustic, _ = runs
    assert from_acoustic.validations == full.validations[1:]
    for stage in ("textual", "duration"):
        for ckpt in (checkpoint_dir_name(1, 1), LAST):
            _assert_tree_equal(_state(root / "from_acoustic" / stage / ckpt),
                               _state(root / "full" / stage / ckpt))
    assert not (root / "from_acoustic" / "acoustic").exists()

    acoustic = _state(root / "full" / "acoustic" / LAST)
    seen = {}

    def fake_run(self, stage, state, *args):
        if stage == "textual":
            seen["state"] = {k: {n: v.clone() for n, v in m.state_dict().items()}
                             for k, m in state.models.items()}
            seen["step"], seen["skip"] = state.step, args[-1]
            seen["moments"] = [len(o.state) for o in state.optimizers.values()]
            seen["manifest"] = self.manifest
        return state

    monkeypatch.setattr(loop_mod.Trainer, "run_stage", fake_run)
    config = load_config_yaml(str(root / "config.yml"))
    mc = load_model_config_yaml(str(root / "model.yml"))
    trainer = loop_mod.Trainer(config, mc, str(root / "fake"), device="cpu")
    trainer.train("textual", checkpoint=str(root / "full" / "acoustic" / LAST))
    _assert_tree_equal(seen["state"], acoustic["models"])
    assert seen["step"] == 0 and seen["skip"] == 0 and seen["moments"] == [0, 0, 0]
    assert seen["manifest"] == loop_mod.Manifest(stage="textual")

    # an acoustic checkpoint with only the acoustic stage's six modules
    six = root / "six_module_checkpoint"
    six.mkdir()
    for f in os.listdir(root / "full" / "acoustic" / LAST):
        if f != STATE_FILE:
            (six / f).write_bytes((root / "full" / "acoustic" / LAST / f).read_bytes())
    torch.save({**acoustic,
                "models": {k: acoustic["models"][k] for k in ACOUSTIC},
                "optimizers": {k: acoustic["optimizers"][k] for k in ACOUSTIC}},
               six / STATE_FILE)
    trainer.train("textual", checkpoint=str(six))
    torch.manual_seed(0)  # the trainer's seeded init
    init = {k: m.state_dict() for k, m in build_models(mc).items()}
    for name, weights in seen["state"].items():
        _assert_tree_equal(weights, acoustic["models"][name] if name in ACOUSTIC
                           else init[name])
    assert seen["step"] == 0 and seen["moments"] == [0, 0, 0]


@pytest.mark.parametrize("stage", ["textual", "duration"])
def test_resume_inside_a_later_stage_is_bitwise(runs, stage):
    root, full, _, resumed = runs
    run = resumed[stage]
    first = STAGES.index(stage)
    n = len(run.step_metrics)
    assert n == 1 + 2 * (len(STAGES) - 1 - first)
    assert run.step_metrics == full.step_metrics[-n:]
    assert run.batches == full.batches[-n:]
    assert run.validations == full.validations[first:]
    for later in STAGES[first:]:
        _assert_tree_equal(_state(root / f"resumed_{stage}" / later / LAST),
                           _state(root / "full" / later / LAST))


def test_no_per_step_lists_unless_asked(runs):
    _root, full, from_acoustic, _ = runs
    assert full.losses == [] and len(full.step_metrics) == 6
    assert from_acoustic.losses is None
    assert from_acoustic.step_metrics is None and from_acoustic.batches is None
    assert [v["stage"] for v in from_acoustic.validations] == ["textual", "duration"]
