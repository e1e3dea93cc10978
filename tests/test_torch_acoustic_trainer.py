"""The acoustic stage end to end on the CPU: ``validate_acoustic`` against
the JAX package, the ``AcousticTrainState`` checkpoint, and
``train --stage acoustic --device cpu`` through the CLI with resume.

* ``validate_acoustic`` (tiny config, weights through the bridge, an
  injected broadband excitation, as the JAX validator's lines compute it
  with that prior): the mel metric rtol 1e-4, the audio 1e-4 absolute;
* a save/load round trip of the acoustic state is bitwise (weights, AdamW
  of all six modules, EMAs, step) and its three generators continue their
  streams;
* the CLI on ``tests/fixtures.py::make_micro_dataset`` at the tiny config,
  the slm term on with the seeded random WavLM
  (``allow_random_fallback``): finite metrics with the ``*_lr_mult``s in
  [0.01, 4], validation passes with eval wavs, checkpoints in the JAX
  naming pruned to 4; a run resumed from its oldest kept checkpoint equals
  the uninterrupted one bitwise (metrics, batch order, final state);
  ``--reset-stage`` restarts the counters, and an alignment checkpoint
  (which holds no module of the later stages) raises. The run goes on into
  the textual and duration stages as ``train`` does; here they are given
  0 epochs (tests/test_torch_recipe_trainer.py trains them).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from fixtures import make_micro_dataset
from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.steps import Batch as JaxBatch
from stylish_tts_tpu.trainer.steps import StepContext as JaxContext
from stylish_tts_tpu.trainer.steps import _acoustic_features as jax_features
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.config import Config
from stylish_tts_torch.convert.from_jax import module_from_jax
from stylish_tts_torch.models import build_models
from stylish_tts_torch.trainer.checkpoint import (
    STATE_FILE,
    Manifest,
    checkpoint_dir_name,
    load_checkpoint,
    save_checkpoint,
)
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state, create_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, make_acoustic_step
from stylish_tts_torch.trainer.validate import validate_acoustic
from test_torch_checkpoint import _assert_tree_equal
from test_torch_synth_common import jax_params, port_config, tiny_jax_config

B, L, F, HOP = 2, 10, 40, 300


def _batch(seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(F * HOP) / 24000.0
    audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 220, (B, 1)) * tt) \
        + 0.05 * rng.standard_normal((B, F * HOP))
    pitch = rng.uniform(90, 250, (B, F))
    durs = np.full((B, L), F // L)
    return (audio.astype(np.float32), rng.integers(1, 170, (B, L)).astype(np.int32),
            np.array([L, L - 3], np.int32), pitch.astype(np.float32), durs.astype(np.int32))


def test_validate_acoustic_matches_jax():
    mc = tiny_jax_config()
    models = jax_build_model(mc)
    texts, align = jnp.ones((1, L), jnp.int32), jnp.ones((1, L, F)) / L
    curve, style = jnp.full((1, F), 100.0), jnp.zeros((1, mc.style_dim))
    params = {
        "speech_predictor": jax_params(lambda k: models["speech_predictor"].init(
            {"params": k}, texts, jnp.full((1,), L), align, curve, curve, curve, style,
            curve, rng=k), seed=3),
        "speech_style_encoder": jax_params(lambda k: models["speech_style_encoder"].init(
            k, jnp.zeros((1, mc.style_encoder.n_mels, F))), seed=4),
    }
    norm = dict(mel_log_mean=-3.5, mel_log_std=3.0)
    ctx = JaxContext(models, mc, {}, JaxNorm(**norm))
    prior = np.tanh(np.random.default_rng(9).standard_normal((B, F * HOP)) * 0.3)
    prior = prior.astype(np.float32)
    batch = _batch(1)

    def jax_validate(params, batch):
        # JAX validate_acoustic's lines, with the prior injected
        mel, style_mel, energy, pitch, alignment, frames = jax_features(ctx, batch)
        audio_t = batch.audio_gt[:, : frames * mc.hop_length]
        st = models["speech_style_encoder"].apply(params["speech_style_encoder"], style_mel)
        voiced = (pitch > 20.0).astype(jnp.float32)
        pred = models["speech_predictor"].apply(
            params["speech_predictor"], batch.text, batch.text_lengths, alignment, pitch,
            energy, voiced, st, pitch, rng=jax.random.PRNGKey(0), prior=jnp.asarray(prior))
        loss = JL.spectral_convergence_loss(ctx.multi_spec(audio_t).mel,
                                            ctx.multi_spec(pred.audio).mel)
        return loss, pred.audio

    ref_loss, ref_audio = jax.jit(jax_validate)(params, JaxBatch(*map(jnp.asarray, batch)))
    pm = build_models(port_config(mc))
    for n in params:
        pm[n].load_state_dict(module_from_jax(pm[n], params[n]))
    state = create_stage_train_state(pm, "cpu", "acoustic")
    pctx = StepContext(port_config(mc), {}, NormalizationStats(**norm))
    m, audio = validate_acoustic(state, pctx, Batch(*map(torch.from_numpy, batch)),
                                 prior=torch.from_numpy(prior))
    np.testing.assert_allclose(float(m["mel"]), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), atol=1e-4)


def _stepped_state(seed):
    mc = port_config(tiny_jax_config())
    torch.manual_seed(seed)
    state = create_stage_train_state(build_models(mc), "cpu", "acoustic", seed=seed)
    ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                      stage_steps=10)
    step = make_acoustic_step(ctx)
    for s in range(2):
        step(state, Batch(*map(torch.from_numpy, _batch(s))))
    return state, mc


def test_acoustic_state_round_trip_is_bitwise(tmp_path):
    state, mc = _stepped_state(0)
    manifest = Manifest(current_epoch=1, current_step=2, current_total_step=2,
                        stage="acoustic")
    path = save_checkpoint(str(tmp_path), state, manifest, Config(), mc,
                           NormalizationStats())
    other, _ = _stepped_state(1)
    other.wavlm = "kept"
    loaded, manifest2, _ = load_checkpoint(path, other)
    assert loaded.wavlm == "kept"  # frozen, never checkpointed
    assert "wavlm" not in torch.load(os.path.join(path, STATE_FILE), weights_only=True)
    _assert_tree_equal(state.state_dict(), loaded.state_dict())
    assert manifest2 == manifest and loaded.step == 2
    for g in ("dropout_generator", "model_generator", "disc_index_generator"):
        assert torch.equal(torch.rand(4, generator=getattr(state, g)),
                           torch.rand(4, generator=getattr(loaded, g))), g


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``train --stage acoustic`` for 2 epochs (validation every 2 steps, a
    checkpoint every step), then resumed from the oldest kept checkpoint
    into another directory; both through the CLI on the CPU."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("acoustic")
    data = make_micro_dataset(str(root / "data"), n_train=4, n_val=2,
                              uniform_duration=True)
    cfg = {
        "training": {"log_interval": 2, "data_workers": 2, "val_interval": 2,
                     "save_interval": 1, "mixed_precision": "bf16"},
        "training_plan": {"acoustic": {"epochs": 2, "probe_batch_max": 2, "lr": 1e-4},
                          **{stage: {"epochs": 0, "probe_batch_max": 2, "lr": 1e-4}
                             for stage in ("textual", "duration")}},
        "dataset": {"path": data},
        "validation": {"sample_count": 1},
    }
    (root / "config.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    mc = port_config(tiny_jax_config()).model_dump()
    mc["slm"]["allow_random_fallback"] = True
    (root / "model.yml").write_text(yaml.safe_dump(mc), encoding="utf-8")
    runner = CliRunner()

    def run(out, *extra):
        result = runner.invoke(train_cli, [
            "train", "--stage", "acoustic", "--config", str(root / "config.yml"),
            "--model-config", str(root / "model.yml"), "--out", str(root / out),
            "--device", "cpu", "--record-steps", *extra], standalone_mode=False)
        assert result.exit_code == 0, result.output + repr(result.exception)
        return result.return_value

    full = run("full")
    stage_dir = root / "full" / "acoustic"
    ckpts = sorted(d for d in os.listdir(stage_dir) if d.startswith("checkpoint_"))
    resumed = run("resumed", "--checkpoint", str(stage_dir / ckpts[0]))
    return root, full, resumed, ckpts


def test_train_acoustic_through_the_cli(runs):
    root, full, _resumed, ckpts = runs
    total = full.stage_manifests["acoustic"].current_total_step
    assert total == 4 and len(full.step_metrics) == total
    keys = {"mel", "multi_phase", "generator", "slm", "discriminator", "lr",
            "mrd0_lr_mult", "mrd1_lr_mult", "mrd2_lr_mult", "disc_lr_mult"}
    for m in full.step_metrics:
        assert set(m) == keys and all(np.isfinite(list(m.values())))
        assert all(0.01 - 1e-6 <= m[k] <= 4.0 + 1e-6 for k in keys if k.endswith("_mult"))
    assert [v["step"] for v in full.validations] == [2, 4]
    assert all(np.isfinite(v["mel"]) for v in full.validations)
    samples = root / "full" / "acoustic" / "samples"
    assert sorted(os.listdir(samples)) == ["step_000000002", "step_000000004"]
    assert all(f.endswith(".wav") for d in os.listdir(samples)
               for f in os.listdir(samples / d))
    assert ckpts == [checkpoint_dir_name(e, s) for e, s in ((1, 1), (1, 2), (2, 3), (2, 4))]


def test_acoustic_resume_equals_the_uninterrupted_run_bitwise(runs):
    root, full, resumed, _ = runs
    n = len(resumed.step_metrics)
    assert n == 3
    assert resumed.step_metrics == full.step_metrics[-n:]
    assert resumed.batches == full.batches[-n:]
    assert resumed.validations == full.validations
    last = checkpoint_dir_name(2, 4)
    saved = [torch.load(root / run / "acoustic" / last / STATE_FILE, weights_only=True)
             for run in ("full", "resumed")]
    _assert_tree_equal(saved[0], saved[1])


def test_unported_stages_and_missing_cuda_raise(runs, tmp_path):
    root, *_ = runs
    runner = CliRunner()
    args = ["train", "--config", str(root / "config.yml"), "--out", str(tmp_path)]
    result = runner.invoke(train_cli, [*args, "--stage", "style", "--device", "cpu"])
    assert result.exit_code != 0 and "Invalid value for '--stage'" in result.output
    if not torch.cuda.is_available():
        result = runner.invoke(train_cli, args, standalone_mode=False)
        assert isinstance(result.exception, RuntimeError)
        assert "CUDA is not available" in str(result.exception)


def test_acoustic_reset_stage_and_foreign_checkpoints(runs, tmp_path, monkeypatch):
    """``--reset-stage`` keeps an acoustic checkpoint's weights but starts
    the counters at 0; an alignment checkpoint cannot seed the acoustic
    state (it holds no module of the later stages) and raises."""
    from stylish_tts_torch.config import load_config_yaml, load_model_config_yaml
    from stylish_tts_torch.trainer import loop as loop_mod

    root, full, _resumed, ckpts = runs
    config = load_config_yaml(str(root / "config.yml"))
    config.loss_weight.slm = 0.0
    mc = load_model_config_yaml(str(root / "model.yml"))
    seen = {}

    def fake_run(self, stage, state, *args):
        if stage == "acoustic":
            seen["step"], seen["skip"], seen["manifest"] = state.step, args[-1], self.manifest
        return state

    monkeypatch.setattr(loop_mod.Trainer, "run_stage", fake_run)
    trainer = loop_mod.Trainer(config, mc, str(tmp_path / "o"), device="cpu")
    ckpt = str(root / "full" / "acoustic" / ckpts[1])  # epoch 1, its second step
    trainer.train("acoustic", checkpoint=ckpt)
    assert seen["step"] == 2 and seen["skip"] == 2 and seen["manifest"].current_total_step == 2
    trainer.train("acoustic", checkpoint=ckpt, reset_stage=True)
    assert seen["step"] == 0 and seen["skip"] == 0
    assert seen["manifest"] == Manifest(stage="acoustic")
    from stylish_tts_torch.models import TextAligner

    aligner_state = create_train_state(TextAligner(hidden_dim=32), 179, "cpu")
    foreign = save_checkpoint(str(tmp_path / "align"), aligner_state,
                              Manifest(stage="alignment"), config, mc, NormalizationStats())
    with pytest.raises(ValueError, match="holds no module of the acoustic"):
        trainer.train("acoustic", checkpoint=foreign)
