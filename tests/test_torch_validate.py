"""Alignment validation: the port's ``trainer/validate.py``
``validate_alignment`` against the JAX package's on the same weights and
batch, and the loop's validation pass (chunking, mean of batch means,
``best_loss``, errors raised).

Tolerances: loss and confidence within 1e-4 relative of JAX's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import make_micro_dataset
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.steps import StepContext as JaxStepContext
from stylish_tts_tpu.trainer.validate import validate_alignment as jax_validate
from stylish_tts_torch.config import Config, ModelConfig
from stylish_tts_torch.convert.from_jax import text_aligner_from_jax
from stylish_tts_torch.data.collate import collate_batch
from stylish_tts_torch.data.sampler import BatchSizeTable, DynamicBatchSampler
from stylish_tts_torch.models.text_aligner import TextAligner
from stylish_tts_torch.trainer import loop as loop_mod
from stylish_tts_torch.trainer.loss_log import weighted_total
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, batch_to_device
from stylish_tts_torch.trainer.validate import validate_alignment

RTOL = 1e-4
HIDDEN = 48
NORM = dict(mel_log_mean=-3.5, mel_log_std=3.0)


def _batch(seed=0):
    """3 rows of harmonic-plus-noise audio (60 align frames) and random
    token strings of ragged length in text bucket 32."""
    rng = np.random.default_rng(seed)
    samples = 60 * 300
    t = np.arange(samples) / 24000
    audio = np.stack([
        0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(samples)
        for f in (110.0, 180.0, 240.0)
    ]).astype(np.float32)
    lengths = np.array([20, 9, 30], np.int32)
    text = np.zeros((3, 32), np.int32)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(0, 178, n)
    zeros = np.zeros((3, 32), np.int32)
    return Batch(audio, text, lengths, np.zeros((3, 60), np.float32), zeros)


def test_validate_alignment_matches_jax():
    model = JaxAligner(hidden_dim=HIDDEN, dropout=0.0)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)), jnp.full((1,), 16, jnp.int32)))
    batch = _batch()
    jax_ctx = JaxStepContext({"text_aligner": model}, JaxModelConfig(), {},
                             JaxNorm(**NORM))
    ref, _ = jax.jit(lambda p, audio, text, lengths: jax_validate(
        SimpleNamespace(params={"text_aligner": p}), jax_ctx,
        SimpleNamespace(audio_gt=audio, text=text, text_lengths=lengths)))(
        params, batch.audio_gt, batch.text, batch.text_lengths)

    port = TextAligner(hidden_dim=HIDDEN, dropout=0.0)
    port.load_state_dict(text_aligner_from_jax(params))
    state = create_train_state(port, 179, "cpu")
    ctx = StepContext(ModelConfig(), {}, NormalizationStats(**NORM))
    ours = validate_alignment(state, ctx, batch_to_device(batch, "cpu"))
    assert not state.aligner.training
    for k in ("align_loss", "confidence"):
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=RTOL,
                                   err_msg=k)
    assert 0.0 < float(ours["confidence"]) <= 1.0


@pytest.fixture(scope="module")
def trainer_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("validate")
    data = make_micro_dataset(str(root / "data"), n_train=2, n_val=5,
                              uniform_duration=True, with_caches=False)
    config = Config()
    config.dataset.path = data
    trainer = loop_mod.Trainer(config, ModelConfig(), str(root / "out"), device="cpu")
    val_ds = trainer.build_dataset(config.dataset.val_data)
    val_bins, _ = val_ds.time_bins()
    torch.manual_seed(0)
    state = create_train_state(TextAligner(hidden_dim=HIDDEN), 179, "cpu")
    ctx = StepContext(trainer.mc, config.loss_weight.model_dump(),
                      NormalizationStats(**NORM))
    return trainer, state, ctx, val_ds, val_bins


@pytest.mark.parametrize("planned,batch_sizes", [(5, [5]), (3, [3, 1, 1]),
                                                 (8, [1, 1, 1, 1, 1])])
def test_validation_chunks_and_means_batch_means(trainer_setup, monkeypatch, planned,
                                                 batch_sizes):
    """A bin's full planned batch stays whole; a ragged one is re-chunked to
    B = 1; the logged metric is the mean of the batch means."""
    trainer, state, ctx, val_ds, val_bins = trainer_setup
    (time_bin, idxs), = val_bins.items()
    table = BatchSizeTable(probe_batch_max=planned)
    table.sizes[time_bin] = planned
    seen = []

    def spy(state_, ctx_, batch):
        seen.append(batch.text.shape[0])
        return validate_alignment(state_, ctx_, batch)

    trainer.manifest.best_loss = float("inf")
    monkeypatch.setattr(loop_mod, "validate_alignment", spy)
    avg = trainer.validate(state, ctx, val_ds, val_bins, table)
    assert seen == batch_sizes
    assert trainer.validations[-1]["batches"] == len(batch_sizes)
    # the mean of batch means, rebuilt from the same chunks
    means = []
    for _bin, batch_idxs in DynamicBatchSampler(val_bins, table, shuffle=False,
                                                drop_last=False):
        chunks = [batch_idxs] if len(batch_idxs) == planned else [[j] for j in batch_idxs]
        for chunk in chunks:
            batch, _ = collate_batch([val_ds.load_segment(j) for j in chunk],
                                     hop_length=300, require_pitch=False)
            means.append({k: float(v) for k, v in validate_alignment(
                state, ctx, batch_to_device(batch, "cpu")).items()})
    for k in ("align_loss", "confidence"):
        assert avg[k] == pytest.approx(np.mean([m[k] for m in means]), rel=1e-6)
    assert trainer.manifest.best_loss == weighted_total(avg, ctx.weights)
    assert 0.0 < avg["confidence"] <= 1.0


def test_a_failing_validation_batch_raises(trainer_setup, monkeypatch):
    """The JAX loop logs and skips a failing batch; the port raises."""
    trainer, state, ctx, val_ds, val_bins = trainer_setup

    def broken(*_args):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(loop_mod, "validate_alignment", broken)
    table = BatchSizeTable(probe_batch_max=4)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        trainer.validate(state, ctx, val_ds, val_bins, table)
