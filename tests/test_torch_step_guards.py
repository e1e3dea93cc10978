"""The trainer's memory guards on the port (``stylish_tts_torch/trainer/
loop.py``), against the JAX loop's rules (``stylish_tts_tpu/trainer/
loop.py`` ``classify_step_failure`` and its OOM shrink-and-skip):

* ``classify_step_failure`` gives JAX's kinds on JAX's test messages, and
  "oom" for a ``torch.OutOfMemoryError``;
* an out-of-memory failure injected into the first step of a bin (the
  alignment loop and the acoustic stage's loop, on the CPU) lowers that
  bin's batch size as JAX's ``BatchSizeTable.shrink`` does (the same
  sizes, the same saved file), skips the batch without counting a step,
  and the run finishes, its later epochs at the lowered size;
* a stale prefetched batch (larger than the bin's current size) that runs
  out of memory is skipped without a second shrink;
* an out-of-memory failure after the step's first optimizer update began
  lowers the bin and raises;
* ``STYLISH_DEBUG_NANSTEP=1`` with an injected NaN writes
  ``nan_batch_step{i}.npz`` (the batch fields, paths, bin) and raises;
  without it the metrics reach the host once per log interval, never per
  step.
"""

import json
import sys

import numpy as np
import pytest
import torch

from fixtures import make_micro_dataset
from stylish_tts_tpu.data.sampler import BatchSizeTable as JaxTable
from stylish_tts_tpu.trainer.loop import classify_step_failure as jax_classify
from stylish_tts_torch.config import Config
from stylish_tts_torch.data.sampler import BatchSizeTable
from stylish_tts_torch.trainer import loop as loop_mod
from stylish_tts_torch.trainer.steps import Batch
from test_torch_synth_common import port_config, tiny_jax_config

JAX_MESSAGES = [
    "INTERNAL: http://127.0.0.1:8113/remote_compile: read body: "
    "response body closed before all bytes were read",
    "UNAVAILABLE: connection reset",
    "RESOURCE_EXHAUSTED: Out of memory allocating 1234 bytes",
    "remote_compile: RESOURCE_EXHAUSTED during compilation",
    "INVALID_ARGUMENT: shape mismatch",
]
N_TRAIN, PROBE = 12, 4  # one bin of 12 clips at B = 4
OOM = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("msg", JAX_MESSAGES)
def test_classify_step_failure_matches_jax(msg):
    assert loop_mod.classify_step_failure(msg) == jax_classify(msg)
    assert loop_mod.classify_step_failure(RuntimeError(msg)) == jax_classify(msg)


def test_torch_oom_is_oom():
    assert loop_mod.classify_step_failure(OOM) == "oom"
    assert loop_mod.classify_step_failure(torch.cuda.OutOfMemoryError("x")) == "oom"
    assert loop_mod.classify_step_failure(ValueError("shape mismatch")) == "fatal"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_micro_dataset(str(tmp_path_factory.mktemp("guards") / "data"),
                              n_train=N_TRAIN, n_val=2, uniform_duration=True)


def _config(data, epochs=2, log_interval=1):
    cfg = Config()
    cfg.dataset.path = data
    cfg.training.log_interval = log_interval
    cfg.training.data_workers = 2
    for stage in ("alignment", "acoustic"):
        plan = cfg.training_plan.get_stage(stage)
        plan.epochs, plan.probe_batch_max, plan.lr = epochs, PROBE, 1e-5
    cfg.loss_weight.slm = 0.0
    return cfg


def _inject(monkeypatch, factory, fail):
    """Wrap the step ``factory`` makes: ``fail(call, real, state, batch)``
    decides per call (1-based). Returns the call log."""
    calls = []
    real_factory = getattr(loop_mod, factory)

    def make(*args, **kwargs):
        real = real_factory(*args, **kwargs)

        def step(state, batch):
            calls.append(int(batch.text.shape[0]))
            return fail(len(calls), real, state, batch)
        return step

    monkeypatch.setattr(loop_mod, factory, make)
    return calls


def _oom_first(call, real, state, batch):
    if call == 1:
        raise OOM
    return real(state, batch)


def _jax_shrunk(path, sizes, time_bin):
    table = JaxTable(str(path))
    table.sizes = dict(sizes)
    table.shrink(time_bin)
    return json.loads(path.read_text())


def test_oom_in_alignment_lowers_the_bin_and_skips(data, tmp_path, monkeypatch, caplog):
    calls = _inject(monkeypatch, "make_alignment_step", _oom_first)
    trainer = loop_mod.Trainer(_config(data), port_config(tiny_jax_config()),
                               str(tmp_path / "out"), device="cpu", record_steps=True)
    state = trainer.train("alignment")
    saved = json.loads((tmp_path / "out" / "alignment" /
                        "alignment_batch_sizes.json").read_text())
    (time_bin,) = (int(k) for k in saved)
    assert saved == _jax_shrunk(tmp_path / "jax.json", {time_bin: PROBE}, time_bin)
    assert saved == {str(time_bin): 3}
    assert "OOM on bin" in caplog.text and "lowered to 3" in caplog.text
    # every call but the failed one is a step; val-split steps (one an
    # epoch) count in state.step but not in the manifest's train steps
    assert state.step == len(calls) - 1 == len(trainer.losses) == len(trainer.batches)
    assert trainer.manifest.current_total_step == len(calls) - 1 - 2
    assert all(np.isfinite(trainer.losses))
    # the second epoch at the lowered size: 12 clips in 4 batches of 3, then
    # the val split's 2 clips
    assert [len(b) for b in trainer.batches[-5:]] == [3, 3, 3, 3, 2]


def test_stale_batch_is_skipped_without_a_second_shrink(data, tmp_path, monkeypatch):
    trainer = loop_mod.Trainer(_config(data), port_config(tiny_jax_config()),
                               str(tmp_path / "out"), device="cpu")
    table = BatchSizeTable(str(tmp_path / "sizes.json"))
    table.sizes = {5: 3}
    table.save()
    before = (tmp_path / "sizes.json").read_bytes()
    state = loop_mod.create_train_state(loop_mod.build_text_aligner(trainer.mc), 179, "cpu")
    stale = Batch(np.zeros((4, 300), np.float32), np.zeros((4, 5), np.int32),
                  np.full((4,), 5, np.int32), None, None)

    def oom(state, batch):
        raise OOM

    assert trainer._step_or_skip(oom, state, stale, 5, table) is None
    assert table.sizes == {5: 3} and (tmp_path / "sizes.json").read_bytes() == before
    at_size = stale._replace(audio_gt=stale.audio_gt[:3])
    assert trainer._step_or_skip(oom, state, at_size, 5, table) is None
    assert table.sizes == {5: 2}

    def fatal(state, batch):
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError, match="shape mismatch"):
        trainer._step_or_skip(fatal, state, at_size, 5, table)
    assert table.sizes == {5: 2}


def _acoustic_trainer(data, tmp_path, monkeypatch, epochs=1):
    monkeypatch.setattr(loop_mod, "NEXT_STAGE", {})
    cfg = _config(data, epochs=epochs)
    cfg.training.val_interval = 1000
    cfg.training.save_interval = 1000
    return loop_mod.Trainer(cfg, port_config(tiny_jax_config()), str(tmp_path / "out"),
                            device="cpu", record_steps=True)


def test_oom_in_the_acoustic_stage_lowers_the_bin_and_skips(data, tmp_path, monkeypatch):
    calls = _inject(monkeypatch, "make_acoustic_step", _oom_first)
    trainer = _acoustic_trainer(data, tmp_path, monkeypatch)
    state = trainer.train("acoustic")
    saved = json.loads((tmp_path / "out" / "acoustic" / "acoustic_batch_sizes.json")
                       .read_text())
    assert saved == {k: 3 for k in saved} and len(saved) == 1
    assert state.step == trainer.manifest.current_total_step == len(calls) - 1 >= 1
    assert len(trainer.step_metrics) == state.step
    assert all(np.isfinite(list(m.values())).all() for m in trainer.step_metrics)


def test_oom_after_the_first_update_raises_with_the_bin_lowered(data, tmp_path,
                                                                monkeypatch):
    def after_update(call, real, state, batch):
        real(state, batch)
        assert state.update_begun
        raise OOM

    _inject(monkeypatch, "make_acoustic_step", after_update)
    trainer = _acoustic_trainer(data, tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="resume from the last checkpoint") as info:
        trainer.train("acoustic")
    assert isinstance(info.value.__cause__, torch.OutOfMemoryError)
    saved = json.loads((tmp_path / "out" / "acoustic" / "acoustic_batch_sizes.json")
                       .read_text())
    assert list(saved.values()) == [3]


def test_nanstep_debugger_dumps_the_batch_and_raises(data, tmp_path, monkeypatch):
    def nan_on_second(call, real, state, batch):
        metrics = real(state, batch)
        if call == 2:
            metrics["align_loss"] = metrics["align_loss"] * float("nan")
        return metrics

    _inject(monkeypatch, "make_alignment_step", nan_on_second)
    monkeypatch.setenv("STYLISH_DEBUG_NANSTEP", "1")
    trainer = loop_mod.Trainer(_config(data), port_config(tiny_jax_config()),
                               str(tmp_path / "out"), device="cpu", record_steps=True)
    with pytest.raises(RuntimeError, match=r"debug: nonfinite \['align_loss'\]"):
        trainer.train("alignment")
    dump = np.load(tmp_path / "out" / "alignment" / "nan_batch_step2.npz")
    assert {"paths", "time_bin", "audio_gt", "text", "text_lengths"} <= set(dump.files)
    assert dump["audio_gt"].dtype == np.float32 and dump["audio_gt"].shape[0] == PROBE
    assert len(dump["paths"]) == PROBE and all(p.endswith(".wav") for p in dump["paths"])
    bins, _ = trainer.build_dataset("train-list.txt").time_bins()
    assert int(dump["time_bin"]) in bins


@pytest.mark.parametrize("debug", [False, True], ids=["off", "on"])
def test_metrics_sync_per_step_only_under_the_debugger(data, tmp_path, monkeypatch, debug):
    if debug:
        monkeypatch.setenv("STYLISH_DEBUG_NANSTEP", "1")
    else:
        monkeypatch.delenv("STYLISH_DEBUG_NANSTEP", raising=False)
    windows = []
    real = loop_mod._metrics_to_host

    def spy(window):
        windows.append((sys._getframe(1).f_code.co_name, len(window)))
        return real(window)

    monkeypatch.setattr(loop_mod, "_metrics_to_host", spy)
    trainer = loop_mod.Trainer(_config(data, epochs=2, log_interval=2),
                               port_config(tiny_jax_config()), str(tmp_path / "out"),
                               device="cpu", record_steps=True)
    trainer.train("alignment")
    train_steps = trainer.manifest.current_total_step
    assert train_steps == 6
    per_step = [n for caller, n in windows if caller == "_debug_nanstep"]
    logged = [n for caller, n in windows if caller != "_debug_nanstep"]
    assert per_step == ([1] * train_steps if debug else [])
    # the log-interval drains hold every step once (the val-split steps
    # too), a drain every second train step and one at the end
    assert sum(logged) == len(trainer.losses)
    assert len(logged) == train_steps // 2 + 1
