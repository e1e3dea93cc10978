"""The validation figures and ``git_state.txt`` on the port.

* ``utils/plotting.py``'s numeric helpers against the JAX package's,
  exactly; both figures where matplotlib is present, None where it is not;
* ``MetricsWriter.add_figure``: TensorBoard only, None skipped;
* a figure that fails raises;
* a tiny ``train --stage duration`` run through the CLI (validation every
  step, one eval sample): the three figure tags
  ``eval/<path>/mel_{gt,pred,diff}`` in the stage's TensorBoard events, and
  ``git_state.txt`` in the stage directory.
"""

import sys

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from fixtures import make_micro_dataset
from stylish_tts_tpu.utils import plotting as jplot
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.config import Config
from stylish_tts_torch.trainer import loss_log
from stylish_tts_torch.utils import plotting
from test_torch_synth_common import port_config, randn, tiny_jax_config

CASES = {
    "normal": lambda: randn((20, 33), 1),
    "log_mel": lambda: np.log(1e-5 + np.abs(randn((80, 41), 2)) ** 2),
    "constant": lambda: np.full((4, 5), 0.25, np.float32),
    "ramp": lambda: np.linspace(-3.0, 5.0, 200, dtype=np.float32).reshape(10, 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_numeric_helpers_equal_jax(case):
    x = CASES[case]()
    assert plotting.robust_color_limits(x) == jplot.robust_color_limits(x)
    assert plotting.robust_color_limits(x, 10.0, 90.0) == jplot.robust_color_limits(
        x, 10.0, 90.0)
    assert plotting.summarize_residual(x) == jplot.summarize_residual(x)


def test_figures_where_matplotlib_is_present():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    gt, pred = CASES["log_mel"](), CASES["log_mel"]()[:, :37] + 0.5
    fig = plotting.plot_spectrogram_figure(gt, "GT")
    diff = plotting.plot_signed_difference_figure(gt, pred, "pred-GT")
    try:
        assert fig.axes[0].get_title() == "GT"
        assert fig.axes[0].images[0].get_array().shape == gt.shape
        stats = plotting.summarize_residual(pred - gt[:, :37])
        assert diff.axes[0].get_title() == (
            f"pred-GT mae={stats['mae']:.3f} rmse={stats['rmse']:.3f} "
            f"bias={stats['bias']:+.3f}")
        assert diff.axes[0].images[0].get_array().shape == (80, 37)
    finally:
        plt.close(fig)
        plt.close(diff)


def test_figures_are_none_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    x = CASES["normal"]()
    assert plotting.plot_spectrogram_figure(x) is None
    assert plotting.plot_signed_difference_figure(x, x) is None


def test_add_figure_skips_none_and_needs_tensorboard(tmp_path, monkeypatch):
    writer = loss_log.MetricsWriter(str(tmp_path))
    calls = []
    if writer._tb is not None:
        monkeypatch.setattr(writer._tb, "add_figure", lambda *a: calls.append(a))
    writer.add_figure("eval/x/mel_gt", None, 3)
    assert not calls
    fig = plotting.plot_spectrogram_figure(CASES["normal"](), "x")
    writer.add_figure("eval/x/mel_gt", fig, 3)
    if writer._tb is not None and fig is not None:
        assert calls == [("eval/x/mel_gt", fig, 3)]
    writer.close()


@pytest.fixture(scope="module")
def duration_run(tmp_path_factory):
    """``train --stage duration`` at the tiny config: 2 train clips at
    B = 2 (one step), validation at that step with one eval sample."""
    root = tmp_path_factory.mktemp("figures")
    data = make_micro_dataset(str(root / "data"), n_train=2, n_val=1,
                              uniform_duration=True)
    plan = {"epochs": 1, "probe_batch_max": 2, "lr": 1e-4}
    cfg = {"dataset": {"path": data},
           "training": {"log_interval": 1, "val_interval": 1, "save_interval": 10},
           "training_plan": {"duration": plan},
           "validation": {"sample_count": 1}}
    (root / "config.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    (root / "model.yml").write_text(yaml.safe_dump(port_config(tiny_jax_config()).model_dump()),
                                    encoding="utf-8")
    result = CliRunner().invoke(train_cli, [
        "train", "--stage", "duration", "--config", str(root / "config.yml"),
        "--model-config", str(root / "model.yml"), "--out", str(root / "out"),
        "--device", "cpu"], standalone_mode=False)
    assert result.exit_code == 0, result.output + repr(result.exception)
    return root, result.return_value


def test_validation_writes_the_three_figure_tags(duration_run):
    pytest.importorskip("matplotlib")
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    root, trainer = duration_run
    assert [v["step"] for v in trainer.validations] == [1]
    events = EventAccumulator(str(root / "out" / "duration" / "tensorboard"),
                              size_guidance={"images": 0})
    events.Reload()
    tags = sorted(events.Tags()["images"])
    assert len(tags) == 3, tags
    path = tags[0][len("eval/"):-len("/mel_diff")]  # the val clip's wav
    assert path.endswith(".wav")
    assert tags == [f"eval/{path}/mel_{k}" for k in ("diff", "gt", "pred")]
    for tag in tags:
        (image,) = events.Images(tag)
        assert image.step == 1 and image.width > 0 and image.height > 0


def test_stage_directory_has_git_state(duration_run):
    root, _ = duration_run
    text = (root / "out" / "duration" / "git_state.txt").read_text(encoding="utf-8")
    first = text.splitlines()[0]
    assert first.startswith("Git commit hash or version: ")
    value = first.split(": ", 1)[1]
    assert value.startswith("version ") or len(value) == 40, first


def test_a_failing_figure_raises(tmp_path, monkeypatch):
    """The port does not swallow a figure's failure (the JAX loop logs it
    at debug level and goes on)."""
    import torch

    from stylish_tts_torch.trainer.loop import Trainer

    def broken(*args):
        raise RuntimeError("no figure")

    monkeypatch.setattr(plotting, "plot_spectrogram_figure", broken)
    trainer = Trainer(Config(), port_config(tiny_jax_config()), str(tmp_path),
                      device="cpu")
    trainer.writer = loss_log.MetricsWriter(str(tmp_path))
    with pytest.raises(RuntimeError, match="no figure"):
        trainer._emit_mel_figures("a.wav", np.zeros(4800, np.float32), torch.zeros(4800), 1)
    trainer.writer.close()
