"""``train --profile DIR`` on the port: the whole run under
``torch.profiler`` (the JAX command's ``jax.profiler.trace``), its Chrome
trace written as ``DIR/trace_rank0.json``.

On the CPU, at the tiny config (``tests/test_torch_synth_common.py``), the
acoustic stage alone (``trainer/loop.NEXT_STAGE`` emptied) for 2 steps: the
trace is JSON with the operations of both steps' generator and
discriminator phases (the convolutions and their backward) and the
program's spans (``utils/trace.py``) on the trace's time base, each
``train.step`` around its step's operations, and the run trains as it does
without the flag (the same metrics, bitwise).
"""

import json

import pytest
import torch
import yaml
from click.testing import CliRunner

from fixtures import make_micro_dataset
from stylish_tts_torch.cli import train_cli
from stylish_tts_torch.trainer import loop as loop_mod
from test_torch_synth_common import port_config, tiny_jax_config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("profile")
    data = make_micro_dataset(str(root / "data"), n_train=4, n_val=2, uniform_duration=True)
    cfg = {
        "training": {"log_interval": 1, "data_workers": 2, "val_interval": 1000,
                     "save_interval": 1000},
        "training_plan": {"acoustic": {"epochs": 1, "probe_batch_max": 2, "lr": 1e-4}},
        "dataset": {"path": data},
        "loss_weight": {"slm": 0.0},
    }
    (root / "config.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    (root / "model.yml").write_text(
        yaml.safe_dump(port_config(tiny_jax_config()).model_dump()), encoding="utf-8")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_mod, "NEXT_STAGE", {})
        results = {}
        for name, extra in (("plain", []), ("profiled", ["--profile", str(root / "trace")])):
            result = CliRunner().invoke(train_cli, [
                "train", "--config", str(root / "config.yml"), "--model-config",
                str(root / "model.yml"), "--out", str(root / name), "--device", "cpu",
                "--record-steps", *extra], standalone_mode=False)
            assert result.exit_code == 0, result.output + repr(result.exception)
            results[name] = result.return_value
    return root, results


def test_profile_writes_a_readable_chrome_trace(runs):
    root, results = runs
    assert sorted(p.name for p in (root / "trace").iterdir()) == ["trace_rank0.json"]
    trace = json.loads((root / "trace" / "trace_rank0.json").read_text(encoding="utf-8"))
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert results["profiled"].manifest.current_total_step == 2
    assert sum(n in ("aten::convolution", "aten::conv1d", "aten::conv2d") for n in names) > 0
    assert any("ConvolutionBackward" in n for n in names)


def test_profiled_run_trains_as_the_plain_one(runs):
    _, results = runs
    assert results["profiled"].step_metrics == results["plain"].step_metrics


def test_profile_holds_the_program_spans_around_their_operations(runs):
    root, _ = runs
    trace = json.loads((root / "trace" / "trace_rank0.json").read_text(encoding="utf-8"))
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    steps = sorted((e for e in spans if e["name"] == "train.step"), key=lambda e: e["ts"])
    assert [e["args"]["unit"] for e in steps] == [0, 1]
    names = {e["name"] for e in spans}
    assert names >= {"train.features", "train.gen.forward", "train.gen.backward",
                     "train.gen.update", "train.disc.forward", "train.disc.backward",
                     "train.disc.update", "train.sync.finite", "train.sync.ema",
                     "loader.load", "loader.wait"}
    assert trace["programSpansDropped"] == 0
    # the backward of a step's convolutions runs inside that step's span
    backward = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"
                and "ConvolutionBackward" in e.get("name", "")]
    assert backward

    def within(op, step):
        return step["ts"] <= op["ts"] and op["ts"] + op["dur"] <= step["ts"] + step["dur"]

    assert all(sum(within(op, step) for step in steps) == 1 for op in backward)
    assert all(any(within(op, step) for op in backward) for step in steps)
