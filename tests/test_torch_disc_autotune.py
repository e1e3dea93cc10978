"""The acoustic step's tuning of its discriminators' cuDNN plans
(``trainer/steps.py`` ``_tune_discriminators``), on the CPU at the
synthesis tests' tiny config:

* the tuning pass runs every convolution of the three MRDs and the waveform
  disc once, forward and backward to both the input and the weights, under
  cuDNN's autotuner with ``TUNE_ENGINES`` engines, unseen by the modules'
  forward hooks, and leaves the parameters, their gradients, their
  ``requires_grad`` and the cuDNN flags as they were, also when it raises;
* the step tunes once per new input shape where cuDNN runs its
  convolutions, never elsewhere, and ``disc.conv_autotune`` counts each
  step as ``on`` or ``off``;
* a step with the tuning pass equals one without it, bit for bit, and
  leaves TF32 off.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stylish_tts_torch.config import Config
from stylish_tts_torch.models import build_models
from stylish_tts_torch.trainer import steps
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, make_acoustic_step
from stylish_tts_torch.utils import trace
from test_torch_synth_common import port_config, tiny_jax_config

B, L, HOP = 2, 10, 300
DISCS = ("mrd0", "mrd1", "mrd2", "disc")


def _batch(seed, frames=40):
    rng = np.random.default_rng(seed)
    tt = np.arange(frames * HOP) / 24000.0
    audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 220, (B, 1)) * tt)
    return Batch(*map(torch.from_numpy, (
        audio.astype(np.float32), rng.integers(1, 170, (B, L)).astype(np.int32),
        np.array([L, L - 3], np.int32), rng.uniform(90, 250, (B, frames)).astype(np.float32),
        np.full((B, L), frames // L).astype(np.int32))))


@pytest.fixture(scope="module")
def mc():
    return port_config(tiny_jax_config())


def _state_and_ctx(mc):
    torch.manual_seed(0)
    state = create_stage_train_state(build_models(mc), "cpu", "acoustic", seed=0)
    ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                      stage_steps=50, base_lr=1e-4)
    return state, ctx


class _Convs(TorchDispatchMode):
    """The convolutions dispatched inside it: the forwards, and the output
    masks of the backwards, with the cuDNN flags at each."""

    def __init__(self):
        super().__init__()
        self.forward, self.backward = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit)
        if func is torch.ops.aten.convolution.default:
            self.forward.append(flags)
        elif func is torch.ops.aten.convolution_backward.default:
            self.backward.append((tuple(args[-1]), flags))
        return func(*args, **(kwargs or {}))


def _inputs(ctx, seed=0):
    audio = _batch(seed).audio_gt
    return ctx.multi_spec(audio).fft_mag, audio


def test_the_tuning_pass_runs_every_conv_under_the_autotuner(monkeypatch, mc):
    state, ctx = _state_and_ctx(mc)
    models = state.models
    models["mrd1"].requires_grad_(False)  # as the generator phase leaves it
    before = {k: {n: p.detach().clone() for n, p in models[k].named_parameters()}
              for k in DISCS}
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark_limit", 10)
    specs, audio = _inputs(ctx)
    seen = []
    hooks = [models[k].register_forward_hook(lambda m, a, out: seen.append(m)) for k in DISCS]
    with _Convs() as convs:
        steps._tune_discriminators(ctx, models, specs, audio)
    for h in hooks:
        h.remove()
    assert seen == []  # the step's first real call is the one a hook sees first

    n_convs = sum(isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))
                  for k in DISCS for m in models[k].modules())
    assert n_convs == 3 * 10 + 9
    tuned = (True, steps.TUNE_ENGINES)
    assert convs.forward == [tuned] * n_convs
    assert len(convs.backward) == n_convs
    assert all(mask[:2] == (True, True) and flags == tuned for mask, flags in convs.backward)
    assert (torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit) == (False, 10)
    for k in DISCS:
        for n, p in models[k].named_parameters():
            assert torch.equal(p, before[k][n]) and p.grad is None
            assert p.requires_grad is (k != "mrd1")


def test_the_tuning_pass_restores_the_flags_when_it_raises(monkeypatch, mc):
    state, ctx = _state_and_ctx(mc)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark_limit", 10)

    def fail(*args):
        raise RuntimeError("planted")

    monkeypatch.setattr(state.models["disc"], "forward", fail)
    specs, audio = _inputs(ctx)
    with pytest.raises(RuntimeError, match="planted"):
        steps._tune_discriminators(ctx, state.models, specs, audio)
    assert (torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit) == (False, 10)


@pytest.mark.parametrize("on_cudnn", [False, True])
def test_the_step_tunes_once_per_new_shape_where_cudnn_runs(monkeypatch, mc, on_cudnn):
    state, ctx = _state_and_ctx(mc)
    monkeypatch.setattr(steps, "_on_cudnn", lambda x: on_cudnn)
    calls = []
    tune = steps._tune_discriminators
    monkeypatch.setattr(steps, "_tune_discriminators",
                        lambda ctx, models, specs, audio: calls.append(audio.shape)
                        or tune(ctx, models, specs, audio))
    step = make_acoustic_step(ctx)
    counts = trace.COUNTERS["disc.conv_autotune"]
    assert counts is steps.AUTOTUNE
    before = dict(counts)
    for seed, frames in ((0, 40), (1, 40), (2, 48), (3, 40)):
        step(state, _batch(seed, frames))
    expected = [(B, 40 * HOP), (B, 48 * HOP)] if on_cudnn else []
    assert [tuple(s) for s in calls] == expected
    key = "on" if on_cudnn else "off"
    assert {k: counts[k] - before[k] for k in ("on", "off")} == {key: 4, **{
        k: 0 for k in ("on", "off") if k != key}}


def test_a_step_with_the_tuning_pass_equals_one_without(monkeypatch, mc):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    results = []
    for on_cudnn in (False, True):
        monkeypatch.setattr(steps, "_on_cudnn", lambda x: on_cudnn)
        state, ctx = _state_and_ctx(mc)
        step = make_acoustic_step(ctx)
        metrics = [step(state, _batch(seed)) for seed in range(2)]
        results.append((metrics, {f"{k}.{n}": p.detach().clone()
                                  for k, m in state.models.items()
                                  for n, p in m.named_parameters()}))
        assert torch.backends.cudnn.allow_tf32 is False
    (m0, p0), (m1, p1) = results
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)
