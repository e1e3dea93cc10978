"""The acoustic discriminators' tuned cuDNN plans on a card, at the acoustic
cell's shapes (B = 16 clips of 132,000 samples; the three MRDs and the
waveform disc at ``ModelConfig()``'s widths), float32 with TF32 off:

* after ``_tune_discriminators`` the discriminators' forward and backward
  run the same kernels under cuDNN's heuristic flag as under its autotuner:
  the plans the tuning pass timed serve the step's own calls;
* each of their convolutions on those plans, forward, input gradient and
  weight and bias gradient, is within 1e-5 of the float64 result, as a
  share of the norm of the same pass over the operands' magnitudes (the
  sums' own scale: a bias gradient of one channel sums millions of terms of
  either sign to a small total, which float32 rounding alone moves by about
  1e-5 of that total, whatever the engine; TF32 would read about 1e-3).
  Each conv is held alone, on the input the module gives it: through a
  whole module a pre-activation within a rounding of zero would take the
  other slope of a leaky ReLU, which is the function's kink and not the
  engine.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so it runs on a GPU machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_disc_autotune_cuda.py -q
"""

import pytest
import torch
from torch.autograd import DeviceType

from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.models.discriminators import ContextFreeDiscriminator, SpecDiscriminator
from stylish_tts_torch.trainer import steps
from stylish_tts_torch.trainer.normalization import NormalizationStats

B, SAMPLES = 16, 132_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _gap(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - ref) / torch.linalg.vector_norm(scale))


def _run(discs, inputs) -> set:
    """The kernels of each discriminator's forward and backward to its input
    and its weights."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for name, x in inputs.items():
            x = x.clone().requires_grad_(True)
            scores = discs[name](x)
            torch.autograd.grad(sum(s.sum() for s in scores), [x, *discs[name].parameters()])
        torch.cuda.synchronize()
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA}


def _passes(conv, x, gy, w, b):
    dims = x.dim() - 2
    fwd = torch.nn.functional.conv2d if dims == 2 else torch.nn.functional.conv1d
    dx, dw, db = torch.ops.aten.convolution_backward(
        gy, x, w, None if b is None else [b.shape[0]], list(conv.stride), list(conv.padding),
        [1] * dims, False, [0] * dims, conv.groups, [True, True, b is not None])
    out = {"forward": fwd(x, w, b, conv.stride, conv.padding, 1, conv.groups),
           "dgrad": dx, "wgrad": dw}
    if b is not None:
        out["bias"] = db
    return out


@pytest.mark.gpu
def test_tuned_discriminator_plans_serve_the_heuristic_flag_and_hold_float64(dev):
    torch.manual_seed(0)
    discs = {**{f"mrd{i}": SpecDiscriminator() for i in range(3)},
             "disc": ContextFreeDiscriminator()}
    discs = {k: m.to(dev) for k, m in discs.items()}
    ctx = steps.StepContext(ModelConfig(), {}, NormalizationStats())
    audio = 0.1 * torch.randn((B, SAMPLES), device=dev)
    specs = ctx.multi_spec(audio).fft_mag
    inputs = {**{f"mrd{i}": s for i, s in enumerate(specs)}, "disc": audio}

    torch.backends.cudnn.benchmark = False
    steps._tune_discriminators(ctx, discs, specs, audio)
    assert torch.backends.cudnn.benchmark is False
    torch.backends.cudnn.benchmark = True
    autotuned = _run(discs, inputs)
    torch.backends.cudnn.benchmark = False
    assert _run(discs, inputs) == autotuned

    layer_inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, a: layer_inputs.append((m, a[0])))
             for d in discs.values() for m in d.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))]
    with torch.no_grad():
        for name, x in inputs.items():
            discs[name](x)
    for h in hooks:
        h.remove()
    assert len(layer_inputs) == 3 * 10 + 9
    gaps = {}
    with torch.no_grad():
        for i, (conv, x) in enumerate(layer_inputs):
            gy = torch.randn_like(conv(x))
            w, b = conv.weight.detach(), conv.bias
            b = None if b is None else b.detach()
            got = _passes(conv, x, gy, w, b)
            x, gy, w, b = (None if t is None else t.double() for t in (x, gy, w, b))
            ref = _passes(conv, x, gy, w, b)
            scale = _passes(conv, x.abs(), gy.abs(), w.abs(), None if b is None else b.abs())
            gaps.update({f"{i}.{k}": _gap(got[k], ref[k], scale[k]) for k in got})
    print({k: f"{v:.1e}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:12]})
    assert max(gaps.values()) <= 1e-5, gaps
