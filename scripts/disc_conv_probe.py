"""The acoustic step's float32 discriminator convolutions on the card, by
layer, pass and kernel, under each way of handing them to cuDNN.

    python3 scripts/disc_conv_probe.py [--out DIR] [--steps N] [--settings ...]

A setting is ``LAYOUT:AUTOTUNE:LIMIT:PART``. ``layers`` runs each conv of
the three MRDs at the acoustic cell's shapes (B = 16 clips of 132,000
samples: |FFT| grids of 257 x 1032, 513 x 516 and 1025 x 258) in NCHW or
NHWC, and each conv of the waveform disc (4,096 windows of 1,024 samples),
under cuDNN's heuristic (AUTOTUNE 0) or its autotuner timing LIMIT engines
(``cudnn.benchmark_limit``): forward, dgrad (the input's gradient) and
wgrad (the weight's and the bias's); ms of the first call (the autotuner's
timing), ms a call after it (CUDA events over ``REPEAT`` calls), the
kernels of one call by name (``torch.profiler``), and ms a step, weighted by
the calls a step makes (``STEP_CALLS``). ``step`` runs ``make_acoustic_step``
at ``ModelConfig()`` with the seeded WavLM, B = 16 x 440 frames, the bf16
generator, with its discriminators' plans tuned (AUTOTUNE 1, the step as it
is) or every plan the heuristic's (AUTOTUNE 0): each warm-up step's ms, ms a
step (host clock, synchronised), device ms a step by kernel over profiled
steps, the ``disc.conv_autotune`` counts, then the first and second step at
a new bin (360 frames); LAYOUT and LIMIT do not apply to it.

float32 with TF32 off, as the benchmark runs it. Each setting runs in a
process of its own: cuDNN keeps one plan per convolution, chosen at its
first call whatever the autotuner flag is later, so a plan found under one
setting would serve the next. Prints one JSON line per setting and writes
them all to ``DIR/disc_conv_probe.json`` (default ``chiprun_out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = 16
SAMPLES = 132_000  # 440 frames x hop 300
REPEAT = 10
SETTINGS = ("nchw:0:10:layers,nhwc:0:10:layers,nchw:1:3:layers,nchw:1:10:layers,"
            "nhwc:1:10:layers,nchw:1:10:step,nchw:0:10:step")
# calls a step makes of each pass: the G phase runs the three MRDs on the
# real and the fake spectrogram and takes the fake input's gradient; the D
# phase runs the sampled MRD (one in three) on both, detached, and takes its
# weights' gradients, and the inputs' gradients of every layer but the
# first; the waveform disc runs in both phases every step
STEP_CALLS = {
    "mrd": {"forward": 2 + 2 / 3, "dgrad": 1 + 2 / 3, "dgrad_first": 1.0, "wgrad": 2 / 3},
    "disc": {"forward": 4.0, "dgrad": 3.0, "dgrad_first": 1.0, "wgrad": 2.0},
}


def _kernels(fn):
    """{kernel name: device ms} of one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out[e.name()] += e.duration_ns() / 1e6
    return dict(out)


def _time(fn) -> tuple:
    """(ms of the first call, which times cuDNN's engines under the
    autotuner; ms a call after it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPEAT):
        fn()
    end.record()
    torch.cuda.synchronize()
    return first, start.elapsed_time(end) / REPEAT


def _passes(x, w, bias, stride, padding, groups):
    """forward, dgrad and wgrad of one conv as zero-argument calls."""
    import torch

    dims = x.dim() - 2
    fwd = torch.nn.functional.conv2d if dims == 2 else torch.nn.functional.conv1d
    y = fwd(x, w, bias, stride, padding, 1, groups)
    gy = torch.randn_like(y)
    bw = torch.ops.aten.convolution_backward
    args = (gy, x, w, None if bias is None else [bias.shape[0]], list(stride),
            list(padding), [1] * dims, False, [0] * dims, groups)
    return {
        "forward": lambda: fwd(x, w, bias, stride, padding, 1, groups),
        "dgrad": lambda: bw(*args, [True, False, False]),
        "wgrad": lambda: bw(*args, [False, True, bias is not None]),
    }, y


def _layer_rows(module: str, layer: str, first: bool, x, w, bias, stride, padding, groups):
    calls, y = _passes(x, w, bias, stride, padding, groups)
    rows = []
    for name, fn in calls.items():
        first, ms = _time(fn)
        weight = STEP_CALLS[module.split(".")[0]]["dgrad_first" if first and name == "dgrad"
                                                  else name]
        rows.append({"module": module, "layer": layer, "pass": name, "ms_first": first,
                     "ms_call": ms,
                     "ms_step": ms * weight, "kernels": _kernels(fn)})
    return rows, y


def probe_layers(layout: str) -> list:
    import torch
    import torch.nn.functional as F

    from stylish_tts_torch.dsp.multi_spectrogram import RESOLUTIONS
    from stylish_tts_torch.models.discriminators import (
        SPEC_LAYERS, ContextFreeDiscriminator, SpecDiscriminator)

    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for r, res in enumerate(RESOLUTIONS):
        mrd = SpecDiscriminator().cuda()
        x = torch.rand((B, 1, res.fft // 2 + 1, SAMPLES // res.hop + 1), device="cuda",
                       generator=gen).contiguous(memory_format=fmt)
        for i, (_, stride, pad) in enumerate(SPEC_LAYERS):
            for name, s, p in ((f"conv_{i}", stride, pad), (f"out_{i}", (1, 1), (1, 1))):
                conv = getattr(mrd, name)
                w = conv.weight.detach().to(memory_format=fmt)
                got, y = _layer_rows(f"mrd.{res.fft}", name, name == "conv_0", x, w,
                                     conv.bias.detach(), s, p, 1)
                rows += got
                if name == f"conv_{i}":
                    x = F.leaky_relu(y, 0.1)  # the next conv's and the head's input
        del mrd
    disc = ContextFreeDiscriminator().cuda()
    shapes = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: shapes.update({n: a[0].shape}))
        for n, m in disc.named_modules() if isinstance(m, torch.nn.Conv1d)]
    with torch.no_grad():
        disc(torch.randn((B, SAMPLES), device="cuda", generator=gen) * 0.1)
    for h in hooks:
        h.remove()
    for n, m in disc.named_modules():
        if isinstance(m, torch.nn.Conv1d):
            x = torch.randn(shapes[n], device="cuda", generator=gen)
            got, _ = _layer_rows("disc", n, n == "conv0.conv", x, m.weight.detach(),
                                 None if m.bias is None else m.bias.detach(), m.stride,
                                 m.padding, m.groups)
            rows += got
    return rows


def _batch(frames: int, seed: int):
    import numpy as np
    import torch

    from stylish_tts_torch.trainer.steps import Batch, batch_to_device

    rng = np.random.default_rng(seed)
    n = 100
    t = np.arange(frames * 300) / 24000.0
    f0 = rng.uniform(90, 220, (B, 1))
    audio = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal((B, t.size))
    durs = np.full((B, n), frames // n)
    durs[:, : frames % n] += 1
    return batch_to_device(Batch(
        audio.astype(np.float32), rng.integers(1, 170, (B, n)).astype(np.int32),
        np.full(B, n, np.int32), np.repeat(f0, frames + 1, 1).astype(np.float32),
        durs.astype(np.int32)), "cuda")


def probe_step(layout: str, autotune: int, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType

    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import build_models
    from stylish_tts_torch.models.slm import WavLMEncoder, wavlm_loss
    from stylish_tts_torch.trainer import steps as steps_mod
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.state import create_stage_train_state

    if not autotune:  # every convolution on the heuristic's plans
        steps_mod._on_cudnn = lambda x: False
    mc = ModelConfig()
    torch.manual_seed(0)
    with torch.device("cuda"):
        models = build_models(mc)
        wavlm = WavLMEncoder()
    state = create_stage_train_state(models, "cuda", "acoustic", seed=0)
    state.wavlm = wavlm.eval().requires_grad_(False)
    ctx = steps_mod.StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                                slm_loss_fn=wavlm_loss, mixed_precision=True)
    step = steps_mod.make_acoustic_step(ctx)
    batches = [_batch(440, s) for s in range(2)]

    def run(n, start=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(state, batches[(start + i) % 2])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    draws = torch.Generator()
    draws.set_state(state.disc_index_generator.get_state())
    warm = 0  # until every MRD has run its D phase (the step's own draws), and 2 more
    seen = set()
    while seen != {0, 1, 2} and warm < 20:
        seen.add(int(torch.randint(3, (1,), generator=draws)))
        warm += 1
    warm_ms = [run(1, i) for i in range(warm + 2)]
    torch.cuda.reset_peak_memory_stats()
    step_ms = run(steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts0 = dict(steps_mod.AUTOTUNE)
    traced = 3
    kernels = defaultdict(float)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(traced)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels[e.name()] += e.duration_ns() / 1e6 / traced
    counts = {k: (v - counts0[k]) / traced for k, v in steps_mod.AUTOTUNE.items()}
    new_bin = _batch(360, 7)
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        step(state, new_bin)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"step_ms": step_ms, "warm_ms": warm_ms,
            "device_ms_step": sum(kernels.values()), "peak_gib": peak,
            "conv_autotune_per_step": counts,
            "new_bin_first_ms": times[0], "new_bin_second_ms": times[1],
            "benchmark_after": torch.backends.cudnn.benchmark,
            "kernels_ms_step": [[k, v] for k, v in top[:40]]}


def child(layout: str, autotune: int, limit: int, part: str, steps: int) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark_limit = limit
    if part == "layers":
        torch.backends.cudnn.benchmark = bool(autotune)
        out = {"rows": probe_layers(layout)}
    else:
        out = probe_step(layout, autotune, steps)
    return {"layout": layout, "autotune": autotune, "limit": limit, "part": part,
            "device": torch.cuda.get_device_name(0), **out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--settings", default=SETTINGS,
                    help="comma-separated LAYOUT:AUTOTUNE:LIMIT:PART (PART layers or step)")
    ap.add_argument("--child", nargs=4, metavar=("LAYOUT", "AUTOTUNE", "LIMIT", "PART"))
    a = ap.parse_args()
    if a.child:
        layout, autotune, limit, part = a.child
        print(json.dumps(child(layout, int(autotune), int(limit), part, a.steps)), flush=True)
        return
    os.makedirs(a.out, exist_ok=True)
    results = []
    for setting in a.settings.split(","):
        cmd = [sys.executable, __file__, "--steps", str(a.steps), "--child",
               *setting.split(":")]
        done = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if done.returncode:
            print(f"{setting} failed:\n{done.stderr[-3000:]}", file=sys.stderr)
            continue
        results.append(json.loads(done.stdout.strip().splitlines()[-1]))
        summary = {k: v for k, v in results[-1].items() if k not in ("rows", "kernels_ms_step")}
        print(json.dumps(summary), flush=True)
    with open(os.path.join(a.out, "disc_conv_probe.json"), "w", encoding="utf-8") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
