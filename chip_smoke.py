#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``stylish_tts_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card (written for an H100, kernels built for ``sm_90a``) and the
CUDA toolkit's ``nvcc``; it imports nothing of JAX or of the JAX package.

Phases (any failure exits non-zero):
1. print the card's name and power limit; build ``csrc/ctc.cu`` with nvcc;
2. drive the main path: the port's ``train-align`` entry
   (``Trainer.train("alignment")``) on ``cuda`` at full width (aligner
   640, 80 mels, 179 classes, ``probe_batch_max`` 128) over a synthetic
   ~5 s / 24 kHz dataset written with numpy, for 2 epochs; the kernel
   launch counts are zeroed just before and read just after, and must
   equal the step count; losses finite, priors updated, the aligner saved
   and reloaded. The main path's largest batch is rebuilt from the
   trainer's own batch plan (``alignment_batch_sizes.json``) and time
   bins; one alignment step on it is timed, then traced with
   ``torch.profiler`` (device time by kernel, written to
   ``chiprun_out/profile_align_step.json``);
3. hold both kernels against the plain PyTorch CTC on the card: the loss
   and the gradient w.r.t. the logits through log_softmax, with priors, at
   small ragged cases (label lengths 0, 1, U, repeats, input_len < T, final
   states across a warp boundary, a row that no alignment fits), at
   B=32/T=400/U=120, at U=512 (S=1025) and at the main path's shape; at
   the ragged cases also alpha and beta against the plain
   ``ctc_alphas_betas``, and a forward under ``torch.no_grad()`` that
   walks alpha alone and gives the same loss;
4. time kernels, plain version and ``F.ctc_loss`` (the library yardstick,
   never used by the port), each as the median of 25 runs after warm-up,
   at the main path's shape, at B=32/T=400/U=120 and at U=512; and the
   forward kernel on one sequence alone (B=1, same T and longest label),
   the T-step chain that every CTA walks; the per-frame time of the
   one-sequence runs, fitted over S;
5. print the ``kernels`` JSON line, then the device line last.

Tolerances: the kernels carry the trellis as float-float pairs and
normalise gamma per frame (see csrc/ctc.cu), so they are held against the
plain version evaluated in float64 on the same float32 inputs: loss rtol
1e-5, gradient atol 1e-5 (shared atomics change the order of the class
sums); alpha and beta rtol 1e-6, atol 1e-4 on the reachable live states.
The error against the plain float32 run is printed beside it; that
version carries its own float32 error (1.5e-4 in the gradient at T = 400).

Times are device times: each timed call is queued behind a sleep kernel
on the card, so that the host's launch work does not count.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# published H100 SXM rates (dense, outside the tensor cores, at 700 W)
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
# operations per live state-frame of the function: the forward LSE of
# three terms is 3 exp + 1 log + ~10 add/max; the gradient does the same
# for beta, then gamma's exp, two adds and the class-bin add. As the
# kernels do it, the forward walks both (28) and the gradient pass only
# forms gamma (adds alpha and beta, the frame's normaliser, gamma's exp,
# the class-bin add: 8)
OPS_PER_STATE_FRAME = {"alpha_beta": 14, "grad": 18}
DESIGN_OPS_PER_STATE_FRAME = {"alpha_beta": 28, "grad": 8}
TRELLIS_RTOL = 1e-6
TRELLIS_ATOL = 1e-4
PRIOR_SCALE = 0.3
N_TIMED = 25

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def require_card():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "stylish_tts_torch" / "csrc" / "ctc.cu").is_file():
        fail(f"run from a checkout of the repo: {ROOT} has no stylish_tts_torch")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return torch


# ---------------------------------------------------------------- phase 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_build():
    from stylish_tts_torch.ops import ctc_cuda

    t0 = time.time()
    ctc_cuda.build()
    log(f"built {ctc_cuda.SOURCE.name} in {time.time() - t0:.1f} s")
    for line in ctc_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("ptxas: " + line.strip())


# ---------------------------------------------------------------- phase 2


def write_dataset(root: Path, n_train: int, n_val: int, seed: int):
    """~5 s, 24 kHz harmonic-plus-noise clips in one duration bin, with
    random phoneme strings of 60-150 symbols from the config's table."""
    import numpy as np

    from stylish_tts_torch.config import SymbolConfig
    from stylish_tts_torch.data.wav import write_wav

    rng = np.random.default_rng(seed)
    sym = SymbolConfig()
    table = list(sym.letters) + list(sym.letters_ipa) + list(",.!? ")
    sr = 24000
    wav_dir = root / "wav-dir"
    wav_dir.mkdir(parents=True)
    for split, n in (("train", n_train), ("val", n_val)):
        lines = []
        for i in range(n):
            samples = int(rng.uniform(5.0, 5.2) * sr)
            t = np.arange(samples) / sr
            f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            audio = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.2
            audio = audio * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t) ** 2)
            audio = audio + 0.01 * rng.standard_normal(samples)
            name = f"{split}{i}.wav"
            write_wav(str(wav_dir / name), audio.astype(np.float32), sr)
            n_ph = int(rng.integers(60, 151))
            phonemes = "".join(rng.choice(table, size=n_ph))
            lines.append(f"{name}|{phonemes}|0|synthetic {i}")
        (root / f"{split}-list.txt").write_text("\n".join(lines) + "\n",
                                                encoding="utf-8")


def main_batch(trainer, out_dir: Path):
    """The main path's largest batch, from the trainer's own batch plan and
    time bins: the first B segments of the train bin with the largest
    planned batch, collated as the loader collates them."""
    from stylish_tts_torch.data.collate import collate_batch
    from stylish_tts_torch.data.sampler import BatchSizeTable
    from stylish_tts_torch.trainer.steps import batch_to_device

    table = BatchSizeTable(str(out_dir / "alignment" / "alignment_batch_sizes.json"))
    train_ds = trainer.build_dataset(trainer.config.dataset.train_data)
    bins, _ = train_ds.time_bins()
    time_bin = max(bins, key=lambda k: (table.get(k), k))
    idxs = sorted(bins[time_bin])[:table.get(time_bin)]
    items = [train_ds.load_segment(i) for i in idxs]
    batch, _ = collate_batch(items, hop_length=trainer.mc.hop_length,
                             require_pitch=False)
    return batch_to_device(batch, "cuda")


def phase_main_path(torch, work: Path):
    import numpy as np

    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import build_text_aligner
    from stylish_tts_torch.ops import ctc_cuda
    from stylish_tts_torch.trainer.loop import Trainer
    from stylish_tts_torch.utils.params_io import load_text_aligner_safetensors

    data = work / "data"
    t0 = time.time()
    write_dataset(data, n_train=160, n_val=16, seed=0)
    log(f"synthetic dataset written in {time.time() - t0:.1f} s")

    config = Config()
    config.dataset.path = str(data)
    config.training.log_interval = 1
    config.training_plan.alignment.epochs = 2
    mc = ModelConfig()  # full width: aligner 640, 80 mels, 178+1 classes
    if config.training_plan.alignment.probe_batch_max != 128:
        fail("default alignment probe_batch_max is not 128")

    for name in ctc_cuda.LAUNCHES:
        ctc_cuda.LAUNCHES[name] = 0
    t0 = time.time()
    trainer = Trainer(config, mc, str(work / "out"), device="cuda")
    state = trainer.train("alignment")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ctc_cuda.LAUNCHES)

    steps = state.step
    log(f"train-align: {steps} steps in {wall:.1f} s; launches {launches}")
    losses = trainer.losses
    if steps < 5:
        fail(f"main path ran {steps} steps (< 5)")
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"losses not all finite or missing: {losses}")
    if any(n != steps for n in launches.values()):
        fail(f"launch counts {launches} != step count {steps}")
    priors = state.log_priors.cpu().numpy()
    if not np.isfinite(priors).all() or not (priors != 0).any():
        fail("label priors were not updated")
    model_path = data / config.dataset.alignment_model_path
    if not model_path.is_file():
        fail(f"{model_path} was not written")

    # the saved aligner reloads and gives the trained one's posteriors,
    # finite and of shape (1, T, 179); on the CPU too
    reloaded = build_text_aligner(mc)
    load_text_aligner_safetensors(str(model_path), reloaded)
    reloaded.eval()
    state.aligner.eval()
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn((1, 200, mc.text_aligner.n_mels), generator=gen)
    lengths = torch.tensor([200], dtype=torch.int32)
    with torch.no_grad():
        on_card = state.aligner(mel.cuda(), lengths.cuda()).cpu()
        on_cpu = reloaded(mel, lengths)
    if tuple(on_card.shape) != (1, 200, mc.text_encoder.tokens + 1):
        fail(f"aligner output shape {tuple(on_card.shape)}")
    err = float((on_card - on_cpu).abs().max())
    if not torch.isfinite(on_card).all() or err > 1e-3:
        fail(f"reloaded aligner on CPU vs trained on card: max err {err}")
    log(f"losses first/last {losses[0]:.4f} / {losses[-1]:.4f}; "
        f"reloaded aligner CPU vs card max err {err:.2e}")
    batch = main_batch(trainer, work / "out")
    return trainer, state, batch, {
        "steps": steps, "wall_s": wall, "launches": launches, "losses": losses,
    }


# kernel-name patterns of the step's device-time breakdown, first match wins
KERNEL_GROUPS = (
    ("CTC kernels", ("ctc_alpha_beta", "ctc_grad")),
    ("fp32 GEMMs and convs", ("gemm", "cutlass", "conv", "implicit", "winograd",
                              "xmma", "cudnn", "fft")),
    ("GroupNorm", ("GroupNorm", "RowwiseMoments", "ComputeInternalGradients")),
    ("AdamW (foreach multi-tensor kernels)", ("multi_tensor_apply",)),
    ("copies and fills", ("Memcpy", "Memset")),
)


def kernel_group(name: str) -> str:
    for group, needles in KERNEL_GROUPS:
        if any(n in name for n in needles):
            return group
    return "elementwise and reductions"


def phase_step_time(torch, trainer, state, batch, n=10):
    """One whole alignment step (mel, aligner fwd+bwd, CTC kernels, AdamW
    with its finite check, prior accumulation) on the main path's largest
    batch and the trained state: its median time, then ``n`` steps under
    ``torch.profiler`` with the device time summed by kernel. Ranges that
    the profiler mirrors onto the device timeline (user annotations such
    as ``Optimizer.step#AdamW.step``) span kernels already counted and are
    left out of the sums. Returns the step's CTC shape (B, T, C, U) too."""
    from torch.autograd import DeviceType

    from stylish_tts_torch.trainer.steps import StepContext, make_alignment_step

    ctx = StepContext(trainer.mc, trainer.config.loss_weight.model_dump(),
                      trainer.normalization, stage_steps=1000, base_lr=1e-5)
    step = make_alignment_step(ctx)
    with torch.no_grad():
        frames = ctx.norm_mel(batch.audio_gt[:1], ctx.to_align_mel).shape[-1]
    shape = (batch.text.shape[0], frames, ctx.blank_id + 1, batch.text.shape[1])
    step_ms = median_ms(torch, lambda: step(state, batch), n=n, warmup=2,
                        sleep=False)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    cpu_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels, annotations = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        row = {"name": e.key, "calls": e.count / n, "ms_per_step": us / 1e3 / n}
        if getattr(e, "is_user_annotation", False) or e.key in cpu_keys:
            annotations.append(row)
        else:
            kernels.append(row)
    if not kernels:
        fail("the profiler trace of the alignment step holds no device time")
    kernels.sort(key=lambda k: -k["ms_per_step"])
    device_ms = sum(k["ms_per_step"] for k in kernels)
    groups = {}
    for k in kernels:
        g = groups.setdefault(kernel_group(k["name"]), {"ms_per_step": 0.0, "calls": 0.0})
        g["ms_per_step"] += k["ms_per_step"]
        g["calls"] += k["calls"]
    for g in groups.values():
        g["share_of_device"] = g["ms_per_step"] / device_ms
    profile = {
        "shape_B_T_C_U": list(shape), "steps": n, "step_ms_median": step_ms,
        "traced_wall_ms_per_step": traced_ms, "device_ms_per_step": device_ms,
        "busy_share": device_ms / traced_ms,
        "kernel_launches_per_step": sum(k["calls"] for k in kernels),
        "groups": groups, "kernels": kernels,
        "left_out_annotations": annotations,
    }
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_align_step.json").write_text(json.dumps(profile, indent=1))
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms_per_step"]):
        log(f"step device time: {g['ms_per_step']:.3f} ms x{g['calls']:.0f} {name}")
    log(f"step at {list(shape)}: {step_ms:.3f} ms (median of {n}); traced "
        f"{traced_ms:.3f} ms, device {device_ms:.3f} ms, busy share "
        f"{device_ms / traced_ms:.3f}; left out {len(annotations)} annotation ranges")
    return shape, step_ms, {k: v for k, v in profile.items() if k != "kernels"}


# ---------------------------------------------------------------- phase 3


def make_case(torch, b, t, c, u, label_lengths, input_lengths, seed,
              repeat_rows=()):
    """Random logits / labels / priors on the card; rows in ``repeat_rows``
    repeat one token (needs input_len >= 2L-1)."""
    gen = torch.Generator().manual_seed(seed)
    logits = (torch.randn((b, t, c), generator=gen) * 2.0).cuda()
    labels = torch.randint(0, c - 1, (b, u), generator=gen, dtype=torch.int32)
    for r in repeat_rows:
        labels[r] = 5
    label_lengths = torch.tensor(label_lengths, dtype=torch.int32)
    for i in range(b):
        labels[i, label_lengths[i]:] = 0
    priors = -2.0 - 6.0 * torch.rand((c,), generator=gen)
    weights = 0.5 + torch.rand((b,), generator=gen)
    return {
        "logits": logits, "labels": labels.cuda(),
        "label_lengths": label_lengths.cuda(),
        "input_lengths": torch.tensor(input_lengths, dtype=torch.int32).cuda(),
        "priors": priors.cuda(), "weights": weights.cuda(), "blank": c - 1,
    }


def run_kernel(torch, case):
    from stylish_tts_torch.ops.ctc_cuda import ctc_loss_with_priors_cuda

    z = case["logits"].clone().requires_grad_(True)
    loss = ctc_loss_with_priors_cuda(
        torch.log_softmax(z, -1), case["input_lengths"], case["labels"],
        case["label_lengths"], case["blank"], log_priors=case["priors"],
        prior_scale=PRIOR_SCALE, reduction="none",
    )
    (loss * case["weights"]).sum().backward()
    return loss.detach(), z.grad


def run_plain(torch, case, dtype):
    """The plain version on the same float32 inputs, evaluated in ``dtype``."""
    from stylish_tts_torch.ops.ctc import ctc_nll

    z = case["logits"].clone().requires_grad_(True)
    lp = torch.log_softmax(z, -1).to(dtype)
    lp = lp - PRIOR_SCALE * case["priors"].to(dtype)[None, None, :]
    loss = ctc_nll(lp, case["input_lengths"], case["labels"],
                   case["label_lengths"], case["blank"])
    (loss * case["weights"].to(dtype)).sum().backward()
    return loss.detach(), z.grad


def phase_check(torch, main_shape):
    b_m, t_m, c_m, u_m = main_shape
    gen = torch.Generator().manual_seed(7)
    main_ll = torch.randint(max(u_m - 30, 1), u_m + 1, (b_m,), generator=gen)
    cases = {
        # label lengths 15 and 16 put the final states across a warp
        # boundary; the last row, a repeated label in 8 frames (it needs 11),
        # is one that no alignment fits
        "ragged_small": dict(
            b=8, t=50, c=179, u=20, label_lengths=[0, 1, 20, 7, 12, 15, 16, 6],
            input_lengths=[50, 37, 50, 20, 45, 50, 50, 8], repeat_rows=(3, 7)),
        "b32_t400_u120": dict(
            b=32, t=400, c=179, u=120,
            label_lengths=torch.randint(90, 121, (32,), generator=gen).tolist(),
            input_lengths=torch.randint(300, 401, (32,), generator=gen).tolist()),
        "u512_s1025": dict(
            b=4, t=1100, c=179, u=512, label_lengths=[512, 400, 300, 511],
            input_lengths=[1100, 1000, 900, 1100]),
        "main_path": dict(
            b=b_m, t=t_m, c=c_m, u=u_m, label_lengths=main_ll.tolist(),
            input_lengths=[t_m] * b_m),
    }
    results = {}
    for i, (name, spec) in enumerate(cases.items()):
        case = make_case(torch, seed=100 + i, **spec)
        k_loss, k_grad = run_kernel(torch, case)
        d_loss, d_grad = run_plain(torch, case, torch.float64)
        f_loss, f_grad = run_plain(torch, case, torch.float32)
        torch.cuda.synchronize()
        loss_rel = float(((k_loss.double() - d_loss).abs()
                          / d_loss.abs().clamp_min(1e-30)).max())
        loss_abs = float((k_loss.double() - d_loss).abs().max())
        grad_err = float((k_grad.double() - d_grad).abs().max())
        grad_err32 = float((k_grad - f_grad).abs().max())
        plain32_err = float((f_grad.double() - d_grad).abs().max())
        finite = bool(torch.isfinite(k_loss).all() and torch.isfinite(k_grad).all())
        results[name] = {
            "shape": [spec["b"], spec["t"], spec["c"], spec["u"]],
            "loss_max_rel_err": loss_rel, "loss_max_abs_err": loss_abs,
            "grad_max_abs_err": grad_err,
            "grad_max_abs_err_vs_plain_fp32": grad_err32,
            "plain_fp32_grad_err_vs_fp64": plain32_err,
        }
        log(f"check {name} {spec['b']}x{spec['t']}x{spec['c']} U={spec['u']}: "
            f"loss rel {loss_rel:.2e}, grad {grad_err:.2e} "
            f"(vs plain fp32 {grad_err32:.2e}; plain fp32 vs fp64 {plain32_err:.2e})")
        if not finite or loss_rel > LOSS_RTOL or grad_err > GRAD_ATOL:
            fail(f"kernel disagrees with the plain version on {name}: "
                 f"loss rel {loss_rel:.3e} (rtol {LOSS_RTOL}), grad "
                 f"{grad_err:.3e} (atol {GRAD_ATOL})")
        if name == "ragged_small":
            results["trellis_" + name] = check_trellis(torch, case)
    return results


def case_log_probs(torch, case):
    lp = (torch.log_softmax(case["logits"], -1)
          - PRIOR_SCALE * case["priors"][None, None, :]).contiguous()
    args = (case["input_lengths"], case["labels"], case["label_lengths"],
            case["blank"])
    return lp, args


def check_trellis(torch, case):
    """alpha, beta and ll of the forward kernel against the plain
    ``ctc_alphas_betas`` in float64 on the live
    states (reachable ones within tolerance, unreachable ones below NEG/10
    on both sides); then a forward under ``torch.no_grad()``, which must
    launch the forward kernel once (alpha alone) and give the same loss as
    the forward that stores alpha and beta."""
    from stylish_tts_torch.ops import ctc as plain
    from stylish_tts_torch.ops import ctc_cuda

    lp, args = case_log_probs(torch, case)
    p_alpha, p_beta, p_ll = plain.ctc_alphas_betas(lp.double(), *args)
    alpha, beta, offsets, k_ll = ctc_cuda.ctc_alpha_beta(lp, *args)
    trellis = ctc_cuda.trellis(alpha, beta, offsets, args[0], args[2])
    out = {"ll_max_rel_err": float(((k_ll - p_ll).abs() / p_ll.abs()).max())}
    for name, ours, ref in zip(("alpha", "beta"), trellis, (p_alpha, p_beta)):
        live = ~torch.isnan(ours)
        reach = live & (ref > plain.NEG / 10)
        err = (ours - ref).abs()[reach]
        excess = float((err - TRELLIS_ATOL - TRELLIS_RTOL * ref.abs()[reach]).max())
        out[name + "_max_abs_err"] = float(err.max())
        if excess > 0 or not bool((ours[live & ~reach] <= plain.NEG / 10).all()):
            fail(f"{name} of the forward kernel disagrees with the plain trellis: "
                 f"max abs err {float(err.max()):.3e} (rtol {TRELLIS_RTOL}, "
                 f"atol {TRELLIS_ATOL})")
    if out["ll_max_rel_err"] > LOSS_RTOL:
        fail(f"ll of the forward kernel: rel err {out['ll_max_rel_err']:.3e}")
    log(f"check trellis: ll rel {out['ll_max_rel_err']:.2e}, alpha "
        f"{out['alpha_max_abs_err']:.2e}, beta {out['beta_max_abs_err']:.2e}")

    with_grad = ctc_cuda.ctc_nll_cuda(lp.clone().requires_grad_(True), *args)
    before = dict(ctc_cuda.LAUNCHES)
    with torch.no_grad():
        no_grad = ctc_cuda.ctc_nll_cuda(lp, *args)
    launched = {n: ctc_cuda.LAUNCHES[n] - before[n] for n in before}
    if launched != {"alpha_beta": 1, "grad": 0}:
        fail(f"the no-grad forward launched {launched}, not the forward kernel once")
    if not torch.equal(no_grad, with_grad.detach()):
        fail("the no-grad forward's loss differs from the forward that stores")
    out["no_grad_launches"] = launched
    log(f"check no-grad forward: launches {launched}, same loss")
    return out


# ---------------------------------------------------------------- phase 4

SLEEP_CYCLES = 2_000_000  # ~1 ms of the card's clock ahead of each timed call


def median_ms(torch, fn, n=N_TIMED, warmup=3, sleep=True):
    """Median time of ``fn`` between CUDA events. With ``sleep``, a sleep
    kernel queued ahead of the start event keeps the card busy while the
    host launches, so the time is the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bounds(b, t, c, u, label_lengths, input_lengths):
    """Least time of each kernel's function at this run's lengths: each
    input read once and each output written once at the function's
    float32 width, over the HBM rate, against the operations over the
    float32 rate; the larger binds. The function is the forward (ll, and
    alpha for the backward) and the backward (the gradient from alpha, ll
    and the log-probs): alpha, the one tensor that must pass from one to
    the other, counts at 4 B for each live state-frame (sequence b has
    2 L_b + 1 states for len_b frames), once each way. ``design_*`` prices
    the work as these kernels do it: both CTAs of a sequence read its live
    log_prob rows and the forward writes beta too, with a float64 offset
    per (b, direction, t); the gradient pass reads alpha, beta and ll but
    not the log-probs, and walks no recursion."""
    frames = [min(n, t) for n in input_lengths]
    state_frames = sum(f * (2 * lab + 1) for f, lab in zip(frames, label_lengths))
    lp = b * t * c * 4  # log_probs in, or the gradient out
    lp_live = sum(frames) * c * 4
    small = b * u * 4 + 2 * b * 4  # labels, input and label lengths
    alpha = state_frames * 4
    fn_bytes = {"alpha_beta": lp + small + alpha + b * 4,  # alpha and ll out
                "grad": lp + small + alpha + b * 4 + b * 4 + lp}  # g in, grad out
    design_bytes = {
        # both CTAs read the live rows; alpha, beta, the offsets and ll out
        "alpha_beta": 2 * lp_live + small + 2 * alpha + 2 * b * t * 8 + b * 8,
        "grad": small + 2 * alpha + b * 8 + b * 4 + lp}  # ll and g in
    out = {}
    for name, nbytes in fn_bytes.items():
        ops = OPS_PER_STATE_FRAME[name] * state_frames
        design_ops = DESIGN_OPS_PER_STATE_FRAME[name] * state_frames
        t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_OPS_PER_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "ops": ops, "design_bytes": design_bytes[name],
                     "design_bound_ms": max(design_bytes[name] / H100_HBM_BYTES_PER_S,
                                            design_ops / H100_FP32_OPS_PER_S) * 1e3}
    return out


def phase_time(torch, shape, seed, label_lengths=None, input_lengths=None):
    import torch.nn.functional as F

    from stylish_tts_torch.ops import ctc as plain
    from stylish_tts_torch.ops import ctc_cuda

    b, t, c, u = shape
    gen = torch.Generator().manual_seed(seed)
    if label_lengths is None:
        label_lengths = torch.randint(max(u - 30, 1), u + 1, (b,), generator=gen).tolist()
    if input_lengths is None:
        input_lengths = [t] * b
    case = make_case(torch, b, t, c, u, label_lengths, input_lengths, seed)
    lp, args = case_log_probs(torch, case)
    g = case["weights"]

    # the forward on the batch and on one sequence alone (the longest label
    # over all T frames)
    one = max(range(b), key=lambda i: label_lengths[i])
    one_args = (torch.full_like(args[0][:1], t), args[1][one:one + 1].contiguous(),
                args[2][one:one + 1].contiguous(), args[3])
    lp_one = lp[one:one + 1].contiguous()
    k_fwd = median_ms(torch, lambda: ctc_cuda.ctc_alpha_beta(lp, *args))
    one_fwd = median_ms(torch, lambda: ctc_cuda.ctc_alpha_beta(lp_one, *one_args))
    alpha_only = median_ms(
        torch, lambda: ctc_cuda.ctc_alpha_beta(lp, *args, store=False))
    alpha, beta, _, ll = ctc_cuda.ctc_alpha_beta(lp, *args)
    k_bwd = median_ms(torch, lambda: ctc_cuda.ctc_grad(alpha, beta, ll, *args, c, g))

    x = lp.clone().requires_grad_(True)
    p_fwd = median_ms(torch, lambda: plain.ctc_nll(x, *args), warmup=1)
    p_loss = plain.ctc_nll(x, *args)
    p_bwd = median_ms(
        torch, lambda: torch.autograd.grad(p_loss, x, g, retain_graph=True),
        warmup=1)

    # F.ctc_loss: (T, B, C) input, int64 targets, per-sequence sums
    xl = lp.detach().permute(1, 0, 2).contiguous().requires_grad_(True)
    tgt = case["labels"].long()
    il = case["input_lengths"].long()
    tl = case["label_lengths"].long()
    l_fwd = median_ms(torch, lambda: F.ctc_loss(
        xl, tgt, il, tl, blank=case["blank"], reduction="none"))
    l_loss = F.ctc_loss(xl, tgt, il, tl, blank=case["blank"], reduction="none")
    l_bwd = median_ms(
        torch, lambda: torch.autograd.grad(l_loss, xl, g, retain_graph=True))
    bd = bounds(b, t, c, u, label_lengths, input_lengths)
    return {
        "shape": [b, t, c, u],
        "alpha_beta": {"ms": k_fwd, "plain_ms": p_fwd, "library_ms": l_fwd,
                       "alpha_only_ms": alpha_only, "one_sequence_ms": one_fwd,
                       "one_sequence_states": 2 * label_lengths[one] + 1,
                       "one_sequence_us_per_frame": one_fwd * 1e3 / t,
                       **bd["alpha_beta"]},
        "grad": {"ms": k_bwd, "plain_ms": p_bwd, "library_ms": l_bwd, **bd["grad"]},
        "kernels_fwd_bwd_ms": k_fwd + k_bwd,
        "plain_fwd_bwd_ms": p_fwd + p_bwd,
        "library_fwd_bwd_ms": l_fwd + l_bwd,
    }


def frame_fit(timings):
    """Least-squares line through the one-sequence forward's time per
    frame against its live states: (fixed us per frame, ns per state)."""
    import numpy as np

    n = np.array([tm["alpha_beta"]["one_sequence_states"] for tm in timings.values()],
                 dtype=np.float64)
    us = np.array([tm["alpha_beta"]["one_sequence_us_per_frame"]
                   for tm in timings.values()])
    slope, fixed = np.polyfit(n, us, 1)
    return {"fixed_us_per_frame": float(fixed), "ns_per_state": float(slope) * 1e3,
            "points": [[float(a), float(b)] for a, b in zip(n, us)]}


# ---------------------------------------------------------------- main


def main() -> int:
    torch = require_card()
    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    phase_build()

    # fp32 everywhere, as the trainer sets it too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trainer, state, batch, main_run = phase_main_path(torch, Path(tmp))
    launches = main_run["launches"]
    main_shape, step_ms, profile = phase_step_time(torch, trainer, state, batch)

    checks = phase_check(torch, main_shape)
    timings = {
        "main_path": phase_time(torch, main_shape, 11,
                                label_lengths=batch.text_lengths.tolist()),
        "b32_t400_u120": phase_time(torch, (32, 400, 179, 120), 12),
        "u512_s1025": phase_time(torch, (4, 1100, 179, 512), 13,
                                 label_lengths=[512, 400, 300, 511],
                                 input_lengths=[1100, 1000, 900, 1100]),
    }
    for name, tm in timings.items():
        a, gr = tm["alpha_beta"], tm["grad"]
        log(f"time {name} {tm['shape']}: kernels {a['ms']:.4f} / {gr['ms']:.4f} ms "
            f"(alpha alone {a['alpha_only_ms']:.4f}; bound {a['bound_ms']:.4f} / "
            f"{gr['bound_ms']:.4f}, design {a['design_bound_ms']:.4f} / "
            f"{gr['design_bound_ms']:.4f}), plain {a['plain_ms']:.3f} / "
            f"{gr['plain_ms']:.3f} ms, F.ctc_loss {a['library_ms']:.4f} / "
            f"{gr['library_ms']:.4f} ms; forward on one sequence "
            f"{a['one_sequence_ms']:.4f} ms ({a['one_sequence_us_per_frame']:.4f} "
            f"us per frame at {a['one_sequence_states']} states)")
    fit = frame_fit(timings)
    log(f"one-sequence forward per frame: {fit['fixed_us_per_frame']:.4f} us fixed "
        f"+ {fit['ns_per_state']:.4f} ns per state (points {fit['points']})")

    src = "stylish_tts_torch/csrc/ctc.cu"
    tm = timings["main_path"]
    kernels = []
    for name, key, replaces, err in (
            ("ctc_alpha_beta_fwd", "alpha_beta",
             "stylish_tts_tpu/ops/ctc_pallas.py:207+237", "loss_max_abs_err"),
            ("ctc_grad_bwd", "grad", "stylish_tts_tpu/ops/ctc_pallas.py:295",
             "grad_max_abs_err")):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": checks["main_path"][err],
            "ms": tm[key]["ms"], "plain_ms": tm[key]["plain_ms"],
            "bound_ms": tm[key]["bound_ms"], "bound_by": tm[key]["bound_by"],
            "library_ms": tm[key]["library_ms"]})
    report = {"card": card, "main_path": {**main_run, "shape": main_shape},
              "step_ms": step_ms, "step_profile": profile, "checks": checks,
              "timings": timings, "frame_fit": fit, "kernels": kernels,
              "wall_s": time.time() - t_start}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"total {time.time() - t_start:.1f} s; details in {OUT / 'chip_smoke.json'}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
