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
5. synthesis at the full default ``ModelConfig()`` on ``cuda``: a package
   of seeded random weights (the six modules of ``build_models`` that a
   package holds) written by the port's ``export_checkpoint`` in
   the JAX layout (the F0 head's bias set to 150 Hz, so the sine source
   runs its harmonics), a static voicepack of seeded styles, eight phoneme
   lines, one per text bucket up to 512; ``speak`` through the port's CLI,
   the wav checked against the package's per-line synthesis (lengths total
   x hop, finite, in [-1, 1], -25 +- 0.5 LUFS per piece of 1 s or more);
   the same package on the CPU against the card on the 60-token line
   (durations 1e-4, same frame bucket; waveform within 1e-3 of the CPU
   waveform's peak, with one injected prior drawn on the CPU; the
   deterministic sine source at a tolerance that scales with its largest
   phase; the DC phase of a negative frame +pi on both); the duration and acoustic phases timed apart per text
   bucket, RTF at B=1, ``generate_speech_batch`` at B=8; one acoustic call
   at the longest line traced with ``torch.profiler`` (device time by
   kernel group, launches, busy share, ``chiprun_out/profile_speak.json``);
6. the data-preparation front end on a fresh copy of the phase-2 corpus,
   each command through the port's CLI on ``cuda``: ``pitch`` (YIN; one
   batch of 8 held against the port on the CPU, voicing >= 99 % and F0
   rel err <= 1e-3; every clip against its generating F0, median rel err
   <= 5 %); ``train-align`` for 3 epochs with validation every 2 train
   steps and a checkpoint every step (CTC launches: alpha_beta = steps +
   validation batches, grad = steps; validation finite, confidence in
   (0, 1]; checkpoints in the JAX naming, pruned to 4; the native loader
   served every train-split batch); ``train-align --checkpoint`` from the
   oldest kept checkpoint into a second directory (the same batch order,
   losses within 1e-4 relative, weights within 1e-4, priors 1e-4
   relative; save and load ms, bytes); ``align --method k2`` (an entry of
   its text's length for every segment, summing to the 440 frames;
   ``scores_*.txt``); the Viterbi on the card against the CPU from the
   same log-probs, bit-identical, both methods; its time and launches at
   B=8 and B=1; one align batch traced (``chiprun_out/profile_align.json``);
   ``align-textgrid`` (one interval per token, xmax = frames x hop); one
   acoustic-stage batch collated from the port-made caches with
   ``require_pitch=True``, its soft alignment covering every frame; the
   native loader against scipy on a batch of 69;
7. the three stages of ``train`` at the full default ``ModelConfig()`` on
   phase 6's corpus and caches: ``train --stage acoustic`` through the CLI
   (bf16, the slm term on with the seeded random WavLM; acoustic
   ``probe_batch_max`` 16, B = 8 by the batch plan at 440 frames, 1 epoch
   = 20 steps; then textual and duration, their plans written out in full,
   B = 17, 1 epoch = 9 steps each; validation every 4 steps with eval wavs,
   a checkpoint every 2 steps) with deterministic cuDNN, its CTC launch
   counts zeroed before and read after (0: no Pallas kernel backs these
   stages); each stage's steps, validations, pruned checkpoints and
   manifest; the frozen modules bitwise across both hand-offs. Against that
   run (the same batches, metrics within 1e-2 relative, each stage's
   trained modules within 0.05 of their move, L2): a resume from the
   oldest kept acoustic checkpoint that ends with acoustic (the later
   stages at 0 epochs); ``--stage textual`` from the acoustic stage's last
   checkpoint (the acoustic modules bitwise), on through duration; a resume
   from the oldest kept textual checkpoint that ends with textual. One fp32
   step of each stage with the parity switches on the card against the CPU
   from the same weights (B=2, 1 s; metrics 1e-3 relative, each trained
   module's weights within 0.1 of the step's move, L2; see
   ``CARD_CPU_*``). 20 bf16 steps of each stage on one fixed batch
   (acoustic and textual B = 16, duration B = 32; metrics finite, lr
   multipliers in [0.01, 4]; the acoustic mel, the textual pitch + energy
   and the duration class cross entropy falling by the margins of
   ``MEL_DROP`` / ``LATER_MOVES``), timed; one step of each traced (device
   time by group, launches, busy share, peak memory,
   ``chiprun_out/profile_{acoustic,textual,duration}_step.json``), WavLM's
   loss forward and backward and the textual step's frozen speech
   predictor forward and backward timed alone for their shares;
8. the export of the voice phase 7 trained, in phase 6's directory, so that
   the run goes through the whole recipe (``pitch`` -> ``train-align`` ->
   ``align`` -> ``train`` -> ``convert`` -> ``voicepack`` -> ``speak``):
   ``convert`` of the duration stage's last checkpoint (the six inference
   modules, every leaf the checkpoint's bitwise; finite pitch stats; the
   duration stats' keys); ``voicepack`` static and ``--dynamic`` on the
   train split (the styles of a batch of 8 on the card against the CPU,
   1e-4 of each style's largest magnitude; its time); ``speak`` from that
   package and voicepack on the synthesis phase's 8 lines (finite,
   non-silent; per line the two-phase path as long as the predicted
   durations times the hop and the fused path no longer, ``speak``'s wav
   the fused lines; RTF at B=1 on both paths);
   ``slm-cache`` over both splits with the seeded random WavLM (a batch of 8
   on the card against the CPU, 2e-3 of each state's largest magnitude,
   float16 storage on both; MB, seconds), then the acoustic stage alone for
   2 steps on a corpus of the first clips reading the cache (every step's
   slm term the cached form, finite), and the same with one fingerprint
   byte flipped raising before a step; ``pitch --method rmvpe`` with seeded
   weights in the reference layout into a cache of its own (a batch of 8
   on the card against the CPU: salience 1e-4 absolute, voicing >= 99 %,
   F0 1e-3 relative; its time beside YIN's);
9. the ringformer generator family (``generator.type: ringformer``) at the
   full default widths, in phase 6's directory: synthesis from seeded
   random weights (``speak`` through the CLI on the 8 lines, checked as in
   phase 5; the card against the CPU on the 60-token line: durations, the
   pcph prior with zero phase within 16 ulps of each harmonic's largest
   phase, the waveform with one injected prior drawn on the CPU within 1e-3
   of its peak; phase times, RTF at B = 1 and 8; the 510-token acoustic call
   traced, ``chiprun_out/profile_ringformer_speak.json``); ``train --stage
   acoustic`` through the CLI on phase 6's corpus (20 acoustic steps at B =
   8, then 9 textual and 9 duration steps; every acoustic step with finite
   ``mag`` and ``phase``, mel falling from the first to the last; CTC
   launches 0); 6 bf16 steps at B = 16 timed and one traced
   (``chiprun_out/profile_ringformer_step.json``, peak memory); one fp32
   step with the parity switches card against CPU (as in phase 7);
   ``convert`` of the duration stage's last checkpoint (every leaf bitwise),
   ``voicepack`` and ``speak`` of the 8 lines from it (as in phase 8);
10. the audiobook path, in phase 6's directory with phase 8's voice: a
   seeded narration (36 segments of 7-9 s of harmonic "speech", 0.6 s
   pauses) and a book (one chapter, one sentence of 260-380 phonemes per
   segment) through ``dataset-from-audiobook`` (one segment per sentence,
   every phoneme string tokenized in full, at most 510 symbols; seconds per
   minute of narration; which g2p backend ran), then ``pitch``,
   ``train-align`` (2 epochs, validation, checkpoints; its CTC counts zeroed
   just before and read just after: alpha_beta = steps + validation batches,
   grad = steps) and ``align`` (every segment's durations summing to its
   bin's frames) through the CLI on ``cuda``; both kernels held against the
   plain version (phase 3's tolerances) at the corpus's largest batch;
   ``prepare-book --phonemize`` and ``speak`` of the book (as phase 5
   checks; the longest line's tokens, RTF). ``generator.remat``: in one
   child process per setting, the acoustic step at full width (bf16, slm
   on, 440 frames) at B = 8, 16, 24 until the first OOM (peak
   memory of each; at B = 16 the step's ms, device ms and launches); one
   fp32 step with remat on, card against CPU (as phase 7). The OOM
   shrink-and-skip: ``train --stage acoustic`` through the CLI in a child
   process under a memory cap halfway between the B = 8 and B = 16 peaks,
   its plan at B = 16 (at least one OOM, each lowering the bin by the 0.9
   rule, the saved table at the lowered size, finite metrics, the peak
   under the cap, only the steps that ran counted);
11. ``import-torch`` on the port, in phase 6's directory: a seeded
   checkpoint in the reference's accelerate layout at the full default
   ``ModelConfig()`` (13 ``.bin`` files, ~250 MB; weight norm on the
   generator blocks' convs, spectral norm on the style encoders' convs,
   BatchNorm running statistics at the conformer, the waveform
   discriminator and the aligner; the F0 head's bias at 150 Hz) imported
   through the CLI (a ``duration`` checkpoint with ``imported_weights`` and
   the affine norm, the aligner beside it; every leaf bitwise the tree of
   ``import_torch_checkpoint``; seconds, MB); ``convert`` (every leaf
   bitwise), ``voicepack`` static on the train split (styles card vs CPU,
   1e-4 of each style's largest magnitude: the encoders without spectral
   norm) and ``speak`` of the synthesis phase's 8 lines from it (as phase 8
   checks them: finite, non-silent, both paths, RTF at B = 1); the card
   against the CPU on the 60-token line as in phase 5; the 510-token
   acoustic call traced (``chiprun_out/profile_imported_speak.json``); the
   CTC counts zeroed before and 0 after;
12. data parallel (``stylish_tts_torch/parallel``), in phase 6's
   directory: (a) world size 1 through NCCL (a file store, rank 0 of 1) at
   the full ``ModelConfig()``: 6 alignment steps on the main path's batch (B
   = 69) and 3 bf16 acoustic steps at B = 16 (slm on), losses, priors and
   weights bitwise against the same steps without a process group
   (deterministic cuDNN; a second run without one says whether the card
   repeats itself), step times with and without the group, and the
   collectives' cost (an NCCL all-reduce of each step's gradients, a host
   flag); (b) two gloo ranks on the one card in two child processes
   (``--dp-rank``; NCCL refuses two ranks on one device) against one
   process on the same rows: one alignment step on 68 rows (34 a rank: the
   CTC kernels launch in both, and each rank holds them against the plain
   version at its shard's shape; dropout off), metrics 1e-6 relative,
   priors 1e-5, the averaged gradient 1e-3 of its norm and the weights 1e-3
   of the step's move (L2); one fp32 acoustic step on 8 (4 a rank; the
   parity switches, an injected excitation, MRD 1, PyTorch's own
   convolutions), metrics 1e-6, the TPRLS medians' values 1e-5, each
   module's averaged gradient 1e-3 with the medians' gradient stopped on
   both sides, the weights 0.1 of the move (AdamW's first step; see
   ``dp_two_ranks``); (c) the bounds-checked CTC build (``ctc_checked``) in
   a child (``--ctc-checked``): no assert; (d) ``train --stage acoustic
   --profile`` through the CLI for 2 steps, its Chrome trace parsed and its
   CUDA kernel events counted; (e) the analytic FLOPs of the B = 16
   acoustic step (``utils/flops.py``; the sampled MRD as the mean of the
   three), its achieved TFLOP/s and MFU against the dense bf16 peak;
13. the synthesis programs per bucket (``export/programs.py``: CUDA
   graphs), in phase 6's directory, on phase 8's voice and on phase 9's
   ringformer package, each: (a) ``warmup`` (its count against
   ``warmup_grid`` + ``fused_grid`` at the package's duration stats, wall
   seconds, the graph pool's MB beside the source draws'); (b) the 8
   synthesis lines, shortest first (``warmup`` captures the largest
   first), through the
   fused and the two-phase programs against the eager phase functions with
   their per-row generators (bitwise expected, held within 1e-5 of the
   eager peak); (c) per line the ms with programs and eager; (d) the
   510-token call traced through its program and eagerly (device ms,
   device operations, host launches, busy share;
   ``chiprun_out/profile_speak_programs.json``, ``..._ringformer.json``)
   and one graph replay timed alone; (e) RTF at B = 1 and at B = 8 (the
   batch's programs against the eager batch); (f) a miss at a fused bucket
   outside the grid (speed 0.5): its ms, the next call's and the eager
   call's; (g) on the FreeGAN voice, the acoustic phase at (32, 100) as a
   ``torch.export`` program through ``convert --exported-program``, loaded
   and run on the card against the eager phase (1e-5 of its peak; the
   ringformer's is held on the CPU, tests/test_torch_programs.py); then (h) in a
   child (``--capture-fails``), a program whose function reads a value back
   must raise at capture;
14. the 2-D and hybrid meshes (``parallel/sharding_rules.py``), in phase 6's
   directory, on phase 2's batch: (a) a 1 x 1 mesh through NCCL, 2
   alignment steps and one fp32 acoustic step bitwise against no group;
   (b) the alignment stage at full width (4 steps on 68 rows, the prior
   update halfway, dropout off, deterministic cuDNN) on a 2 x 2 and a
   (2, 1, 2) mesh of 4 gloo ranks each on the one card (children
   ``--mesh-rank``; NCCL refuses two ranks on one device) against one
   process: losses 1e-5 relative, the updated priors 1e-5 (the
   accumulators 1e-5 relative), the first step's gradient 1e-3 of its norm,
   the weights 1e-2 of the move after the first and the fourth step (see
   ``MESH_ALIGN_WEIGHT_RTOL``), every rank's weights alike, 4 + 4 CTC
   launches on every rank and both kernels held against the plain version
   at each rank's shard; (c), (d) one fp32 acoustic, textual and duration
   step at full width (B = 2, 1 s, the parity switches, MRD 1, PyTorch's
   own convolutions, the TPRLS medians' gradient stopped) on a 1 x 2 mesh
   of 2 gloo ranks against one process: metrics 1e-4, each trained
   module's weights 0.1 of the move; (e) collectives per step by axis,
   bytes of parameters + moments per rank against the full state, step ms
   (the ranks share one card: not a scaling figure), and the sharded
   parameter and FLOP shares of the state and the audit views;
15. print the synthesis, front-end, acoustic, later-stage, recipe,
   ringformer, audiobook, imported, data-parallel, programs and mesh
   summary lines (a line saying that no multi-GPU scaling number exists
   before the data-parallel one, and one saying the same before the mesh
   one), the ``kernels`` JSON line (``launches``: the audiobook
   ``train-align``'s; ``launches_by_path``: that, the front end's, phase
   2's, the imported voice's, the data-parallel phase's and the meshes'),
   then the device line last.

Tolerances: the kernels carry the trellis as float-float pairs and
normalise gamma per frame (see csrc/ctc.cu), so they are held against the
plain version evaluated in float64 on the same float32 inputs: loss rtol
1e-5, gradient atol 1e-5 (shared atomics change the order of the class
sums); alpha and beta rtol 1e-6, atol 1e-4 on the reachable live states.
The error against the plain float32 run is printed beside it; that
version carries its own float32 error (1.5e-4 in the gradient at T = 400).

Kernel times are device times: each timed call is queued behind a sleep
kernel on the card, so that the host's launch work does not count. The
synthesis phases are timed without it (CUDA events around the call, host
launches included), since they are host-bound.
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
    random phoneme strings of 60-150 symbols from the config's table.
    Returns {wav name: (base F0 Hz, samples)}: clip i's F0 at t seconds is
    base * (1 + 0.1 sin(2 pi 0.7 t))."""
    import numpy as np

    from stylish_tts_torch.config import SymbolConfig
    from stylish_tts_torch.data.wav import write_wav

    rng = np.random.default_rng(seed)
    sym = SymbolConfig()
    table = list(sym.letters) + list(sym.letters_ipa) + list(",.!? ")
    sr = 24000
    wav_dir = root / "wav-dir"
    wav_dir.mkdir(parents=True)
    truth = {}
    for split, n in (("train", n_train), ("val", n_val)):
        lines = []
        for i in range(n):
            samples = int(rng.uniform(5.0, 5.2) * sr)
            t = np.arange(samples) / sr
            base = rng.uniform(90, 220)
            truth[f"{split}{i}.wav"] = (base, samples)
            f0 = base * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
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
    return truth


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
    trainer = Trainer(config, mc, str(work / "out"), device="cuda", record_steps=True)
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
        results[name], case = check_case(torch, name, spec, seed=100 + i)
        if name == "ragged_small":
            results["trellis_" + name] = check_trellis(torch, case)
    return results


def check_case(torch, name, spec, seed):
    """Both kernels against the plain version in float64 on one random case
    of ``spec`` (``make_case``'s arguments): the loss and the gradient."""
    case = make_case(torch, seed=seed, **spec)
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
    result = {
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
    return result, case


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


# the U = 512 case of scripts/ctc_u512_repeat.py, repeated through the
# bounds-checked build
U512_SPEC = dict(b=4, t=1100, c=179, u=512, label_lengths=[512, 400, 300, 511],
                 input_lengths=[1100, 1000, 900, 1100])
U512_SEEDS = (102, 103, 104)
U512_REPEATS = 20


def ctc_checked(torch, main_shape) -> dict:
    """Both kernels of the bounds-checked build (``ctc_cuda.bounds_checked``:
    a device assert on every shared-memory and global index): the U = 512
    case ``U512_REPEATS`` times on each of ``U512_SEEDS``, synchronised after
    each, then ``phase_check``'s cases (the ragged ones, B=32/T=400/U=120,
    U = 512, the main path's shape) against the plain version. A failed
    assert ends this process's CUDA context: run it in a process of its own
    (``child``)."""
    from stylish_tts_torch.ops import ctc_cuda

    t0 = time.time()
    with ctc_cuda.bounds_checked():
        build_s = time.time() - t0
        t0 = time.time()
        for _ in range(U512_REPEATS):
            for seed in U512_SEEDS:
                run_kernel(torch, make_case(torch, seed=seed, **U512_SPEC))
                torch.cuda.synchronize()
        repeat_s = time.time() - t0
        checks = phase_check(torch, main_shape)
        torch.cuda.synchronize()
    log(f"bounds-checked CTC build: built in {build_s:.1f} s; U = 512 x "
        f"{U512_REPEATS * len(U512_SEEDS)} in {repeat_s:.1f} s and the checks' cases, "
        f"no assert")
    return {"build_s": build_s, "u512_runs": U512_REPEATS * len(U512_SEEDS),
            "u512_s": repeat_s, "checks": checks, "launches": dict(ctc_cuda.LAUNCHES)}


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


# ---------------------------------------------------------------- phase 5

# token counts of the speak lines (the two pad symbols included): one in
# each text bucket up to 512
SPEAK_TOKENS = (30, 60, 90, 120, 180, 250, 380, 510)
BATCH_TOKENS = (96, 100, 104, 108, 112, 116, 120, 124)  # B=8, text bucket 128
SHORT_LINE = 1  # the 60-token line: the card against the CPU
F0_BIAS_HZ = 150.0
# the waveform on the card against the CPU, relative to the CPU waveform's
# peak (random weights, no loudness normalisation on this path: the scale
# is the run's own); 1e-3 of the peak is 60 dB below it
WAVE_RTOL = 1e-3
DURATION_ATOL = 1e-4
LUFS_TARGET, LUFS_TOL, LUFS_MIN_SECONDS = -25.0, 0.5, 1.0
N_PHASE_TIMED = 5

# kernel groups of the acoustic call's device time; kernels launched under
# the DSP ranges (patched in for the trace) count as DFT/iSTFT first
SPEAK_GROUPS = (
    ("copies and fills", ("Memcpy", "Memset", "CatArrayBatchedCopy", "copy_kernel")),
    ("convs", ("conv", "implicit", "winograd", "fprop", "dgrad", "Conv")),
    ("GEMMs", ("gemm", "Gemm", "cutlass", "xmma", "splitK", "cublas")),
)


def speak_group(name: str, scope: str | None) -> str:
    if scope == "dsp":
        return "DFT/iSTFT (framed-DFT matmuls, overlap-add, atan2/magnitude)"
    if scope == "resblocks":
        return "AdaIN/snake resblocks (all their kernels)"
    for group, needles in SPEAK_GROUPS:
        if any(n in name for n in needles):
            return group
    return "elementwise and norms"


def speak_lines(seed: int, counts):
    """Phoneme strings of ``count - 2`` symbols (the tokenizer adds two pads)."""
    import numpy as np

    from stylish_tts_torch.config import SymbolConfig

    rng = np.random.default_rng(seed)
    letters = list(SymbolConfig().letters_ipa)
    table = letters + [" "] * 8
    lines = []
    for n in counts:
        chars = rng.choice(table, size=n - 2)
        chars[0], chars[-1] = rng.choice(letters, size=2)  # speak strips each line
        lines.append("".join(chars))
    return lines


def write_speak_inputs(torch, root: Path, mc):
    """A full-width package of seeded random weights (model config ``mc``),
    written by the port's export in the JAX layout; a static voicepack of
    seeded style vectors; the lines."""
    import numpy as np

    from stylish_tts_torch.export.package import export_checkpoint
    from stylish_tts_torch.models import INFERENCE_MODELS, build_models
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.tts.voicepack import build_static_pack, save_static_voicepack

    torch.manual_seed(0)
    models = build_models(mc)
    with torch.no_grad():
        # a voice's F0 (~150 Hz) out of the random pitch head, so that the
        # harmonic source runs its harmonics, as it does for a trained voice
        models["pitch_energy_predictor"].f0_proj.bias.fill_(F0_BIAS_HZ)
    n_params = {k: sum(p.numel() for p in models[k].parameters()) for k in INFERENCE_MODELS}
    export_checkpoint(models, mc, NormalizationStats(), str(root / "pkg"))
    rng = np.random.default_rng(1)
    styles = {k: (0.5 * rng.standard_normal((400, mc.style_dim))).astype(np.float32)
              for k in ("speech", "pe", "duration")}
    styles["lengths"] = rng.integers(5, 512, 400).astype(np.int32)
    save_static_voicepack(str(root / "voicepack.safetensors"), build_static_pack(styles))
    lines = speak_lines(2, SPEAK_TOKENS)
    (root / "lines.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return lines, n_params


def phase_speak(torch, root: Path, mc):
    """``speak`` through the port's CLI on ``cuda`` from a package of model
    config ``mc``; then the wav against the package's own per-line
    synthesis: same lengths (total x hop), in [-1, 1], finite, each piece at
    -25 LUFS."""
    import numpy as np

    from stylish_tts_torch.cli import tts_cli
    from stylish_tts_torch.data.wav import read_wav
    from stylish_tts_torch.export.package import InferencePackage
    from stylish_tts_torch.tts.loudness import integrated_loudness
    from stylish_tts_torch.tts.voicepack import load_voicepack, lookup_static_style

    lines, n_params = write_speak_inputs(torch, root, mc)
    wav_path = root / "speech.wav"
    t0 = time.time()
    tts_cli.main(["speak", "--model", str(root / "pkg"),
                  "--voicepack", str(root / "voicepack.safetensors"),
                  "--text", str(root / "lines.txt"), "--out", str(wav_path),
                  "--device", "cuda"], standalone_mode=False)
    torch.cuda.synchronize()
    speak_s = time.time() - t0
    pkg = InferencePackage(str(root / "pkg"), device="cuda")
    mc = pkg.mc
    wav = read_wav(str(wav_path), mc.sample_rate)
    if not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        fail("speak wrote a wav that is not finite or leaves [-1, 1]")
    pack = load_voicepack(str(root / "voicepack.safetensors"))
    pieces, start = [], 0
    for line in lines:
        tokens = pkg.tokenize(line)
        audio = pkg.generate_speech(tokens, *lookup_static_style(pack, tokens.shape[0]))
        texts, lengths, (_, _, dur_style) = line_inputs(torch, pkg, pack, line, "cuda")
        total = int(round(float(pkg.durations(texts, lengths, dur_style).cpu().numpy().sum())))
        if audio.shape[0] != total * mc.hop_length:
            fail(f"a {tokens.shape[0]}-token line gave {audio.shape[0]} samples, "
                 f"not total {total} x hop {mc.hop_length}")
        piece = wav[start:start + audio.shape[0]]
        start += audio.shape[0]
        seconds = audio.shape[0] / mc.sample_rate
        lufs = integrated_loudness(piece, mc.sample_rate)
        clipped = float(np.mean(np.abs(piece) >= 32767 / 32768))
        pieces.append({"tokens": int(tokens.shape[0]), "frames": total,
                       "seconds": seconds, "lufs": lufs, "clipped_share": clipped})
        if seconds >= LUFS_MIN_SECONDS and abs(lufs - LUFS_TARGET) > LUFS_TOL:
            fail(f"a {seconds:.2f} s piece is at {lufs:.2f} LUFS, not "
                 f"{LUFS_TARGET} +- {LUFS_TOL}")
    if start != wav.shape[0]:
        fail(f"speak wrote {wav.shape[0]} samples; the lines add up to {start}")
    log(f"speak: {len(lines)} lines, {wav.shape[0] / mc.sample_rate:.2f} s of audio in "
        f"{speak_s:.2f} s (first call, includes loading); LUFS "
        f"{[round(p['lufs'], 2) for p in pieces]}")
    return pkg, pack, lines, {"wall_s": speak_s, "audio_s": wav.shape[0] / mc.sample_rate,
                              "pieces": pieces, "params": n_params}


def line_inputs(torch, pkg, pack, line, device):
    """(texts, lengths, speech, pe, duration styles) of one line on ``device``."""
    from stylish_tts_torch.tts.voicepack import lookup_static_style

    tokens = pkg.tokenize(line)
    texts, lengths = pkg._texts([tokens])
    styles = [torch.as_tensor(s, device=device)[None]
              for s in lookup_static_style(pack, tokens.shape[0])]
    return texts.to(device), lengths.to(device), styles


def phase_card_vs_cpu(torch, pkg, pack, root: Path, line: str):
    """The same package on the CPU and on the card, one short line: the
    durations; the waveform with one injected prior (the random source,
    drawn once on the CPU; broadband, so the head STFT's phases are well
    conditioned); the deterministic sine source, at a tolerance that scales
    with its largest phase; the DC phase of a negative frame."""
    import math

    import numpy as np

    from stylish_tts_torch.dsp import stft as stft_lib
    from stylish_tts_torch.export.package import InferencePackage, frame_bucket

    cpu = InferencePackage(str(root / "pkg"), device="cpu")
    c_texts, c_lengths, (c_sp, c_pe, c_du) = line_inputs(torch, cpu, pack, line, "cpu")
    with torch.no_grad():
        d_cpu = cpu.durations(c_texts, c_lengths, c_du)
        d_gpu = pkg.durations(c_texts.cuda(), c_lengths.cuda(), c_du.cuda()).cpu()
        dur_err = float((d_cpu - d_gpu).abs().max())
        t_cpu = int(round(float(d_cpu.numpy().sum())))
        t_gpu = int(round(float(d_gpu.numpy().sum())))
        if dur_err > DURATION_ATOL or frame_bucket(t_cpu) != frame_bucket(t_gpu):
            fail(f"durations on the card vs the CPU: max err {dur_err:.3e}, frame "
                 f"buckets {frame_bucket(t_gpu)} / {frame_bucket(t_cpu)}")
        frames = frame_bucket(t_cpu)
        alignment = cpu.duration_processor.duration_to_alignment(d_cpu, frames)
        pitch, _ = cpu.models["pitch_energy_predictor"](c_texts, c_lengths, alignment, c_pe)
        voiced = (pitch > 20.0).to(torch.float32)
        basegen = cpu.models["speech_predictor"].generator.basegen
        prior = basegen.source(pitch * voiced, cpu._source_generators(1))
        w_cpu = cpu.acoustic(c_texts, c_lengths, d_cpu, c_pe, c_sp, frames, prior=prior)
        w_gpu = pkg.acoustic(c_texts.cuda(), c_lengths.cuda(), d_cpu.cuda(), c_pe.cuda(),
                             c_sp.cuda(), frames, prior=prior.cuda()).cpu()
        wave_err = float((w_cpu - w_gpu).abs().max())
        wave_peak = float(w_cpu.abs().max())
        wave_rms = float(w_cpu.square().mean().sqrt())
        wave_tol = WAVE_RTOL * wave_peak
        near_threshold = int(((pitch - 20.0).abs() < 1e-2).sum())

        f0 = pitch * voiced
        s_cpu = basegen.source(f0, None, deterministic=True)
        gpu_source = pkg.models["speech_predictor"].generator.basegen.source
        s_gpu = gpu_source(f0.cuda(), None, deterministic=True).cpu()
        harmonics = torch.arange(1, basegen.source.n_harm + 1, dtype=torch.float64)
        rad = torch.remainder(f0.double()[:, None, :] * harmonics[None, :, None]
                              / pkg.mc.sample_rate, 1.0)
        max_phase = float((torch.cumsum(rad, -1) * 2 * math.pi * pkg.mc.hop_length).max())
        weights = float(basegen.source.merge.weight.abs().sum())
        source_tol = 0.1 * weights * 16 * max_phase * 2.0 ** -23
        source_err = float((s_cpu - s_gpu).abs().max())

        neg = -0.5 - torch.rand((1, 4000), generator=torch.Generator().manual_seed(3))
        dc = {}
        for dev in ("cpu", "cuda"):
            mag, hx, hy = stft_lib.stft_magnitude_unit_phase(neg.to(dev), 64, 4, 64)
            dc[dev] = torch.atan2(hy * mag, hx * mag)[:, 0].cpu()
    if not wave_err <= wave_tol:
        fail(f"waveform on the card vs the CPU (same prior): max err {wave_err:.3e}, "
             f"tolerance {wave_tol:.3e} ({WAVE_RTOL} x peak {wave_peak:.4g}; RMS "
             f"{wave_rms:.4g}; {near_threshold} frames within 1e-2 of the voiced "
             f"threshold)")
    if source_err > source_tol:
        fail(f"sine source on the card vs the CPU: max err {source_err:.3e}, tolerance "
             f"{source_tol:.3e} (max phase {max_phase:.4g} rad)")
    if not (torch.equal(dc["cpu"], dc["cuda"])
            and bool((dc["cuda"] == torch.tensor(math.pi, dtype=torch.float32)).all())):
        fail("the DC phase of a negative frame is not +pi on both devices")
    out = {"tokens": int(c_lengths[0]), "frames": frames,
           "duration_max_abs_err": dur_err, "wave_max_abs_err": wave_err,
           "wave_tol": wave_tol, "wave_rtol_of_peak": WAVE_RTOL, "wave_peak": wave_peak,
           "wave_rms": wave_rms, "frames_near_voiced_threshold": near_threshold,
           "source_max_abs_err": source_err, "source_tol": source_tol,
           "source_max_phase_rad": max_phase, "dc_phase_plus_pi": True}
    log(f"card vs CPU, {out['tokens']} tokens, {frames} frames: durations {dur_err:.2e}, "
        f"wave {wave_err:.2e} (tol {wave_tol:.2e} = {WAVE_RTOL} x peak {wave_peak:.4g}; "
        f"RMS {wave_rms:.4g}), source {source_err:.2e} (tol "
        f"{source_tol:.2e} at max phase {max_phase:.4g} rad), DC phase +pi on both")
    return out


def phase_speak_times(torch, pkg, pack, lines):
    """Per text bucket: the duration phase and the acoustic phase apart
    (CUDA events around each call, host launches included; median of
    N_PHASE_TIMED after one warm-up); RTF at B=1 (host clock, synchronised,
    generate_speech end to end over every line); generate_speech_batch at
    B=8 (text bucket 128)."""
    import numpy as np

    from stylish_tts_torch.export.package import frame_bucket
    from stylish_tts_torch.tts.voicepack import lookup_static_style

    hop = pkg.mc.hop_length
    sr = pkg.mc.sample_rate
    per_bucket = []
    for line in lines:
        texts, lengths, (sp, pe, du) = line_inputs(torch, pkg, pack, line, "cuda")
        durations = pkg.durations(texts, lengths, du)
        frames = frame_bucket(int(round(float(durations.sum()))))
        dur_ms = median_ms(torch, lambda: pkg.durations(texts, lengths, du),
                           n=N_PHASE_TIMED, warmup=1, sleep=False)
        ac_ms = median_ms(torch, lambda: pkg.acoustic(texts, lengths, durations, pe, sp,
                                                      frames),
                          n=N_PHASE_TIMED, warmup=1, sleep=False)
        per_bucket.append({"tokens": int(lengths[0]), "text_bucket": int(texts.shape[1]),
                           "frame_bucket": frames, "duration_ms": dur_ms,
                           "acoustic_ms": ac_ms})
        log(f"phases at L={texts.shape[1]} F={frames}: duration {dur_ms:.2f} ms, "
            f"acoustic {ac_ms:.2f} ms")

    wall, audio_s = 0.0, 0.0
    for line in lines:
        tokens = pkg.tokenize(line)
        styles = lookup_static_style(pack, tokens.shape[0])
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = pkg.generate_speech(tokens, *styles)
            times.append(time.perf_counter() - t0)
        wall += statistics.median(times)
        audio_s += audio.shape[0] / sr

    batch_lines = speak_lines(4, BATCH_TOKENS)
    tokens = [pkg.tokenize(line) for line in batch_lines]
    styles = [np.stack(s) for s in zip(*(lookup_static_style(pack, t.shape[0])
                                         for t in tokens))]
    pkg.generate_speech_batch(tokens, *styles)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = pkg.generate_speech_batch(tokens, *styles)
        times.append(time.perf_counter() - t0)
    batch_s = statistics.median(times)
    batch_audio = sum(w.shape[0] for w in wavs) / sr
    if not all(np.isfinite(w).all() for w in wavs):
        fail("generate_speech_batch gave non-finite audio")
    out = {"per_bucket": per_bucket, "rtf_b1": wall / audio_s, "b1_wall_s": wall,
           "b1_audio_s": audio_s, "batch8_wall_s": batch_s, "batch8_audio_s": batch_audio,
           "batch8_rtf": batch_s / batch_audio, "hop": hop}
    log(f"RTF at B=1 over {len(lines)} lines: {out['rtf_b1']:.5f} ({wall:.3f} s for "
        f"{audio_s:.2f} s of audio); batch B=8: {batch_s:.3f} s for {batch_audio:.2f} s "
        f"(RTF {out['batch8_rtf']:.5f})")
    return out


def phase_speak_profile(torch, pkg, pack, line):
    """One acoustic call at the longest line under ``torch.profiler``:
    device ms by kernel group, launches, busy share (device ms over the
    call's untraced time; the profiler slows the host). The port's DSP entry
    points are wrapped in profiler ranges for the trace only, so that the
    framed-DFT matmuls count as DFT/iSTFT and not as GEMMs; so are the
    AdaIN/snake resblocks (``AdaptiveGeneratorBlock``), a group of their own."""
    from torch.autograd import DeviceType

    from stylish_tts_torch.dsp import stft as stft_lib
    from stylish_tts_torch.export.package import frame_bucket
    from stylish_tts_torch.models.common import AdaptiveGeneratorBlock

    texts, lengths, (sp, pe, du) = line_inputs(torch, pkg, pack, line, "cuda")
    durations = pkg.durations(texts, lengths, du)
    frames = frame_bucket(int(round(float(durations.sum()))))
    call = lambda: pkg.acoustic(texts, lengths, durations, pe, sp, frames)  # noqa: E731
    call_ms = median_ms(torch, call, n=N_PHASE_TIMED, warmup=1, sleep=False)

    originals = [(stft_lib, name, "dsp", getattr(stft_lib, name))
                 for name in ("stft_magnitude_unit_phase", "istft")]
    originals.append((AdaptiveGeneratorBlock, "forward", "resblocks",
                      AdaptiveGeneratorBlock.forward))

    def ranged(scope, fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function("scope." + scope):
                return fn(*args, **kwargs)
        return wrapper

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        for obj, name, scope, fn in originals:
            setattr(obj, name, ranged(scope, fn))
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, name, _, fn in originals:
            setattr(obj, name, fn)

    def scope_of(evt):
        while evt is not None:
            if evt.name.startswith("scope."):
                return evt.name[len("scope."):]
            evt = evt.cpu_parent
        return None

    groups, kernels = {}, {}
    launches = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU:
            continue
        scope = scope_of(evt)
        for k in evt.kernels:
            ms = k.duration / 1e3
            g = groups.setdefault(speak_group(k.name, scope), {"ms": 0.0, "launches": 0})
            g["ms"] += ms
            g["launches"] += 1
            row = kernels.setdefault(k.name, {"ms": 0.0, "launches": 0})
            row["ms"] += ms
            row["launches"] += 1
            launches += 1
    device_ms = sum(g["ms"] for g in groups.values())
    if not launches or device_ms <= 0:
        fail("the profiler trace of the acoustic call holds no device time")
    for g in groups.values():
        g["share_of_device"] = g["ms"] / device_ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:40]
    profile = {"card": None, "tokens": int(lengths[0]), "text_bucket": int(texts.shape[1]),
               "frame_bucket": frames, "audio_s": frames * pkg.mc.hop_length
               / pkg.mc.sample_rate, "call_ms": call_ms, "traced_wall_ms": wall_ms,
               "device_ms": device_ms, "busy_share": device_ms / call_ms,
               "busy_share_traced": device_ms / wall_ms, "launches": launches,
               "groups": groups, "top_kernels": [{"name": n, **v} for n, v in top]}
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"acoustic device time: {g['ms']:.3f} ms x{g['launches']} {name}")
    log(f"acoustic call at L={texts.shape[1]} F={frames}: {call_ms:.2f} ms (median "
        f"of {N_PHASE_TIMED}), traced {wall_ms:.2f} ms, device {device_ms:.2f} ms, busy "
        f"share {device_ms / call_ms:.3f} ({device_ms / wall_ms:.3f} of the traced "
        f"call), {launches} launches")
    return profile


def phase_synthesis(torch, card: str):
    from stylish_tts_torch.config import ModelConfig

    with tempfile.TemporaryDirectory(prefix="chip_smoke_speak_") as tmp:
        root = Path(tmp)
        pkg, pack, lines, speak = phase_speak(torch, root, ModelConfig())
        check = phase_card_vs_cpu(torch, pkg, pack, root, lines[SHORT_LINE])
    times = phase_speak_times(torch, pkg, pack, lines)
    profile = phase_speak_profile(torch, pkg, pack, lines[-1])
    profile["card"] = card
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_speak.json").write_text(json.dumps(profile, indent=1))
    return {"speak": speak, "card_vs_cpu": check, "times": times,
            "profile": {k: v for k, v in profile.items() if k != "top_kernels"}}


# ---------------------------------------------------------------- phase 6

# the front end's train-align: 3 epochs of 2 train steps (B = 69) and one
# val-split step; validation every 2 train steps (16 ragged val clips ->
# 16 batches of 1 each time), a checkpoint every train step
FRONT_EPOCHS = 3
FRONT_VAL_INTERVAL = 2
FRONT_SAVE_INTERVAL = 1
MAX_KEEP = 4
# pitch: the card against the port on the CPU on one batch, and against
# the clips' generating F0
PITCH_VOICING_AGREE = 0.99
PITCH_F0_RTOL = 1e-3
PITCH_TRUTH_MEDIAN_MAX = 0.05
PITCH_BATCH = 8
# resume against the uninterrupted run (cuDNN's backward is not bitwise).
# The resumed span moves a weight by at most about the sum of its lrs
# (~1e-5 at lr <= 1e-5), so the final weights are held against that move:
# a resume that lost the AdamW moments or skipped updates misses by a
# sizeable share of it
RESUME_RTOL = 1e-4
WEIGHT_SPAN_RTOL = 0.05
VITERBI_SCORE_ATOL = 1e-6
TEXTGRID_SEGMENT = "train3.wav"
N_FRONT_TIMED = 5


def front_config(data: Path, path: Path) -> Path:
    """The front end's YAML. A partial ``training_plan.alignment`` takes
    ``StagePlan``'s class defaults for the fields it leaves out (batch 16,
    lr 1e-4), so the alignment plan's own defaults are written out."""
    import yaml

    from stylish_tts_torch.config import Config

    plan = Config().training_plan.alignment
    path.write_text(yaml.safe_dump({
        "dataset": {"path": str(data)},
        "training": {"log_interval": 1, "val_interval": FRONT_VAL_INTERVAL,
                     "save_interval": FRONT_SAVE_INTERVAL},
        "training_plan": {"alignment": {"epochs": FRONT_EPOCHS,
                                        "probe_batch_max": plan.probe_batch_max,
                                        "lr": plan.lr}},
    }), encoding="utf-8")
    return path


def cli(torch, *args, device=True):
    """One command of the port's training CLI, in this process (on ``cuda``
    unless ``device`` is False: ``convert`` takes none); returns what the
    command returns and its wall seconds (synchronised)."""
    from stylish_tts_torch.cli import train_cli

    t0 = time.time()
    rv = train_cli.main([*args, *(["--device", "cuda"] if device else [])],
                        standalone_mode=False)
    torch.cuda.synchronize()
    return rv, time.time() - t0


def dataset(data: Path, split: str, **caches):
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.dataset import FilePathDataset
    from stylish_tts_torch.text import TextCleaner

    mc = ModelConfig()
    lines = (data / f"{split}-list.txt").read_text(encoding="utf-8").splitlines()
    return FilePathDataset(
        data_list=lines, root_path=str(data / "wav-dir"),
        text_cleaner=TextCleaner(mc.symbol), sample_rate=mc.sample_rate,
        coarse_hop_length=mc.hop_length * mc.coarse_multiplier,
        **{k: str(data / v) for k, v in caches.items()})


def front_pitch(torch, data, cfg, out, truth):
    """``pitch`` through the CLI; the card against the port on the CPU on
    one batch; every clip against its generating F0; YIN's times."""
    import numpy as np

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.caches import load_cache
    from stylish_tts_torch.dataprep.pitch import WINDOW, yin_pitch

    mc = ModelConfig()
    _, seconds = cli(torch, "pitch", "--config", str(cfg), "--out", str(out))
    cache = load_cache(str(data / "pitch.safetensors"))
    if len(cache) != len(truth):
        fail(f"pitch wrote {len(cache)} entries for {len(truth)} clips")

    ds = dataset(data, "train")
    ds.time_bins()
    items = [ds.load_segment(i) for i in range(PITCH_BATCH)]
    audio = torch.from_numpy(np.stack([it["audio"] for it in items]))
    frames = audio.shape[1] // mc.hop_length
    t0 = time.time()
    cpu = yin_pitch(audio, hop=mc.hop_length, frames=frames,
                    sample_rate=mc.sample_rate).numpy()
    cpu_s = time.time() - t0
    card = np.stack([cache[it["path"]] for it in items])
    agree = float(np.mean((card > 0) == (cpu > 0)))
    both = (card > 0) & (cpu > 0)
    rel = float(np.max(np.abs(card[both] / cpu[both] - 1))) if both.any() else 0.0
    if agree < PITCH_VOICING_AGREE or rel > PITCH_F0_RTOL:
        fail(f"pitch on the card vs the CPU: voicing agrees on {agree:.4f} of "
             f"frames (>= {PITCH_VOICING_AGREE}), F0 max rel err {rel:.3e} "
             f"(<= {PITCH_F0_RTOL})")

    errs, voiced, inside = [], 0, 0
    hop, sr = mc.hop_length, mc.sample_rate
    for name, (base, samples) in truth.items():
        f0 = cache[name]
        pad = (f0.shape[0] * hop - samples) // 2
        t = (np.arange(f0.shape[0]) * hop - WINDOW / 2 - pad) / sr
        ok = (t > WINDOW / sr) & (t < (samples - WINDOW) / sr)
        inside += int(ok.sum())
        ok &= f0 > 0
        voiced += int(ok.sum())
        true = base * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t[ok]))
        errs.append(np.abs(f0[ok] / true - 1))
    errs = np.concatenate(errs)
    median = float(np.median(errs))
    if median > PITCH_TRUTH_MEDIAN_MAX or voiced < 0.5 * inside:
        fail(f"pitch against the generating F0: median rel err {median:.4f} "
             f"(<= {PITCH_TRUTH_MEDIAN_MAX}) on {voiced} of {inside} frames voiced")

    on = audio.cuda()
    yin = lambda: yin_pitch(on, hop=hop, frames=frames, sample_rate=sr)  # noqa: E731
    batch_ms = median_ms(torch, yin, n=N_FRONT_TIMED, warmup=1, sleep=False)
    device_ms = median_ms(torch, yin, n=N_FRONT_TIMED, warmup=1)
    out_d = {"seconds": seconds, "segments": len(cache), "frames": frames,
             "batch": PITCH_BATCH, "batch_ms": batch_ms, "batch_device_ms": device_ms,
             "cpu_batch_s": cpu_s, "voicing_agree": agree, "f0_max_rel_err": rel,
             "truth_median_rel_err": median, "truth_p90_rel_err":
             float(np.quantile(errs, 0.9)), "truth_voiced_frames": voiced,
             "truth_frames": inside}
    log(f"pitch: {len(cache)} clips in {seconds:.2f} s; batch of {PITCH_BATCH} x "
        f"{frames} frames {batch_ms:.2f} ms ({device_ms:.2f} ms behind a sleep); "
        f"card vs CPU voicing {agree:.4f}, F0 rel {rel:.2e}; vs the generating F0 "
        f"median {median:.4f} on {voiced}/{inside} frames")
    return out_d


def checkpoint_dirs(stage_dir: Path):
    import re

    names = sorted(d.name for d in stage_dir.iterdir() if d.name.startswith("checkpoint_"))
    if not all(re.fullmatch(r"checkpoint_\d{5}_step_\d{9}", n) for n in names):
        fail(f"checkpoint directories not in the JAX naming: {names}")
    return names


def front_train(torch, cfg, out):
    """``train-align`` through the CLI with validation and checkpoints; the
    CTC launches = steps + validation batches (alpha alone) and steps."""
    import numpy as np

    from stylish_tts_torch.data import loader
    from stylish_tts_torch.ops import ctc_cuda

    for counts in (ctc_cuda.LAUNCHES, loader.BATCHES):
        for name in counts:
            counts[name] = 0
    trainer, wall = cli(torch, "train-align", "--config", str(cfg), "--out", str(out),
                        "--record-steps")
    launches = dict(ctc_cuda.LAUNCHES)
    batches = dict(loader.BATCHES)
    steps = len(trainer.losses)
    train_steps = trainer.manifest.current_total_step
    val_batches = sum(v["batches"] for v in trainer.validations)
    expect_vals = train_steps // FRONT_VAL_INTERVAL
    if not all(np.isfinite(trainer.losses)) or steps <= train_steps:
        fail(f"train-align losses: {trainer.losses}")
    if len(trainer.validations) != expect_vals or not val_batches:
        fail(f"{len(trainer.validations)} validations, expected {expect_vals}")
    for v in trainer.validations:
        if not (np.isfinite(v["align_loss"]) and 0.0 < v["confidence"] <= 1.0):
            fail(f"validation at step {v['step']}: {v}")
    if launches != {"alpha_beta": steps + val_batches, "grad": steps}:
        fail(f"CTC launches {launches}; expected alpha_beta = {steps} steps + "
             f"{val_batches} validation batches, grad = {steps}")
    if batches != {"native": train_steps, "scipy": 0}:
        fail(f"loader batches {batches}: the native loader did not serve all "
             f"{train_steps} train-split batches")
    names = checkpoint_dirs(out / "alignment")
    if len(names) != MAX_KEEP or names[-1] != f"checkpoint_{FRONT_EPOCHS:05d}_step_{train_steps:09d}":
        fail(f"checkpoints not pruned to {MAX_KEEP} ending at the last step: {names}")
    log(f"train-align (front): {steps} steps ({train_steps} train-split), "
        f"{len(trainer.validations)} validations of {val_batches} batches in all, "
        f"{wall:.1f} s; launches {launches}; loader {batches}; validation "
        f"{[(v['step'], round(v['align_loss'], 4), round(v['confidence'], 4)) for v in trainer.validations]}; "
        f"checkpoints {names}")
    return trainer, {
        "wall_s": wall, "steps": steps, "train_steps": train_steps,
        "launches": launches, "loader_batches": batches,
        "validations": trainer.validations, "validation_batches": val_batches,
        "checkpoints": names, "losses": trainer.losses,
        "best_loss": trainer.manifest.best_loss}


def front_resume(torch, cfg, work, full):
    """``train-align --checkpoint`` from the oldest kept checkpoint into a
    second directory, against the uninterrupted run; the checkpoint's own
    save and load times and its size."""
    import numpy as np

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.models import build_text_aligner
    from stylish_tts_torch.trainer.checkpoint import (
        STATE_FILE, load_checkpoint, save_checkpoint)
    from stylish_tts_torch.trainer.state import create_train_state

    stage_dir = work / "out" / "alignment"
    names = checkpoint_dirs(stage_dir)
    resumed, wall = cli(torch, "train-align", "--config", str(cfg), "--out",
                        str(work / "resumed"), "--checkpoint", str(stage_dir / names[0]),
                        "--record-steps")
    n = len(resumed.losses)
    ref = np.asarray(full.losses[-n:])
    loss_rel = float(np.max(np.abs(np.asarray(resumed.losses) - ref) / np.abs(ref)))
    same_order = resumed.batches == full.batches[-n:]
    last = names[-1]
    saved = [torch.load(path, map_location="cpu", weights_only=True) for path in (
        work / "out" / "alignment" / last / STATE_FILE,
        work / "resumed" / "alignment" / last / STATE_FILE,
        stage_dir / names[0] / STATE_FILE)]

    def weight_diff(a, b):
        return max(float((a["aligner"][k] - b["aligner"][k]).abs().max())
                   for k in a["aligner"])

    weight_err = weight_diff(saved[0], saved[1])
    span = weight_diff(saved[0], saved[2])
    prior_rel = float(((saved[0]["log_priors"] - saved[1]["log_priors"]).abs()
                       / saved[0]["log_priors"].abs().clamp_min(1e-30)).max())
    if (not same_order or not 0 < n < len(full.losses) or loss_rel > RESUME_RTOL
            or not weight_err <= WEIGHT_SPAN_RTOL * span or prior_rel > RESUME_RTOL
            or saved[0]["step"] != saved[1]["step"]):
        fail(f"resume from {names[0]} vs the uninterrupted run: same batch order "
             f"{same_order}, {n} steps, loss rel err {loss_rel:.3e} (<= {RESUME_RTOL}), "
             f"weights {weight_err:.3e} (<= {WEIGHT_SPAN_RTOL} x the span's move "
             f"{span:.3e}), priors rel {prior_rel:.3e}")

    mc = ModelConfig()
    state = create_train_state(build_text_aligner(mc), mc.text_encoder.tokens + 1, "cuda")
    t0 = time.perf_counter()
    state, manifest, norm = load_checkpoint(str(stage_dir / last), state)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    path = Path(save_checkpoint(str(work / "saved"), state, manifest, resumed.config,
                                mc, norm))
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    log(f"resume from {names[0]}: {n} steps in {wall:.1f} s, same batch order, loss "
        f"rel err {loss_rel:.2e}, weights {weight_err:.2e} of a {span:.2e} move, priors "
        f"rel {prior_rel:.2e}; "
        f"checkpoint save {save_ms:.1f} ms, load {load_ms:.1f} ms, {nbytes} bytes")
    return {"from": names[0], "steps": n, "wall_s": wall, "loss_max_rel_err": loss_rel,
            "weight_max_abs_err": weight_err, "weight_span_max_abs": span,
            "prior_max_rel_err": prior_rel,
            "save_ms": save_ms, "load_ms": load_ms, "bytes": nbytes}


def front_align(torch, data, cfg, out):
    """``align --method k2`` through the CLI: an entry for every segment of
    its text's length, durations summing to the frames, the scores files."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.caches import load_cache
    from stylish_tts_torch.text import TextCleaner

    _, seconds = cli(torch, "align", "--config", str(cfg), "--out", str(out),
                     "--method", "k2")
    cache = load_cache(str(data / "alignment.safetensors"))
    cleaner = TextCleaner(ModelConfig().symbol)
    n = 0
    for split in ("train", "val"):
        lines = (data / f"{split}-list.txt").read_text(encoding="utf-8").splitlines()
        scores = (out / f"scores_{split}.txt").read_text(encoding="utf-8").splitlines()
        if len(scores) != len(lines):
            fail(f"scores_{split}.txt has {len(scores)} rows for {len(lines)} segments")
        for line in lines:
            name, phonemes = line.split("|")[:2]
            durs = cache.get(name)
            if durs is None or durs.shape != (1, len(cleaner(phonemes))):
                fail(f"alignment of {name}: {None if durs is None else durs.shape}, "
                     f"text of {len(cleaner(phonemes))} tokens")
            if durs.sum() != FRONT_FRAMES:
                fail(f"durations of {name} sum to {durs.sum()}, not {FRONT_FRAMES}")
            n += 1
    log(f"align: {n} segments in {seconds:.2f} s")
    return {"seconds": seconds, "segments": n}


def profile_ranges(torch, fn, ranges):
    """``fn`` under ``torch.profiler``: device ms and launches per named
    range (``record_function`` names in ``ranges``) and in all."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def owner(evt):
        while evt is not None:
            if evt.name in ranges:
                return evt.name
            evt = evt.cpu_parent
        return "other"

    groups = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU:
            continue
        g = None
        for k in evt.kernels:
            g = g or groups.setdefault(owner(evt), {"device_ms": 0.0, "launches": 0})
            g["device_ms"] += k.duration / 1e3
            g["launches"] += 1
    device_ms = sum(g["device_ms"] for g in groups.values())
    launches = sum(g["launches"] for g in groups.values())
    if not launches:
        fail("the profiler trace holds no device time")
    return {"traced_wall_ms": wall_ms, "device_ms": device_ms, "launches": launches,
            "groups": groups}


def front_viterbi(torch, data, card):
    """The Viterbi on the card against the CPU from the same log-probs (both
    methods), its time and launches at B = 8 and B = 1, one align batch
    timed and traced (``chiprun_out/profile_align.json``)."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.collate import collate_batch
    from stylish_tts_torch.dataprep.align import (
        align_mel_transform, forced_align_batch, posteriors)
    from stylish_tts_torch.models import build_text_aligner
    from stylish_tts_torch.ops.ctc import ctc_forced_align
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.utils.params_io import load_text_aligner_safetensors

    mc = ModelConfig()
    aligner = build_text_aligner(mc)
    load_text_aligner_safetensors(str(data / "alignment_model.safetensors"), aligner)
    aligner = aligner.cuda().eval()
    norm = NormalizationStats.load(str(data.parent / "out" / "normalization.json"))
    to_mel = align_mel_transform(mc)
    blank = mc.text_encoder.tokens
    ds = dataset(data, "train")
    ds.time_bins()
    batch, _ = collate_batch([ds.load_segment(i) for i in range(8)],
                             hop_length=mc.hop_length, require_pitch=False)
    audio = torch.from_numpy(batch.audio_gt).cuda()
    text = torch.from_numpy(batch.text).cuda()
    lengths = torch.from_numpy(batch.text_lengths).cuda()
    log_probs, frames = posteriors(aligner, to_mel, norm, audio)

    check = {}
    for method in ("k2", "torch"):
        card_res, card_blank = forced_align_batch(log_probs, frames, text, lengths,
                                                  blank, method)
        cpu_res, cpu_blank = forced_align_batch(log_probs.cpu(), frames.cpu(),
                                                text.cpu(), lengths.cpu(), blank, method)
        same = all(torch.equal(getattr(card_res, k).cpu(), getattr(cpu_res, k))
                   for k in ("frame_tokens", "durations", "onsets"))
        score_err = float((card_res.scores.cpu() - cpu_res.scores).abs().max())
        if not same or not torch.equal(card_blank.cpu(), cpu_blank) \
                or score_err > VITERBI_SCORE_ATOL:
            fail(f"Viterbi ({method}) on the card vs the CPU from the same log-probs: "
                 f"integer outputs equal {same}, scores max err {score_err:.3e}")
        check[method] = {"bit_identical": True, "score_max_abs_err": score_err}

    def batch_call():
        lp, fr = posteriors(aligner, to_mel, norm, audio)
        res, _ = forced_align_batch(lp, fr, text, lengths, blank, "k2")
        return res.durations.cpu()

    batch_ms = median_ms(torch, batch_call, n=N_FRONT_TIMED, warmup=1, sleep=False)
    inner = torch.cat([text[:, 1:], torch.zeros_like(text[:, :1])], 1)
    inner_len = torch.clamp(lengths - 2, min=1)
    viterbi = {}
    for b in (8, 1):
        args = (log_probs[:b].contiguous(), frames[:b], inner[:b], inner_len[:b], blank)
        call = lambda: ctc_forced_align(*args)  # noqa: E731
        ms = median_ms(torch, call, n=N_FRONT_TIMED, warmup=1, sleep=False)
        prof = profile_ranges(torch, call, ())
        viterbi[f"b{b}"] = {"ms": ms, "device_ms": prof["device_ms"],
                            "launches": prof["launches"], "T": int(log_probs.shape[1]),
                            "U": int(inner.shape[1])}
    def ranged_batch():
        with torch.profiler.record_function("align.posteriors"):
            lp, fr = posteriors(aligner, to_mel, norm, audio)
        with torch.profiler.record_function("align.viterbi"):
            res, _ = forced_align_batch(lp, fr, text, lengths, blank, "k2")
        return res.durations.cpu()

    prof = profile_ranges(torch, ranged_batch, ("align.posteriors", "align.viterbi"))
    profile = {"card": card, "B": 8, "T": int(log_probs.shape[1]),
               "text_bucket": int(text.shape[1]), "batch_ms": batch_ms,
               "busy_share": prof["device_ms"] / batch_ms, **prof}
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_align.json").write_text(json.dumps(profile, indent=1))
    log(f"Viterbi card vs CPU bit-identical (k2 and torch; scores "
        f"{max(c['score_max_abs_err'] for c in check.values()):.1e}); align batch B=8 "
        f"{batch_ms:.2f} ms, device {prof['device_ms']:.2f} ms in {prof['launches']} "
        f"launches (busy {profile['busy_share']:.3f}); Viterbi "
        + ", ".join(f"{k}: {v['ms']:.2f} ms, device {v['device_ms']:.2f} ms, "
                    f"{v['launches']} launches" for k, v in viterbi.items()))
    return {"check": check, "batch_ms": batch_ms, "viterbi": viterbi,
            "profile": {k: v for k, v in profile.items() if k != "card"}}


def front_textgrid(torch, data, cfg, out):
    """``align-textgrid`` through the CLI on one segment: one interval per
    token, xmax = frames x hop."""
    import re

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.text import TextCleaner

    mc = ModelConfig()
    cli(torch, "align-textgrid", "--config", str(cfg), "--out", str(out),
        "--segment", TEXTGRID_SEGMENT)
    text = (out / TEXTGRID_SEGMENT.replace(".wav", ".TextGrid")).read_text(encoding="utf-8")
    line = next(x for x in (data / "train-list.txt").read_text(encoding="utf-8").splitlines()
                if x.startswith(TEXTGRID_SEGMENT + "|"))
    n_tokens = len(TextCleaner(mc.symbol)(line.split("|")[1]))
    intervals = int(re.search(r"intervals: size = (\d+)", text).group(1))
    xmax = float(re.search(r"^xmax = ([\d.]+)$", text, re.M).group(1))
    want = FRONT_FRAMES * mc.hop_length / mc.sample_rate
    if intervals != n_tokens or abs(xmax - want) > 1e-6:
        fail(f"TextGrid of {TEXTGRID_SEGMENT}: {intervals} intervals for {n_tokens} "
             f"tokens, xmax {xmax} (expected {want})")
    log(f"align-textgrid: {intervals} intervals, xmax {xmax} s")
    return {"intervals": intervals, "xmax": xmax}


def front_ready(torch, data):
    """The acoustic stage's input from the port-made caches: one batch
    collated with ``require_pitch=True``, its soft alignment covering every
    frame (each frame peaks on a token whose span lies within 3 frames)."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.collate import collate_batch
    from stylish_tts_torch.ops.duration import DurationProcessor

    ds = dataset(data, "train", pitch_path="pitch.safetensors",
                 alignment_path="alignment.safetensors")
    ds.time_bins()
    batch, _ = collate_batch([ds.load_segment(i) for i in range(8)],
                             hop_length=ModelConfig().hop_length, require_pitch=True)
    frames = batch.pitch.shape[1]
    durations = torch.from_numpy(batch.durations).cuda()
    alignment = DurationProcessor().duration_to_alignment(durations, frames)
    upper = torch.cumsum(durations.float(), 1)
    lower = upper - durations.float()
    owner = alignment.argmax(1)
    f = torch.arange(frames, device="cuda", dtype=torch.float32)[None, :]
    covered = bool(((torch.gather(lower, 1, owner) - 3 < f)
                    & (f < torch.gather(upper, 1, owner) + 3)).all())
    col = float((alignment.sum(1) - 1).abs().max())
    if (frames != FRONT_FRAMES or not (batch.durations.sum(1) == frames).all()
            or not covered or col > 1e-5 or not (batch.pitch > 0).any()):
        fail(f"acoustic-stage batch from the port's caches: frames {frames}, "
             f"duration sums {batch.durations.sum(1).tolist()}, covered {covered}, "
             f"column sums off by {col:.2e}")
    log(f"acoustic-stage batch: B={batch.text.shape[0]}, {frames} frames, text bucket "
        f"{batch.text.shape[1]}, alignment covers every frame")
    return {"B": int(batch.text.shape[0]), "frames": frames,
            "text_bucket": int(batch.text.shape[1])}


def front_loader(torch, data):
    """The native loader against the scipy path on one planned batch."""
    from stylish_tts_torch.data.loader import PrefetchLoader

    ds = dataset(data, "train")
    ds.time_bins()
    idxs = list(range(min(FRONT_BATCH, len(ds))))
    out = {}
    for name, native in (("native", True), ("scipy", False)):
        ldr = PrefetchLoader(ds, [], ds.coarse_hop_length, require_pitch=False,
                             use_native=native)
        times = []
        for _ in range(N_FRONT_TIMED):
            t0 = time.perf_counter()
            ldr.load_items(idxs)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name + "_ms"] = statistics.median(times)
    log(f"loader, batch of {len(idxs)}: native {out['native_ms']:.1f} ms, "
        f"scipy {out['scipy_ms']:.1f} ms")
    return out


FRONT_FRAMES = 440  # the clips' duration bin: 19 * 20 + 60 frames
FRONT_BATCH = 69  # the planned batch of that bin at probe_batch_max 128


def phase_front_end(torch, work: Path, card: str):
    """pitch -> train-align (validated, checkpointed) -> resume -> align ->
    align-textgrid through the port's CLI on a fresh copy of the synthetic
    corpus; then the acoustic stage's batch and the loader."""
    data = work / "data"
    truth = write_dataset(data, n_train=160, n_val=16, seed=0)
    cfg = front_config(data, work / "front.yml")
    out = work / "out"
    t0 = time.time()
    report = {"pitch": front_pitch(torch, data, cfg, out, truth)}
    trainer, report["train_align"] = front_train(torch, cfg, out)
    report["resume"] = front_resume(torch, cfg, work, trainer)
    report["align"] = front_align(torch, data, cfg, out)
    report["viterbi"] = front_viterbi(torch, data, card)
    report["textgrid"] = front_textgrid(torch, data, cfg, out)
    report["ready"] = front_ready(torch, data)
    report["loader"] = front_loader(torch, data)
    report["wall_s"] = time.time() - t0
    log(f"front end: {report['wall_s']:.1f} s")
    return report


# ---------------------------------------------------------------- phase 7

# the three stages of ``train`` on the front end's corpus and caches. The
# batch planner's memory rule gives B = int(probe_batch_max x 240 / 440)
# at the clips' 440-frame bin: acoustic (probe_batch_max 16) B = 8, so
# 160 train clips give 20 steps per epoch; textual and duration (32, the
# JAX defaults) B = 17, 9 steps per epoch
ACOUSTIC_EPOCHS = 1
ACOUSTIC_PROBE_BATCH_MAX = 16
# training_plan.textual and .duration, written out in full: the JAX
# defaults but for the epochs
LATER_PLANS = {"textual": {"epochs": 1, "probe_batch_max": 32, "lr": 3e-5},
               "duration": {"epochs": 1, "probe_batch_max": 32, "lr": 1e-4}}
STAGES = ("acoustic", "textual", "duration")
VAL_INTERVAL = 4  # every stage validates at least twice
SAVE_INTERVAL = 2
ACOUSTIC_B = 16  # the timed batch, one bin of the corpus
# a resumed or restarted run against the uninterrupted one: each metric
# within 1e-2 relative; each stage's trained modules' weights within 0.05
# of their move over the span both runs trained (L2 norms of the
# differences)
ACOUSTIC_RESUME_RTOL = 1e-2
# card against CPU, one fp32 step with the parity switches: metrics rtol
# 1e-3; each module's updated weights within 0.1 of the step's move (L2),
# and no element off by more than AdamW can move it (2 x 4 lr). A first
# AdamW step moves EVERY element by exactly lr x mult x sign(g), so an
# element whose gradient is below its sum's float32 noise (the attention
# key biases', whose gradient the softmax's shift invariance makes vanish)
# flips with odds 1/2 and adds (2 lr)^2: 0.1 admits a quarter percent of a
# module's elements flipping
CARD_CPU_METRIC_RTOL = 1e-3
CARD_CPU_WEIGHT_RTOL = 0.1
CARD_CPU_MAX_ABS = 2 * 4.0 * 1e-4
MOVE_STEPS = 20
MEL_DROP = 0.9  # mel at the last of the 20 steps below 0.9 x the first
N_ACOUSTIC_TIMED = 5
# first match wins: cuDNN's implicit-GEMM convs and its layout transposes
# are convs; cuBLAS / cuBLASLt (nvjet) kernels GEMMs
ACOUSTIC_GROUPS = (
    ("AdamW", ("multi_tensor_apply",)),
    ("convs", ("cudnn", "fprop", "dgrad", "wgrad", "conv", "Conv", "winograd")),
    ("GEMMs", ("gemm", "Gemm", "nvjet", "cutlass", "cublas", "matmul")),
    ("copies and fills", ("Memcpy", "Memset", "copy_kernel", "fill")),
)


def acoustic_group(name: str, scope: str | None) -> str:
    """A kernel's group: the forward scopes (DSP, discriminators, WavLM) by
    profiler range; the rest, the backward included, by kernel name, with
    the convs and GEMMs split by precision (fp32 FFMA or bf16)."""
    base = next((g for g, needles in ACOUSTIC_GROUPS if any(n in name for n in needles)),
                "elementwise and norms")
    # cuDNN and cuBLAS name a bf16 kernel's type; cuBLASLt's nvjet names
    # carry none and count as fp32
    if base in ("convs", "GEMMs"):
        low = name.lower()
        base += " bf16" if ("bf16" in low or "bfloat16" in low) else " fp32"
    if scope == "wavlm":
        return "WavLM " + base
    if scope is not None and base != "AdamW":
        return scope + (" (fp32 convs)" if base == "convs fp32" else "")
    return base


def acoustic_configs(data: Path, work: Path, generator: str = "freegan",
                     acoustic_epochs: int = ACOUSTIC_EPOCHS,
                     save_interval: int = SAVE_INTERVAL):
    """The YAMLs of ``train``: every field of ``training_plan.<stage>``
    written out for the three stages (a partial plan takes the class
    defaults); bf16; the slm term at its default 0.2 with the seeded random
    WavLM; ``generator.type`` as given."""
    import yaml

    from stylish_tts_torch.config import ModelConfig

    cfg = work / "acoustic.yml"
    cfg.write_text(yaml.safe_dump({
        "dataset": {"path": str(data)},
        "training": {"log_interval": 5, "val_interval": VAL_INTERVAL,
                     "save_interval": save_interval, "mixed_precision": "bf16"},
        "training_plan": {"acoustic": {"epochs": acoustic_epochs,
                                       "probe_batch_max": ACOUSTIC_PROBE_BATCH_MAX,
                                       "lr": 1e-4},
                          **LATER_PLANS},
        "loss_weight": {"slm": 0.2},
        "validation": {"sample_count": 2},
    }), encoding="utf-8")
    mc = ModelConfig().model_dump()
    mc["slm"]["allow_random_fallback"] = True
    mc["generator"]["type"] = generator
    model_cfg = work / "acoustic_model.yml"
    model_cfg.write_text(yaml.safe_dump(mc), encoding="utf-8")
    return cfg, model_cfg


def stage_train(torch, cfg, model_cfg, out, stage, *extra):
    """``train --stage <stage>`` through the CLI, on through the later
    stages (deterministic cuDNN, so a resume can be held against the
    uninterrupted run), every step's metrics kept; the CTC counts are zeroed
    before and read after: no Pallas kernel backs these stages."""
    import numpy as np

    from stylish_tts_torch.ops import ctc_cuda

    for name in ctc_cuda.LAUNCHES:
        ctc_cuda.LAUNCHES[name] = 0
    torch.backends.cudnn.deterministic = True
    try:
        trainer, wall = cli(torch, "train", "--stage", stage, "--config", str(cfg),
                            "--model-config", str(model_cfg), "--out", str(out),
                            "--record-steps", *extra)
    finally:
        torch.backends.cudnn.deterministic = False
    launches = dict(ctc_cuda.LAUNCHES)
    if any(launches.values()):
        fail(f"train --stage {stage} launched a CTC kernel: {launches}")
    for m in trainer.step_metrics:
        if not all(np.isfinite(list(m.values()))):
            fail(f"nonfinite training metric: {m}")
        mults = [v for k, v in m.items() if k.endswith("_lr_mult")]
        # four in the acoustic stage (3 MRDs, disc), one in each later one
        if len(mults) not in (1, 4) or not all(0.01 - 1e-6 <= v <= 4.0 + 1e-6
                                               for v in mults):
            fail(f"lr multipliers outside [0.01, 4]: {m}")
    for v in trainer.validations:
        if not all(np.isfinite(x) for k, x in v.items() if k not in ("stage", "step")):
            fail(f"nonfinite validation: {v}")
    return trainer, wall, launches


def stage_runs(trainer, stages):
    """Per stage: (first row, row count) of the trainer's step records."""
    spans, at = {}, 0
    for stage in stages:
        n = trainer.stage_manifests[stage].current_total_step
        spans[stage] = (at, n)
        at += n
    return spans


def saved_models(torch, path):
    return torch.load(path / "state.pt", map_location="cpu", weights_only=True)["models"]


def span_ratios(torch, full, other, start, names):
    """Per module: L2 of (other - full) over L2 of (full - start)."""
    ratios = {}
    for module in names:
        err = torch.sqrt(sum(((full[module][k].float() - other[module][k].float()) ** 2)
                             .sum() for k in full[module]))
        move = torch.sqrt(sum(((full[module][k].float() - start[module][k].float()) ** 2)
                              .sum() for k in full[module]))
        ratios[module] = float(err / move.clamp_min(1e-30))
    return ratios


def compare_runs(torch, full, other, out_full, out_other, first_stage, start,
                 last_stage="duration"):
    """``other`` (resumed or restarted at ``first_stage``, trained through
    ``last_stage``) against the uninterrupted run: the same batches, its
    metrics within the resume tolerance, and at each of those stages' last
    checkpoint the stage's trained modules within 0.05 of their move since
    ``start`` (the checkpoint the other run began from; for a stage after it,
    the stage's own start)."""
    from stylish_tts_torch.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS

    at, span = stage_runs(full, STAGES)[last_stage]
    end = at + span  # the uninterrupted run's row after last_stage's last step
    n = len(other.step_metrics)
    ref = full.step_metrics[end - n: end]
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
              for a, b in zip(other.step_metrics, ref) for k in b)
    ratios = {}
    for stage in STAGES[STAGES.index(first_stage): STAGES.index(last_stage) + 1]:
        last = checkpoint_dirs(out_full / stage)[-1]
        names = STAGE_TRAIN_MODELS[stage] + STAGE_DISCRIMINATORS[stage]
        ratios.update({f"{stage}/{k}": v for k, v in span_ratios(
            torch, saved_models(torch, out_full / stage / last),
            saved_models(torch, out_other / stage / last), start, names).items()})
        start = saved_models(torch, out_full / stage / last)
    same = other.batches == full.batches[end - n: end]
    if (not same or not 0 < n < end
            or rel > ACOUSTIC_RESUME_RTOL or max(ratios.values()) > WEIGHT_SPAN_RTOL):
        fail(f"{out_other.name} against the uninterrupted run: {n} steps, same batches "
             f"{same}, metric rel err {rel:.3e} (<= "
             f"{ACOUSTIC_RESUME_RTOL}), weights/move {ratios} (<= {WEIGHT_SPAN_RTOL})")
    return n, rel, ratios


def config_until(cfg: Path, last_stage: str) -> Path:
    """``cfg`` for a run held against the uninterrupted one: every stage
    after ``last_stage`` at 0 epochs, so that it ends with the stages it
    checks (their samplers, plans and lr schedules are the uninterrupted
    run's), and checkpoints only at each stage's end and no validation:
    neither is compared, and validation draws from a generator of its own,
    not from the state's."""
    import yaml

    doc = yaml.safe_load(cfg.read_text(encoding="utf-8"))
    for stage in STAGES[STAGES.index(last_stage) + 1:]:
        doc["training_plan"][stage]["epochs"] = 0
    doc["training"]["save_interval"] = doc["training"]["val_interval"] = 10_000
    out = cfg.with_name(f"{cfg.stem}_until_{last_stage}.yml")
    out.write_text(yaml.safe_dump(doc), encoding="utf-8")
    return out


def acoustic_stage(torch, data, work):
    """``train --stage acoustic`` through the CLI: acoustic, then textual,
    then duration, validated and checkpointed; the frozen modules held
    bitwise across each hand-off. Then against that run: a resume inside
    acoustic that ends with acoustic, a start of ``--stage textual`` from the
    acoustic stage's last checkpoint that runs on through duration, and a
    resume inside textual that ends with textual."""
    import numpy as np

    from stylish_tts_torch.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS
    from stylish_tts_torch.trainer.checkpoint import read_manifest

    cfg, model_cfg = acoustic_configs(data, work)
    out = work / "acoustic_out"
    trainer, wall, launches = stage_train(torch, cfg, model_cfg, out, "acoustic")
    spans = stage_runs(trainer, STAGES)
    epochs = {"acoustic": ACOUSTIC_EPOCHS, **{k: v["epochs"] for k, v in LATER_PLANS.items()}}
    per_stage, last = {}, {}
    for stage in STAGES:
        manifest = trainer.stage_manifests[stage]
        steps = manifest.current_total_step
        stage_dir = out / stage
        vals = [v for v in trainer.validations if v["stage"] == stage]
        names = checkpoint_dirs(stage_dir)
        last[stage] = names[-1]
        if steps != epochs[stage] * manifest.steps_per_epoch or steps < 8:
            fail(f"{stage}: {steps} steps of {manifest.steps_per_epoch} per epoch")
        if len(vals) != steps // VAL_INTERVAL or not vals:
            fail(f"{stage} validations: {vals}")
        samples = sorted((stage_dir / "samples").glob("step_*/*.wav"))
        if len(samples) != 2 * len(vals):
            fail(f"{stage} eval samples written: {[str(p) for p in samples]}")
        if (len(names) != min(MAX_KEEP, steps // SAVE_INTERVAL + 1)
                or names[-1] != f"checkpoint_{epochs[stage]:05d}_step_{steps:09d}"
                or read_manifest(str(stage_dir / names[-1])) != manifest):
            fail(f"{stage} checkpoints not pruned to {MAX_KEEP} ending at the stage's "
                 f"manifest: {names}")
        at, n = spans[stage]
        rows = trainer.step_metrics[at: at + n]
        per_stage[stage] = {
            "steps": steps, "B": len(trainer.batches[at]), "validations": vals,
            "checkpoints": names, "first": rows[0], "last": rows[-1]}
        shown = [(v["step"], {k: round(x, 4) for k, x in v.items()
                              if k not in ("stage", "step", "batches")}) for v in vals]
        log(f"train {stage}: {steps} steps at B={len(trainer.batches[at])}; validation "
            f"{shown}; checkpoints {names}; first / last step {rows[0]} / {rows[-1]}")
    # the frozen modules leave each later stage as they entered it
    ends = {stage: saved_models(torch, out / stage / last[stage]) for stage in STAGES}
    frozen = {"textual": [k for k in ends["acoustic"] if k not in
                          STAGE_TRAIN_MODELS["textual"] + STAGE_DISCRIMINATORS["textual"]],
              "duration": [k for k in ends["textual"] if k not in
                           STAGE_TRAIN_MODELS["duration"] + STAGE_DISCRIMINATORS["duration"]]}
    before = {"textual": "acoustic", "duration": "textual"}
    for stage, names in frozen.items():
        for name in names:
            a, b = ends[before[stage]][name], ends[stage][name]
            if not all(torch.equal(a[k], b[k]) for k in a):
                fail(f"{name}, frozen in {stage}, moved")
    log(f"train: {sum(p['steps'] for p in per_stage.values())} steps in {wall:.1f} s; "
        f"CTC launches {launches}; frozen modules bitwise across both hand-offs")

    a_names = per_stage["acoustic"]["checkpoints"]
    resumed, r_wall, _ = stage_train(torch, config_until(cfg, "acoustic"), model_cfg,
                                     work / "acoustic_resumed", "acoustic", "--checkpoint",
                                     str(out / "acoustic" / a_names[0]))
    r_n, r_rel, r_ratios = compare_runs(
        torch, trainer, resumed, out, work / "acoustic_resumed", "acoustic",
        saved_models(torch, out / "acoustic" / a_names[0]), last_stage="acoustic")
    log(f"resume from acoustic/{a_names[0]}: {r_n} acoustic steps in {r_wall:.1f} s; "
        f"metric rel err {r_rel:.2e}; weight error / move {r_ratios}")

    restarted, s_wall, _ = stage_train(torch, config_until(cfg, "duration"), model_cfg,
                                       work / "textual_started",
                                       "textual", "--checkpoint",
                                       str(out / "acoustic" / last["acoustic"]))
    textual_start = saved_models(torch, work / "textual_started" / "textual"
                                 / checkpoint_dirs(work / "textual_started" / "textual")[-1])
    for name in frozen["textual"]:
        a = ends["acoustic"][name]
        if not all(torch.equal(a[k], textual_start[name][k]) for k in a):
            fail(f"--stage textual from the acoustic checkpoint: {name} is not the "
                 "checkpoint's")
    s_n, s_rel, s_ratios = compare_runs(
        torch, trainer, restarted, out, work / "textual_started", "textual",
        ends["acoustic"])
    log(f"--stage textual from acoustic/{last['acoustic']}: the acoustic modules "
        f"bitwise; {s_n} steps in {s_wall:.1f} s; metric rel err {s_rel:.2e}; weight "
        f"error / move {s_ratios}")

    t_names = per_stage["textual"]["checkpoints"]
    t_resumed, t_wall, _ = stage_train(torch, config_until(cfg, "textual"), model_cfg,
                                       work / "textual_resumed", "textual", "--checkpoint",
                                       str(out / "textual" / t_names[0]))
    t_n, t_rel, t_ratios = compare_runs(
        torch, trainer, t_resumed, out, work / "textual_resumed", "textual",
        saved_models(torch, out / "textual" / t_names[0]), last_stage="textual")
    log(f"resume from textual/{t_names[0]}: {t_n} textual steps in {t_wall:.1f} s; metric "
        f"rel err {t_rel:.2e}; weight error / move {t_ratios}")
    acoustic_rows = trainer.step_metrics[: per_stage["acoustic"]["steps"]]
    return trainer, {"wall_s": wall, "steps": per_stage["acoustic"]["steps"],
                     "B": per_stage["acoustic"]["B"], "ctc_launches": launches,
                     "validations": per_stage["acoustic"]["validations"],
                     "checkpoints": a_names, "metrics": acoustic_rows,
                     "stages": per_stage,
                     "resume_from": a_names[0], "resume_steps": r_n,
                     "resume_wall_s": r_wall, "resume_metric_max_rel_err": r_rel,
                     "resume_weight_err_over_move": r_ratios,
                     "textual_start_steps": s_n, "textual_start_wall_s": s_wall,
                     "textual_start_metric_max_rel_err": s_rel,
                     "textual_start_weight_err_over_move": s_ratios,
                     "textual_resume_from": t_names[0], "textual_resume_steps": t_n,
                     "textual_resume_wall_s": t_wall,
                     "textual_resume_metric_max_rel_err": t_rel,
                     "textual_resume_weight_err_over_move": t_ratios}


def acoustic_batch(torch, data, b, seconds=None):
    """``b`` train clips of the corpus's bin, collated as the loader does;
    cut to ``seconds`` (whole frames, durations rescaled to sum to them)."""
    import numpy as np

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.collate import collate_batch
    from stylish_tts_torch.trainer.steps import Batch

    hop = ModelConfig().hop_length
    ds = dataset(data, "train", pitch_path="pitch.safetensors",
                 alignment_path="alignment.safetensors")
    ds.time_bins()
    batch, _ = collate_batch([ds.load_segment(i) for i in range(b)], hop_length=hop,
                             require_pitch=True)
    if seconds is not None:
        frames = int(seconds * 24000) // hop // 2 * 2
        durs = batch.durations.astype(np.float64) * frames / batch.durations.sum(1,
                                                                                 keepdims=True)
        durs = np.floor(durs).astype(np.int32)
        durs[:, 0] += frames - durs.sum(1)
        batch = Batch(batch.audio_gt[:, : frames * hop], batch.text, batch.text_lengths,
                      batch.pitch[:, :frames], durs)
    return batch


def stage_state(torch, mc, device, stage="acoustic", seed=0):
    from stylish_tts_torch.models import build_models
    from stylish_tts_torch.trainer.state import create_stage_train_state

    torch.manual_seed(seed)
    return create_stage_train_state(build_models(mc), device, stage, seed=seed)


def acoustic_card_vs_cpu(torch, data, mc=None):
    """One full-width fp32 step (parity switches, an injected broadband
    excitation, MRD 1, slm on) from the same weights on the card and on the
    CPU: every metric, and every module's updated weights. ``mc``: the
    default ``ModelConfig()`` unless given."""
    import numpy as np

    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models.slm import random_wavlm, wavlm_loss
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.steps import StepContext, batch_to_device, make_acoustic_step

    mc = mc or ModelConfig()
    batch = acoustic_batch(torch, data, 2, seconds=1.0)
    gen = torch.Generator().manual_seed(3)
    prior = torch.tanh(0.3 * torch.randn(batch.audio_gt.shape, generator=gen))
    results = {}
    for device in ("cpu", "cuda"):
        state = stage_state(torch, mc, device)
        start = {n: {k: v.cpu().clone() for k, v in m.state_dict().items()}
                 for n, m in state.models.items()}
        state.wavlm = random_wavlm(0).to(device).eval().requires_grad_(False)
        ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                          stage_steps=100, slm_loss_fn=wavlm_loss,
                          parity_deterministic=True, parity_prior=prior.to(device),
                          forced_disc_index=1)
        t0 = time.time()
        metrics = make_acoustic_step(ctx)(state, batch_to_device(batch, device))
        metrics = {k: float(v) for k, v in metrics.items()}
        results[device] = (metrics, {n: {k: v.cpu() for k, v in m.state_dict().items()}
                                     for n, m in state.models.items()}, time.time() - t0)
    (m_cpu, w_cpu, cpu_s), (m_card, w_card, _) = results["cpu"], results["cuda"]
    metric_rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu}
    ratios, worst_abs = {}, 0.0
    for n in w_cpu:
        err = sum(float(((w_card[n][k] - r) ** 2).sum()) for k, r in w_cpu[n].items())
        move = sum(float(((r - start[n][k]) ** 2).sum()) for k, r in w_cpu[n].items())
        ratios[n] = (err / move) ** 0.5 if move > 0 else (0.0 if err == 0 else float("inf"))
        worst_abs = max(worst_abs, max(float((w_card[n][k] - r).abs().max())
                                       for k, r in w_cpu[n].items()))
    if (max(metric_rel.values()) > CARD_CPU_METRIC_RTOL
            or max(ratios.values()) > CARD_CPU_WEIGHT_RTOL or worst_abs > CARD_CPU_MAX_ABS
            or not all(np.isfinite(list(m_card.values())))):
        fail(f"acoustic step ({mc.generator.type}), card vs CPU: metrics rel {metric_rel} (<= "
             f"{CARD_CPU_METRIC_RTOL}); weights: error / move {ratios} (<= "
             f"{CARD_CPU_WEIGHT_RTOL}), max abs {worst_abs:.2e} (<= {CARD_CPU_MAX_ABS})")
    log(f"acoustic step ({mc.generator.type}) card vs CPU (fp32, B=2, "
        f"{batch.audio_gt.shape[1]} samples): "
        f"metrics max rel {max(metric_rel.values()):.2e} "
        f"({max(metric_rel, key=metric_rel.get)}), weights error / move "
        f"{ {k: round(v, 5) for k, v in ratios.items()} }, max abs {worst_abs:.2e}; "
        f"CPU step {cpu_s:.1f} s")
    return {"metric_rel_err": metric_rel, "weight_err_over_move": ratios,
            "weight_max_abs_err": worst_abs, "cpu_step_s": cpu_s,
            "samples": int(batch.audio_gt.shape[1])}


def acoustic_moves_and_times(torch, data, card, mc=None, n_steps=MOVE_STEPS,
                             mel_drop=MEL_DROP, name="acoustic"):
    """``n_steps`` bf16 steps on one fixed corpus batch of 16 from seeded
    weights (``mc``: the default ``ModelConfig()`` unless given; metrics
    finite, lr multipliers in [0.01, 4], mel falling by the ``mel_drop``
    margin where one is given), each timed; then the step's device time by
    kernel group under ``torch.profiler`` (``chiprun_out/profile_<name>_step.json``),
    its launches, busy share and peak memory, and the WavLM's part (its loss
    forward and backward alone at the step's shapes)."""
    import numpy as np
    from torch.autograd import DeviceType

    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.dsp import mel as mel_lib
    from stylish_tts_torch.dsp import multi_spectrogram
    from stylish_tts_torch.dsp import stft as stft_lib
    from stylish_tts_torch.models.slm import random_wavlm, wavlm_loss
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.steps import StepContext, batch_to_device, make_acoustic_step

    mc = mc or ModelConfig()
    batch = batch_to_device(acoustic_batch(torch, data, ACOUSTIC_B), "cuda")
    state = stage_state(torch, mc, "cuda")
    state.wavlm = random_wavlm(0).cuda().eval().requires_grad_(False)
    ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                      stage_steps=10_000, slm_loss_fn=wavlm_loss, mixed_precision=True)
    step = make_acoustic_step(ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, step_ms = [], []
    for _ in range(n_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    for m in metrics:
        mults = [v for k, v in m.items() if k.endswith("_lr_mult")]
        if not all(np.isfinite(list(m.values()))) or not all(0.01 - 1e-6 <= v <= 4 + 1e-6
                                                              for v in mults):
            fail(f"acoustic moves: metrics {m}")
    mel0, mel1 = metrics[0]["mel"], metrics[-1]["mel"]
    if mel_drop is not None and not mel1 < mel_drop * mel0:
        fail(f"acoustic moves: mel {mel0:.4f} -> {mel1:.4f}, not below {mel_drop} x the first")
    median_step = statistics.median(step_ms[2:])

    # WavLM alone: the target's forward and the prediction's forward and
    # backward at the step's audio
    frames = ctx.norm_mel(batch.audio_gt[:1], ctx.to_mel).shape[-1]
    audio_t = batch.audio_gt[:, : frames * mc.hop_length]
    pred = (audio_t * 0.5).detach().requires_grad_(True)

    def slm_call():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = wavlm_loss(state.wavlm, audio_t, pred)
        loss.backward()
        pred.grad = None

    wavlm_ms = median_ms(torch, slm_call, n=N_ACOUSTIC_TIMED, warmup=1, sleep=False)

    # one step traced, forward scopes in profiler ranges
    wrapped = []

    def scope(obj, attr, name):
        fn = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function("scope." + name):
                return fn(*args, **kwargs)
        setattr(obj, attr, wrapper)
        wrapped.append((obj, attr, fn))

    for n in ("mrd0", "mrd1", "mrd2", "disc"):
        scope(state.models[n], "forward", "discriminators")
    scope(state.wavlm, "forward", "wavlm")
    scope(multi_spectrogram.MultiSpectrogram, "single", "DSP")
    scope(mel_lib.MelSpectrogram, "__call__", "DSP")
    scope(stft_lib, "istft", "DSP")
    scope(stft_lib, "stft_magnitude_unit_phase", "DSP")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, attr, fn in reversed(wrapped):
            setattr(obj, attr, fn)

    def scope_of(evt):
        while evt is not None:
            if evt.name.startswith("scope."):
                return evt.name[len("scope."):]
            evt = evt.cpu_parent
        return None

    groups, kernels, launches = {}, {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU:
            continue
        sc = scope_of(evt)
        for k in evt.kernels:
            ms = k.duration / 1e3
            g = groups.setdefault(acoustic_group(k.name, sc), {"ms": 0.0, "launches": 0})
            g["ms"] += ms
            g["launches"] += 1
            row = kernels.setdefault(k.name, {"ms": 0.0, "launches": 0})
            row["ms"] += ms
            row["launches"] += 1
            launches += 1
    device_ms = sum(g["ms"] for g in groups.values())
    if not launches or device_ms <= 0:
        fail("the profiler trace of the acoustic step holds no device time")
    for g in groups.values():
        g["share_of_device"] = g["ms"] / device_ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:40]
    profile = {"card": card, "B": ACOUSTIC_B, "frames": int(batch.pitch.shape[1]),
               "samples": int(batch.audio_gt.shape[1]), "step_ms_median": median_step,
               "traced_wall_ms": traced_ms, "device_ms": device_ms,
               "busy_share": device_ms / median_step, "launches": launches,
               "peak_memory_bytes": peak, "wavlm_ms": wavlm_ms,
               "wavlm_share": wavlm_ms / median_step, "groups": groups,
               "top_kernels": [{"name": n, **v} for n, v in top]}
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_{name}_step.json").write_text(json.dumps(profile, indent=1))
    for group, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"{name} step device time: {g['ms']:.3f} ms x{g['launches']} {group}")
    log(f"{name} step B={ACOUSTIC_B} F={profile['frames']} bf16: {median_step:.2f} ms "
        f"(median of {n_steps - 2}), device {device_ms:.2f} ms, busy share "
        f"{device_ms / median_step:.3f}, {launches} launches, peak "
        f"{peak / 2**30:.2f} GiB; WavLM {wavlm_ms:.2f} ms ({wavlm_ms / median_step:.3f}); "
        f"mel {mel0:.4f} -> {mel1:.4f} over {n_steps} steps")
    return {"metrics": metrics, "step_ms": step_ms,
            **{k: v for k, v in profile.items() if k != "top_kernels"}}


# the later stages' moves and times at full width: B, and the gate on the
# stage's loss (textual: pitch + energy; duration: duration_ce) at the last
# of the 20 steps against the first (PERF.md states the prediction)
LATER_MOVES = {"textual": (16, 0.98), "duration": (32, 0.9)}
LATER_LR = 1e-4
# fixed non-uniform class weights for the duration steps held apart from
# the trainer (the trainer's come from the corpus's alignments)
DURATION_CLASS_WEIGHTS = (0.5, 2.0)


def later_step(torch, ctx, stage, device):
    from stylish_tts_torch.trainer.steps import make_duration_step, make_textual_step

    if stage == "textual":
        return make_textual_step(ctx)
    return make_duration_step(ctx, torch.linspace(*DURATION_CLASS_WEIGHTS, 16, device=device))


def later_card_vs_cpu(torch, data):
    """One full-width fp32 textual step and one duration step (parity
    switches: no dropout, the frozen speech predictor on an injected
    broadband excitation) from the same seeded weights on the card and on
    the CPU: every metric, and each trained module's updated weights."""
    import numpy as np

    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.steps import StepContext, batch_to_device

    mc = ModelConfig()
    batch = acoustic_batch(torch, data, 2, seconds=1.0)
    gen = torch.Generator().manual_seed(3)
    prior = torch.tanh(0.3 * torch.randn(batch.audio_gt.shape, generator=gen))
    report = {}
    for stage in ("textual", "duration"):
        trained = STAGE_TRAIN_MODELS[stage] + STAGE_DISCRIMINATORS[stage]
        results = {}
        for device in ("cpu", "cuda"):
            state = stage_state(torch, mc, device, stage)
            start = {n: {k: v.cpu().clone() for k, v in state.models[n].state_dict().items()}
                     for n in trained}
            ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                              stage_steps=100, parity_deterministic=True,
                              parity_prior=prior.to(device))
            t0 = time.time()
            metrics = later_step(torch, ctx, stage, device)(state, batch_to_device(batch, device))
            metrics = {k: float(v) for k, v in metrics.items()}
            results[device] = (metrics, {n: {k: v.cpu() for k, v in
                                             state.models[n].state_dict().items()}
                                         for n in trained}, time.time() - t0)
        (m_cpu, w_cpu, cpu_s), (m_card, w_card, _) = results["cpu"], results["cuda"]
        metric_rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu}
        ratios, worst_abs = {}, 0.0
        for n in trained:
            err = sum(float(((w_card[n][k] - r) ** 2).sum()) for k, r in w_cpu[n].items())
            move = sum(float(((r - start[n][k]) ** 2).sum()) for k, r in w_cpu[n].items())
            ratios[n] = (err / move) ** 0.5 if move > 0 else float("inf")
            worst_abs = max(worst_abs, max(float((w_card[n][k] - r).abs().max())
                                           for k, r in w_cpu[n].items()))
        if (max(metric_rel.values()) > CARD_CPU_METRIC_RTOL
                or max(ratios.values()) > CARD_CPU_WEIGHT_RTOL or worst_abs > CARD_CPU_MAX_ABS
                or not all(np.isfinite(list(m_card.values())))):
            fail(f"{stage} step, card vs CPU: metrics rel {metric_rel} (<= "
                 f"{CARD_CPU_METRIC_RTOL}); weights: error / move {ratios} (<= "
                 f"{CARD_CPU_WEIGHT_RTOL}), max abs {worst_abs:.2e} (<= {CARD_CPU_MAX_ABS})")
        log(f"{stage} step card vs CPU (fp32, B=2, {batch.audio_gt.shape[1]} samples): "
            f"metrics max rel {max(metric_rel.values()):.2e} "
            f"({max(metric_rel, key=metric_rel.get)}), weights error / move "
            f"{ {k: round(v, 5) for k, v in ratios.items()} }, max abs {worst_abs:.2e}; "
            f"CPU step {cpu_s:.1f} s")
        report[stage] = {"metric_rel_err": metric_rel, "weight_err_over_move": ratios,
                         "weight_max_abs_err": worst_abs, "cpu_step_s": cpu_s}
    return report


def frozen_speech_ms(torch, ctx, state, batch):
    """The textual step's frozen path alone at its shapes: the speech
    predictor's forward on the curves, the mel loss and the backward to
    the curves (no weight gradient), bf16 autocast, median ms."""
    from stylish_tts_torch import losses as L
    from stylish_tts_torch.trainer.steps import _acoustic_features

    sp, se = state.models["speech_predictor"], state.models["speech_style_encoder"]
    sp.eval()
    se.eval()
    sp.requires_grad_(False)
    se.requires_grad_(False)
    mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
    audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        style = se(style_mel)
    feats_t = ctx.multi_spec(audio_t)
    curves = [pitch.clone().requires_grad_(True), energy.clone().requires_grad_(True)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def call():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            audio = sp(batch.text, batch.text_lengths, alignment, curves[0], curves[1],
                       (pitch > 20.0).float(), style, curves[0], generator=gen).audio.float()
            loss = L.spectral_convergence_loss(feats_t.mel, ctx.multi_spec(audio).mel)
        loss.backward()
        for c in curves:
            c.grad = None

    return median_ms(torch, call, n=N_ACOUSTIC_TIMED, warmup=1, sleep=False)


def later_moves_and_times(torch, data, card):
    """Per later stage: 20 bf16 steps on one fixed corpus batch from seeded
    weights (metrics finite, the lr multiplier in [0.01, 4], the stage's
    loss falling by the stated margin), each timed; then one step's device
    time by kernel group under ``torch.profiler`` (forward scopes: the
    frozen speech predictor, the discriminator, the DSP), its launches,
    busy share and peak memory; for textual the frozen path's forward and
    backward alone."""
    import numpy as np
    from torch.autograd import DeviceType

    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.dsp import mel as mel_lib
    from stylish_tts_torch.dsp import multi_spectrogram
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.steps import StepContext, batch_to_device

    mc = ModelConfig()
    report = {}
    for stage, (b, gate) in LATER_MOVES.items():
        batch = batch_to_device(acoustic_batch(torch, data, b), "cuda")
        state = stage_state(torch, mc, "cuda", stage)
        ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                          stage_steps=10_000, base_lr=LATER_LR, mixed_precision=True)
        step = later_step(torch, ctx, stage, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, step_ms = [], []
        for _ in range(MOVE_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            m = step(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated()

        def loss_of(m):
            return m["pitch"] + m["energy"] if stage == "textual" else m["duration_ce"]

        for m in metrics:
            mults = [v for k, v in m.items() if k.endswith("_lr_mult")]
            if not all(np.isfinite(list(m.values()))) or not all(
                    0.01 - 1e-6 <= v <= 4 + 1e-6 for v in mults):
                fail(f"{stage} moves: metrics {m}")
        first, last = loss_of(metrics[0]), loss_of(metrics[-1])
        if not last < gate * first:
            fail(f"{stage} moves: loss {first:.4f} -> {last:.4f}, not below {gate} x the first")
        median_step = statistics.median(step_ms[2:])
        frozen_ms = frozen_speech_ms(torch, ctx, state, batch) if stage == "textual" else None

        wrapped = []

        def scope(obj, attr, name):
            fn = getattr(obj, attr)

            def wrapper(*args, **kwargs):
                with torch.profiler.record_function("scope." + name):
                    return fn(*args, **kwargs)
            setattr(obj, attr, wrapper)
            wrapped.append((obj, attr, fn))

        disc = "pitch_disc" if stage == "textual" else "dur_disc"
        scope(state.models[disc], "forward", "discriminators")
        if stage == "textual":
            scope(state.models["speech_predictor"], "forward", "frozen speech predictor")
        scope(multi_spectrogram.MultiSpectrogram, "single", "DSP")
        scope(mel_lib.MelSpectrogram, "__call__", "DSP")
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        try:
            with torch.profiler.profile(activities=activities) as prof:
                t0 = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for obj, attr, fn in reversed(wrapped):
                setattr(obj, attr, fn)

        def scope_of(evt):
            while evt is not None:
                if evt.name.startswith("scope."):
                    return evt.name[len("scope."):]
                evt = evt.cpu_parent
            return None

        groups, kernels, launches = {}, {}, 0
        for evt in prof.events():
            if evt.device_type != DeviceType.CPU:
                continue
            sc = scope_of(evt)
            for k in evt.kernels:
                ms = k.duration / 1e3
                g = groups.setdefault(acoustic_group(k.name, sc), {"ms": 0.0, "launches": 0})
                g["ms"] += ms
                g["launches"] += 1
                row = kernels.setdefault(k.name, {"ms": 0.0, "launches": 0})
                row["ms"] += ms
                row["launches"] += 1
                launches += 1
        device_ms = sum(g["ms"] for g in groups.values())
        if not launches or device_ms <= 0:
            fail(f"the profiler trace of the {stage} step holds no device time")
        for g in groups.values():
            g["share_of_device"] = g["ms"] / device_ms
        top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:40]
        profile = {"card": card, "stage": stage, "B": b, "frames": int(batch.pitch.shape[1]),
                   "tokens": int(batch.text.shape[1]), "lr": LATER_LR,
                   "step_ms_median": median_step, "traced_wall_ms": traced_ms,
                   "device_ms": device_ms, "busy_share": device_ms / median_step,
                   "launches": launches, "peak_memory_bytes": peak,
                   "frozen_speech_ms": frozen_ms,
                   "frozen_speech_share": frozen_ms / median_step if frozen_ms else None,
                   "loss_first_last": [first, last], "groups": groups,
                   "top_kernels": [{"name": n, **v} for n, v in top]}
        OUT.mkdir(exist_ok=True)
        (OUT / f"profile_{stage}_step.json").write_text(json.dumps(profile, indent=1))
        for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
            log(f"{stage} step device time: {g['ms']:.3f} ms x{g['launches']} {name}")
        log(f"{stage} step B={b} F={profile['frames']} bf16: {median_step:.2f} ms "
            f"(median of {MOVE_STEPS - 2}), device {device_ms:.2f} ms, busy share "
            f"{device_ms / median_step:.3f}, {launches} launches, peak "
            f"{peak / 2**30:.2f} GiB; loss {first:.4f} -> {last:.4f} over {MOVE_STEPS} "
            f"steps" + (f"; frozen speech predictor fwd + bwd alone {frozen_ms:.2f} ms"
                        if frozen_ms else ""))
        report[stage] = {"metrics": metrics, "step_ms": step_ms,
                         **{k: v for k, v in profile.items() if k != "top_kernels"}}
        del state, batch, step
        torch.cuda.empty_cache()
    return report


def phase_stages(torch, work: Path, card: str):
    """The three stages of ``train`` on the front end's corpus and caches
    (phase 6's directory): train, resume and restart through the CLI, the
    card against the CPU, training moves, times."""
    data = work / "data"
    t0 = time.time()
    _, report = acoustic_stage(torch, data, work)
    report["card_vs_cpu"] = acoustic_card_vs_cpu(torch, data)
    report["moves"] = acoustic_moves_and_times(torch, data, card)
    report["later_card_vs_cpu"] = later_card_vs_cpu(torch, data)
    report["later_moves"] = later_moves_and_times(torch, data, card)
    report["phase_wall_s"] = time.time() - t0
    log(f"training phase: {report['phase_wall_s']:.1f} s")
    return report


# ---------------------------------------------------------------- phase 8

# the export of the voice that phase 7 trained, on phase 6's corpus:
# ``convert`` of the duration stage's last checkpoint, ``voicepack`` (static
# and dynamic), ``speak``; ``slm-cache`` and the acoustic stage reading it;
# ``pitch --method rmvpe`` with seeded weights. Card against CPU on one batch
# of 8: styles within 1e-4 and slm states within 2e-3 of each one's largest
# magnitude (the states stored float16 on both sides), RMVPE salience 1e-4
# absolute, voicing >= 99 %, F0 1e-3 relative
RECIPE_BATCH = 8
STYLE_TOL = 1e-4
SLM_TOL = 2e-3
RMVPE_SALIENCE_ATOL = 1e-4
RMVPE_RERUN_RTOL = 1e-5  # the command's F0 against a second run on the card
SLM_TRAIN_CLIPS = 16  # the slm run's train split: 2 steps at B = 8
SLM_VAL_CLIPS = 4
DURATION_STATS_KEYS = {"frames_per_token_p05", "frames_per_token_p50",
                       "frames_per_token_p95"}


def first_clips(data: Path, n: int, **caches):
    """The first ``n`` train clips (one time bin) as a dataset."""
    ds = dataset(data, "train", **caches)
    ds.segments = ds.segments[:n]
    return ds


def recipe_convert(torch, work, ckpt, mc=None):
    """``convert``: the six modules, every leaf the checkpoint's bitwise
    (``mc``: the checkpoint's model config, the default ``ModelConfig()``
    unless given), finite pitch stats, the duration stats' keys."""
    import numpy as np
    from safetensors.numpy import load_file

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.convert.from_jax import module_to_jax_flat
    from stylish_tts_torch.models import INFERENCE_MODULES, build_models

    pkg = work / "pkg"
    _, seconds = cli(torch, "convert", "--config", str(work / "acoustic.yml"),
                     "--model-config", str(work / "acoustic_model.yml"),
                     "--checkpoint", str(ckpt), "--out", str(pkg), device=False)
    flat = load_file(str(pkg / "params.safetensors"))
    modules = sorted({k.split("/", 1)[0] for k in flat})
    if modules != sorted(INFERENCE_MODULES):
        fail(f"convert wrote the modules {modules}, not {sorted(INFERENCE_MODULES)}")
    saved = saved_models(torch, ckpt)
    skeleton = build_models(mc or ModelConfig())
    expected = {f"{name}/{k}": v for name in INFERENCE_MODULES
                for k, v in module_to_jax_flat(skeleton[name], saved[name]).items()}
    differ = [k for k, v in expected.items() if not np.array_equal(flat.get(k), v)]
    if differ or set(flat) != set(expected):
        fail(f"convert: {len(differ)} leaves differ from the checkpoint's, keys "
             f"{sorted(set(flat) ^ set(expected))[:5]} on one side only")
    meta = json.loads((pkg / "metadata.json").read_text(encoding="utf-8"))
    stats = (meta["pitch_log2_mean"], meta["pitch_log2_std"])
    if not all(np.isfinite(stats)) or set(meta["duration_stats"]) != DURATION_STATS_KEYS:
        fail(f"convert's stats: pitch log2 {stats}, duration {meta['duration_stats']}")
    log(f"convert: {len(flat)} leaves of {len(modules)} modules bitwise in {seconds:.2f} s; "
        f"pitch log2 {stats[0]:.4f} +- {stats[1]:.4f}; duration {meta['duration_stats']}")
    return pkg, {"seconds": seconds, "modules": len(modules), "leaves": len(flat),
                 "pitch_log2": stats, "duration_stats": meta["duration_stats"]}


def recipe_voicepack(torch, data, work, ckpt):
    """``voicepack`` and ``voicepack --dynamic`` on the train split; the
    styles of one batch of 8 on the card against the CPU; its time."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.tts.voicepack import load_voicepack

    args = ["--config", str(work / "acoustic.yml"), "--model-config",
            str(work / "acoustic_model.yml"), "--checkpoint", str(ckpt)]
    static, dynamic = work / "voicepack.safetensors", work / "voicepack_dynamic.safetensors"
    styles, seconds = cli(torch, "voicepack", *args, "--out", str(static))
    _, dyn_seconds = cli(torch, "voicepack", *args, "--out", str(dynamic), "--dynamic")
    n = styles["lengths"].shape[0]
    pack, dyn = load_voicepack(str(static)), load_voicepack(str(dynamic))
    if (pack["kind"], dyn["kind"]) != ("static", "dynamic") or pack["speech"].shape[0] != 512 \
            or dyn["embedding"].shape[0] != n:
        fail(f"voicepacks: {pack['kind']} {pack['speech'].shape}, {dyn['kind']} "
             f"{dyn['embedding'].shape} for {n} segments")

    errs, batch_ms = styles_card_vs_cpu(torch, data, ckpt, ModelConfig(), styles)
    log(f"voicepack: {n} segments in {seconds:.2f} s (dynamic {dyn_seconds:.2f} s); a batch "
        f"of {RECIPE_BATCH} {batch_ms:.2f} ms; card vs CPU {errs}")
    return static, {"seconds": seconds, "dynamic_seconds": dyn_seconds, "segments": n,
                    "card_vs_cpu": errs, "batch_ms": batch_ms}


def styles_card_vs_cpu(torch, data, ckpt, mc, styles):
    """The styles of the first RECIPE_BATCH train clips from the checkpoint's
    encoders (model config ``mc``) on the card against the CPU, and the
    ``voicepack`` command's (``styles``) against the CPU: each within
    STYLE_TOL of its largest magnitude; the card's batch ms."""
    import numpy as np

    from stylish_tts_torch.trainer.checkpoint import load_stage_models
    from stylish_tts_torch.tts.voicepack import encode_all_styles

    ds = first_clips(data, RECIPE_BATCH, pitch_path="pitch.safetensors")
    out = {}
    for device in ("cuda", "cpu"):
        models, norm = load_stage_models(str(ckpt), mc, device)
        out[device] = encode_all_styles(ds, models, norm, mc)
        if device == "cuda":
            card_models = models
    errs = {}
    for key in ("speech", "pe", "duration"):
        ref = out["cpu"][key]
        scale = float(np.abs(ref).max())
        errs[key] = max(float(np.abs(out["cuda"][key] - ref).max()),
                        float(np.abs(styles[key][:RECIPE_BATCH] - ref).max())) / scale
    if not all(np.isfinite(styles[k]).all() for k in ("speech", "pe", "duration")) \
            or max(errs.values()) > STYLE_TOL:
        fail(f"styles on the card against the CPU (the command's and a direct call): "
             f"{errs} of the largest magnitude (<= {STYLE_TOL})")
    batch_ms = median_ms(torch, lambda: encode_all_styles(ds, card_models, norm, mc),
                         n=N_FRONT_TIMED, warmup=1, sleep=False)
    return errs, batch_ms


def recipe_speak(torch, work, pkg_dir, voicepack, voice="trained"):
    """``speak`` from the exported package and voicepack on the synthesis
    phase's 8 lines: finite, non-silent. Per line, the two-phase path is as
    long as the predicted durations (``durations``, rounded) times the hop,
    and the fused path, which ``speak`` takes, no longer (shorter where the
    durations overflow its frame bucket and are squeezed); ``speak``'s wav
    is the fused lines end to end. RTF at B = 1 on both paths."""
    import numpy as np

    from stylish_tts_torch.cli import tts_cli
    from stylish_tts_torch.data.wav import read_wav
    from stylish_tts_torch.export.package import InferencePackage
    from stylish_tts_torch.tts.voicepack import load_voicepack, lookup_static_style

    lines = speak_lines(2, SPEAK_TOKENS)
    (work / "lines.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    wav_path = work / "speech.wav"
    t0 = time.time()
    tts_cli.main(["speak", "--model", str(pkg_dir), "--voicepack", str(voicepack),
                  "--text", str(work / "lines.txt"), "--out", str(wav_path),
                  "--device", "cuda"], standalone_mode=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    pkg = InferencePackage(str(pkg_dir), device="cuda")
    pack = load_voicepack(str(voicepack))
    hop = pkg.mc.hop_length * pkg.mc.coarse_multiplier
    wav = read_wav(str(wav_path), pkg.mc.sample_rate)
    rms = float(np.sqrt(np.mean(np.square(wav))))
    if not np.isfinite(wav).all() or rms < 1e-3:
        fail(f"speak from the {voice} voice: rms {rms:.2e}, finite "
             f"{bool(np.isfinite(wav).all())}")
    wall = {"fused": 0.0, "two_phase": 0.0}
    lengths = {"fused": [], "two_phase": [], "predicted": []}
    for line in lines:
        texts, text_lengths, (_, _, du) = line_inputs(torch, pkg, pack, line, "cuda")
        d = pkg.durations(texts, text_lengths, du).cpu().numpy()
        lengths["predicted"].append(int(round(float(d.sum()))) * hop)
        tokens = pkg.tokenize(line)
        styles = lookup_static_style(pack, tokens.shape[0])
        for path, fused in (("fused", True), ("two_phase", False)):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                audio = pkg.generate_speech(tokens, *styles, fused=fused)
                times.append(time.perf_counter() - t1)
            wall[path] += statistics.median(times)
            lengths[path].append(audio.shape[0])
    if lengths["two_phase"] != lengths["predicted"] \
            or any(f > t for f, t in zip(lengths["fused"], lengths["two_phase"])) \
            or wav.shape[0] != sum(lengths["fused"]):
        fail(f"speak from the {voice} voice: {wav.shape[0]} samples; per line fused "
             f"{lengths['fused']}, two-phase {lengths['two_phase']}, predicted "
             f"{lengths['predicted']}")
    squeezed = sum(f < t for f, t in zip(lengths["fused"], lengths["two_phase"]))
    audio_s = {k: sum(v) / pkg.mc.sample_rate for k, v in lengths.items()}
    rtf = {k: wall[k] / audio_s[k] for k in wall}
    log(f"speak from the {voice} voice: {wav.shape[0] / pkg.mc.sample_rate:.2f} s of audio "
        f"({squeezed} of {len(lines)} lines squeezed into their bucket; two-phase "
        f"{audio_s['two_phase']:.2f} s), rms {rms:.4f}, {seconds:.2f} s; RTF at B=1 fused "
        f"{rtf['fused']:.5f}, two-phase {rtf['two_phase']:.5f}")
    return {"seconds": seconds, "audio_s": wav.shape[0] / pkg.mc.sample_rate, "rms": rms,
            "squeezed_lines": squeezed, "rtf_b1": rtf["fused"],
            "rtf_b1_two_phase": rtf["two_phase"], "two_phase_audio_s": audio_s["two_phase"]}


def slm_corpus(data: Path, root: Path, cache, flip: bool = False) -> Path:
    """A corpus of the first clips of each split beside ``data`` (its wavs and
    caches by link), with their entries of the slm cache; one fingerprint
    byte flipped if asked."""
    import numpy as np

    from stylish_tts_torch.data.caches import save_cache
    from stylish_tts_torch.dataprep.slm_cache import FINGERPRINT_KEY

    root.mkdir()
    names = []
    for split, n in (("train", SLM_TRAIN_CLIPS), ("val", SLM_VAL_CLIPS)):
        lines = (data / f"{split}-list.txt").read_text(encoding="utf-8").splitlines()[:n]
        (root / f"{split}-list.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
        names += [line.split("|", 1)[0] for line in lines]
    for name in ("wav-dir", "pitch.safetensors", "alignment.safetensors"):
        (root / name).symlink_to(data / name)
    fingerprint = np.array(cache[FINGERPRINT_KEY])
    if flip:
        fingerprint[0] ^= 1
    save_cache(str(root / "slm.safetensors"),
               {**{k: cache[k] for k in names}, FINGERPRINT_KEY: fingerprint})
    return root


def recipe_slm(torch, data, work):
    """``slm-cache`` over both splits (the seeded random WavLM); one batch of
    8 on the card against the CPU; 2 steps of the acoustic stage (the later
    stages at 0 epochs) on a corpus of its first clips, reading the cache
    (every step's slm term the cached form, finite); the same with one
    fingerprint byte flipped raises before a step."""
    import numpy as np
    import yaml

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.caches import load_cache
    from stylish_tts_torch.dataprep.slm_cache import FINGERPRINT_KEY, compute_slm_cache
    from stylish_tts_torch.models import slm
    from stylish_tts_torch.trainer import loop

    cfg, model_cfg = work / "acoustic.yml", work / "acoustic_model.yml"
    _, seconds = cli(torch, "slm-cache", "--config", str(cfg), "--model-config",
                     str(model_cfg), "--out", str(work / "slm_out"))
    path = data / "slm.safetensors"
    cache = load_cache(str(path))
    mb = path.stat().st_size / 1e6
    mc = ModelConfig()
    ds = first_clips(data, RECIPE_BATCH)
    wavlm = slm.load_wavlm(mc.slm.model, allow_random_fallback=True, device="cpu")
    cpu = compute_slm_cache(ds, wavlm)
    if not np.array_equal(cpu[FINGERPRINT_KEY], cache[FINGERPRINT_KEY]):
        fail("slm cache: the card's fingerprint is not the CPU's")
    err = 0.0
    for seg in ds.segments:
        a, b = cache[seg.wav_path].astype(np.float32), cpu[seg.wav_path].astype(np.float32)
        if a.shape != b.shape:
            fail(f"slm states {a.shape} on the card, {b.shape} on the CPU")
        err = max(err, max(float(np.abs(a[i] - b[i]).max() / np.abs(b[i]).max())
                           for i in range(a.shape[0])))
    if err > SLM_TOL:
        fail(f"slm states on the card against the CPU: {err:.3e} of the largest "
             f"magnitude (<= {SLM_TOL})")

    plan = yaml.safe_load(cfg.read_text(encoding="utf-8"))
    plan["training"].update(val_interval=10**6, save_interval=10**6)
    plan["training_plan"]["acoustic"]["epochs"] = 1
    for stage in ("textual", "duration"):  # the acoustic stage's steps alone
        plan["training_plan"][stage]["epochs"] = 0
    calls = {"cached": 0, "inline": 0}
    cached, inline = slm.wavlm_loss_cached, loop.wavlm_loss

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    runs = {}
    slm.wavlm_loss_cached, loop.wavlm_loss = count("cached", cached), count("inline", inline)
    try:
        for name, flip in (("matching", False), ("foreign", True)):
            corpus = slm_corpus(data, work / f"slm_{name}", cache, flip=flip)
            plan["dataset"]["path"] = str(corpus)
            run_cfg = work / f"slm_{name}.yml"
            run_cfg.write_text(yaml.safe_dump(plan), encoding="utf-8")
            args = ("train", "--stage", "acoustic", "--config", str(run_cfg),
                    "--model-config", str(model_cfg), "--out", str(work / f"slm_{name}_out"),
                    "--record-steps")
            try:
                runs[name] = cli(torch, *args)
            except RuntimeError as exc:
                runs[name] = exc
            if name == "matching":
                matched = dict(calls)
    finally:
        slm.wavlm_loss_cached, loop.wavlm_loss = cached, inline
    if isinstance(runs["matching"], Exception):
        fail(f"the acoustic stage on a matching slm cache raised: {runs['matching']!r}")
    trainer, train_s = runs["matching"]
    values = [m["slm"] for m in trainer.step_metrics]
    if len(values) != 2 or not np.isfinite(values).all() or matched != {"cached": 2,
                                                                       "inline": 0}:
        fail(f"the acoustic stage on the slm cache: slm {values}, calls {matched}")
    foreign = runs["foreign"]
    if not isinstance(foreign, RuntimeError) or "DIFFERENT WavLM" not in str(foreign) \
            or calls != matched:
        fail(f"a cache with a flipped fingerprint byte gave {foreign!r}, calls {calls}")
    log(f"slm-cache: {len(cache) - 1} segments, {mb:.1f} MB in {seconds:.2f} s; card vs "
        f"CPU {err:.2e}; 2 acoustic steps on it in {train_s:.2f} s, slm {values}; "
        f"a flipped fingerprint raised")
    return {"seconds": seconds, "mb": mb, "segments": len(cache) - 1, "card_vs_cpu": err,
            "train_s": train_s, "slm": values, "foreign_raised": True}


def recipe_rmvpe(torch, data, work):
    """``pitch --method rmvpe`` with seeded weights in the reference layout
    (a cache of its own); one batch of 8 on the card against the CPU; the
    batch's time."""
    import numpy as np
    import yaml
    from safetensors.torch import save_file

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.caches import load_cache
    from stylish_tts_torch.dataprep.rmvpe import (
        RMVPEPitchExtractor, decode_f0, random_rmvpe_state_dict,
    )

    weights = work / "rmvpe.safetensors"
    save_file(random_rmvpe_state_dict(0), str(weights))
    cfg = work / "rmvpe.yml"
    cfg.write_text(yaml.safe_dump({"dataset": {"path": str(data),
                                               "pitch_path": "pitch_rmvpe.safetensors"}}),
                   encoding="utf-8")
    _, seconds = cli(torch, "pitch", "--config", str(cfg), "--out", str(work / "rmvpe_out"),
                     "--method", "rmvpe", "--rmvpe-weights", str(weights))
    cache = load_cache(str(data / "pitch_rmvpe.safetensors"))
    mc = ModelConfig()
    ds = first_clips(data, RECIPE_BATCH)
    ds.time_bins()
    items = [ds.load_segment(i) for i in range(RECIPE_BATCH)]
    audio = np.stack([it["audio"] for it in items])
    frames = audio.shape[1] // mc.hop_length
    card = RMVPEPitchExtractor(str(weights), mc.sample_rate, mc.hop_length, device="cuda")
    cpu = RMVPEPitchExtractor(str(weights), mc.sample_rate, mc.hop_length, device="cpu")
    sal_card, sal_cpu = card.salience(audio), cpu.salience(audio)
    sal_err = float((sal_card.cpu() - sal_cpu).abs().max())
    f0_card = decode_f0(sal_card).cpu().numpy()[:, :frames]
    f0_cpu = decode_f0(sal_cpu).numpy()[:, :frames]
    written = np.stack([cache[it["path"]] for it in items])
    # the command's extractor and this one may take other cuDNN algorithms
    written_err = float(np.abs(written - f0_card).max() / np.abs(f0_card).max())
    agree = float(np.mean((f0_card > 0) == (f0_cpu > 0)))
    both = (f0_card > 0) & (f0_cpu > 0)
    rel = float(np.max(np.abs(f0_card[both] / f0_cpu[both] - 1))) if both.any() else 0.0
    if (len(cache) != len(dataset(data, "train")) + len(dataset(data, "val"))
            or written_err > RMVPE_RERUN_RTOL or sal_err > RMVPE_SALIENCE_ATOL
            or agree < PITCH_VOICING_AGREE or rel > PITCH_F0_RTOL):
        fail(f"pitch --method rmvpe: {len(cache)} entries, the command's F0 "
             f"{written_err:.2e} off the extractor's (<= {RMVPE_RERUN_RTOL}); card vs CPU salience "
             f"{sal_err:.2e} (<= {RMVPE_SALIENCE_ATOL}), voicing {agree:.4f} (>= "
             f"{PITCH_VOICING_AGREE}), F0 {rel:.2e} (<= {PITCH_F0_RTOL})")
    batch_ms = median_ms(torch, lambda: card.infer(audio), n=N_FRONT_TIMED, warmup=1,
                         sleep=False)
    log(f"pitch --method rmvpe: {len(cache)} clips in {seconds:.2f} s; a batch of "
        f"{RECIPE_BATCH} {batch_ms:.2f} ms; card vs CPU salience {sal_err:.2e}, voicing "
        f"{agree:.4f}, F0 {rel:.2e}")
    return {"seconds": seconds, "batch_ms": batch_ms, "salience_max_abs_err": sal_err,
            "voicing_agree": agree, "f0_max_rel_err": rel}


def phase_recipe(torch, work: Path):
    """The export of phase 7's voice, on phase 6's corpus and caches (the
    same directory): convert -> voicepack -> speak; slm-cache and the
    acoustic stage on it; pitch --method rmvpe."""
    data = work / "data"
    t0 = time.time()
    stage_dir = work / "acoustic_out" / "duration"
    ckpt = stage_dir / checkpoint_dirs(stage_dir)[-1]
    pkg, report = recipe_convert(torch, work, ckpt)
    report = {"convert": report}
    voicepack, report["voicepack"] = recipe_voicepack(torch, data, work, ckpt)
    report["speak"] = recipe_speak(torch, work, pkg, voicepack)
    report["slm_cache"] = recipe_slm(torch, data, work)
    report["rmvpe"] = recipe_rmvpe(torch, data, work)
    report["wall_s"] = time.time() - t0
    log(f"recipe export phase: {report['wall_s']:.1f} s")
    return report


# ---------------------------------------------------------------- phase 9

RINGFORMER_ACOUSTIC_EPOCHS = 1  # 20 acoustic steps at B = 8 on phase 6's corpus
RINGFORMER_SAVE_INTERVAL = 10  # checkpoints: phase 7 holds their pruning and resumes
RINGFORMER_TIMED_STEPS = 6  # at B = 16: 2 warm-up steps, the median of 4
# the pcph prior, card against CPU: within PCPH_ULPS ulps of each harmonic's
# largest phase, as the sine source. Its phase is a float32 cumulative sum
# over frames: the card's parallel scan and the CPU's sequential sum round
# differently, by a few ulps of the largest frame-start cycle count (4.50
# at the 60-token line, 400 frames, on an H100 80GB HBM3); JAX against the
# port on the CPU, both sequential, holds 4 (tests/test_torch_ringformer.py)
PCPH_ULPS = 16
# broadband noise on the injected prior of the card-vs-CPU waveform, so that
# every bin of the head's STFT carries energy (a harmonic prior's empty bins
# make the atan2 phase round-off)
PRIOR_NOISE = 0.03


def ringformer_config():
    from stylish_tts_torch.config import ModelConfig

    mc = ModelConfig()
    mc.generator.type = "ringformer"
    return mc


def ringformer_card_vs_cpu(torch, pkg, pack, root: Path, line: str):
    """The ringformer package on the CPU and on the card, one short line: the
    durations; the pcph prior with zero initial phase, its error in ulps of
    each harmonic's largest phase; the waveform with one injected prior (the
    pcph drawn on the CPU from the row's generator, plus broadband noise)
    within 1e-3 of the CPU waveform's peak."""
    import math

    import numpy as np

    from stylish_tts_torch.export.package import InferencePackage, frame_bucket
    from stylish_tts_torch.models.ringformer import MAX_HARMONICS, generate_pcph

    cpu = InferencePackage(str(root / "pkg"), device="cpu")
    hop, sr = cpu.models["speech_predictor"].generator.prior_hop, cpu.mc.sample_rate
    c_texts, c_lengths, (c_sp, c_pe, c_du) = line_inputs(torch, cpu, pack, line, "cpu")
    with torch.no_grad():
        d_cpu = cpu.durations(c_texts, c_lengths, c_du)
        d_gpu = pkg.durations(c_texts.cuda(), c_lengths.cuda(), c_du.cuda()).cpu()
        dur_err = float((d_cpu - d_gpu).abs().max())
        t_cpu = int(round(float(d_cpu.numpy().sum())))
        t_gpu = int(round(float(d_gpu.numpy().sum())))
        if dur_err > DURATION_ATOL or frame_bucket(t_cpu) != frame_bucket(t_gpu):
            fail(f"ringformer durations on the card vs the CPU: max err {dur_err:.3e}, "
                 f"frame buckets {frame_bucket(t_gpu)} / {frame_bucket(t_cpu)}")
        frames = frame_bucket(t_cpu)
        alignment = cpu.duration_processor.duration_to_alignment(d_cpu, frames)
        pitch, _ = cpu.models["pitch_energy_predictor"](c_texts, c_lengths, alignment, c_pe)
        voiced = (pitch > 20.0).to(torch.float32)

        p_cpu = generate_pcph(pitch, voiced, hop, sr, None)
        p_gpu = generate_pcph(pitch.cuda(), voiced.cuda(), hop, sr, None).cpu()
        c_max = float(torch.cumsum(pitch.double() / sr, dim=1).max())
        f_max = float((pitch * voiced).max())
        n_harm = max(1, min(MAX_HARMONICS, int(sr / 2 // max(f_max, 1.0))))
        ulps = sum(float(np.spacing(np.float32(2 * math.pi * h * hop * c_max)))
                   for h in range(1, MAX_HARMONICS + 1))
        pcph_unit = 0.1 * math.sqrt(2.0 / n_harm) * ulps
        pcph_err = float((p_cpu - p_gpu).abs().max())

        noise = torch.randn(p_cpu.shape, generator=torch.Generator().manual_seed(4))
        prior = generate_pcph(pitch, voiced, hop, sr, cpu._source_generators(1)) \
            + PRIOR_NOISE * noise
        w_cpu = cpu.acoustic(c_texts, c_lengths, d_cpu, c_pe, c_sp, frames, prior=prior)
        w_gpu = pkg.acoustic(c_texts.cuda(), c_lengths.cuda(), d_cpu.cuda(), c_pe.cuda(),
                             c_sp.cuda(), frames, prior=prior.cuda()).cpu()
        wave_err = float((w_cpu - w_gpu).abs().max())
        wave_peak = float(w_cpu.abs().max())
        wave_rms = float(w_cpu.square().mean().sqrt())
        wave_tol = WAVE_RTOL * wave_peak
    if not wave_err <= wave_tol:
        fail(f"ringformer waveform on the card vs the CPU (same prior): max err "
             f"{wave_err:.3e}, tolerance {wave_tol:.3e} ({WAVE_RTOL} x peak {wave_peak:.4g})")
    if not pcph_err <= PCPH_ULPS * pcph_unit:
        fail(f"pcph on the card vs the CPU: max err {pcph_err:.3e} = "
             f"{pcph_err / pcph_unit:.2f} ulps of the phase (<= {PCPH_ULPS})")
    out = {"tokens": int(c_lengths[0]), "frames": frames, "duration_max_abs_err": dur_err,
           "wave_max_abs_err": wave_err, "wave_tol": wave_tol, "wave_peak": wave_peak,
           "wave_rms": wave_rms, "pcph_max_abs_err": pcph_err,
           "pcph_err_ulps": pcph_err / pcph_unit, "pcph_ulps_limit": PCPH_ULPS,
           "pcph_max_cycles": c_max * hop * MAX_HARMONICS}
    log(f"ringformer card vs CPU, {out['tokens']} tokens, {frames} frames: durations "
        f"{dur_err:.2e}, wave {wave_err:.2e} (tol {wave_tol:.2e} = {WAVE_RTOL} x peak "
        f"{wave_peak:.4g}; RMS {wave_rms:.4g}), pcph {pcph_err:.2e} = "
        f"{pcph_err / pcph_unit:.3f} ulps of the phase (largest {out['pcph_max_cycles']:.4g} "
        f"cycles)")
    return out


def phase_ringformer(torch, work: Path, card: str):
    """The ringformer generator family (``generator.type: ringformer``) at
    the full default widths on ``cuda``: synthesis from seeded random
    weights (``speak`` on the 8 lines, the card against the CPU, phase times,
    RTF at B = 1 and 8, a profile of the 510-token call); ``train --stage
    acoustic`` through the CLI on phase 6's corpus (20 acoustic steps at B
    = 8, then 9 textual and 9 duration steps; MagPhase terms finite, mel
    falling); the B = 16 step timed and traced; one fp32 step card against
    CPU; ``convert`` of the duration stage's last checkpoint, ``voicepack``
    and ``speak`` of the 8 lines from it."""
    t0 = time.time()
    mc = ringformer_config()
    root = work / "ringformer"
    (root / "speak").mkdir(parents=True)
    pkg, pack, lines, speak = phase_speak(torch, root / "speak", mc)
    check = ringformer_card_vs_cpu(torch, pkg, pack, root / "speak", lines[SHORT_LINE])
    times = phase_speak_times(torch, pkg, pack, lines)
    profile = phase_speak_profile(torch, pkg, pack, lines[-1])
    profile["card"] = card
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_ringformer_speak.json").write_text(json.dumps(profile, indent=1))
    del pkg
    synthesis_s = time.time() - t0

    data = work / "data"
    cfg, model_cfg = acoustic_configs(data, root, "ringformer", RINGFORMER_ACOUSTIC_EPOCHS,
                                      RINGFORMER_SAVE_INTERVAL)
    out = root / "out"
    trainer, train_s, ctc_launches = stage_train(torch, cfg, model_cfg, out, "acoustic")
    spans = stage_runs(trainer, STAGES)
    at, n = spans["acoustic"]
    rows = trainer.step_metrics[at: at + n]
    if not all({"mag", "phase"} <= set(m) for m in rows):
        fail(f"ringformer acoustic steps without the MagPhase terms: {rows[0]}")
    if not rows[-1]["mel"] < rows[0]["mel"]:
        fail(f"ringformer acoustic mel {rows[0]['mel']:.4f} -> {rows[-1]['mel']:.4f}: "
             "not falling")
    steps = {stage: {"steps": trainer.stage_manifests[stage].current_total_step,
                     "B": len(trainer.batches[spans[stage][0]])} for stage in STAGES}
    log(f"ringformer train: {steps} in {train_s:.1f} s; acoustic mel {rows[0]['mel']:.4f} "
        f"-> {rows[-1]['mel']:.4f}, mag {rows[0]['mag']:.4f} -> {rows[-1]['mag']:.4f}, "
        f"phase {rows[0]['phase']:.4f} -> {rows[-1]['phase']:.4f}; CTC launches "
        f"{ctc_launches}")
    moves = acoustic_moves_and_times(torch, data, card, mc, n_steps=RINGFORMER_TIMED_STEPS,
                                     mel_drop=None, name="ringformer")
    step_check = acoustic_card_vs_cpu(torch, data, mc)

    ckpt = out / "duration" / checkpoint_dirs(out / "duration")[-1]
    pkg_dir, convert = recipe_convert(torch, root, ckpt, mc)
    voicepack = root / "voicepack.safetensors"
    _, voicepack_s = cli(torch, "voicepack", "--config", str(cfg), "--model-config",
                         str(model_cfg), "--checkpoint", str(ckpt), "--out", str(voicepack))
    spoken = recipe_speak(torch, root, pkg_dir, voicepack)
    wall = time.time() - t0
    log(f"ringformer phase: {wall:.1f} s (synthesis {synthesis_s:.1f} s, train "
        f"{train_s:.1f} s)")
    return {"wall_s": wall, "synthesis_s": synthesis_s, "speak": speak,
            "card_vs_cpu": check, "times": times,
            "profile": {k: v for k, v in profile.items() if k != "top_kernels"},
            "train_s": train_s, "steps": steps, "ctc_launches": ctc_launches,
            "acoustic_metrics": rows, "moves": {k: v for k, v in moves.items()
                                                if k != "metrics"},
            "step_card_vs_cpu": step_check, "convert": convert,
            "voicepack_s": voicepack_s, "trained_speak": spoken}


# ---------------------------------------------------------------- phase 10

# the audiobook path: a seeded narration of 36 segments of 7-9 s of
# harmonic "speech" (as ``write_dataset``) with 0.6 s pauses, so that a
# segment and its half-pauses stay under ``vad_split``'s 10 s cap and VAD
# cuts at each pause; a book of one chapter with one sentence of 260-380
# phonemes per segment, so that the packer's 510 budget keeps one sentence
# per utterance (two pass it) and the pairing is one to one
BOOK_SEGMENTS = 36
BOOK_SPEECH_S = (7.0, 9.0)
BOOK_PAUSE_S = 0.6
BOOK_PHONEMES = (260, 380)
BOOK_MAX_SYMBOLS = 510
BOOK_VAL_FRACTION = 0.1
BOOK_WORDS = (
    "the morning was cold and road wet from rain she walked along river until found "
    "old stone bridge nobody had crossed it for years moss grew thick on every rail "
    "small boat drifted past its single lamp still burning her brother told wait there "
    "bells rang when did ring sound rolled over water like thunder counted each stroke "
    "at twelfth turned home house quiet fire in kitchen gone out garden window light"
).split()
# train-align on the audiobook corpus: 2 epochs, validation every 4 train
# steps, a checkpoint every 5
BOOK_EPOCHS = 2
BOOK_VAL_INTERVAL = 4
BOOK_SAVE_INTERVAL = 5
# remat: the acoustic step at full width on phase 6's 440-frame clips, bf16,
# slm on, in one child process per setting: each batch size in turn (2 steps;
# at B = 16 2 warm-up steps, the median of 4, one traced) until the first OOM.
# Cut to B = 24 to keep the script inside its time (the full sweep to 96
# found B = 32 out of memory with remat off, and B = 96 with it on)
REMAT_SIZES = (8, 16, 24)
REMAT_TIMED_B = 16
# the first step's mel, multi-phase and slm terms with remat against without
# (their forward runs the same kernels; the discriminators, bf16 with remat
# by the JAX rule, enter neither)
REMAT_FIRST_STEP_RTOL = 1e-3
# the OOM run: ``train --stage acoustic`` through the CLI in a child process
# under a memory cap between the B = 8 and B = 16 peaks (remat off), two
# epochs on phase 6's corpus (the skipped batches and the prefetched ones
# behind them can use up the first); its plan gives B = int(30 x 240 / 440)
# = 16 at 440 frames
OOM_PROBE_BATCH_MAX = 30
OOM_EPOCHS = 2


def write_narration(path: Path, n: int, seed: int) -> float:
    """``n`` segments of 7-9 s of harmonic "speech", each followed but the
    last by a pause of 0.6 s (a noise floor 1e-4), in one wav; returns its
    seconds."""
    import numpy as np

    from stylish_tts_torch.data.wav import write_wav

    rng = np.random.default_rng(seed)
    sr = 24000
    pieces = []
    for i in range(n):
        samples = int(rng.uniform(*BOOK_SPEECH_S) * sr)
        t = np.arange(samples) / sr
        f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        audio = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.2
        audio = audio * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t) ** 2)
        pieces.append(audio + 0.01 * rng.standard_normal(samples))
        if i < n - 1:
            pieces.append(1e-4 * rng.standard_normal(int(BOOK_PAUSE_S * sr)))
    audio = np.concatenate(pieces).astype(np.float32)
    write_wav(str(path), audio, sr)
    return audio.shape[0] / sr


def write_book(path: Path, n: int, seed: int):
    """One chapter of ``n`` sentences of plain words, each of 260-380
    phonemes under the port's ``phonemize`` (normalised first, as
    ``prepare_dataset`` measures them). Returns the sentences."""
    import numpy as np

    from stylish_tts_torch.textproc import normalize_text, phonemize

    rng = np.random.default_rng(seed)
    sentences = []
    while len(sentences) < n:
        words, target = [], int(rng.integers(BOOK_PHONEMES[0], BOOK_PHONEMES[1] + 1))
        while len(phonemize(normalize_text(" ".join(words)))) < target:
            words.append(str(rng.choice(BOOK_WORDS)))
        sentence = " ".join(words).capitalize() + "."
        if len(phonemize(normalize_text(sentence))) <= BOOK_PHONEMES[1]:
            sentences.append(sentence)
    path.write_text("Chapter 1\n" + " ".join(sentences) + "\n", encoding="utf-8")
    return sentences


def book_dataset(torch, work: Path):
    """``dataset-from-audiobook`` through the CLI: one segment per sentence,
    each phoneme string tokenized in full and at most 510 symbols."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.wav import read_wav
    from stylish_tts_torch.text import TextCleaner
    from stylish_tts_torch.textproc import g2p

    root = work / "audiobook"
    root.mkdir()
    seconds = write_narration(root / "narration.wav", BOOK_SEGMENTS, seed=40)
    sentences = write_book(root / "book.txt", BOOK_SEGMENTS, seed=41)
    data = root / "data"
    _, wall = cli(torch, "dataset-from-audiobook", "--audio", str(root / "narration.wav"),
                  "--book", str(root / "book.txt"), "--out", str(data), "--val-fraction",
                  str(BOOK_VAL_FRACTION), device=False)
    lines = []
    for split in ("train", "val"):
        lines += (data / f"{split}-list.txt").read_text(encoding="utf-8").splitlines()
    wavs = sorted((data / "wav-dir").glob("*.wav"))
    if not len(lines) == len(wavs) == len(sentences) == BOOK_SEGMENTS:
        fail(f"dataset-from-audiobook: {len(lines)} lines and {len(wavs)} segments for "
             f"{len(sentences)} sentences ({BOOK_SEGMENTS} narrated)")
    mc = ModelConfig()
    cleaner = TextCleaner(mc.symbol)
    lengths, clip_s = [], []
    for line in lines:
        name, phonemes = line.split("|")[:2]
        if len(cleaner(phonemes)) != len(phonemes) + 2 or len(phonemes) > BOOK_MAX_SYMBOLS:
            fail(f"{name}: {len(phonemes)} phonemes, {len(cleaner(phonemes)) - 2} of them "
                 f"tokenized (at most {BOOK_MAX_SYMBOLS}, all)")
        lengths.append(len(phonemes))
        clip_s.append(read_wav(str(data / "wav-dir" / name), mc.sample_rate).shape[0]
                      / mc.sample_rate)
    if not (BOOK_SPEECH_S[0] <= min(clip_s) and max(clip_s) <= 10.0):
        fail(f"audiobook segments of {min(clip_s):.2f}-{max(clip_s):.2f} s")
    backend = "espeak" if g2p.espeak_available() else "rules"
    log(f"dataset-from-audiobook ({backend} g2p): {seconds:.1f} s of narration -> "
        f"{len(lines)} segments of {min(clip_s):.2f}-{max(clip_s):.2f} s, phonemes "
        f"{min(lengths)}-{max(lengths)}, in {wall:.2f} s ({wall / (seconds / 60):.3f} s per "
        f"minute of narration)")
    return root, data, {"g2p_backend": backend, "narration_s": seconds, "wall_s": wall,
                        "s_per_narration_minute": wall / (seconds / 60),
                        "segments": len(lines), "sentences": len(sentences),
                        "phonemes_min_max": [min(lengths), max(lengths)],
                        "clip_s_min_max": [min(clip_s), max(clip_s)]}


def book_config(data: Path, path: Path) -> Path:
    """The audiobook corpus's YAML: the alignment plan written out in full."""
    import yaml

    from stylish_tts_torch.config import Config

    plan = Config().training_plan.alignment
    path.write_text(yaml.safe_dump({
        "dataset": {"path": str(data)},
        "training": {"log_interval": 1, "val_interval": BOOK_VAL_INTERVAL,
                     "save_interval": BOOK_SAVE_INTERVAL},
        "training_plan": {"alignment": {"epochs": BOOK_EPOCHS,
                                        "probe_batch_max": plan.probe_batch_max,
                                        "lr": plan.lr}},
    }), encoding="utf-8")
    return path


def book_train_align(torch, cfg, out):
    """``train-align`` on the audiobook corpus through the CLI, the CTC
    counts zeroed just before and read just after: alpha_beta = steps +
    validation batches, grad = steps."""
    import numpy as np

    from stylish_tts_torch.ops import ctc_cuda

    for name in ctc_cuda.LAUNCHES:
        ctc_cuda.LAUNCHES[name] = 0
    trainer, wall = cli(torch, "train-align", "--config", str(cfg), "--out", str(out),
                        "--record-steps")
    launches = dict(ctc_cuda.LAUNCHES)
    steps = len(trainer.losses)
    val_batches = sum(v["batches"] for v in trainer.validations)
    if not steps or not all(np.isfinite(trainer.losses)) or not trainer.validations:
        fail(f"audiobook train-align: losses {trainer.losses}, validations "
             f"{trainer.validations}")
    for v in trainer.validations:
        if not (np.isfinite(v["align_loss"]) and 0.0 < v["confidence"] <= 1.0):
            fail(f"audiobook validation at step {v['step']}: {v}")
    if launches != {"alpha_beta": steps + val_batches, "grad": steps} or not all(
            launches.values()):
        fail(f"audiobook train-align CTC launches {launches}; expected alpha_beta = "
             f"{steps} steps + {val_batches} validation batches, grad = {steps}")
    names = checkpoint_dirs(out / "alignment")
    log(f"train-align (audiobook): {steps} steps "
        f"({trainer.manifest.current_total_step} train-split), {len(trainer.validations)} "
        f"validations of {val_batches} batches in {wall:.1f} s; launches {launches}; loss "
        f"{trainer.losses[0]:.4f} -> {trainer.losses[-1]:.4f}; checkpoints {names}")
    return trainer, {"wall_s": wall, "steps": steps,
                     "train_steps": trainer.manifest.current_total_step,
                     "launches": launches, "validation_batches": val_batches,
                     "validations": trainer.validations, "checkpoints": names,
                     "loss_first_last": [trainer.losses[0], trainer.losses[-1]]}


def book_align(torch, data, cfg, out):
    """``align --method k2``: every segment's durations, one per token,
    summing to the frames of its duration bin."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.data.caches import load_cache
    from stylish_tts_torch.data.dataset import get_frame_count
    from stylish_tts_torch.text import TextCleaner

    _, seconds = cli(torch, "align", "--config", str(cfg), "--out", str(out),
                     "--method", "k2")
    cache = load_cache(str(data / "alignment.safetensors"))
    cleaner = TextCleaner(ModelConfig().symbol)
    n, frames_seen = 0, set()
    for split in ("train", "val"):
        ds = dataset(data, split)
        ds.time_bins()
        for seg in ds.segments:
            durs = cache.get(seg.wav_path)
            frames = get_frame_count(seg.time_bin)
            tokens = len(cleaner(seg.phonemes))
            frames_seen.add(frames)
            if durs is None or durs.shape != (1, tokens) or durs.sum() != frames:
                fail(f"alignment of {seg.wav_path}: "
                     f"{None if durs is None else (durs.shape, float(durs.sum()))}, "
                     f"{tokens} tokens, {frames} frames")
            n += 1
    log(f"align (audiobook): {n} segments in {seconds:.2f} s, bins of "
        f"{min(frames_seen)}-{max(frames_seen)} frames")
    return {"seconds": seconds, "segments": n, "frames_min_max": [min(frames_seen),
                                                                  max(frames_seen)]}


def book_kernel_check(torch, trainer, out):
    """Both CTC kernels against the plain version (phase 3's tolerances) at
    the corpus's largest train-align batch: the bin of the trainer's batch
    plan with the most frames x planned batch, its label lengths."""
    from stylish_tts_torch.data.collate import collate_batch
    from stylish_tts_torch.data.dataset import get_frame_count
    from stylish_tts_torch.data.sampler import BatchSizeTable
    from stylish_tts_torch.trainer.steps import StepContext

    table = BatchSizeTable(str(out / "alignment" / "alignment_batch_sizes.json"))
    ds = trainer.build_dataset(trainer.config.dataset.train_data)
    bins, _ = ds.time_bins()
    time_bin = max(bins, key=lambda k: (table.get(k) * get_frame_count(k), k))
    idxs = sorted(bins[time_bin])[:table.get(time_bin)]
    batch, _ = collate_batch([ds.load_segment(i) for i in idxs],
                             hop_length=trainer.mc.hop_length, require_pitch=False)
    ctx = StepContext(trainer.mc, trainer.config.loss_weight.model_dump(),
                      trainer.normalization)
    with torch.no_grad():
        t = ctx.norm_mel(torch.from_numpy(batch.audio_gt[:1]).cuda(),
                         ctx.to_align_mel).shape[-1]
    b, u = batch.text.shape
    spec = dict(b=b, t=t, c=ctx.blank_id + 1, u=u,
                label_lengths=batch.text_lengths.tolist(), input_lengths=[t] * b)
    result, _ = check_case(torch, "audiobook_batch", spec, seed=140)
    return result


def book_speak(torch, work: Path, root: Path):
    """``prepare-book --phonemize`` on the book through the synthesis CLI,
    then ``speak`` of its lines with phase 8's package and static
    voicepack: finite, in [-1, 1], each piece of 1 s or more at -25 +- 0.5
    LUFS; the longest line's tokens, the document's RTF."""
    import numpy as np

    from stylish_tts_torch.cli import tts_cli
    from stylish_tts_torch.data.wav import read_wav
    from stylish_tts_torch.export.package import TEXT_BUCKETS, InferencePackage
    from stylish_tts_torch.tts.loudness import integrated_loudness
    from stylish_tts_torch.tts.voicepack import load_voicepack, lookup_static_style

    lines_path, wav_path = root / "book_lines.txt", root / "book.wav"
    t0 = time.time()
    tts_cli.main(["prepare-book", "--text", str(root / "book.txt"), "--out",
                  str(lines_path), "--phonemize"], standalone_mode=False)
    prepare_s = time.time() - t0
    lines = [x for x in lines_path.read_text(encoding="utf-8").splitlines() if x.strip()]
    pkg = InferencePackage(str(work / "pkg"), device="cuda")
    tokens = [pkg.tokenize(x.strip()).shape[0] for x in lines]
    over = sum(n > TEXT_BUCKETS[-1] for n in tokens)
    if over:
        fail(f"prepare-book wrote {over} lines over the {TEXT_BUCKETS[-1]}-token bucket "
             f"(tokens {tokens})")
    t0 = time.time()
    tts_cli.main(["speak", "--model", str(work / "pkg"), "--voicepack",
                  str(work / "voicepack.safetensors"), "--text", str(lines_path), "--out",
                  str(wav_path), "--device", "cuda"], standalone_mode=False)
    torch.cuda.synchronize()
    speak_s = time.time() - t0
    wav = read_wav(str(wav_path), pkg.mc.sample_rate)
    if not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        fail("speak of the book wrote a wav that is not finite or leaves [-1, 1]")
    pack = load_voicepack(str(work / "voicepack.safetensors"))
    start, gen_s, lufs = 0, 0.0, []
    for line in lines:
        toks = pkg.tokenize(line.strip())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        audio = pkg.generate_speech(toks, *lookup_static_style(pack, toks.shape[0]))
        gen_s += time.perf_counter() - t1
        piece = wav[start:start + audio.shape[0]]
        start += audio.shape[0]
        seconds = audio.shape[0] / pkg.mc.sample_rate
        if seconds >= LUFS_MIN_SECONDS:
            lufs.append(integrated_loudness(piece, pkg.mc.sample_rate))
            if abs(lufs[-1] - LUFS_TARGET) > LUFS_TOL:
                fail(f"a {seconds:.2f} s piece of the book is at {lufs[-1]:.2f} LUFS")
    if start != wav.shape[0]:
        fail(f"speak wrote {wav.shape[0]} samples for the book; its lines add up to {start}")
    audio_s = wav.shape[0] / pkg.mc.sample_rate
    log(f"prepare-book --phonemize: {len(lines)} lines in {prepare_s:.2f} s, tokens "
        f"{min(tokens)}-{max(tokens)}; speak {audio_s:.1f} s of audio in {speak_s:.2f} s "
        f"(RTF {speak_s / audio_s:.5f} with loading; lines alone {gen_s / audio_s:.5f}); "
        f"LUFS {min(lufs):.2f}..{max(lufs):.2f}")
    return {"lines": len(lines), "prepare_s": prepare_s, "tokens_max": max(tokens),
            "tokens_min": min(tokens), "lines_over_512": over, "speak_s": speak_s,
            "audio_s": audio_s, "rtf": speak_s / audio_s, "rtf_lines": gen_s / audio_s,
            "lufs_min_max": [min(lufs), max(lufs)]}


def remat_probe(torch, data: Path, remat: bool) -> dict:
    """The acoustic step at full width (bf16, slm on, ``generator.remat`` as
    given) on the first B clips of phase 6's corpus, B in ``REMAT_SIZES``
    until the first OOM: each size's peak memory after 2 steps (the first
    allocates the AdamW moments); at B = 16 the step timed and traced."""
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models.slm import random_wavlm, wavlm_loss
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.steps import StepContext, batch_to_device, make_acoustic_step

    free, total = torch.cuda.mem_get_info()
    mc = ModelConfig()
    mc.generator.remat = remat
    state = stage_state(torch, mc, "cuda")
    state.wavlm = random_wavlm(0).cuda().eval().requires_grad_(False)
    ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                      stage_steps=10_000, slm_loss_fn=wavlm_loss, mixed_precision=True)
    step = make_acoustic_step(ctx)
    sizes = {}
    for b in REMAT_SIZES:
        batch = batch_to_device(acoustic_batch(torch, data, b), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed, metrics = [], []
        try:
            for _ in range(6 if b == REMAT_TIMED_B else 2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                m = step(state, batch)
                end.record()
                end.synchronize()
                timed.append(start.elapsed_time(end))
                metrics.append({k: float(v) for k, v in m.items()})
            oom = False
        except torch.OutOfMemoryError:
            oom = True
        peak = torch.cuda.max_memory_allocated()
        if oom:
            sizes[b] = {"oom": True, "peak_bytes_at_oom": peak}
            log(f"remat {remat}: B={b} out of memory (peak {peak / 2**30:.2f} GiB)")
            break
        row = {"oom": False, "peak_bytes": peak, "step_ms": timed, "metrics": metrics}
        if b == REMAT_TIMED_B:
            row["step_ms_median"] = statistics.median(timed[2:])
            prof = profile_ranges(torch, lambda: step(state, batch), ())
            row.update(device_ms=prof["device_ms"], launches=prof["launches"],
                       traced_wall_ms=prof["traced_wall_ms"])
        sizes[b] = row
        log(f"remat {remat}: B={b} peak {peak / 2**30:.2f} GiB, steps "
            f"{[round(x, 1) for x in timed]} ms")
    fits = [b for b, r in sizes.items() if not r["oom"]]
    return {"remat": remat, "sizes": sizes, "largest_b": max(fits) if fits else 0,
            "free_bytes_at_start": free, "total_bytes": total}


def oom_run(torch, work: Path, cap: int) -> dict:
    """``train --stage acoustic`` through the CLI under a memory cap of
    ``cap`` bytes (``set_per_process_memory_fraction``), with the plan's
    B = 16 at 440 frames, alone (the later stages are not run), two epochs
    on phase 6's corpus: the OOMs logged, the saved table, the steps that
    ran."""
    import re

    import numpy as np
    import yaml

    from stylish_tts_torch.trainer import loop

    root = work / "oom"
    root.mkdir()
    cfg, model_cfg = acoustic_configs(work / "data", root, acoustic_epochs=OOM_EPOCHS,
                                      save_interval=1000)
    raw = yaml.safe_load(cfg.read_text(encoding="utf-8"))
    raw["training_plan"]["acoustic"]["probe_batch_max"] = OOM_PROBE_BATCH_MAX
    raw["training"]["val_interval"] = 1000
    cfg.write_text(yaml.safe_dump(raw), encoding="utf-8")
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total)
    loop.NEXT_STAGE.clear()  # this child process runs the acoustic stage alone
    trainer, wall = cli(torch, "train", "--stage", "acoustic", "--config", str(cfg),
                        "--model-config", str(model_cfg), "--out", str(root / "out"),
                        "--record-steps")
    peak = torch.cuda.max_memory_allocated()
    text = (root / "out" / "acoustic" / "train.log").read_text(encoding="utf-8")
    shrinks = [[int(x) for x in m] for m in re.findall(
        r"OOM on bin (\d+) at batch size (\d+); batch size lowered to (\d+)", text)]
    stale = len(re.findall(r"OOM on stale prefetched batch", text))
    table = json.loads((root / "out" / "acoustic" / "acoustic_batch_sizes.json")
                       .read_text(encoding="utf-8"))
    sizes = [len(b) for b in trainer.batches]
    finite = all(np.isfinite(list(m.values())).all() for m in trainer.step_metrics)
    return {"cap_bytes": cap, "peak_bytes": peak, "wall_s": wall, "shrinks": shrinks,
            "stale_skips": stale, "table": table, "batch_sizes": sizes,
            "steps": trainer.manifest.current_total_step,
            "step_records": len(trainer.step_metrics), "finite": finite,
            "mel_first_last": [trainer.step_metrics[0]["mel"],
                               trainer.step_metrics[-1]["mel"]] if sizes else None}


def child(torch, flag: str, *args) -> dict:
    """Run this script's ``flag`` in a child process (the remat probes and
    the OOM run: an expected OOM, and the memory cap, stay there); returns
    the JSON it writes. This process hands its allocator's cached blocks
    back first, so that the child has the card's memory but what this
    process holds live."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"child {flag}: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved); the card has "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_child_") as tmp:
        out = Path(tmp) / "result.json"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag,
                               *map(str, args), str(out)], timeout=600)
        if proc.returncode != 0 or not out.is_file():
            fail(f"child {flag} {args} exited {proc.returncode}")
        return json.loads(out.read_text(encoding="utf-8"))


def child_main(argv) -> int:
    """``chip_smoke.py --remat-probe 0|1 DATA OUT``, ``--oom-run WORK CAP
    OUT``, ``--ctc-checked B T C U OUT`` or ``--dp-rank RANK STORE BATCH
    DATA OUT``: one measurement in this process, its result written to
    OUT."""
    torch = require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flag, *args, out = argv
    if flag == "--remat-probe":
        result = remat_probe(torch, Path(args[1]), args[0] == "1")
    elif flag == "--oom-run":
        result = oom_run(torch, Path(args[0]), int(args[1]))
    elif flag == "--ctc-checked":
        result = ctc_checked(torch, tuple(map(int, args)))
    elif flag == "--dp-rank":
        result = dp_rank_main(torch, int(args[0]), args[1], args[2], args[3])
    elif flag == "--mesh-rank":
        result = mesh_rank_main(torch, args[0], int(args[1]), args[2], args[3])
    elif flag == "--capture-fails":
        result = capture_fails(torch)
    else:
        fail(f"unknown flag {flag}")
    Path(out).write_text(json.dumps(result), encoding="utf-8")
    return 0


def book_remat(torch, work: Path) -> dict:
    """The remat probes (off, then on), each in its own process; one fp32
    step with remat on, card against CPU."""
    from stylish_tts_torch.config import ModelConfig

    probes = {name: child(torch, "--remat-probe", int(on), work / "data")
              for name, on in (("off", False), ("on", True))}
    for name, p in probes.items():
        if not all(str(b) in p["sizes"] and not p["sizes"][str(b)]["oom"]
                   for b in (8, REMAT_TIMED_B)):
            fail(f"remat {name}: B = 8 or 16 did not fit: {p['sizes']}")
    # the first step's forward (the same weights and batch, the generator's
    # bf16 autocast either way): the terms the discriminators do not enter
    first = {k: probes[k]["sizes"]["8"]["metrics"][0] for k in ("off", "on")}
    probes["first_step_rel_err"] = {
        k: abs(first["on"][k] - first["off"][k]) / abs(first["off"][k])
        for k in ("mel", "multi_phase", "slm")}
    if max(probes["first_step_rel_err"].values()) > REMAT_FIRST_STEP_RTOL:
        fail(f"the first step with remat against without: {probes['first_step_rel_err']} "
             f"(<= {REMAT_FIRST_STEP_RTOL})")
    mc = ModelConfig()
    mc.generator.remat = True
    probes["card_vs_cpu"] = acoustic_card_vs_cpu(torch, work / "data", mc)
    off, on = (probes[k]["sizes"][str(REMAT_TIMED_B)] for k in ("off", "on"))
    log(f"remat at B={REMAT_TIMED_B}: step {off['step_ms_median']:.1f} -> "
        f"{on['step_ms_median']:.1f} ms, device {off['device_ms']:.1f} -> "
        f"{on['device_ms']:.1f} ms, launches {off['launches']} -> {on['launches']}, peak "
        f"{off['peak_bytes'] / 2**30:.2f} -> {on['peak_bytes'] / 2**30:.2f} GiB; largest B "
        f"that fits {probes['off']['largest_b']} -> {probes['on']['largest_b']}")
    return probes


def book_oom(torch, work: Path, probe_off: dict) -> dict:
    """The OOM run in a child process, its cap halfway between the B = 8 and
    B = 16 peaks without remat: at least one OOM, each lowering by the 0.9
    rule, the saved table at the lowered size, finite metrics, the peak under
    the cap, the steps only those that ran."""
    p8, p16 = (probe_off["sizes"][str(b)]["peak_bytes"] for b in (8, REMAT_TIMED_B))
    run = child(torch, "--oom-run", work, (p8 + p16) // 2)
    shrinks, sizes = run["shrinks"], run["batch_sizes"]
    chain = all(new == max(int(old * 0.9), 1) for _, old, new in shrinks)
    final = min(new for _, _, new in shrinks) if shrinks else None
    if (not shrinks or not chain or list(run["table"].values()) != [final]
            or not run["finite"] or run["peak_bytes"] > run["cap_bytes"]
            or not run["steps"] == run["step_records"] == len(sizes) or not sizes
            or sizes[-1] > final):
        fail(f"OOM run under a cap of {run['cap_bytes'] / 2**30:.2f} GiB: {run}")
    log(f"OOM run: cap {run['cap_bytes'] / 2**30:.2f} GiB, shrinks {shrinks}, stale "
        f"skips {run['stale_skips']}, table {run['table']}, {run['steps']} steps at sizes "
        f"{sizes}, peak {run['peak_bytes'] / 2**30:.2f} GiB, {run['wall_s']:.1f} s")
    return run


def phase_audiobook(torch, work: Path, card: str):
    """The audiobook path in phase 6's directory: narration and a book ->
    ``dataset-from-audiobook`` -> ``pitch`` -> ``train-align`` -> ``align``
    (the CTC kernels on it, and held against the plain version at its
    largest batch) -> ``prepare-book --phonemize`` -> ``speak`` with phase
    8's voice; then remat and the OOM shrink-and-skip."""
    t0 = time.time()
    root, data, report = book_dataset(torch, work)
    report = {"dataset": report}
    cfg = book_config(data, root / "book.yml")
    out = root / "out"
    _, report["pitch_s"] = cli(torch, "pitch", "--config", str(cfg), "--out", str(out))
    trainer, report["train_align"] = book_train_align(torch, cfg, out)
    report["align"] = book_align(torch, data, cfg, out)
    report["kernel_check"] = book_kernel_check(torch, trainer, out)
    report["speak"] = book_speak(torch, work, root)
    report["path_s"] = time.time() - t0
    report["remat"] = book_remat(torch, work)
    report["oom"] = book_oom(torch, work, report["remat"]["off"])
    report["wall_s"] = time.time() - t0
    log(f"audiobook phase: {report['wall_s']:.1f} s (the path {report['path_s']:.1f} s)")
    return report


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 11

# import-torch: a seeded accelerate checkpoint in the reference layout at the
# full ModelConfig() (weight norm, spectral norm and BatchNorm sites; the F0
# head's bias at F0_BIAS_HZ, as phase 5's voice), imported, exported and
# spoken; on phase 6's corpus, in its directory
IMPORT_SEED = 5


def imported_checkpoint(torch, root: Path, cfg: Path, model_cfg: Path):
    """The reference checkpoint written and ``import-torch`` through the CLI:
    a ``duration`` checkpoint with ``imported_weights`` and the affine norm in
    its model config, every leaf of its twelve modules and of the aligner
    beside it bitwise the tree that ``import_torch_checkpoint`` returns for
    the same files; seconds and MB."""
    import numpy as np
    from safetensors.numpy import load_file

    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.convert.checkpoint_import import import_torch_checkpoint
    from stylish_tts_torch.convert.from_jax import flatten, module_to_jax_flat
    from stylish_tts_torch.convert.reference_layout import (
        reference_state_dicts, write_accelerate_checkpoint)
    from stylish_tts_torch.models import build_models, build_text_aligner
    from stylish_tts_torch.trainer.checkpoint import ALIGNER_FILE, STATE_FILE, read_manifest
    from stylish_tts_torch.utils.params_io import load_text_aligner_safetensors

    t0 = time.time()
    sds, _ = reference_state_dicts(ModelConfig(), IMPORT_SEED)
    sds["pitch_energy_predictor"]["F0_proj.bias"][:] = F0_BIAS_HZ
    paths = write_accelerate_checkpoint(str(root / "reference"), sds)
    write_s = time.time() - t0
    reference_mb = sum(Path(p).stat().st_size for p in paths) / 1e6
    ckpt, import_s = cli(torch, "import-torch", "--config", str(cfg), "--model-config",
                         str(model_cfg), "--checkpoint", str(root / "reference"), "--out",
                         str(root / "out"), device=False)
    ckpt = Path(ckpt)
    mc = ModelConfig.model_validate_json((ckpt / "model_config.json").read_text(
        encoding="utf-8"))
    if (read_manifest(str(ckpt)).stage != "duration" or not mc.imported_weights
            or mc.generator.norm_mode != "affine"):
        fail(f"import-torch wrote stage {read_manifest(str(ckpt)).stage}, imported_weights "
             f"{mc.imported_weights}, norm_mode {mc.generator.norm_mode}")
    params = import_torch_checkpoint(str(root / "reference"), ModelConfig())
    skeleton = build_models(mc)
    got = {name: module_to_jax_flat(skeleton[name], sd)
           for name, sd in saved_models(torch, ckpt).items()}
    got["text_aligner"] = load_file(str(ckpt / ALIGNER_FILE))
    want = {name: {f"params/{k}": v for k, v in flatten(params[name]["params"]).items()}
            for name in params}
    differ = [f"{name}/{k}" for name in want for k, v in want[name].items()
              if not np.array_equal(got.get(name, {}).get(k), v)]
    leaves = sum(len(v) for v in want.values())
    if set(got) != set(want) or differ or leaves != sum(len(v) for v in got.values()):
        fail(f"import-torch: modules {sorted(got)}, {len(differ)} of {leaves} leaves differ "
             f"from import_torch_checkpoint's ({differ[:5]})")
    load_text_aligner_safetensors(str(ckpt / ALIGNER_FILE), build_text_aligner(mc))
    checkpoint_mb = sum(p.stat().st_size for p in (ckpt / STATE_FILE, ckpt / ALIGNER_FILE)) / 1e6
    n_params = sum(int(np.prod(v.shape)) for tree in want.values() for v in tree.values())
    log(f"import-torch: reference checkpoint {reference_mb:.1f} MB written in {write_s:.2f} s; "
        f"imported in {import_s:.2f} s ({n_params:,} parameters); {leaves} leaves of 13 "
        f"modules bitwise; checkpoint {checkpoint_mb:.1f} MB")
    return ckpt, mc, {"write_s": write_s, "reference_mb": reference_mb, "import_s": import_s,
                      "parameters": n_params, "leaves_bitwise": leaves,
                      "checkpoint_mb": checkpoint_mb}


def phase_imported(torch, work: Path, card: str):
    """``import-torch`` of a seeded reference checkpoint at the full
    ``ModelConfig()``, then ``convert`` (every leaf bitwise), ``voicepack``
    (static; the styles card vs CPU) and ``speak`` of the 8 lines (as phase
    8 holds them), the card against the CPU on the 60-token line (as phase
    5), and the 510-token acoustic call traced
    (``chiprun_out/profile_imported_speak.json``); the CTC counts zeroed
    before and read after (0: nothing here runs the CTC)."""
    from stylish_tts_torch.export.package import InferencePackage
    from stylish_tts_torch.ops import ctc_cuda
    from stylish_tts_torch.tts.voicepack import load_voicepack

    for name in ctc_cuda.LAUNCHES:
        ctc_cuda.LAUNCHES[name] = 0
    t0 = time.time()
    data, root = work / "data", work / "imported"
    root.mkdir()
    cfg, model_cfg = acoustic_configs(data, root)
    ckpt, mc, report = imported_checkpoint(torch, root, cfg, model_cfg)
    pkg_dir, report["convert"] = recipe_convert(torch, root, ckpt, mc)
    voicepack = root / "voicepack.safetensors"
    styles, report["voicepack_s"] = cli(torch, "voicepack", "--config", str(cfg),
                                        "--model-config", str(model_cfg), "--checkpoint",
                                        str(ckpt), "--out", str(voicepack))
    report["styles_card_vs_cpu"], report["styles_batch_ms"] = styles_card_vs_cpu(
        torch, data, ckpt, mc, styles)
    log(f"voicepack of the imported voice: {styles['lengths'].shape[0]} segments in "
        f"{report['voicepack_s']:.2f} s; card vs CPU {report['styles_card_vs_cpu']}")
    report["speak"] = recipe_speak(torch, root, pkg_dir, voicepack, voice="imported")
    pkg, pack = InferencePackage(str(pkg_dir), device="cuda"), load_voicepack(str(voicepack))
    lines = speak_lines(2, SPEAK_TOKENS)
    report["card_vs_cpu"] = phase_card_vs_cpu(torch, pkg, pack, root, lines[SHORT_LINE])
    profile = phase_speak_profile(torch, pkg, pack, lines[-1])
    profile["card"] = card
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_imported_speak.json").write_text(json.dumps(profile, indent=1))
    report["profile"] = {k: v for k, v in profile.items() if k != "top_kernels"}
    report["ctc_launches"] = dict(ctc_cuda.LAUNCHES)
    if any(report["ctc_launches"].values()):
        fail(f"the imported voice's export and synthesis launched a CTC kernel: "
             f"{report['ctc_launches']}")
    report["wall_s"] = time.time() - t0
    log(f"imported phase: {report['wall_s']:.1f} s")
    return report


# ---------------------------------------------------------------- phase 12

# data parallel (``stylish_tts_torch/parallel``): world size 1 through NCCL
# bitwise against no process group; two gloo ranks on the one card (NCCL
# refuses two ranks on one device) against one process on the same rows;
# the bounds-checked CTC build; ``train --profile``; the FLOP count
DP_ALIGN_STEPS = 6
DP_ACOUSTIC_STEPS = 3
DP_ALIGN_B = 68  # global, 34 rows a rank
DP_ACOUSTIC_B = 8  # global, 4 rows a rank, fp32
DP_FORCED = 1
DP_METRIC_RTOL = 1e-6  # measured on an H100: 1.1e-7
DP_PRIOR_ATOL = 1e-5
DP_WEIGHT_RTOL = 1e-3  # L2 error of a module's weights over the step's move
# the acoustic step's weights: AdamW's first step moves an element by
# lr x sign(g), and the elements whose gradient is float noise (a conv bias
# before a norm) take either sign (the card-vs-CPU tolerance of phase 7)
DP_ACOUSTIC_WEIGHT_RTOL = CARD_CPU_WEIGHT_RTOL
DP_GRAD_RTOL = 1e-3  # L2 error of a module's averaged gradient over its norm
# the TPRLS medians' values (scores of O(0.1-1)): a neighbour swap moves one
# by ~1e-6, a rank's own median would miss the global one by ~5e-4
DP_MEDIAN_ATOL = 1e-5
H100_BF16_DENSE_FLOP_PER_S = 989e12


def _snapshot(torch, modules):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in modules.items()}


def _record_grads(steps_mod):
    """Patch ``steps.apply_module_update`` to keep each module's averaged
    gradient (as AdamW gets it); returns the dict it fills and the undo."""
    grads, real = {}, steps_mod.apply_module_update

    def update(module, optimizer, lr, finite=None):
        grads[id(module)] = [p.grad.detach().clone() for p in module.parameters()
                             if p.grad is not None]
        return real(module, optimizer, lr, finite)

    steps_mod.apply_module_update = update
    return grads, lambda: setattr(steps_mod, "apply_module_update", real)


def dp_align_run(torch, batch, n_steps, rows=None, dropout=True):
    """``n_steps`` alignment steps at the full ``ModelConfig()`` from seed 0
    on ``batch`` (its ``rows``: this rank's), the priors refreshed halfway,
    the aligner's dropout off unless ``dropout`` (each rank draws its own):
    losses, the priors' accumulators and priors, the weights before and
    after, the first step's averaged gradient, each step's ms and its CTC
    launches."""
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import build_text_aligner
    from stylish_tts_torch.ops import ctc_cuda
    from stylish_tts_torch.trainer import steps as steps_mod
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.state import create_train_state

    if rows is not None:
        batch = type(batch)(*(None if x is None else x[rows] for x in batch))
    mc = ModelConfig()
    torch.manual_seed(0)
    state = create_train_state(build_text_aligner(mc), mc.text_encoder.tokens + 1, "cuda")
    if not dropout:
        state.aligner.dropout = 0.0
    ctx = steps_mod.StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                                stage_steps=1000, base_lr=1e-4)
    step = steps_mod.make_alignment_step(ctx)
    before = _snapshot(torch, {"text_aligner": state.aligner})
    grads, undo = _record_grads(steps_mod)
    launches = dict(ctc_cuda.LAUNCHES)
    losses, ms, first_grad = [], [], None
    try:
        for i in range(n_steps):
            if i == n_steps // 2 and i:
                state = steps_mod.finish_alignment_epoch(ctx, state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(state, batch)["align_loss"].detach().clone())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            first_grad = first_grad or grads.get(id(state.aligner))
    finally:
        undo()
    return {"losses": torch.stack(losses).cpu(), "step_ms": ms, "before": before,
            "after": _snapshot(torch, {"text_aligner": state.aligner}),
            "grads": {"text_aligner": [g.cpu() for g in first_grad]},
            "priors": {k: getattr(state, k).detach().cpu().clone()
                       for k in ("log_priors_sum", "prior_count", "log_priors")},
            "launches": {k: ctc_cuda.LAUNCHES[k] - launches[k] for k in launches}}


def dp_acoustic_run(torch, data, b, n_steps, prior=None, rows=None):
    """``n_steps`` acoustic steps from seed 0 on ``b`` corpus clips (its
    ``rows``): bf16 with the slm term (as phase 7 times the step), or, with
    an injected excitation ``prior`` (B, S), fp32 with the parity switches
    and MRD ``DP_FORCED`` on PyTorch's own convolutions (cuDNN off: they
    compute each row alone, where cuDNN's choice of algorithm follows the
    batch), the TPRLS medians' gradient stopped (see ``dp_two_ranks``);
    metrics, the four stepped modules' weights before and after, the first
    step's averaged gradients, the TPRLS medians' values, each step's ms."""
    from stylish_tts_torch import losses
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models.slm import random_wavlm, wavlm_loss
    from stylish_tts_torch.trainer import steps as steps_mod
    from stylish_tts_torch.trainer.normalization import NormalizationStats

    fp32 = prior is not None
    batch = acoustic_batch(torch, data, b)
    if rows is not None:
        batch = type(batch)(*(None if x is None else x[rows] for x in batch))
        prior = None if prior is None else prior[rows]
    batch = steps_mod.batch_to_device(batch, "cuda")
    mc = ModelConfig()
    state = stage_state(torch, mc, "cuda")
    names = ("speech_predictor", "speech_style_encoder", f"mrd{DP_FORCED}", "disc")
    if fp32:
        ctx = steps_mod.StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                                    stage_steps=10_000, parity_deterministic=True,
                                    parity_prior=prior.cuda(), forced_disc_index=DP_FORCED)
    else:
        state.wavlm = random_wavlm(0).cuda().eval().requires_grad_(False)
        ctx = steps_mod.StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                                    stage_steps=10_000, slm_loss_fn=wavlm_loss,
                                    mixed_precision=True)
    step = steps_mod.make_acoustic_step(ctx)
    before = _snapshot(torch, {n: state.models[n] for n in names}) if fp32 else None
    grads, undo = _record_grads(steps_mod)
    medians, real_median = [], losses._median_lower

    def median(x):
        m = real_median(x)
        medians.append(float(m))
        return m.detach()

    losses._median_lower = median
    torch.backends.cudnn.enabled = not fp32
    metrics, ms, first = [], [], None
    try:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = {n: [g.cpu() for g in grads[id(state.models[n])]] for n in names
                         if id(state.models[n]) in grads}
    finally:
        undo()
        losses._median_lower = real_median
        torch.backends.cudnn.enabled = True
    out = {"metrics": metrics, "step_ms": ms, "grads": first, "state": state, "batch": batch,
           "ctx": ctx, "medians": medians}
    if fp32:
        out.update(before=before, after=_snapshot(torch, {n: state.models[n] for n in names}))
    return out


def _weights_equal(torch, a, b) -> bool:
    return all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


def dp_world_one(torch, align_batch, data, work: Path) -> dict:
    """(a) World size 1 through NCCL (a file store, rank 0 of 1) against no
    process group: ``DP_ALIGN_STEPS`` alignment steps on the main path's
    batch and ``DP_ACOUSTIC_STEPS`` bf16 acoustic steps at B = 16, losses,
    priors and weights bitwise, with deterministic cuDNN; each without a
    group a second time, which says whether the card repeats itself. The
    collectives' cost: one NCCL all-reduce of each step's gradients and one
    flag on the host group, at world size 1."""
    import torch.distributed as dist

    from stylish_tts_torch import parallel
    from stylish_tts_torch.parallel import mesh

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for name in ("no_group", "group", "no_group_again"):
            if name == "group":
                parallel.init_data_parallel(backend="nccl", rank=0, world_size=1,
                                            init_method=f"file://{work / 'store_ws1'}",
                                            device="cuda:0")
            try:
                align = dp_align_run(torch, align_batch, DP_ALIGN_STEPS)
                acoustic = dp_acoustic_run(torch, data, ACOUSTIC_B, DP_ACOUSTIC_STEPS)
                if name == "group":
                    cost = {}
                    for what, grads in (("align", align["grads"]["text_aligner"]),
                                        ("acoustic", [g for n in ("speech_predictor",
                                                                  "speech_style_encoder")
                                                      for g in acoustic["grads"][n]])):
                        flat = torch.cat([g.reshape(-1) for g in grads]).cuda()
                        cost[f"{what}_grad_all_reduce_ms"] = median_ms(
                            torch, lambda: dist.all_reduce(flat), n=10, sleep=False)
                        cost[f"{what}_grad_elements"] = flat.numel()
                    t0 = time.perf_counter()
                    for _ in range(100):
                        mesh._host_all_reduce([1.0], dist.ReduceOp.MIN)
                    cost["host_flag_ms"] = (time.perf_counter() - t0) * 10
            finally:
                parallel.shutdown()
            acoustic.update(weights=_snapshot(torch, acoustic["state"].models))
            for k in ("state", "batch", "ctx"):
                acoustic.pop(k)
            runs[name] = {"align": align, "acoustic": acoustic}
    finally:
        torch.backends.cudnn.deterministic = False
    same = {}
    for other in ("group", "no_group_again"):
        a, b = runs["no_group"], runs[other]
        same[other] = {
            "align_losses": torch.equal(a["align"]["losses"], b["align"]["losses"]),
            "align_priors": all(torch.equal(a["align"]["priors"][k], b["align"]["priors"][k])
                                for k in a["align"]["priors"]),
            "align_weights": _weights_equal(torch, a["align"]["after"], b["align"]["after"]),
            "acoustic_metrics": a["acoustic"]["metrics"] == b["acoustic"]["metrics"],
            "acoustic_weights": _weights_equal(torch, a["acoustic"]["weights"],
                                               b["acoustic"]["weights"])}
    ms = {name: {"align_step_ms": statistics.median(r["align"]["step_ms"][1:]),
                 "acoustic_step_ms": statistics.median(r["acoustic"]["step_ms"][1:])}
          for name, r in runs.items()}
    log(f"dp world size 1: bitwise with the group {same['group']}; a second run without "
        f"{same['no_group_again']}; step ms {ms}; collectives {cost}")
    if not all(same["group"].values()):
        fail(f"world size 1 through NCCL is not bitwise the run without a group: {same}")
    return {"bitwise": same, "step_ms": ms, "collectives_ws1": cost,
            "align_launches": runs["group"]["align"]["launches"]}


def children(torch, flag: str, arg_lists, timeout: int = 600) -> list:
    """This script's ``flag`` in one child process per argument list, all at
    once; returns their JSON results in order (``child`` for one)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_children_") as tmp:
        outs = [Path(tmp) / f"result{i}.json" for i in range(len(arg_lists))]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag,
                                   *map(str, args), str(out)])
                 for args, out in zip(arg_lists, outs)]
        try:
            codes = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes) or not all(o.is_file() for o in outs):
            fail(f"children {flag} exited {codes}")
        return [json.loads(o.read_text(encoding="utf-8")) for o in outs]


def _rel(torch, a, b) -> float:
    """The L2 distance of the tensors ``a`` from ``b`` over the norm of ``b``."""
    return _l2(torch, a, b) / max(_l2(torch, b, [torch.zeros_like(y) for y in b]), 1e-300)


def _l2(torch, a, b) -> float:
    return sum(float(torch.linalg.vector_norm((x - y).double())) ** 2
               for x, y in zip(a, b)) ** 0.5


def _weight_err_over_move(torch, before, after, ref_after) -> dict:
    """Per module, the L2 distance of ``after`` from ``ref_after`` over
    the reference step's move from ``before``."""
    out = {}
    for n, ref in ref_after.items():
        keys = sorted(ref)
        move = _l2(torch, [ref[k] for k in keys], [before[n][k] for k in keys])
        out[n] = _l2(torch, [after[n][k] for k in keys], [ref[k] for k in keys]) / max(move,
                                                                                     1e-300)
    return out


def dp_rank_main(torch, rank: int, store: str, align_path: str, data: str) -> dict:
    """One of two gloo ranks on ``cuda:0``: one alignment step on its 34 of
    ``DP_ALIGN_B`` rows (the CTC kernels' launches counted), both kernels
    held against the plain version at its shard's shape, one fp32 acoustic
    step on its 4 of ``DP_ACOUSTIC_B`` rows; its results, the first
    averaged gradients and the weights after, to files beside ``store``."""
    from stylish_tts_torch import parallel
    from stylish_tts_torch.ops import ctc_cuda
    from stylish_tts_torch.trainer.steps import Batch

    parallel.init_data_parallel(backend="gloo", rank=rank, world_size=2,
                                init_method=f"file://{store}", device="cuda:0", timeout_s=300)
    try:
        saved = torch.load(align_path, weights_only=True)
        batch = Batch(*(None if x is None else x.cuda() for x in saved["batch"]))
        rows = list(parallel.shard_rows(range(DP_ALIGN_B)))
        for k in ctc_cuda.LAUNCHES:
            ctc_cuda.LAUNCHES[k] = 0
        collectives = dict(parallel.COLLECTIVES)
        align = dp_align_run(torch, batch, 1, rows=rows, dropout=False)
        align_collectives = {k: parallel.COLLECTIVES[k] - collectives[k] for k in collectives}
        b, t, c, u = saved["shape"]
        spec = dict(b=len(rows), t=t, c=c, u=u,
                    label_lengths=saved["batch"][2][rows].tolist(), input_lengths=[t] * len(rows))
        check, _ = check_case(torch, f"dp rank {rank}", spec, seed=200 + rank)
        acoustic_rows = list(parallel.shard_rows(range(DP_ACOUSTIC_B)))
        collectives = dict(parallel.COLLECTIVES)
        acoustic = dp_acoustic_run(torch, Path(data), DP_ACOUSTIC_B, 1, prior=saved["prior"],
                                   rows=acoustic_rows)
        acoustic_collectives = {k: parallel.COLLECTIVES[k] - collectives[k]
                                for k in collectives}
        torch.save({"align": {k: align[k] for k in ("after", "grads", "priors", "losses")},
                    "acoustic": {k: acoustic[k] for k in ("after", "grads")}},
                   f"{store}.rank{rank}.pt")
    finally:
        parallel.shutdown()
    return {"rank": rank, "align_loss": float(align["losses"][0]),
            "align_step_ms": align["step_ms"][0], "align_launches": align["launches"],
            "align_collectives": align_collectives, "acoustic_metrics": acoustic["metrics"][0],
            "acoustic_step_ms": acoustic["step_ms"][0], "acoustic_medians": acoustic["medians"],
            "acoustic_collectives": acoustic_collectives, "kernel_check": check}


def dp_two_ranks(torch, align_batch, data, work: Path) -> dict:
    """(b) Two gloo ranks on the one card (children of this process) against
    one process on the same rows: the alignment step on ``DP_ALIGN_B`` rows
    and the fp32 acoustic step on ``DP_ACOUSTIC_B``: metrics ``DP_METRIC_RTOL``,
    priors ``DP_PRIOR_ATOL``, averaged gradients ``DP_GRAD_RTOL``, weights
    ``DP_WEIGHT_RTOL`` of the step's move (the acoustic step's
    ``DP_ACOUSTIC_WEIGHT_RTOL``); the CTC kernels launched in both ranks.

    The acoustic comparison takes an injected excitation (the deterministic
    sine source accumulates its phase with a scan whose rounding follows the
    batch) and PyTorch's own convolutions (cuDNN's choice of algorithm
    follows the batch). The kernels still round a row's scores differently
    in a batch of 4 and of 8, by ~1e-7, and that swaps most TPRLS medians
    (lower medians of ~100,000 scores) with a neighbour: the median
    element's gradient is the sum of all the others', so a swap moves a
    module's gradient by up to its own size (measured: 14 of 22 medians,
    the speech predictor's gradient by 0.28). So the medians' values are
    held (``DP_MEDIAN_ATOL``: global medians), and the gradients with the
    medians' gradient stopped on both
    sides (a patch of this comparison only; the gradient through the
    gathered median is held against JAX exactly in
    tests/test_torch_parallel.py)."""
    from stylish_tts_torch.trainer.steps import Batch

    rows = list(range(DP_ALIGN_B))
    cut = Batch(*(None if x is None else x[rows] for x in align_batch))
    with torch.no_grad():
        from stylish_tts_torch.config import ModelConfig
        from stylish_tts_torch.trainer.normalization import NormalizationStats
        from stylish_tts_torch.trainer.steps import StepContext

        ctx = StepContext(ModelConfig(), {}, NormalizationStats())
        frames = ctx.norm_mel(cut.audio_gt[:1], ctx.to_align_mel).shape[-1]
    shape = (DP_ALIGN_B, frames, ctx.blank_id + 1, cut.text.shape[1])
    align_path = work / "dp_align_batch.pt"
    with torch.no_grad():  # the step's frames: the even mel frames of the audio
        frames = ctx.norm_mel(torch.as_tensor(acoustic_batch(torch, data, 1).audio_gt),
                              ctx.to_mel).shape[-1]
    samples = ModelConfig().hop_length * frames
    gen = torch.Generator().manual_seed(5)
    prior = torch.tanh(torch.randn((DP_ACOUSTIC_B, samples), generator=gen) * 0.3)
    torch.save({"batch": [None if x is None else x.cpu() for x in cut], "shape": shape,
                "prior": prior}, align_path)
    ref_align = dp_align_run(torch, cut, 1, dropout=False)
    ref_acoustic = dp_acoustic_run(torch, data, DP_ACOUSTIC_B, 1, prior=prior)
    for k in ("state", "batch", "ctx"):
        ref_acoustic.pop(k)
    store = work / "store_dp2"
    ranks = children(torch, "--dp-rank", [(r, store, align_path, data) for r in (0, 1)])
    saved = [torch.load(f"{store}.rank{r}.pt", weights_only=True) for r in (0, 1)]
    ref = {"align_loss": float(ref_align["losses"][0]),
           "acoustic_metrics": ref_acoustic["metrics"][0]}
    errs = {"align_loss_rel": max(abs(r["align_loss"] - ref["align_loss"]) / abs(ref["align_loss"])
                                  for r in ranks),
            "acoustic_metric_rel": {k: max(abs(r["acoustic_metrics"][k] - v) / max(abs(v), 1e-30)
                                           for r in ranks)
                                    for k, v in ref["acoustic_metrics"].items()},
            "median_abs": max(abs(a - b) for r in ranks
                              for a, b in zip(r["acoustic_medians"], ref_acoustic["medians"])),
            "medians": len(ref_acoustic["medians"]),
            "priors_abs": max(float((s["align"]["priors"][k].double()
                                     - ref_align["priors"][k].double()).abs().max())
                              for s in saved for k in ("log_priors_sum", "prior_count")),
            "align_grad_rel": max(_rel(torch, s["align"]["grads"]["text_aligner"],
                                       ref_align["grads"]["text_aligner"]) for s in saved),
            "acoustic_grad_rel": {n: max(_rel(torch, s["acoustic"]["grads"][n], g)
                                         for s in saved)
                                  for n, g in ref_acoustic["grads"].items()},
            "align_weight_err_over_move": max(
                _weight_err_over_move(torch, ref_align["before"], s["align"]["after"],
                                      ref_align["after"])["text_aligner"] for s in saved),
            "acoustic_weight_err_over_move": {
                n: max(_weight_err_over_move(torch, ref_acoustic["before"],
                                             s["acoustic"]["after"], ref_acoustic["after"])[n]
                       for s in saved) for n in ref_acoustic["after"]},
            "ranks_weights_equal": all(
                _weights_equal(torch, saved[0][k]["after"], saved[1][k]["after"])
                for k in ("align", "acoustic"))}
    launches = {k: sum(r["align_launches"][k] for r in ranks) for k in ranks[0]["align_launches"]}
    report = {"ranks": ranks, "errors": errs, "launches": launches,
              "reference_step_ms": {"align": ref_align["step_ms"][0],
                                    "acoustic": ref_acoustic["step_ms"][0]}}
    log(f"dp two gloo ranks on one card: errors {errs}; CTC launches {launches}; "
        f"collectives per step: align {ranks[0]['align_collectives']}, acoustic "
        f"{ranks[0]['acoustic_collectives']}")
    bad = [k for k, lim in (("align_loss_rel", DP_METRIC_RTOL),
                            ("priors_abs", DP_PRIOR_ATOL), ("align_grad_rel", DP_GRAD_RTOL),
                            ("align_weight_err_over_move", DP_WEIGHT_RTOL),
                            ("median_abs", DP_MEDIAN_ATOL))
           if not errs[k] <= lim]
    for key, lim in (("acoustic_metric_rel", DP_METRIC_RTOL),
                     ("acoustic_grad_rel", DP_GRAD_RTOL),
                     ("acoustic_weight_err_over_move", DP_ACOUSTIC_WEIGHT_RTOL)):
        bad += [f"{key} {n}" for n, v in errs[key].items() if not v <= lim]
    if bad or not errs["ranks_weights_equal"] or not all(launches.values()) or any(
            launches[k] != 2 for k in launches):
        fail(f"two ranks against one process: {bad}, ranks alike "
             f"{errs['ranks_weights_equal']}, CTC launches {launches}")
    return report


def dp_profile(torch, data: Path, work: Path) -> dict:
    """(d) ``train --stage acoustic --profile DIR`` through the CLI for 2
    steps (B = 8 on the first 16 clips; bf16, no slm term, the later stages
    at 0 epochs): the Chrome trace parsed, its CUDA kernel events counted and
    summed by name."""
    import yaml

    root = work / "dp_profile"
    root.mkdir()
    for split, n in (("train", 16), ("val", 2)):
        lines = (data / f"{split}-list.txt").read_text(encoding="utf-8").splitlines()[:n]
        (root / f"{split}-list.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    for name in ("wav-dir", "pitch.safetensors", "alignment.safetensors"):
        (root / name).symlink_to(data / name)
    cfg, model_cfg = acoustic_configs(root, root)
    doc = yaml.safe_load(cfg.read_text(encoding="utf-8"))
    doc["loss_weight"]["slm"] = 0.0
    cfg.write_text(yaml.safe_dump(doc), encoding="utf-8")
    cfg = config_until(cfg, "acoustic")
    trace_dir = root / "trace"
    trainer, wall = cli(torch, "train", "--config", str(cfg), "--model-config", str(model_cfg),
                        "--out", str(root / "out"), "--stage", "acoustic", "--profile",
                        str(trace_dir))
    steps = trainer.stage_manifests["acoustic"].current_total_step
    path = trace_dir / "trace_rank0.json"
    t0 = time.time()
    events = json.loads(path.read_text(encoding="utf-8"))["traceEvents"]
    parse_s = time.time() - t0
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e.get("dur", 0.0) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    report = {"steps": steps, "wall_s": wall, "trace_mb": path.stat().st_size / 1e6,
              "parse_s": parse_s, "events": len(events),
              "kernel_events": sum(v[0] for v in kernels.values()),
              "kernel_ms": sum(v[1] for v in kernels.values()), "kernel_names": len(kernels),
              "top_kernels_ms": {name[:80]: round(v[1], 3) for name, v in top}}
    log(f"train --profile: {steps} steps in {wall:.1f} s; trace {report['trace_mb']:.1f} MB, "
        f"{report['events']} events, {report['kernel_events']} CUDA kernel events "
        f"({report['kernel_ms']:.1f} ms, {len(kernels)} kernels); top {report['top_kernels_ms']}")
    if steps != 2 or not report["kernel_events"]:
        fail(f"train --profile: {steps} steps, {report['kernel_events']} kernel events")
    return report


def dp_flops(torch, data: Path, card: str) -> dict:
    """(e) The analytic matmul + convolution FLOPs (``utils/flops.py``) of
    the bf16 acoustic step at B = 16 with the slm term (the sampled MRD as
    the mean of the three ``forced_disc_index`` runs), its achieved TFLOP/s
    at the step's time (the median of 3 steps with the MRD sampled, after
    the counted ones) and the MFU against the H100's dense bf16 peak."""
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models.slm import random_wavlm, wavlm_loss
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.steps import StepContext, batch_to_device, make_acoustic_step
    from stylish_tts_torch.utils.flops import count_mean

    mc = ModelConfig()
    batch = batch_to_device(acoustic_batch(torch, data, ACOUSTIC_B), "cuda")
    state = stage_state(torch, mc, "cuda")
    state.wavlm = random_wavlm(0).cuda().eval().requires_grad_(False)
    steps = [make_acoustic_step(StepContext(
        mc, Config().loss_weight.model_dump(), NormalizationStats(), stage_steps=10_000,
        slm_loss_fn=wavlm_loss, mixed_precision=True, forced_disc_index=i)) for i in range(3)]
    t0 = time.time()
    count = count_mean(steps, state, batch)
    torch.cuda.synchronize()
    count_s = time.time() - t0
    sampled = make_acoustic_step(StepContext(
        mc, Config().loss_weight.model_dump(), NormalizationStats(), stage_steps=10_000,
        slm_loss_fn=wavlm_loss, mixed_precision=True))
    step_ms = median_ms(torch, lambda: sampled(state, batch), n=3, warmup=1, sleep=False)
    achieved = count.total / (step_ms / 1e3)
    report = {"card": card, "B": ACOUSTIC_B, "flops": count.total, "matmul_flops": count.matmul,
              "conv_flops": count.conv, "notes": count.notes, "count_s": count_s,
              "step_ms": step_ms, "achieved_tflops": achieved / 1e12,
              "mfu_vs_dense_bf16": achieved / H100_BF16_DENSE_FLOP_PER_S}
    log(f"acoustic step B={ACOUSTIC_B}: {count.total / 1e12:.4f} TFLOP (matmul "
        f"{count.matmul / 1e12:.4f}, conv {count.conv / 1e12:.4f}); at {step_ms:.2f} ms "
        f"{achieved / 1e12:.2f} TFLOP/s, MFU {report['mfu_vs_dense_bf16']:.4f} of the dense "
        f"bf16 peak 989 TFLOP/s ({card})")
    if not count.total > 0:
        fail("the acoustic step counted no FLOPs")
    return report


def phase_data_parallel(torch, work: Path, card: str, align_batch, main_shape) -> dict:
    """Phase 12: (a) world size 1 through NCCL bitwise; (b) two gloo ranks on
    the card against one process; (c) the bounds-checked CTC build in a
    child; (d) ``train --profile``; (e) the FLOP count and MFU."""
    t0 = time.time()
    data = work / "data"
    report = {"world_one": dp_world_one(torch, align_batch, data, work)}
    report["two_ranks"] = dp_two_ranks(torch, align_batch, data, work)
    report["ctc_checked"] = child(torch, "--ctc-checked", *main_shape)
    report["profile"] = dp_profile(torch, data, work)
    report["flops"] = dp_flops(torch, data, card)
    report["wall_s"] = time.time() - t0
    log(f"data-parallel phase: {report['wall_s']:.1f} s")
    return report


# ---------------------------------------------------------------- phase 13

# a program's waveform against the eager call's (per-row generators), as a
# share of the eager waveform's peak: the expectation is bitwise (the same
# kernels in the same order, no cuDNN autotuning)
PROGRAM_RTOL = 1e-5
N_PROGRAM_TIMED = 3
MISS_SPEED = 0.5  # a fused frame bucket outside the grid warmed for speed 1
MISS_LINE = 3  # the 120-token line
EXPORT_RTOL = 1e-5  # the exported program against the eager acoustic phase
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                    "cudaMemsetAsync")


def eager_speech(pkg, tokens, styles, fused=None, speed=1.0):
    """``generate_speech`` composed from the eager phase functions (the
    per-row generators, every kernel launched from Python): what the
    programs replace."""
    from stylish_tts_torch.export.package import frame_bucket

    texts, lengths = pkg._texts([tokens])
    sp, pe, du = (pkg._tensor(s)[None] for s in styles)
    hop = pkg.mc.hop_length * pkg.mc.coarse_multiplier
    f_fused = pkg._fused_frame_bucket(tokens.shape[0], speed)
    if fused is None:
        fused = f_fused is not None
    if fused:
        audio, totals = pkg.fused(texts, lengths, du, pe, sp, 1.0 / speed, f_fused)
        return audio[0, :int(totals[0]) * hop].cpu().numpy()
    durations = pkg.durations(texts, lengths, du).cpu().numpy() / speed
    total = int(round(float(durations.sum())))
    audio = pkg.acoustic(texts, lengths, pkg._tensor(durations), pe, sp, frame_bucket(total))
    return audio[0, :total * hop].cpu().numpy()


def eager_batch(pkg, token_lists, styles):
    """``generate_speech_batch`` from the eager phase functions."""
    import numpy as np

    from stylish_tts_torch.export.package import frame_bucket

    b = len(token_lists)
    texts, lengths = pkg._texts(token_lists)
    sp, pe, du = (pkg._tensor(np.broadcast_to(np.asarray(s, np.float32),
                                              (b, pkg.mc.style_dim))) for s in styles)
    durations = pkg.durations(texts, lengths, du).cpu().numpy()
    totals = np.round(durations.sum(axis=1)).astype(int)
    audio = pkg.acoustic(texts, lengths, pkg._tensor(durations), pe, sp,
                         frame_bucket(int(totals.max()))).cpu().numpy()
    hop = pkg.mc.hop_length * pkg.mc.coarse_multiplier
    return [audio[i, :totals[i] * hop] for i in range(b)]


def wall_ms(torch, fn, n=N_PROGRAM_TIMED):
    """Median host-clock ms of ``fn`` (which ends reading its audio back)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wave_err(got, ref, what):
    """max |got - ref| over ref's peak; fails above PROGRAM_RTOL."""
    import numpy as np

    if got.shape != ref.shape:
        fail(f"{what}: {got.shape[0]} samples from the program, {ref.shape[0]} eager")
    peak = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / max(peak, 1e-30)
    if not (np.isfinite(got).all() and peak > 0 and err <= PROGRAM_RTOL):
        fail(f"{what}: program vs eager {err:.3e} of the peak {peak:.4g} "
             f"(<= {PROGRAM_RTOL})")
    return err


def count_programs(pkg) -> int:
    return sum(len(entry) for cache in (pkg._duration_fns, pkg._acoustic_fns,
                                        pkg._fused_fns) for entry in cache.values())


def traced(torch, fn):
    """``fn`` under ``torch.profiler``: device ms and device operations
    (kernels, copies, fills: the CUDA events of the trace) and the host's
    launch calls (the runtime's launch, graph launch, copy and fill APIs)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:  # kernels only reachable through the CPU ops that launched them
        device = [k for e in prof.events() if e.device_type == DeviceType.CPU
                  for k in e.kernels]
    host = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name in HOST_LAUNCH_APIS)
    graphs = sum(1 for e in prof.events() if e.name == "cudaGraphLaunch")
    span = (lambda e: e.duration) if device and not hasattr(device[0], "time_range") \
        else (lambda e: e.time_range.elapsed_us())
    return {"device_ms": sum(span(e) for e in device) / 1e3,
            "device_ops": len(device), "host_launches": host, "graph_launches": graphs}


def replay_ms(torch, program, n=5):
    """Median device ms of one graph replay (CUDA events around it)."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        program.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def programs_warmup(torch, pkg):
    """(a): ``warmup`` at the package's duration stats; its count against
    ``warmup_grid`` + ``fused_grid``; wall s; the pool's MB (the segments
    of the allocator's snapshot in the package's pool, and the MB the
    programs' outputs hold there), beside the source draws' MB (outside
    the pool) and the card's reserved memory that warmup added."""
    import gc

    from stylish_tts_torch.export.package import TEXT_BUCKETS, fused_grid, warmup_grid

    stats = pkg.duration_stats
    if not stats:
        fail("the package carries no duration stats: warmup builds no fused program")
    grid = warmup_grid(TEXT_BUCKETS, stats)
    fused = fused_grid(TEXT_BUCKETS, stats["frames_per_token_p95"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    built = pkg.warmup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if built != len(grid) + len(fused):
        fail(f"warmup built {built} programs, the grid has {len(grid)} + {len(fused)}")
    programs = [p for cache in (pkg._duration_fns, pkg._acoustic_fns, pkg._fused_fns)
                for entry in cache.values() for p in entry.values()]
    if any(p.graph is None for p in programs):
        fail("a program on the card holds no CUDA graph")
    gc.collect()
    torch.cuda.empty_cache()
    added = torch.cuda.memory_reserved() - reserved0
    outside = sum(t.numel() * t.element_size() for d in pkg._source_draws.values()
                  for t in d if t is not None)
    pool = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id") or ()) == tuple(pkg._pool or ())]
    if not pool:
        fail("the allocator's snapshot holds no segment of the package's graph pool")
    return {"built": built, "acoustic": len(grid), "fused": len(fused),
            "duration": len(pkg._duration_fns), "seconds": seconds,
            "reserved_mb": added / 2**20, "draws_mb": outside / 2**20,
            "pool_mb": sum(seg["total_size"] for seg in pool) / 2**20,
            "pool_segments": len(pool),
            "pool_allocated_mb": sum(seg["allocated_size"] for seg in pool) / 2**20}


def programs_lines(torch, pkg, pack, lines):
    """(b) and (c): every line, shortest first (``warmup`` captured the
    largest first), through the fused and the two-phase programs against
    the eager composition; then per line the ms of both, fused as
    ``speak`` takes it; (e) RTF at B = 1."""
    from stylish_tts_torch.tts.voicepack import lookup_static_style

    sr = pkg.mc.sample_rate
    errs, rows = [], []
    before = count_programs(pkg)
    for line in lines:
        tokens = pkg.tokenize(line)
        styles = lookup_static_style(pack, tokens.shape[0])
        for fused in (True, False):
            got = pkg.generate_speech(tokens, *styles, fused=fused)
            ref = eager_speech(pkg, tokens, styles, fused=fused)
            errs.append(wave_err(got, ref, f"{tokens.shape[0]}-token line, "
                                           f"{'fused' if fused else 'two-phase'}"))
    built_by_lines = count_programs(pkg) - before
    for line in lines:
        tokens = pkg.tokenize(line)
        styles = lookup_static_style(pack, tokens.shape[0])
        audio = pkg.generate_speech(tokens, *styles)
        rows.append({"tokens": int(tokens.shape[0]), "audio_s": audio.shape[0] / sr,
                     "programs_ms": wall_ms(torch, lambda: pkg.generate_speech(
                         tokens, *styles)),
                     "eager_ms": wall_ms(torch, lambda: eager_speech(pkg, tokens, styles))})
    audio_s = sum(r["audio_s"] for r in rows)
    return {"max_err_of_peak": max(errs), "compared": len(errs),
            "built_by_lines": built_by_lines, "lines": rows,
            "rtf_b1": sum(r["programs_ms"] for r in rows) / 1e3 / audio_s,
            "eager_rtf_b1": sum(r["eager_ms"] for r in rows) / 1e3 / audio_s}


def programs_batch(torch, pkg, pack):
    """(e) RTF at B = 8: ``generate_speech_batch`` through its programs
    (built on its first call) against the eager composition."""
    import numpy as np

    from stylish_tts_torch.tts.voicepack import lookup_static_style

    tokens = [pkg.tokenize(line) for line in speak_lines(4, BATCH_TOKENS)]
    styles = [np.stack(s) for s in zip(*(lookup_static_style(pack, t.shape[0])
                                         for t in tokens))]
    wavs = pkg.generate_speech_batch(tokens, *styles)
    refs = eager_batch(pkg, tokens, styles)
    err = max(wave_err(w, r, f"batch row {i}") for i, (w, r) in enumerate(zip(wavs, refs)))
    audio_s = sum(w.shape[0] for w in wavs) / pkg.mc.sample_rate
    ms = wall_ms(torch, lambda: pkg.generate_speech_batch(tokens, *styles))
    eager = wall_ms(torch, lambda: eager_batch(pkg, tokens, styles))
    return {"max_err_of_peak": err, "audio_s": audio_s, "programs_ms": ms,
            "eager_ms": eager, "rtf": ms / 1e3 / audio_s, "eager_rtf": eager / 1e3 / audio_s}


def programs_profile(torch, pkg, pack, rows, lines, card, name):
    """(d) the shortest and the longest line's call (fused, as ``speak``
    takes it) under the profiler, through its program and eager: device
    ms, device operations, host launches, busy share (device ms over the
    untraced call's ms, ``rows``' (c) medians); one graph replay of each
    between CUDA events."""
    from stylish_tts_torch.tts.voicepack import lookup_static_style

    out = {"card": card}
    for which, i in (("shortest", 0), ("longest", len(lines) - 1)):
        tokens = pkg.tokenize(lines[i])
        styles = lookup_static_style(pack, tokens.shape[0])
        F = pkg._fused_frame_bucket(tokens.shape[0], 1.0)
        program = pkg._fused_fns[(pkg._texts([tokens])[0].shape[1], F)][1]
        call = {"tokens": int(tokens.shape[0]), "frame_bucket": F}
        for path, fn, key in (
                ("programs", lambda: pkg.generate_speech(tokens, *styles), "programs_ms"),
                ("eager", lambda: eager_speech(pkg, tokens, styles), "eager_ms")):
            fn()
            row = traced(torch, fn)
            if row["device_ms"] <= 0:
                fail(f"the trace of the {path} call holds no device time")
            row["call_ms"] = rows[i][key]
            row["busy_share"] = row["device_ms"] / row["call_ms"]
            call[path] = row
        call["programs"]["replay_ms"] = replay_ms(torch, program)
        if call["programs"]["graph_launches"] < 1:
            fail("the program's call launched no CUDA graph")
        out[which] = call
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_speak_programs{name}.json").write_text(json.dumps(out, indent=1))
    return out


def programs_miss(torch, pkg, pack, line):
    """(f) a request at a fused bucket outside the grid (speed 0.5): the
    miss's ms (draws, warm-up run, capture, replay), the next call's, and
    the eager call's at the same bucket; one program added."""
    from stylish_tts_torch.tts.voicepack import lookup_static_style

    tokens = pkg.tokenize(line)
    styles = lookup_static_style(pack, tokens.shape[0])
    L = pkg._texts([tokens])[0].shape[1]
    F = pkg._fused_frame_bucket(tokens.shape[0], MISS_SPEED)
    if (L, F) in pkg._fused_fns:
        fail(f"the miss bucket ({L}, {F}) is in the warmed grid")
    before = count_programs(pkg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pkg.generate_speech(tokens, *styles, speed=MISS_SPEED)
    torch.cuda.synchronize()
    miss_ms = (time.perf_counter() - t0) * 1e3
    if count_programs(pkg) != before + 1 or (L, F) not in pkg._fused_fns:
        fail("a miss did not build exactly one program")
    err = wave_err(got, eager_speech(pkg, tokens, styles, speed=MISS_SPEED), "the miss")
    return {"bucket": [L, F], "miss_ms": miss_ms, "max_err_of_peak": err,
            "hit_ms": wall_ms(torch, lambda: pkg.generate_speech(tokens, *styles,
                                                                  speed=MISS_SPEED)),
            "eager_ms": wall_ms(torch, lambda: eager_speech(pkg, tokens, styles,
                                                           speed=MISS_SPEED))}


def programs_exported(torch, pkg, pkg_dir, convert_args=None):
    """(g) the acoustic phase at (32, 100) as a ``torch.export`` program,
    written by ``convert --exported-program`` (``convert_args``: the CLI's
    config and checkpoint, into a new package directory) or by the function
    it calls, loaded, and run on the card against the eager acoustic phase
    (its per-row generators)."""
    from stylish_tts_torch.export import package as package_module

    t0 = time.perf_counter()
    if convert_args is not None:
        pkg_dir = pkg_dir.parent / (pkg_dir.name + "_exported")
        cli(torch, "convert", *convert_args, "--out", str(pkg_dir), "--exported-program")
        path = package_module.exported_program_path(str(pkg_dir))
    else:
        path = package_module._emit_exported_program(str(pkg_dir), "cuda")
    seconds = time.perf_counter() - t0
    if convert_args is not None:  # the eager side from the same package directory
        from stylish_tts_torch.export.package import InferencePackage

        pkg = InferencePackage(str(pkg_dir), device="cuda")
    program = torch.export.load(path).module()
    _, args = pkg._acoustic_module_and_args(32, 100)
    with torch.no_grad():
        out = program(*args)
        ref = pkg.acoustic(*args[:5], 100)
    peak = float(ref.abs().max())
    err = float((out - ref).abs().max()) / max(peak, 1e-30)
    if not (out.is_cuda and peak > 0 and err <= EXPORT_RTOL):
        fail(f"the exported program on the card: {err:.3e} of the eager peak {peak:.4g} "
             f"(<= {EXPORT_RTOL}), on {out.device}")
    return {"seconds": seconds, "max_err_of_peak": err, "mb": Path(path).stat().st_size / 2**20,
            "via": "cli" if convert_args is not None else "function"}


def capture_fails(torch) -> dict:
    """(h), in a child process: a program whose function reads a value back
    (``float(t.sum())``: a host sync) must raise at its capture; the card
    works after it."""
    from stylish_tts_torch.export.programs import BucketProgram

    x = torch.ones(4, device="cuda")
    raised = None
    try:
        BucketProgram(lambda t: t * float(t.sum()), (x,))
    except Exception as e:  # noqa: BLE001 - what the capture raised is the result
        raised = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:200]}"
    return {"raised": raised, "card_usable_after": float((x * 2).sum()) == 8.0}


def programs_family(torch, name, pkg_dir, voicepack, card, convert_args=None):
    """Phase 13 (a)-(g) on one package: see the module docstring."""
    from stylish_tts_torch.export.package import InferencePackage
    from stylish_tts_torch.tts.voicepack import load_voicepack

    t0 = time.time()
    pkg = InferencePackage(str(pkg_dir), device="cuda")
    pack = load_voicepack(str(voicepack))
    lines = speak_lines(2, SPEAK_TOKENS)
    report = {"warmup": programs_warmup(torch, pkg)}
    log(f"programs ({name}) warmup: {json.dumps(report['warmup'])}")
    report["lines"] = programs_lines(torch, pkg, pack, lines)
    log(f"programs ({name}) lines: max err {report['lines']['max_err_of_peak']:.3e}, built "
        f"{report['lines']['built_by_lines']}")
    report["batch8"] = programs_batch(torch, pkg, pack)
    report["profile"] = programs_profile(torch, pkg, pack, report["lines"]["lines"], lines,
                                         card, "" if name == "freegan" else "_" + name)
    report["miss"] = programs_miss(torch, pkg, pack, lines[MISS_LINE])
    if convert_args is not None:  # the ringformer's program: tests/test_torch_programs.py
        report["exported"] = programs_exported(torch, pkg, Path(pkg_dir), convert_args)
    report["programs"] = count_programs(pkg)
    report["wall_s"] = time.time() - t0
    w, ln = report["warmup"], report["lines"]
    log(f"programs ({name}): warmup {w['built']} (acoustic {w['acoustic']} + fused "
        f"{w['fused']}; {w['duration']} duration) in {w['seconds']:.2f} s, pool "
        f"{w['pool_mb']:.1f} MB, draws {w['draws_mb']:.1f} MB; {ln['compared']} calls vs "
        f"eager, max {ln['max_err_of_peak']:.3e} of the peak; RTF B=1 {ln['rtf_b1']:.5f} "
        f"(eager {ln['eager_rtf_b1']:.5f}), B=8 {report['batch8']['rtf']:.5f} (eager "
        f"{report['batch8']['eager_rtf']:.5f})")
    log(f"programs ({name}) per line ms (programs / eager): "
        + ", ".join(f"{r['tokens']}: {r['programs_ms']:.2f} / {r['eager_ms']:.2f}"
                    for r in ln["lines"]))
    for pr in (report["profile"]["shortest"], report["profile"]["longest"]):
        pg, eg = pr["programs"], pr["eager"]
        log(f"programs ({name}) {pr['tokens']}-token call: programs {pg['call_ms']:.2f} ms, "
            f"device {pg['device_ms']:.2f} ms in {pg['device_ops']} ops, "
            f"{pg['host_launches']} host launches, busy {pg['busy_share']:.3f}, replay "
            f"{pg['replay_ms']:.2f} ms; eager {eg['call_ms']:.2f} ms, device "
            f"{eg['device_ms']:.2f}, {eg['host_launches']} host launches, busy "
            f"{eg['busy_share']:.3f}")
    m = report["miss"]
    log(f"programs ({name}) miss at {m['bucket']}: {m['miss_ms']:.1f} ms (then "
        f"{m['hit_ms']:.2f}; eager {m['eager_ms']:.2f})")
    if "exported" in report:
        ex = report["exported"]
        log(f"programs ({name}) exported program ({ex['via']}) {ex['seconds']:.1f} s, "
            f"{ex['mb']:.1f} MB, {ex['max_err_of_peak']:.3e} of the peak")
    return report


def programs_summary(programs: dict, card: str) -> dict:
    """The ``programs`` summary line of phase 13's report."""
    return {
        "card": card, "wall_s": programs["wall_s"],
        "capture_failure_raised": programs["capture_fails"]["raised"],
        **{f"{f}_{k}": v for f in ("freegan", "ringformer") for k, v in {
            "warmup_built": programs[f]["warmup"]["built"],
            "warmup_s": programs[f]["warmup"]["seconds"],
            "pool_mb": programs[f]["warmup"]["pool_mb"],
            "draws_mb": programs[f]["warmup"]["draws_mb"],
            "max_err_of_peak": max(programs[f][k]["max_err_of_peak"]
                                   for k in ("lines", "batch8", "miss")),
            "line_ms": {r["tokens"]: [r["programs_ms"], r["eager_ms"]]
                        for r in programs[f]["lines"]["lines"]},
            "rtf_b1": [programs[f]["lines"]["rtf_b1"], programs[f]["lines"]["eager_rtf_b1"]],
            "rtf_b8": [programs[f]["batch8"]["rtf"], programs[f]["batch8"]["eager_rtf"]],
            **{f"{w}_call": {p: {k: programs[f]["profile"][w][p][k] for k in (
                "call_ms", "device_ms", "device_ops", "host_launches", "busy_share")}
                for p in ("programs", "eager")} for w in ("shortest", "longest")},
            **{f"{w}_replay_ms": programs[f]["profile"][w]["programs"]["replay_ms"]
               for w in ("shortest", "longest")},
            "miss_ms": [programs[f]["miss"]["miss_ms"], programs[f]["miss"]["hit_ms"],
                        programs[f]["miss"]["eager_ms"]]}.items()},
        "exported_err_of_peak": programs["freegan"]["exported"]["max_err_of_peak"],
        "exported_s": programs["freegan"]["exported"]["seconds"]}


def phase_programs(torch, work: Path, card: str):
    """Phase 13: the programs per bucket on phase 8's voice (FreeGAN, full
    ``ModelConfig()``, duration stats) and phase 9's ringformer package;
    a capture that fails must raise (child)."""
    import gc

    t0 = time.time()
    report = {}
    stage_dir = work / "acoustic_out" / "duration"
    convert_args = ["--config", str(work / "acoustic.yml"), "--model-config",
                    str(work / "acoustic_model.yml"), "--checkpoint",
                    str(stage_dir / checkpoint_dirs(stage_dir)[-1])]
    for name, pkg_dir, voicepack, args in (
            ("freegan", work / "pkg", work / "voicepack.safetensors", convert_args),
            ("ringformer", work / "ringformer" / "pkg",
             work / "ringformer" / "voicepack.safetensors", None)):
        report[name] = programs_family(torch, name, pkg_dir, voicepack, card, args)
        gc.collect()
        torch.cuda.empty_cache()
    report["capture_fails"] = child(torch, "--capture-fails")
    if not report["capture_fails"]["raised"] or not report["capture_fails"]["card_usable_after"]:
        fail(f"a capture with a host sync: {report['capture_fails']}")
    report["wall_s"] = time.time() - t0
    log(f"programs phase: {report['wall_s']:.1f} s; a failing capture raised "
        f"{report['capture_fails']['raised']}")
    return report


# ---------------------------------------------------------------- phase 14

MESH_ALIGN_STEPS = 4  # 2 steps, the epoch's prior update, 2 steps
MESH_ALIGN_B = DP_ALIGN_B  # 68: 34 rows a data rank
MESH_SHAPES = {"2d": (2, 2), "hybrid": (2, 1, 2)}  # 4 gloo ranks each on the card
MESH_STAGE_SHAPE = (1, 2)  # 2 gloo ranks: the acoustic, textual and duration steps
MESH_LOSS_RTOL = 1e-5
# the priors made at the epoch's update (from the first two steps'
# posteriors); the accumulators of the last two steps, relative
MESH_PRIOR_ATOL = 1e-5
MESH_PRIOR_RTOL = 1e-5
# the first step's gradient (gathered): L2 error over its norm, phase 12's
# DP_GRAD_RTOL. Then the weights' L2 error over the move, after the first
# step and after the fourth: the sharded products sum in another order,
# which moves each gradient by rounding, and AdamW moves every element by
# about lr x the sign of its gradient, so an element whose gradient is
# rounding noise moves by lr either way: each such flip adds 2 lr to the
# error (2.1e-3 of the move after one step on an H100, what ~5 flips of
# the 4.88M elements give)
MESH_GRAD_RTOL = DP_GRAD_RTOL
MESH_ALIGN_WEIGHT_RTOL = 1e-2
MESH_STAGE_METRIC_RTOL = 1e-4
MESH_STAGE_WEIGHT_RTOL = CARD_CPU_WEIGHT_RTOL  # 0.1 of the step's move (L2)
MESH_STAGE_B, MESH_STAGE_SECONDS = 2, 1.0
MESH_STAGES = ("acoustic", "textual", "duration")
# the audit's configuration (scripts/audit_sharding.py): B = 16 x 3 s
AUDIT_B, AUDIT_L, AUDIT_F = 16, 64, 240


def _cpu(tree: dict) -> dict:
    return {n: {k: v.detach().cpu() for k, v in sd.items()} for n, sd in tree.items()}


def mesh_wrap(mesh):
    from stylish_tts_torch.parallel import sharding_rules as sr

    return sr.parallel_2d_step if len(mesh.shape) == 2 else sr.parallel_hybrid_step


def state_bytes(torch, state) -> dict:
    """This rank's bytes of parameters plus AdamW moments, and the full
    state's (the sharded ones gathered: a collective on a mesh)."""
    from stylish_tts_torch.parallel import sharding_rules as sr

    modules = sr._module_table(state)
    opts = list(sr._optimizers(state))
    local = sum(p.numel() * p.element_size() for m in modules.values() for p in m.parameters())
    local += sum(t.numel() * t.element_size() for o in opts for st in o.state.values()
                 for k, t in st.items() if k in ("exp_avg", "exp_avg_sq"))
    full = sum(t.numel() * t.element_size() for kind in sr.gather_state(state).values()
               for sd in kind.values() for t in sd.values())
    return {"local": local, "full": full}


def mesh_align_run(torch, batch, mesh=None, n_steps=MESH_ALIGN_STEPS) -> dict:
    """``n_steps`` alignment steps at the full ``ModelConfig()`` from seed 0,
    dropout off, the priors refreshed halfway, on the global ``batch``: on
    ``mesh`` through ``parallel_2d_step`` / ``parallel_hybrid_step`` (each
    rank its rows, the kernels sharded), else in one process. Losses,
    priors, the weights before and after (gathered), step ms, CTC launches,
    collectives by axis, the state's bytes."""
    from stylish_tts_torch import parallel
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import build_text_aligner
    from stylish_tts_torch.ops import ctc_cuda
    from stylish_tts_torch.parallel import sharding_rules as sr
    from stylish_tts_torch.trainer import steps as steps_mod
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.state import create_train_state

    mc = ModelConfig()
    torch.manual_seed(0)
    state = create_train_state(build_text_aligner(mc), mc.text_encoder.tokens + 1, "cuda")
    state.aligner.dropout = 0.0
    ctx = steps_mod.StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                                stage_steps=1000, base_lr=1e-4)
    before = _cpu(_snapshot(torch, {"text_aligner": state.aligner}))
    step = steps_mod.make_alignment_step(ctx)
    if mesh is not None:
        step = mesh_wrap(mesh)(step, state, mesh)

    def weights():
        if mesh is None:
            return _cpu(_snapshot(torch, {"text_aligner": state.aligner}))
        return _cpu({"text_aligner": sr.gather_state(state)["params"]["text_aligner"]})

    grads, real_update = {}, steps_mod.apply_module_update
    coll = {k: 0 for k in parallel.COLLECTIVES}  # the steps' own, by axis

    def count(fn, sign):
        before = dict(parallel.COLLECTIVES)
        out = fn()
        for k in coll:
            coll[k] += sign * (parallel.COLLECTIVES[k] - before[k])
        return out

    def update(module, optimizer, lr, finite=None):  # the first step's gradient
        if not grads:
            grads.update(count(lambda: {k: g.cpu() for k, g in
                                        sr.gather_grads(module).items()}, -1))
        return real_update(module, optimizer, lr, finite)

    steps_mod.apply_module_update = update
    launches = dict(ctc_cuda.LAUNCHES)
    losses, ms, first = [], [], None
    try:
        for i in range(n_steps):
            if i == n_steps // 2:
                state = steps_mod.finish_alignment_epoch(ctx, state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(count(lambda: step(state, batch), 1)["align_loss"].detach().clone())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first = weights()
    finally:
        steps_mod.apply_module_update = real_update
    out = {"losses": torch.stack(losses).cpu(), "step_ms": ms, "before": before,
           "after_first": first, "grads": grads,
           "log_priors_updated": state.log_priors.detach().cpu().clone(),
           "priors": {k: getattr(state, k).detach().cpu().clone()
                      for k in ("log_priors_sum", "prior_count", "log_priors")},
           "launches": {k: ctc_cuda.LAUNCHES[k] - launches[k] for k in launches},
           "collectives_per_step": {k: v / n_steps for k, v in coll.items()}}
    out["after"] = weights()
    if mesh is not None:
        out["bytes"] = state_bytes(torch, state)
    return out


def mesh_stage_run(torch, stage, batch, prior, mesh=None) -> dict:
    """One fp32 step of ``stage`` at the full ``ModelConfig()`` from seed 0
    (the parity switches, the injected excitation ``prior``, MRD
    ``DP_FORCED``), on ``mesh`` or in one process; PyTorch's own
    convolutions and the TPRLS medians' gradient stopped, as
    ``dp_two_ranks`` compares (the medians swap with a neighbour under any
    change of rounding). Metrics, the trained modules' weights before and
    after (gathered), step ms, collectives by axis, the state's bytes."""
    from stylish_tts_torch import losses, parallel
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import STAGE_TRAIN_MODELS
    from stylish_tts_torch.parallel import sharding_rules as sr
    from stylish_tts_torch.trainer import steps as steps_mod
    from stylish_tts_torch.trainer.normalization import NormalizationStats

    mc = ModelConfig()
    state = stage_state(torch, mc, "cuda", stage)
    names = STAGE_TRAIN_MODELS[stage]
    before = _cpu(_snapshot(torch, {n: state.models[n] for n in names}))
    ctx = steps_mod.StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                                stage_steps=100, parity_deterministic=True,
                                parity_prior=prior.cuda(), forced_disc_index=DP_FORCED)
    step = (steps_mod.make_acoustic_step(ctx) if stage == "acoustic"
            else later_step(torch, ctx, stage, "cuda"))
    if mesh is not None:
        step = mesh_wrap(mesh)(step, state, mesh)
    real_median = losses._median_lower
    losses._median_lower = lambda x: real_median(x).detach()
    torch.backends.cudnn.enabled = False
    coll = dict(parallel.COLLECTIVES)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in step(state, batch).items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        losses._median_lower = real_median
        torch.backends.cudnn.enabled = True
    out = {"metrics": metrics, "step_ms": ms, "before": before,
           "collectives_per_step": {k: parallel.COLLECTIVES[k] - coll[k] for k in coll}}
    if mesh is None:
        out["after"] = _cpu(_snapshot(torch, {n: state.models[n] for n in names}))
    else:
        full = sr.gather_state(state)["params"]
        out["after"] = _cpu({n: full[n] for n in names})
        out["bytes"] = state_bytes(torch, state)
    return out


def mesh_rank_main(torch, kind: str, rank: int, store: str, args_path: str) -> dict:
    """One gloo rank on ``cuda:0`` of a mesh (``args``' shape): ``align``,
    the alignment steps on the global batch (its CTC launches counted, both
    kernels held against the plain version at its shard's shape); or
    ``stages``, one step of each later stage. Tensors to a file beside
    ``store``; the summary returned."""
    from stylish_tts_torch import parallel
    from stylish_tts_torch.ops import ctc_cuda
    from stylish_tts_torch.parallel import sharding_rules as sr
    from stylish_tts_torch.trainer.steps import Batch

    args = torch.load(args_path, weights_only=True)
    shape = tuple(args["mesh"])
    world = 1
    for n in shape:
        world *= n
    parallel.init_data_parallel(backend="gloo", rank=rank, world_size=world,
                                init_method=f"file://{store}", device="cuda:0", timeout_s=300)
    try:
        mesh = sr.make_2d_mesh(*shape) if len(shape) == 2 else sr.make_hybrid_mesh(*shape)
        batch = Batch(*(None if x is None else x.cuda() for x in args["batch"]))
        if kind == "align":
            for k in ctc_cuda.LAUNCHES:
                ctc_cuda.LAUNCHES[k] = 0
            torch.backends.cudnn.deterministic = True
            run = mesh_align_run(torch, batch, mesh)
            b, t, c, u = args["shape"]
            k = b // mesh.data
            rows = slice(parallel.rank() * k, (parallel.rank() + 1) * k)
            spec = dict(b=k, t=t, c=c, u=u, label_lengths=args["batch"][2][rows].tolist(),
                        input_lengths=[t] * k)
            check, _ = check_case(torch, f"mesh {shape} rank {rank}", spec, seed=300 + rank)
            saved = {k: run[k] for k in ("losses", "priors", "after", "after_first",
                                         "log_priors_updated", "grads")}
            summary = {"losses": run["losses"].tolist(), "launches": run["launches"],
                       "check": check, **{k: run[k] for k in ("step_ms", "collectives_per_step",
                                                            "bytes")}}
        else:
            runs = {stage: mesh_stage_run(torch, stage, batch, args["prior"], mesh)
                    for stage in MESH_STAGES}
            saved = {stage: r["after"] for stage, r in runs.items()}
            summary = {stage: {k: r[k] for k in ("metrics", "step_ms", "collectives_per_step",
                                                 "bytes")} for stage, r in runs.items()}
        torch.save(saved, f"{store}.rank{rank}.pt")
    finally:
        parallel.shutdown()
    return {"rank": rank, "model_rank": rank % shape[-1], **summary}


def mesh_world_one(torch, batch, stage_batch, prior, work: Path) -> dict:
    """(a) A 1 x 1 mesh through NCCL (a file store, rank 0 of 1) against no
    process group: 2 alignment steps and one fp32 acoustic step, losses,
    priors, metrics and weights bitwise (deterministic cuDNN)."""
    from stylish_tts_torch import parallel
    from stylish_tts_torch.parallel import sharding_rules as sr

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for name in ("no_group", "mesh_1x1"):
            mesh = None
            if name == "mesh_1x1":
                parallel.init_data_parallel(backend="nccl", rank=0, world_size=1,
                                            init_method=f"file://{work / 'store_mesh1'}",
                                            device="cuda:0")
                mesh = sr.make_2d_mesh(1, 1)
            try:
                runs[name] = {"align": mesh_align_run(torch, batch, mesh, n_steps=2),
                              "acoustic": mesh_stage_run(torch, "acoustic", stage_batch, prior,
                                                         mesh)}
            finally:
                parallel.shutdown()
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = runs["no_group"], runs["mesh_1x1"]
    same = {"align_losses": torch.equal(a["align"]["losses"], b["align"]["losses"]),
            "align_priors": all(torch.equal(a["align"]["priors"][k], b["align"]["priors"][k])
                                for k in a["align"]["priors"]),
            "align_weights": _weights_equal(torch, a["align"]["after"], b["align"]["after"]),
            "acoustic_metrics": a["acoustic"]["metrics"] == b["acoustic"]["metrics"],
            "acoustic_weights": _weights_equal(torch, a["acoustic"]["after"],
                                               b["acoustic"]["after"])}
    log(f"mesh 1 x 1 through NCCL: bitwise the path without a group {same}; collectives "
        f"{b['align']['collectives_per_step']}")
    if not all(same.values()):
        fail(f"a 1 x 1 mesh through NCCL is not bitwise the path without a group: {same}")
    return {"bitwise": same, "align_launches": b["align"]["launches"],
            "step_ms": {n: {"align": r["align"]["step_ms"], "acoustic": r["acoustic"]["step_ms"]}
                        for n, r in runs.items()}}


def mesh_shares(torch) -> dict:
    """(e) The counterpart of ``scripts/audit_sharding.py`` on the port: per
    module, the parameter share that the rules shard in the state view (the
    step's) and in the audit's view (the module's name prepended), and the
    module's forward FLOPs at the audit's configuration (``utils/flops.py``
    ``count_fn``, on the card); the param share and the FLOP-weighted share
    of each view."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.models import build_models, build_text_aligner
    from stylish_tts_torch.ops.duration import DurationProcessor
    from stylish_tts_torch.parallel.sharding_rules import module_specs
    from stylish_tts_torch.utils.flops import count_fn

    mc = ModelConfig()
    torch.manual_seed(0)
    models = build_models(mc)
    models["text_aligner"] = build_text_aligner(mc)
    b, lt, f = AUDIT_B, AUDIT_L, AUDIT_F
    gen = torch.Generator().manual_seed(0)
    dev = "cuda"
    audio = (torch.randn((b, f * mc.hop_length), generator=gen) * 0.1).to(dev)
    texts = torch.randint(1, 170, (b, lt), generator=gen).to(dev)
    lengths = torch.full((b,), lt, device=dev)
    align = DurationProcessor().duration_to_alignment(torch.full((b, lt), f / lt, device=dev), f)
    pitch = torch.full((b, f), 120.0, device=dev)
    energy = torch.zeros((b, f), device=dev)
    voiced = torch.ones((b, f), device=dev)
    style = torch.zeros((b, mc.style_dim), device=dev)
    style_mel = torch.randn((b, 80, f), generator=gen).to(dev)
    spec = torch.rand((b, 1, 257, 563), generator=gen).to(dev)
    align_mel = torch.randn((b, f, mc.text_aligner.n_mels), generator=gen).to(dev)
    calls = {
        "speech_predictor": lambda m: m(texts, lengths, align, pitch, energy, voiced, style,
                                        pitch, deterministic_prior=True).audio,
        "pitch_energy_predictor": lambda m: m(texts, lengths, align, style),
        "duration_predictor": lambda m: m(texts, lengths, style),
        "text_aligner": lambda m: m(align_mel, torch.full((b,), f, device=dev)),
        "speech_style_encoder": lambda m: m(style_mel),
        "pe_style_encoder": lambda m: m(style_mel, pitch, energy),
        "duration_style_encoder": lambda m: m(style_mel),
        **{f"mrd{i}": (lambda m: m(spec)) for i in range(3)},
        "disc": lambda m: m(audio),
        "pitch_disc": lambda m: m(torch.stack([pitch * voiced, energy], 1)),
        "dur_disc": lambda m: m(torch.full((b, 1, lt), 4.0, device=dev)),
    }
    rows = {}
    for name, module in models.items():
        module = module.to(dev).eval()
        total = {}
        for view, audit in (("state", False), ("audit", True)):
            specs = module_specs(name, module, audit=audit)
            total[view] = sum(module.get_parameter(k).numel() for k, d in specs.items()
                              if d is not None)
        n = sum(p.numel() for p in module.parameters())
        with torch.no_grad():
            flops = count_fn(calls[name], module).total
        rows[name] = {"params": n, "state": total["state"], "audit": total["audit"],
                      "flops": flops}
        models[name] = module.cpu()
    flops_all = sum(r["flops"] for r in rows.values())
    params_all = sum(r["params"] for r in rows.values())
    shares = {}
    for view in ("state", "audit"):
        shares[f"{view}_param_share"] = sum(r[view] for r in rows.values()) / params_all
        shares[f"{view}_flop_share"] = sum(r["flops"] * r[view] / r["params"]
                                           for r in rows.values()) / flops_all
    log("sharded share (port, ModelConfig(), forward FLOPs at B = 16 x 3 s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    return {"modules": rows, **shares}


def mesh_summary(mesh: dict, card: str) -> dict:
    """The mesh phase's printed line."""
    ranks, errs = mesh["ranks"], mesh["errors"]
    return {
        "card": card, "wall_s": mesh["wall_s"], "ranks_s": mesh["ranks_s"],
        "world_one_bitwise": mesh["world_one"]["bitwise"],
        **{f"align_{n}_{k}": errs[n][k] for n in MESH_SHAPES
           for k in ("loss_rel", "priors_abs", "accumulators_rel", "grad_rel",
                     "weight_err_over_move", "weight_err_over_move_4")},
        **{f"{s}_metric_max_rel": max(errs[s]["metric_rel"].values()) for s in MESH_STAGES},
        **{f"{s}_weight_err_over_move": errs[s]["weight_err_over_move"] for s in MESH_STAGES},
        "ctc_launches_per_rank": mesh["launches_per_rank"],
        "collectives_per_step": {
            **{f"align_{n}": ranks[n][0]["collectives_per_step"] for n in MESH_SHAPES},
            **{s: ranks["stages"][0][s]["collectives_per_step"] for s in MESH_STAGES}},
        "rank0_state_bytes": {
            **{f"align_{n}": ranks[n][0]["bytes"] for n in MESH_SHAPES},
            **{s: ranks["stages"][0][s]["bytes"] for s in MESH_STAGES}},
        "step_ms_ranks_share_one_card": {
            **{f"align_{n}": ranks[n][0]["step_ms"] for n in MESH_SHAPES},
            **{s: ranks["stages"][0][s]["step_ms"] for s in MESH_STAGES}},
        "step_ms_one_process": mesh["reference_step_ms"],
        **{k: v for k, v in mesh["shares"].items() if k.endswith("share")}}


def phase_mesh(torch, work: Path, card: str, align_batch) -> dict:
    """Phase 14: the 2-D and hybrid meshes (``parallel/sharding_rules.py``):
    (a) a 1 x 1 mesh through NCCL bitwise; (b) the alignment stage at full
    width on a 2 x 2 and a (2, 1, 2) mesh of 4 gloo ranks each on the card
    against one process (the CTC kernels launched on every rank); (c), (d)
    one acoustic, textual and duration step at full width on a 1 x 2 mesh of
    2 gloo ranks against one process; (e) collectives by axis, step ms,
    bytes per rank, the sharded shares."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.steps import Batch, StepContext, batch_to_device

    t0 = time.time()
    data = work / "data"
    batch = Batch(*(None if x is None else x[:MESH_ALIGN_B] for x in align_batch))
    ctx = StepContext(ModelConfig(), {}, NormalizationStats())
    with torch.no_grad():
        frames = ctx.norm_mel(batch.audio_gt[:1], ctx.to_align_mel).shape[-1]
    shape = (MESH_ALIGN_B, frames, ctx.blank_id + 1, batch.text.shape[1])
    stage_batch = acoustic_batch(torch, data, MESH_STAGE_B, seconds=MESH_STAGE_SECONDS)
    gen = torch.Generator().manual_seed(3)
    prior = torch.tanh(0.3 * torch.randn(stage_batch.audio_gt.shape, generator=gen))
    stage_batch = batch_to_device(stage_batch, "cuda")
    report = {"world_one": mesh_world_one(torch, batch, stage_batch, prior, work)}

    # the one-process references (the alignment runs with deterministic
    # cuDNN, here and in the ranks; a second one says whether the card
    # repeats itself)
    torch.backends.cudnn.deterministic = True
    try:
        ref_align = mesh_align_run(torch, batch)
        ref_again = mesh_align_run(torch, batch)
    finally:
        torch.backends.cudnn.deterministic = False
    ref_stages = {stage: mesh_stage_run(torch, stage, stage_batch, prior)
                  for stage in MESH_STAGES}

    # the ranks: both alignment meshes and the stage mesh at once on the card
    jobs = []
    for name, mesh_shape in (*MESH_SHAPES.items(), ("stages", MESH_STAGE_SHAPE)):
        args = work / f"mesh_{name}_args.pt"
        kind = "stages" if name == "stages" else "align"
        torch.save({"mesh": list(mesh_shape), "shape": shape,
                    "batch": [None if x is None else x.cpu()
                              for x in (stage_batch if kind == "stages" else batch)],
                    "prior": prior}, args)
        store = work / f"store_mesh_{name}"
        n = 1
        for d in mesh_shape:
            n *= d
        jobs += [(name, r, (kind, r, store, args)) for r in range(n)]
    t_ranks = time.time()
    results = children(torch, "--mesh-rank", [j[2] for j in jobs])
    ranks_s = time.time() - t_ranks
    by_mesh = {}
    for (name, r, (_, _, store, _)), res in zip(jobs, results):
        by_mesh.setdefault(name, []).append(
            (res, torch.load(f"{store}.rank{r}.pt", weights_only=True)))

    bad, errs = [], {}
    for name in MESH_SHAPES:
        ranks = by_mesh[name]
        e = {"loss_rel": max(float(((s["losses"].double() - ref_align["losses"].double()).abs()
                                    / ref_align["losses"].double().abs()).max())
                             for _, s in ranks),
             "priors_abs": max(float((s["log_priors_updated"].double()
                                      - ref_align["log_priors_updated"].double()).abs().max())
                               for _, s in ranks),
             "accumulators_rel": max(float(((s["priors"][k].double()
                                             - ref_align["priors"][k].double()).abs()
                                            / ref_align["priors"][k].double().abs()
                                            .clamp_min(1e-30)).max())
                                     for _, s in ranks for k in ("log_priors_sum",
                                                                 "prior_count")),
             "grad_rel": max(_rel(torch, [s["grads"][k] for k in sorted(ref_align["grads"])],
                                  [ref_align["grads"][k] for k in sorted(ref_align["grads"])])
                             for _, s in ranks),
             "weight_err_over_move": max(
                 _weight_err_over_move(torch, ref_align["before"], s["after_first"],
                                       ref_align["after_first"])["text_aligner"]
                 for _, s in ranks),
             "weight_err_over_move_4": max(
                 _weight_err_over_move(torch, ref_align["before"], s["after"],
                                       ref_align["after"])["text_aligner"] for _, s in ranks),
             "ranks_alike": all(_weights_equal(torch, ranks[0][1]["after"], s["after"])
                                for _, s in ranks),
             "launches": [res["launches"] for res, _ in ranks]}
        errs[name] = e
        bad += [f"{name} {k}" for k, lim in (("loss_rel", MESH_LOSS_RTOL),
                                            ("priors_abs", MESH_PRIOR_ATOL),
                                            ("accumulators_rel", MESH_PRIOR_RTOL),
                                            ("grad_rel", MESH_GRAD_RTOL),
                                            ("weight_err_over_move", MESH_ALIGN_WEIGHT_RTOL),
                                            ("weight_err_over_move_4", MESH_ALIGN_WEIGHT_RTOL))
                if not e[k] <= lim]
        if not e["ranks_alike"] or any(l[k] != MESH_ALIGN_STEPS for l in e["launches"]
                                       for k in l):
            bad.append(f"{name} ranks alike {e['ranks_alike']}, CTC launches {e['launches']}")
    stage_ranks = by_mesh["stages"]
    for stage in MESH_STAGES:
        ref = ref_stages[stage]
        e = {"metric_rel": {k: max(abs(res[stage]["metrics"][k] - v) / max(abs(v), 1e-30)
                                   for res, _ in stage_ranks)
                            for k, v in ref["metrics"].items()},
             "weight_err_over_move": {n: max(_weight_err_over_move(
                 torch, ref["before"], s[stage], ref["after"])[n] for _, s in stage_ranks)
                 for n in ref["after"]}}
        errs[stage] = e
        bad += [f"{stage} metric {k}" for k, v in e["metric_rel"].items()
                if not v <= MESH_STAGE_METRIC_RTOL]
        bad += [f"{stage} weights {n}" for n, v in e["weight_err_over_move"].items()
                if not v <= MESH_STAGE_WEIGHT_RTOL]
    errs["align_one_process_again"] = {
        "loss_rel": float(((ref_again["losses"].double() - ref_align["losses"].double()).abs()
                           / ref_align["losses"].double().abs()).max()),
        "weight_err_over_move": _weight_err_over_move(
            torch, ref_align["before"], ref_again["after"], ref_align["after"])["text_aligner"]}
    report.update(errors=errs, ranks={k: [res for res, _ in v] for k, v in by_mesh.items()},
                  ranks_s=ranks_s,
                  reference_step_ms={"align": ref_align["step_ms"],
                                     **{s: r["step_ms"] for s, r in ref_stages.items()}},
                  launches_per_rank={name: [res["launches"] for res, _ in by_mesh[name]]
                                     for name in MESH_SHAPES})
    report["shares"] = mesh_shares(torch)
    report["wall_s"] = time.time() - t0
    for name in MESH_SHAPES:
        r0 = by_mesh[name][0][0]
        log(f"mesh {name} {MESH_SHAPES[name]} alignment (4 gloo ranks on one card): errors "
            f"{errs[name]}; collectives per step {r0['collectives_per_step']}; bytes of "
            f"parameters + moments on rank 0 {r0['bytes']}; step ms {r0['step_ms']} against "
            f"one process {ref_align['step_ms']} (ranks share one card: not a scaling figure)")
    r0 = stage_ranks[0][0]
    for stage in MESH_STAGES:
        log(f"mesh {MESH_STAGE_SHAPE} {stage} step: errors {errs[stage]}; collectives "
            f"{r0[stage]['collectives_per_step']}; bytes on rank 0 {r0[stage]['bytes']}; "
            f"step ms {r0[stage]['step_ms']:.1f} against one process "
            f"{ref_stages[stage]['step_ms']:.1f} (ranks share one card: not a scaling figure)")
    log(f"one process against itself: {errs['align_one_process_again']}")
    log(f"mesh phase: {report['wall_s']:.1f} s (ranks {ranks_s:.1f} s)")
    if bad:
        fail(f"the meshes against one process: {bad}")
    return report


def main() -> int:
    if len(sys.argv) > 1:
        return child_main(sys.argv[1:])
    torch = require_card()
    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    phase_s = {}  # wall seconds of each phase, in order
    mark = [time.time()]

    def lap(name):
        now = time.time()
        phase_s[name] = now - mark[0]
        mark[0] = now

    phase_build()
    lap("1_build")

    # fp32 everywhere, as the trainer sets it too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trainer, state, batch, main_run = phase_main_path(torch, Path(tmp))
    main_shape, step_ms, profile = phase_step_time(torch, trainer, state, batch)
    lap("2_main_path")

    checks = phase_check(torch, main_shape)
    lap("3_check")
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
    lap("4_time")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_front_") as tmp:
        front = phase_front_end(torch, Path(tmp), card)
        lap("6_front_end")
        acoustic = phase_stages(torch, Path(tmp), card)
        lap("7_stages")
        recipe = phase_recipe(torch, Path(tmp))
        lap("8_recipe")
        ringformer = phase_ringformer(torch, Path(tmp), card)
        lap("9_ringformer")
        audiobook = phase_audiobook(torch, Path(tmp), card)
        lap("10_audiobook")
        imported = phase_imported(torch, Path(tmp), card)
        lap("11_imported")
        data_parallel = phase_data_parallel(torch, Path(tmp), card, batch, main_shape)
        lap("12_data_parallel")
        programs = phase_programs(torch, Path(tmp), card)
        lap("13_programs")
        mesh = phase_mesh(torch, Path(tmp), card, batch)
        lap("14_mesh")
    front_launches = front["train_align"]["launches"]
    if not all(front_launches.values()):
        fail(f"a CTC kernel of the front end's train-align never launched: {front_launches}")
    book_launches = audiobook["train_align"]["launches"]

    synthesis = phase_synthesis(torch, card)
    lap("5_synthesis")

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
            "launches": book_launches[key],
            "launches_by_path": {"audiobook_train_align": book_launches[key],
                                 "front_end_train_align": front_launches[key],
                                 "main_path_train_align": main_run["launches"][key],
                                 "imported_voice": imported["ctc_launches"][key],
                                 "data_parallel_world_one_align":
                                     data_parallel["world_one"]["align_launches"][key],
                                 "data_parallel_two_ranks_align":
                                     data_parallel["two_ranks"]["launches"][key],
                                 "mesh_1x1_nccl_align":
                                     mesh["world_one"]["align_launches"][key],
                                 **{f"mesh_{name}_align_per_rank": [
                                     l[key] for l in mesh["launches_per_rank"][name]]
                                    for name in MESH_SHAPES}},
            "max_abs_err": max(checks["main_path"][err], audiobook["kernel_check"][err]),
            "ms": tm[key]["ms"], "plain_ms": tm[key]["plain_ms"],
            "bound_ms": tm[key]["bound_ms"], "bound_by": tm[key]["bound_by"],
            "library_ms": tm[key]["library_ms"]})
    report = {"card": card, "main_path": {**main_run, "shape": main_shape},
              "step_ms": step_ms, "step_profile": profile, "checks": checks,
              "timings": timings, "frame_fit": fit, "kernels": kernels,
              "front_end": front, "synthesis": synthesis, "acoustic": acoustic,
              "recipe": recipe, "ringformer": ringformer, "audiobook": audiobook,
              "imported": imported, "data_parallel": data_parallel, "programs": programs,
              "mesh": mesh, "phase_s": phase_s,
              "wall_s": time.time() - t_start}
    log("phase wall s: " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}))
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"total {time.time() - t_start:.1f} s; details in {OUT / 'chip_smoke.json'}")

    times, prof = synthesis["times"], synthesis["profile"]
    print(json.dumps({"speak": {
        "card": card, "rtf_b1": times["rtf_b1"], "batch8_rtf": times["batch8_rtf"],
        "phases_ms": {str(b["text_bucket"]): [b["duration_ms"], b["acoustic_ms"]]
                      for b in times["per_bucket"]},
        "profile_frames": prof["frame_bucket"], "profile_device_ms": prof["device_ms"],
        "profile_busy_share": prof["busy_share"], "profile_launches": prof["launches"],
        "groups_ms": {g: v["ms"] for g, v in prof["groups"].items()},
        **{"card_vs_cpu_" + k: synthesis["card_vs_cpu"][k]
           for k in ("wave_max_abs_err", "wave_tol", "wave_peak", "wave_rms")}}}),
        flush=True)
    vit = front["viterbi"]
    print(json.dumps({"front_end": {
        "card": card, "wall_s": front["wall_s"],
        "pitch_s": front["pitch"]["seconds"], "pitch_batch8_ms": front["pitch"]["batch_ms"],
        "pitch_voicing_agree": front["pitch"]["voicing_agree"],
        "pitch_f0_max_rel_err": front["pitch"]["f0_max_rel_err"],
        "pitch_truth_median_rel_err": front["pitch"]["truth_median_rel_err"],
        "train_align_s": front["train_align"]["wall_s"],
        "train_align_launches": front_launches,
        "validation_batches": front["train_align"]["validation_batches"],
        "resume_loss_max_rel_err": front["resume"]["loss_max_rel_err"],
        "resume_weight_max_abs_err": front["resume"]["weight_max_abs_err"],
        "resume_weight_span_max_abs": front["resume"]["weight_span_max_abs"],
        "checkpoint_save_ms": front["resume"]["save_ms"],
        "checkpoint_load_ms": front["resume"]["load_ms"],
        "checkpoint_bytes": front["resume"]["bytes"],
        "align_s": front["align"]["seconds"], "align_batch8_ms": vit["batch_ms"],
        "viterbi_ms": {k: v["ms"] for k, v in vit["viterbi"].items()},
        "viterbi_launches": {k: v["launches"] for k, v in vit["viterbi"].items()},
        "align_busy_share": vit["profile"]["busy_share"],
        "loader_ms": front["loader"]}}), flush=True)
    mv = acoustic["moves"]
    print(json.dumps({"acoustic": {
        "card": card, "train_s": acoustic["wall_s"], "train_steps": acoustic["steps"],
        "ctc_launches": acoustic["ctc_launches"],
        "validation_mel": [v["mel"] for v in acoustic["validations"]],
        "resume_metric_max_rel_err": acoustic["resume_metric_max_rel_err"],
        "resume_weight_err_over_move": max(acoustic["resume_weight_err_over_move"].values()),
        "card_vs_cpu_metric_max_rel_err": max(acoustic["card_vs_cpu"]["metric_rel_err"].values()),
        "card_vs_cpu_weight_max_abs_err": acoustic["card_vs_cpu"]["weight_max_abs_err"],
        "mel_first_last": [mv["metrics"][0]["mel"], mv["metrics"][-1]["mel"]],
        "step_ms_b16": mv["step_ms_median"], "device_ms": mv["device_ms"],
        "busy_share": mv["busy_share"], "launches": mv["launches"],
        "peak_memory_gib": mv["peak_memory_bytes"] / 2**30, "wavlm_share": mv["wavlm_share"],
        "groups_ms": {g: v["ms"] for g, v in mv["groups"].items()}}}), flush=True)
    stages, lmv, lcc = acoustic["stages"], acoustic["later_moves"], acoustic["later_card_vs_cpu"]
    print(json.dumps({"later_stages": {
        "card": card, "ctc_launches": acoustic["ctc_launches"],
        "steps": {k: [v["steps"], v["B"]] for k, v in stages.items()},
        "validations": {k: [{m: x for m, x in v.items() if m not in ("stage", "batches")}
                            for v in stages[k]["validations"]]
                        for k in ("textual", "duration")},
        "textual_start_metric_max_rel_err": acoustic["textual_start_metric_max_rel_err"],
        "textual_resume_metric_max_rel_err": acoustic["textual_resume_metric_max_rel_err"],
        "textual_resume_weight_err_over_move": max(
            acoustic["textual_resume_weight_err_over_move"].values()),
        **{f"{s}_card_vs_cpu_metric_max_rel_err": max(lcc[s]["metric_rel_err"].values())
           for s in lcc},
        **{f"{s}_card_vs_cpu_weight_err_over_move": max(lcc[s]["weight_err_over_move"].values())
           for s in lcc},
        **{f"{s}_{k}": lmv[s][k] for s in lmv for k in (
            "B", "step_ms_median", "device_ms", "busy_share", "launches", "loss_first_last")},
        **{f"{s}_peak_memory_gib": lmv[s]["peak_memory_bytes"] / 2**30 for s in lmv},
        "textual_frozen_speech_share": lmv["textual"]["frozen_speech_share"],
        **{f"{s}_groups_ms": {g: v["ms"] for g, v in lmv[s]["groups"].items()} for s in lmv}}}),
        flush=True)
    rv, sl, rm = recipe["voicepack"], recipe["slm_cache"], recipe["rmvpe"]
    print(json.dumps({"recipe": {
        "card": card, "wall_s": recipe["wall_s"],
        "convert_s": recipe["convert"]["seconds"], "convert_modules": recipe["convert"]["modules"],
        "convert_leaves_bitwise": recipe["convert"]["leaves"],
        "pitch_log2": recipe["convert"]["pitch_log2"],
        "duration_stats": recipe["convert"]["duration_stats"],
        "voicepack_s": rv["seconds"], "voicepack_dynamic_s": rv["dynamic_seconds"],
        "styles_batch8_ms": rv["batch_ms"], "styles_card_vs_cpu": rv["card_vs_cpu"],
        "speak_s": recipe["speak"]["seconds"], "speak_audio_s": recipe["speak"]["audio_s"],
        "speak_rms": recipe["speak"]["rms"], "rtf_b1": recipe["speak"]["rtf_b1"],
        "speak_squeezed_lines": recipe["speak"]["squeezed_lines"],
        "rtf_b1_two_phase": recipe["speak"]["rtf_b1_two_phase"],
        "two_phase_audio_s": recipe["speak"]["two_phase_audio_s"],
        "random_weights_rtf_b1": synthesis["times"]["rtf_b1"],
        "slm_cache_s": sl["seconds"], "slm_cache_mb": sl["mb"],
        "slm_card_vs_cpu": sl["card_vs_cpu"], "slm_steps": sl["slm"],
        "slm_train_s": sl["train_s"], "slm_foreign_cache_raised": sl["foreign_raised"],
        "rmvpe_s": rm["seconds"], "rmvpe_batch8_ms": rm["batch_ms"],
        "yin_batch8_ms": front["pitch"]["batch_ms"],
        "rmvpe_salience_max_abs_err": rm["salience_max_abs_err"],
        "rmvpe_voicing_agree": rm["voicing_agree"],
        "rmvpe_f0_max_rel_err": rm["f0_max_rel_err"]}}), flush=True)
    rf, rm, rt = ringformer, ringformer["moves"], ringformer["times"]
    rp, rc = ringformer["profile"], ringformer["card_vs_cpu"]
    print(json.dumps({"ringformer": {
        "card": card, "wall_s": rf["wall_s"], "rtf_b1": rt["rtf_b1"],
        "batch8_rtf": rt["batch8_rtf"],
        "phases_ms": {str(b["text_bucket"]): [b["duration_ms"], b["acoustic_ms"]]
                      for b in rt["per_bucket"]},
        "profile_frames": rp["frame_bucket"], "profile_device_ms": rp["device_ms"],
        "profile_busy_share": rp["busy_share"], "profile_launches": rp["launches"],
        "profile_groups_ms": {g: v["ms"] for g, v in rp["groups"].items()},
        "card_vs_cpu_wave_max_abs_err": rc["wave_max_abs_err"],
        "card_vs_cpu_wave_tol": rc["wave_tol"], "pcph_err_ulps": rc["pcph_err_ulps"],
        "train_s": rf["train_s"], "steps": {k: [v["steps"], v["B"]] for k, v in rf["steps"].items()},
        "ctc_launches": rf["ctc_launches"],
        "mel_first_last": [rf["acoustic_metrics"][0]["mel"], rf["acoustic_metrics"][-1]["mel"]],
        "mag_first_last": [rf["acoustic_metrics"][0]["mag"], rf["acoustic_metrics"][-1]["mag"]],
        "phase_first_last": [rf["acoustic_metrics"][0]["phase"],
                             rf["acoustic_metrics"][-1]["phase"]],
        "step_ms_b16": rm["step_ms_median"], "device_ms": rm["device_ms"],
        "busy_share": rm["busy_share"], "launches": rm["launches"],
        "peak_memory_gib": rm["peak_memory_bytes"] / 2**30, "wavlm_share": rm["wavlm_share"],
        "groups_ms": {g: v["ms"] for g, v in rm["groups"].items()},
        "card_vs_cpu_metric_max_rel_err": max(rf["step_card_vs_cpu"]["metric_rel_err"].values()),
        "card_vs_cpu_weight_err_over_move": max(
            rf["step_card_vs_cpu"]["weight_err_over_move"].values()),
        "convert_leaves_bitwise": rf["convert"]["leaves"],
        "trained_rtf_b1": rf["trained_speak"]["rtf_b1"],
        "trained_speak_audio_s": rf["trained_speak"]["audio_s"]}}), flush=True)
    ab, rem, oom = audiobook, audiobook["remat"], audiobook["oom"]
    timed = {k: rem[k]["sizes"][str(REMAT_TIMED_B)] for k in ("off", "on")}
    print(json.dumps({"audiobook": {
        "card": card, "wall_s": ab["wall_s"], "path_s": ab["path_s"],
        "g2p_backend": ab["dataset"]["g2p_backend"],
        "narration_s": ab["dataset"]["narration_s"], "segments": ab["dataset"]["segments"],
        "dataset_s_per_narration_minute": ab["dataset"]["s_per_narration_minute"],
        "phonemes_min_max": ab["dataset"]["phonemes_min_max"], "pitch_s": ab["pitch_s"],
        "train_align_s": ab["train_align"]["wall_s"],
        "train_align_steps": ab["train_align"]["steps"],
        "train_align_launches": ab["train_align"]["launches"],
        "validation_batches": ab["train_align"]["validation_batches"],
        "align_s": ab["align"]["seconds"], "align_frames_min_max": ab["align"]["frames_min_max"],
        "kernel_check_shape": ab["kernel_check"]["shape"],
        "kernel_check_loss_max_rel_err": ab["kernel_check"]["loss_max_rel_err"],
        "kernel_check_grad_max_abs_err": ab["kernel_check"]["grad_max_abs_err"],
        "book_lines": ab["speak"]["lines"], "book_tokens_max": ab["speak"]["tokens_max"],
        "book_lines_over_512": ab["speak"]["lines_over_512"],
        "book_audio_s": ab["speak"]["audio_s"], "book_rtf": ab["speak"]["rtf"],
        "book_rtf_lines": ab["speak"]["rtf_lines"],
        "book_lufs_min_max": ab["speak"]["lufs_min_max"],
        **{f"remat_{k}_step_ms_b16": v["step_ms_median"] for k, v in timed.items()},
        **{f"remat_{k}_device_ms_b16": v["device_ms"] for k, v in timed.items()},
        **{f"remat_{k}_launches_b16": v["launches"] for k, v in timed.items()},
        **{f"remat_{k}_peak_gib": {b: (r.get("peak_bytes") or r["peak_bytes_at_oom"]) / 2**30
                                   for b, r in rem[k]["sizes"].items()}
           for k in ("off", "on")},
        **{f"remat_{k}_oom_at": [b for b, r in rem[k]["sizes"].items() if r["oom"]]
           for k in ("off", "on")},
        **{f"remat_{k}_largest_b": rem[k]["largest_b"] for k in ("off", "on")},
        **{f"remat_{k}_free_gib_at_start": rem[k]["free_bytes_at_start"] / 2**30
           for k in ("off", "on")},
        "remat_first_step_rel_err": rem["first_step_rel_err"],
        "remat_card_vs_cpu_metric_max_rel_err": max(rem["card_vs_cpu"]["metric_rel_err"].values()),
        "remat_card_vs_cpu_weight_err_over_move": max(
            rem["card_vs_cpu"]["weight_err_over_move"].values()),
        "oom_cap_gib": oom["cap_bytes"] / 2**30, "oom_peak_gib": oom["peak_bytes"] / 2**30,
        "oom_shrinks": oom["shrinks"], "oom_stale_skips": oom["stale_skips"],
        "oom_table": oom["table"], "oom_steps": oom["steps"],
        "oom_batch_sizes": oom["batch_sizes"]}}), flush=True)
    im, ip, ic = imported, imported["profile"], imported["card_vs_cpu"]
    print(json.dumps({"imported": {
        "card": card, "wall_s": im["wall_s"], "parameters": im["parameters"],
        "reference_mb": im["reference_mb"], "reference_write_s": im["write_s"],
        "import_s": im["import_s"], "checkpoint_mb": im["checkpoint_mb"],
        "leaves_bitwise": im["leaves_bitwise"], "convert_s": im["convert"]["seconds"],
        "convert_leaves_bitwise": im["convert"]["leaves"], "voicepack_s": im["voicepack_s"],
        "styles_card_vs_cpu": im["styles_card_vs_cpu"],
        "styles_batch8_ms": im["styles_batch_ms"], "speak_s": im["speak"]["seconds"],
        "speak_audio_s": im["speak"]["audio_s"], "speak_rms": im["speak"]["rms"],
        "rtf_b1": im["speak"]["rtf_b1"], "rtf_b1_two_phase": im["speak"]["rtf_b1_two_phase"],
        "speak_squeezed_lines": im["speak"]["squeezed_lines"],
        "card_vs_cpu_duration_max_abs_err": ic["duration_max_abs_err"],
        "card_vs_cpu_wave_max_abs_err": ic["wave_max_abs_err"],
        "card_vs_cpu_wave_tol": ic["wave_tol"], "card_vs_cpu_wave_peak": ic["wave_peak"],
        "profile_frames": ip["frame_bucket"], "profile_call_ms": ip["call_ms"],
        "profile_device_ms": ip["device_ms"], "profile_busy_share": ip["busy_share"],
        "profile_launches": ip["launches"],
        "profile_groups_ms": {g: v["ms"] for g, v in ip["groups"].items()},
        "random_weights_profile_device_ms": prof["device_ms"],
        "random_weights_profile_launches": prof["launches"],
        "ctc_launches": im["ctc_launches"]}}), flush=True)
    dp, dpe = data_parallel, data_parallel["two_ranks"]["errors"]
    print("data parallel: the machine holds one card, so no multi-GPU scaling number "
          "exists; two ranks share that card through gloo", flush=True)
    print(json.dumps({"data_parallel": {
        "card": card, "wall_s": dp["wall_s"], "world_one_bitwise": dp["world_one"]["bitwise"],
        "world_one_step_ms": dp["world_one"]["step_ms"],
        "world_one_collectives": dp["world_one"]["collectives_ws1"],
        "two_ranks_errors": dpe, "two_ranks_ctc_launches": dp["two_ranks"]["launches"],
        "two_ranks_step_ms": {r["rank"]: [r["align_step_ms"], r["acoustic_step_ms"]]
                              for r in dp["two_ranks"]["ranks"]},
        "one_process_step_ms": dp["two_ranks"]["reference_step_ms"],
        "two_ranks_collectives": {k: dp["two_ranks"]["ranks"][0][k]
                                  for k in ("align_collectives", "acoustic_collectives")},
        "ctc_checked_u512_runs": dp["ctc_checked"]["u512_runs"],
        "profile": {k: dp["profile"][k] for k in ("steps", "trace_mb", "kernel_events",
                                                  "kernel_ms", "kernel_names")},
        "flops_acoustic_b16": dp["flops"]["flops"],
        "achieved_tflops": dp["flops"]["achieved_tflops"],
        "mfu_vs_dense_bf16": dp["flops"]["mfu_vs_dense_bf16"]}}), flush=True)
    print(json.dumps({"programs": programs_summary(programs, card)}), flush=True)
    print("mesh: the ranks of each mesh share the one card through gloo, so no tensor-parallel "
          "speed or scaling number exists", flush=True)
    print(json.dumps({"mesh": mesh_summary(mesh, card)}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
