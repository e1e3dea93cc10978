"""Traffic kind ``train_stage``: a training stage's step fed by the
program's prefetching loader, on a seeded corpus written in set-up.

Parameters (``ttsbench/traffic/<mix>.json``): ``stage`` (acoustic or
textual), ``batch``, ``clips``, ``clip_seconds`` [lo, hi], ``phonemes``
[lo, hi], ``f0_hz`` [lo, hi], ``lr``, ``stage_steps``, ``checked_steps``
(the first steps, held against the reference), ``max_warmup_steps``,
``trace_seconds`` (the traced window), ``loader_depth``.

The corpus: ``clips`` harmonic-plus-noise clips (3-10 harmonics of a
vibrato F0, a level of -24 to -6 dB, an amplitude envelope of 1-6 Hz,
noise at -60 to -30 dB, each drawn per clip so that the rows of a batch
differ as a corpus's do), each with a random
phoneme string, written as 16-bit WAVs with their pitch cache (the
generating F0 at the padded frames) and alignment cache (random positive
durations that fill the padded frames), in the ``data/caches.py`` format.
No ``pitch`` or ``align`` run. The batches: each epoch a seeded
permutation of the clips, cut into batches of ``batch``.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from ttsbench import checks
from ttsbench.harness import NATIVE_BUILD_DIR, DeviceTrace, RunRecord, log

SAMPLE_RATE = 24000


# ---------------------------------------------------------------- traffic


def corpus_rows(params: dict, seed: int, symbols: str) -> List[dict]:
    """The clips of the corpus: name, samples, base F0, phonemes, and the
    per-clip noise seed."""
    rng = np.random.default_rng([seed, 1])
    rows = []
    for i in range(params["clips"]):
        seconds = rng.uniform(*params["clip_seconds"])
        n_ph = int(rng.integers(params["phonemes"][0], params["phonemes"][1] + 1))
        rows.append({"name": f"clip{i:03d}.wav",
                     "samples": int(seconds * SAMPLE_RATE),
                     "f0": float(rng.uniform(*params["f0_hz"])),
                     "phonemes": "".join(rng.choice(list(symbols), size=n_ph)),
                     "level": float(10.0 ** rng.uniform(-1.2, -0.3)),
                     "harmonics": int(rng.integers(3, 11)),
                     "envelope_hz": float(rng.uniform(1.0, 6.0)),
                     "noise": float(10.0 ** rng.uniform(-3.0, -1.5)),
                     "noise_seed": int(rng.integers(2**31))})
    return rows


def clip_audio(row: dict) -> tuple:
    """(audio float32, F0 at each sample)."""
    t = np.arange(row["samples"]) / SAMPLE_RATE
    f0 = row["f0"] * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    audio = sum(np.sin(k * phase) / k for k in range(1, row["harmonics"] + 1))
    audio = row["level"] * audio * (0.6 + 0.4 * np.sin(2 * np.pi * row["envelope_hz"] * t) ** 2)
    audio = audio + row["noise"] * np.random.default_rng(row["noise_seed"]).standard_normal(
        t.shape)
    return audio.astype(np.float32), f0


def write_corpus(params: dict, seed: int, root: Path, symbols: str, hop: int) -> dict:
    """Write the clips, their list file and both caches under ``root``;
    returns the corpus description both sides read."""
    from safetensors.numpy import save_file
    from scipy.io import wavfile

    rows = corpus_rows(params, seed, symbols)
    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True)
    pitch, align = {}, {}
    rng = np.random.default_rng([seed, 2])
    for row in rows:
        audio, f0 = clip_audio(row)
        wavfile.write(str(wav_dir / row["name"]),
                      SAMPLE_RATE, (np.clip(audio, -1, 1) * 32767.0).astype(np.int16))
        frames = row["samples"] // hop
        padded = ((frames - 20) // 20) * 20 + 60
        start = (padded * hop - row["samples"]) // 2
        centres = np.arange(padded) * hop - start
        inside = (centres >= 0) & (centres < row["samples"])
        pitch[row["name"]] = np.where(inside, f0[np.clip(centres, 0, row["samples"] - 1)],
                                      0.0).astype(np.float32)
        n_tok = len(row["phonemes"]) + 2  # the tokenizer's two pads
        durs = 1 + rng.multinomial(padded - n_tok, np.full(n_tok, 1.0 / n_tok))
        align[row["name"]] = durs[None].astype(np.float32)
    save_file(pitch, str(root / "pitch.safetensors"))
    save_file(align, str(root / "alignment.safetensors"))
    (root / "train-list.txt").write_text(
        "".join(f"{r['name']}|{r['phonemes']}|0|clip\n" for r in rows), encoding="utf-8")
    return {"wav_dir": str(wav_dir), "pitch": str(root / "pitch.safetensors"),
            "alignment": str(root / "alignment.safetensors"),
            "list": str(root / "train-list.txt"),
            "names": [r["name"] for r in rows], "phonemes": [r["phonemes"] for r in rows]}


def batch_order(params: dict, seed: int) -> Iterator[List[int]]:
    """Endless row batches: each epoch a seeded permutation of the clips,
    cut into whole batches."""
    rng = np.random.default_rng([seed, 3])
    b = params["batch"]
    while True:
        perm = rng.permutation(params["clips"])
        for i in range(0, len(perm) - b + 1, b):
            yield sorted(int(x) for x in perm[i:i + b])


class _Sampler:
    """``batch_order`` as the loader's sampler: (time bin, rows)."""

    def __init__(self, params, seed, time_bin):
        self.params, self.seed, self.time_bin = params, seed, time_bin

    def __iter__(self):
        for rows in batch_order(self.params, self.seed):
            yield self.time_bin, rows


def replay_mrds(generator_state, steps: int) -> List[int]:
    """The MRD indices ``steps`` acoustic steps draw from a disc-index
    generator in ``generator_state`` (one ``randint(3)`` a step)."""
    import torch

    g = torch.Generator()
    g.set_state(generator_state)
    return [int(torch.randint(3, (1,), generator=g)) for _ in range(steps)]


# ---------------------------------------------------------------- driver


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: Path):
        self.config, self.params, self.seed = config, traffic, seed
        self.device, self.workdir = device, Path(workdir)
        self.stage = traffic["stage"]
        self.training = {k: traffic[k] for k in ("lr", "stage_steps", "state_seed")}

    # -- set-up

    def setup(self) -> None:
        import torch

        from stylish_tts_torch import native
        from stylish_tts_torch.config import ModelConfig
        from stylish_tts_torch.data.dataset import FilePathDataset
        from stylish_tts_torch.data.loader import PrefetchLoader
        from stylish_tts_torch.models import build_models
        from stylish_tts_torch.models.slm import WavLMEncoder, wavlm_loss
        from stylish_tts_torch.text import TextCleaner
        from stylish_tts_torch.trainer.normalization import NormalizationStats
        from stylish_tts_torch.trainer.state import create_stage_train_state
        from stylish_tts_torch.trainer.steps import (
            StepContext, batch_to_device, make_acoustic_step, make_textual_step)
        from ttsbench.reference import train as ref

        t0 = time.perf_counter()
        native.BUILD_DIR = NATIVE_BUILD_DIR
        self.native_cached = any(NATIVE_BUILD_DIR.glob("libstylish_io_*.so"))
        mc = ModelConfig.model_validate(self.config["model"])
        self.mc = mc
        symbols = ref.model_config(self.config["model"]).symbol.letters_ipa.replace("'", "")
        self.corpus = write_corpus(self.params, self.seed, self.workdir, symbols, mc.hop_length)
        t_corpus = time.perf_counter()

        weights, wavlm_sd = ref.make_weights(self.config["model"], self.device, self.seed,
                                             self.config["f0_bias_hz"],
                                             with_wavlm=self.stage == "acoustic")
        with torch.device(self.device):
            models = build_models(mc)
        for k, m in models.items():
            m.load_state_dict(weights[k])
        del weights
        state = create_stage_train_state(models, self.device, self.stage,
                                         seed=self.training["state_seed"])
        if wavlm_sd is not None:
            with torch.device(self.device):
                wavlm = WavLMEncoder()
            wavlm.load_state_dict(wavlm_sd)
            state.wavlm = wavlm.eval().requires_grad_(False)
            del wavlm_sd
        self.state = state
        ctx = StepContext(mc, ref.loss_weights(), NormalizationStats(),
                          stage_steps=self.training["stage_steps"],
                          base_lr=self.training["lr"],
                          slm_loss_fn=wavlm_loss if self.stage == "acoustic" else None,
                          mixed_precision=torch.device(self.device).type == "cuda")
        self.step = {"acoustic": make_acoustic_step, "textual": make_textual_step}[
            self.stage](ctx)
        t_state = time.perf_counter()

        with open(self.corpus["list"], encoding="utf-8") as f:
            lines = f.readlines()
        ds = FilePathDataset(
            data_list=lines, root_path=self.corpus["wav_dir"],
            text_cleaner=TextCleaner(mc.symbol), sample_rate=mc.sample_rate,
            coarse_hop_length=mc.hop_length * mc.coarse_multiplier,
            pitch_path=self.corpus["pitch"], alignment_path=self.corpus["alignment"])
        bins, _ = ds.time_bins()
        if len(bins) != 1:
            raise RuntimeError(f"the corpus spans time bins {sorted(bins)}, not one")
        loader = PrefetchLoader(ds, _Sampler(self.params, self.seed, next(iter(bins))),
                                mc.hop_length, require_pitch=True,
                                device_put=lambda b: batch_to_device(b, self.device),
                                depth=self.params["loader_depth"])
        self.loader = iter(loader)

        # the checked steps: the window's own call and feed
        draws = state.disc_index_generator.get_state()
        names = ref.trained_modules(self.stage)
        start = checks.leaf_snapshot(state.models, names)
        losses = []
        self.checked_rows = []
        order = batch_order(self.params, self.seed)
        first = checks.FirstCalls(checks.first_step_modules(state.models, self.stage))
        for i in range(self.params["checked_steps"]):
            _, batch, _ = next(self.loader)
            self.checked_rows.append(next(order))
            metrics = self.step(state, batch)
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                grads = checks.first_grad_norms(state, names)
                first.close()
        self.readings = {"losses": losses, "grads": grads, "first_calls": first.outputs,
                         "changes": checks.change_norms(state, names, start)}
        del start
        warm = 0
        while not self._warm(draws, warm) and warm < self.params["max_warmup_steps"]:
            _, batch, _ = next(self.loader)
            self.step(state, batch)
            warm += 1
        if not self._warm(draws, warm):
            raise RuntimeError(f"not every discriminator ran in {warm} warm-up steps")
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        log(f"set-up: corpus {t_corpus - t0:.2f} s; weights and state {t_state - t_corpus:.2f} s;"
            f" {self.params['checked_steps']} checked + {warm} warm-up steps, loader and "
            f"native build {t_end - t_state:.2f} s; native loader "
            f"{'cached' if self.native_cached else 'built in this run'}")

    def _warm(self, draws, warm: int) -> bool:
        """Every MRD has run its discriminator phase (so every shape the
        window runs has run): the program's draws, replayed."""
        steps = self.params["checked_steps"] + warm
        return self.stage != "acoustic" or set(replay_mrds(draws, steps)) == {0, 1, 2}

    # -- the window

    def _run(self, seconds: float, spans: Dict[str, list]) -> tuple:
        import torch

        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            a = time.time_ns()
            _, batch, _ = next(self.loader)
            b = time.time_ns()
            self.step(self.state, batch)
            c = time.time_ns()
            spans["loader.next"].append((a, b))
            spans["step"].append((b, c))
            steps += 1
        if cuda:
            torch.cuda.synchronize()
        return steps, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        self.spans = {"loader.next": [], "step": []}
        steps, window_s = self._run(seconds, self.spans)
        self.attempted = steps
        return {"train_step_ms": window_s * 1e3 / steps}

    def traced_window(self, seconds: float) -> RunRecord:
        import torch

        cuda = torch.device(self.device).type == "cuda"
        spans = self.spans = {"loader.next": [], "step": []}
        disc_gen = self.state.disc_index_generator.get_state()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with DeviceTrace() as trace:
            lo = time.time_ns()
            steps, _ = self._run(seconds, spans)
            hi = time.time_ns()
        self.attempted = steps
        record = trace.record(steps, lo, hi, spans,
                              peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)
        # which MRD each traced step ran: the program's draws, replayed
        self.traced_disc = (replay_mrds(disc_gen, steps) if self.stage == "acoustic"
                            else [None] * steps)
        return record

    def info(self) -> str:
        from stylish_tts_torch.data.loader import BATCHES

        means = {k: sum(e - b for b, e in v) / max(len(v), 1) / 1e6
                 for k, v in self.spans.items()}
        return (f"loader batches by path: {dict(BATCHES)}; mean ms: "
                + ", ".join(f"{k} {v:.2f}" for k, v in means.items()))

    def release(self) -> None:
        import torch

        self.loader.close()
        del self.loader, self.state, self.step
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check

    def check(self, traced: bool = False) -> tuple:
        """(numbers, FLOPs of the traced window's steps or None)."""
        from ttsbench.reference import train as ref

        indices = sorted(set(self.traced_disc)) if traced else None
        reading = ref.run_steps(self.stage, self.config["model"], self.training, self.seed,
                                self.config["f0_bias_hz"], self.corpus, self.checked_rows,
                                self.device, flops_disc_indices=indices)
        numbers = checks.training_numbers(self.readings, reading)
        log("worst, program/reference (gap): " + checks.explain(self.readings, reading))
        log(f"not compared: {checks.logged_numbers(self.readings, reading)}")
        flops = (sum(reading["flops"][k] for k in self.traced_disc) if traced else None)
        return numbers, flops

