"""Traffic kind ``kokoro_lines``: one client, closed loop, each line of a
book through a Kokoro-82M package's ``generate_speech`` (the two-phase
path: the duration program, the durations to the host, the acoustic
program at the line's frame bucket) and ``normalize_loudness``.

Parameters (``ttsbench/traffic/<mix>.json``) as ``speak_lines``'s, whose
pool, order and strata functions this kind imports: ``pool`` lines whose
phoneme counts are made as ``prepare-book`` makes them from
``sizes_seed``, ``voices``, ``strata``, ``check_lines``,
``trace_seconds``. From ``--seed``: each line's phoneme ids (uniform over
1-177, between the two 0 pads), its voice (one of ``voices`` seeded
voicepacks of (510, 256); a line of n phonemes speaks with row n - 1, as
the port's ``voice_row`` picks it for the timed path and the reference's
``voice_style`` for its own) and the order. Set-up replays only the
duration program on each pool line, to learn its frame bucket, and builds
one acoustic program per (text bucket, frame bucket) pair.

The check, over ``check_lines`` finished lines drawn from the seed and the
longest: ``wave_gap``, the program's normalised waveform against the
reference's bucket path (``reference/kokoro.py``: the same buckets, the
same ``nn.LSTM``, convolutions and DFT bases, the same source draws) then
the reference's loudness copy; ``dur_mismatch``, the share of the lines'
ids whose integer duration, as the timed path fetched it, differs from
the reference's unpadded forward (Kokoro's own, batch 1, the LSTM cell
written out); ``unpadded_mel_gap``, the mel spectral convergence of the
unpadded forward's normalised waveform (with the same draws on its
samples) against the program's. ``checks/<cell>.json`` says which are
compared; the others are logged.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict

import numpy as np

from ttsbench import checks
from ttsbench.harness import DeviceTrace, RunRecord, log, p95, rate
from ttsbench.traffic.speak_lines import line_order, pool_sizes

# the mel of unpadded_mel_gap: Kokoro's training mel (24 kHz)
MEL = {"n_fft": 2048, "hop_length": 300, "win_length": 1200, "n_mels": 80,
       "sample_rate": 24000}
PHONEME_IDS = (1, 178)  # the ids a line draws from, [lo, hi)


def make_pool(params: dict, seed: int) -> list:
    """The lines: ids with their two 0 pads, and a voice."""
    rng = np.random.default_rng([seed, 11])
    pool = []
    for n in pool_sizes(params):
        ids = np.concatenate([[0], rng.integers(*PHONEME_IDS, size=n), [0]]).astype(np.int32)
        pool.append({"tokens": ids, "voice": int(rng.integers(params["voices"]))})
    return pool


def check_sample(params: dict, seed: int, finished) -> list:
    """The lines the check reads: a seeded draw of ``check_lines`` and the
    longest."""
    finished = sorted(finished)
    rng = np.random.default_rng([seed, 15])
    k = min(params["check_lines"], len(finished))
    return sorted(set(int(i) for i in rng.choice(finished, k, replace=False)))


class Reference:
    """The reference's modules from the seed, float32 with TF32 off unless
    ``control``."""

    def __init__(self, config: dict, device, seed: int):
        import torch

        from ttsbench.reference import kokoro as R

        self.R, self.config = R, config
        self.device = torch.device(device)
        self.models = R.make_models(config["model"], self.device, seed, config["f0_bias_hz"],
                                    config["duration_head"])
        self.hop = R.frame_samples(R.config(config["model"]))

    def bucket(self, ids: np.ndarray, pack: np.ndarray, control: bool = False):
        """(integer durations, normalised waveform) of the bucket path, with
        the voicepack ``pack``'s row of the line."""
        import torch

        from ttsbench.reference import precision
        from ttsbench.reference.stts.tts.loudness import normalize_loudness
        from ttsbench.reference.synth import frame_bucket, text_bucket

        R = self.R
        with torch.inference_mode(), (precision.tf32() if control else precision.exact()):
            L = text_bucket(ids.shape[0])
            texts = torch.zeros((1, L), dtype=torch.long, device=self.device)
            texts[0, :ids.shape[0]] = torch.as_tensor(ids, dtype=torch.long)
            lengths = torch.tensor([ids.shape[0]], device=self.device)
            style = torch.as_tensor(R.voice_style(pack, ids), device=self.device)[None]
            dur, d = R.durations_bucket(self.models, texts, lengths, style,
                                        torch.tensor(1.0, device=self.device))
            f = int(dur.sum())
            F = frame_bucket(f)
            noise = R.source_noise(1, F, self.hop, self.device)
            audio = R.acoustic_bucket(self.models, texts, lengths, dur, d, style, F, noise)
            audio = audio[0, :f * self.hop].cpu().numpy()
            dur = dur[0, :ids.shape[0]].long().cpu().numpy()
        return dur, normalize_loudness(audio, MEL["sample_rate"], -25.0)

    def unpadded(self, ids: np.ndarray, pack: np.ndarray):
        """(integer durations, normalised waveform) of Kokoro's own forward,
        its source reading the first samples of the bucket's draws."""
        import torch

        from ttsbench.reference import precision
        from ttsbench.reference.stts.tts.loudness import normalize_loudness
        from ttsbench.reference.synth import frame_bucket

        R = self.R
        with torch.inference_mode(), precision.exact():
            ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
            style = torch.as_tensor(R.voice_style(pack, ids), device=self.device)
            dur, d = R.durations_unpadded(self.models, ids_t, style)
            noise = R.source_noise(1, frame_bucket(int(dur.sum())), self.hop, self.device)[0]
            audio = R.acoustic_unpadded(self.models, ids_t, dur, d, style, noise)
            audio, dur = audio.cpu().numpy(), dur.long().cpu().numpy()
        return dur, normalize_loudness(audio, MEL["sample_rate"], -25.0)


def line_numbers(lines: list, ref: Reference, control: bool = False) -> Dict[str, float]:
    """``wave_gap``, ``dur_mismatch`` and ``unpadded_mel_gap`` over
    ``lines``: (ids, voicepack, program's durations, program's waveform)."""
    waves, mels, mismatched, ids_total = [], [], 0, 0
    for ids, pack, dur, out in lines:
        _, bucket = ref.bucket(ids, pack, control)
        udur, unpadded = ref.unpadded(ids, pack)
        waves.append(checks.wave_gap(out, bucket, ref.hop))
        mels.append(checks.mel_gap(out, unpadded, ref.hop, MEL))
        mismatched += int((np.asarray(dur) != udur).sum())
        ids_total += ids.shape[0]
    return {"wave_gap": max(waves), "dur_mismatch": mismatched / ids_total,
            "unpadded_mel_gap": max(mels)}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: Path):
        self.config, self.params, self.seed = config, traffic, seed
        self.device, self.workdir = device, Path(workdir)

    def setup(self) -> None:
        import torch

        from stylish_tts_torch.config import KokoroConfig
        from stylish_tts_torch.export import open_package
        from stylish_tts_torch.export.package import export_checkpoint
        from stylish_tts_torch.models import build_models
        # imported here, not in the window: its scipy import takes seconds
        from stylish_tts_torch.tts.loudness import normalize_loudness
        from ttsbench.reference import kokoro as R

        t0 = time.perf_counter()
        self.normalize = normalize_loudness
        mc = KokoroConfig.model_validate(self.config["model"])
        self.mc = mc
        self.pool = make_pool(self.params, self.seed)
        self.voices = R.make_voicepacks(self.params["voices"], self.seed,
                                        width=2 * mc.style_dim)
        weights = R.make_weights(self.config["model"], self.device, self.seed,
                                 self.config["f0_bias_hz"], self.config["duration_head"])
        with torch.device(self.device):
            models = build_models(mc)
        for k, m in models.items():
            m.load_state_dict(weights[k])
        del weights
        pkg_dir = self.workdir / "package"
        export_checkpoint(models, mc, None, str(pkg_dir))
        del models
        self.pkg = open_package(str(pkg_dir), device=self.device)
        t_pkg = time.perf_counter()

        self.durations: Dict[int, np.ndarray] = {}
        by_length = sorted(self.pool, key=lambda line: -line["tokens"].shape[0])
        self.pkg.warmup([(line["tokens"], self._row(line)) for line in by_length])
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        built = {name: sum(len(v) for v in getattr(self.pkg, name).values())
                 for name in ("_acoustic_fns", "_duration_fns")}
        lengths = [p["tokens"].shape[0] for p in self.pool]
        log(f"set-up: package {t_pkg - t0:.2f} s; warm-up of {len(self.pool)} lines "
            f"({min(lengths)}-{max(lengths)} ids, median {int(np.median(lengths))}) "
            f"{time.perf_counter() - t_pkg:.2f} s; programs built {built}")
        self.order = line_order(self.params, self.seed, 100_000)
        rng = np.random.default_rng([self.seed, 14])
        longest = sorted(range(len(self.pool)),
                         key=lambda i: -self.pool[i]["tokens"].shape[0])[:4]
        draw = min(4 * self.params["check_lines"], len(self.pool))
        self.keep = set(int(i) for i in rng.choice(len(self.pool), draw, replace=False))
        self.keep |= set(longest)
        self.outputs: Dict[int, np.ndarray] = {}

    def _row(self, line: dict) -> np.ndarray:
        from stylish_tts_torch.export.kokoro import voice_row

        return voice_row(self.voices[line["voice"]], line["tokens"].shape[0])

    def _run(self, seconds: float, spans: Dict[str, list]) -> tuple:
        lat, audio_s, n, served = [], 0.0, 0, []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = int(self.order[self.pos])
            self.pos += 1
            line = self.pool[i]
            row = self._row(line)
            a = time.perf_counter()
            s0 = time.time_ns()
            audio = self.pkg.generate_speech(line["tokens"], row)
            s1 = time.time_ns()
            out = self.normalize(audio, self.mc.sample_rate)
            s2 = time.time_ns()
            lat.append(time.perf_counter() - a)
            spans["generate_speech"].append((s0, s1))
            spans["loudness"].append((s1, s2))
            audio_s += out.shape[0] / self.mc.sample_rate
            served.append((i, out.shape[0]))
            if i in self.keep and i not in self.outputs:
                self.outputs[i] = out
                self.durations[i] = self.pkg.last_durations
            n += 1
        return n, time.perf_counter() - t0, lat, audio_s, served

    def window(self, seconds: float) -> dict:
        self.pos = 0
        self.spans = {"generate_speech": [], "loudness": []}
        n, window_s, lat, audio_s, served = self._run(seconds, self.spans)
        self.attempted, self.served = n, served
        return {"synth_audio_s_per_s": rate(audio_s, window_s),
                "line_p95_ms": p95(lat) * 1e3}

    def traced_window(self, seconds: float) -> RunRecord:
        import torch

        self.pos = 0
        spans = self.spans = {"generate_speech": [], "loudness": []}
        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with DeviceTrace() as trace:
            lo = time.time_ns()
            n, _, _, audio_s, served = self._run(seconds, spans)
            hi = time.time_ns()
        self.attempted, self.served = n, served
        return trace.record(n, lo, hi, spans, audio_s=audio_s,
                            peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)

    def info(self) -> str:
        means = {k: sum(e - b for b, e in v) / max(len(v), 1) / 1e6
                 for k, v in self.spans.items()}
        return (f"lines served {self.attempted}; mean ms: "
                + ", ".join(f"{k} {v:.2f}" for k, v in means.items()))

    def release(self) -> None:
        import torch

        del self.pkg
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, traced: bool = False) -> tuple:
        """(numbers, FLOPs of the traced window's lines or None)."""
        from ttsbench.reference.kokoro import LineFlops

        sample = check_sample(self.params, self.seed, self.outputs)
        sample.append(max(self.outputs, key=lambda i: self.pool[i]["tokens"].shape[0]))
        ref = Reference(self.config, self.device, self.seed)
        lines = [(self.pool[i]["tokens"], self.voices[self.pool[i]["voice"]],
                  self.durations[i], self.outputs[i]) for i in sorted(set(sample))]
        self.checked = len(lines)
        numbers = line_numbers(lines, ref)
        flops = None
        if traced:
            count = LineFlops(self.config["model"])
            flops = sum(count(self.pool[i]["tokens"].shape[0], samples // ref.hop)
                        for i, samples in self.served)
        return numbers, flops


def control(cell, seed: int, device: str) -> Dict[str, float]:
    """The control's numbers: the reference's bucket path with TF32 on in
    the program's place, on the lines a run of ``seed`` compares (the
    sample drawn from the whole pool)."""
    ref = Reference(cell.config, device, seed)
    params = cell.traffic
    pool = make_pool(params, seed)
    from ttsbench.reference.kokoro import make_voicepacks

    voices = make_voicepacks(params["voices"], seed, width=2 * cell.config["model"]["style_dim"])
    sample = check_sample(params, seed, range(len(pool)))
    sample.append(max(range(len(pool)), key=lambda i: pool[i]["tokens"].shape[0]))
    lines = []
    for i in sorted(set(sample)):
        ids, pack = pool[i]["tokens"], voices[pool[i]["voice"]]
        dur, out = ref.bucket(ids, pack, control=True)
        lines.append((ids, pack, dur, out))
    return line_numbers(lines, ref)
