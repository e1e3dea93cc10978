"""Traffic kind ``f5_lines``: one client, closed loop, each chunk of a book
through an F5-TTS package's ``generate_speech`` (the sample program at the
chunk's frame bucket: the text conditioning, the guided Euler steps; then
the Vocos program at the generated frames' bucket) and
``normalize_loudness``, as ``speak`` serves F5-TTS's chunks one after
another.

Parameters (``ttsbench/traffic/<mix>.json``), and what each draws from:

* from ``sizes_seed`` (the same for every run, so every seed does the same
  work): each of ``voices`` voices' reference clip length, uniform over
  ``ref_seconds``, and its transcript's bytes, ``ref_bytes_per_s`` a
  second; the ``pool`` chunks: chapters of ``chapter_sentences`` sentences
  whose lengths in bytes are log-normal (``sentence_median_bytes``,
  ``sentence_sigma``), capped at the voice's budget, packed by F5-TTS's
  ``chunk_text`` rule into the budget ``infer_process`` gives the voice
  (reference and generated audio near the sampler's ``max_seconds``), a
  chapter each voice in turn;
* from ``--seed``: each voice's clip (a harmonic tone of its own pitch,
  vibrato and syllable rate, with a little noise) and its transcript's ids,
  each chunk's ids (uniform over the vocabulary) and its x_0's seed, and
  the order: rounds of one chunk from each of ``strata`` frame-count
  strata, the strata and each stratum's chunks in seeded orders, so that
  every round carries nearly the same work.

Set-up builds one sample program per frame bucket and one Vocos program
per bucket of generated frames that the pool reaches
(``F5Package.warmup``), without serving the pool.

The check, over ``check_chunks`` finished chunks drawn from the seed and
the longest: ``mel_gap``, the mel spectral convergence of the program's
normalised waveform against the reference's (``reference/f5.py``: F5-TTS's
unpadded batch-1 forward in float32, each guidance row its own forward,
the same x_0 and times, Vocos, then the reference's loudness copy);
logged: ``wave_gap``, ``velocity_gap`` (the first step's guided velocity,
the program's eager replay of that step against the reference's, relative
norm) and ``residual_max`` (the largest magnitude of the last DiT block's
residual stream over a chunk's steps, float16's range being 65,504).
``checks/<cell>.json`` says which are compared.

The control (``python -m ttsbench.f5_control``) runs the same program
with the DiT one precision below the configuration's (bfloat16), or with
a planted fault, on the chunks a run of each seed compares.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from ttsbench import checks
from ttsbench.harness import DeviceTrace, RunRecord, log, p95, rate, union_length

SPEED = 1.0
# the attention kernels of a device trace, told by name (lower case)
ATTENTION_KERNELS = ("fmha", "flash", "attention", "sdpa")


def attention_ms(run):
    """The union of the attention kernels' intervals in ``run``'s trace, in
    ms, or None where there are none."""
    spans = [(s, e) for s, e, name in run.device
             if any(k in name.lower() for k in ATTENTION_KERNELS)]
    if not spans:
        return None
    return union_length(spans) / 1e6


def sentence_lengths(params: dict, rng, budget: int) -> np.ndarray:
    raw = rng.lognormal(np.log(params["sentence_median_bytes"]), params["sentence_sigma"],
                        params["chapter_sentences"])
    return np.clip(np.round(raw), 2, budget).astype(int)


def pack(lengths, budget: int) -> List[int]:
    """``chunk_text``'s packing on sentence lengths: a sentence joins the
    chunk while the chunk's bytes with their trailing space and the
    sentence's fit the budget; a chunk is stripped of its last space."""
    out, cur = [], 0
    for s in lengths:
        if cur + s <= budget:
            cur += s + 1
        else:
            if cur:
                out.append(cur - 1)
            cur = s + 1
    if cur:
        out.append(cur - 1)
    return out


def voice_sizes(params: dict) -> list:
    """Each voice's (clip seconds, transcript bytes), from ``sizes_seed``."""
    rng = np.random.default_rng([params["sizes_seed"], 1])
    lo, hi = params["ref_seconds"]
    seconds = rng.uniform(lo, hi, params["voices"])
    return [(float(s), int(round(params["ref_bytes_per_s"] * s))) for s in seconds]


def budget(ref_bytes: int, seconds: float, max_seconds: float) -> int:
    """``infer_process``'s ``max_chars``."""
    return int(ref_bytes / seconds * (max_seconds - seconds) * SPEED)


def pool_sizes(params: dict, max_seconds: float) -> List[tuple]:
    """The pool's (voice, generated bytes) pairs."""
    rng = np.random.default_rng([params["sizes_seed"], 2])
    voices = voice_sizes(params)
    out, v = [], 0
    while len(out) < params["pool"]:
        seconds, ref_bytes = voices[v]
        cap = budget(ref_bytes, seconds, max_seconds)
        out += [(v, n) for n in pack(sentence_lengths(params, rng, cap), cap)]
        v = (v + 1) % len(voices)
    return out[:params["pool"]]


def voice_clip(seed: int, voice: int, seconds: float, sample_rate: int,
               rms: float) -> np.ndarray:
    """A clip of ``seconds``: harmonics of a pitch with vibrato under a
    syllable envelope, with a little noise, at ``rms``."""
    rng = np.random.default_rng([seed, 12, voice])
    t = np.arange(int(round(seconds * sample_rate))) / sample_rate
    f0 = rng.uniform(90.0, 220.0) * (1.0 + 0.04 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    tone = sum(np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h for h in range(1, 9))
    envelope = np.abs(np.sin(np.pi * rng.uniform(3.0, 5.0) * t + rng.uniform(0, np.pi)))
    x = tone * envelope + 0.05 * rng.standard_normal(t.shape)
    return (x * (rms / np.sqrt(np.mean(x * x)))).astype(np.float32)


def make_pool(params: dict, seed: int, vocab_size: int, max_seconds: float) -> list:
    """The chunks: voice, generated ids and bytes, x_0's seed."""
    rng = np.random.default_rng([seed, 11])
    pool = []
    for voice, n in pool_sizes(params, max_seconds):
        pool.append({"voice": voice, "ids": rng.integers(0, vocab_size, n), "bytes": n,
                     "noise_seed": int(rng.integers(2**62))})
    return pool


def make_voices(params: dict, seed: int, vocab_size: int, sample_rate: int,
                rms: float) -> list:
    """Each voice's clip, transcript ids and bytes."""
    rng = np.random.default_rng([seed, 13])
    return [{"audio": voice_clip(seed, v, s, sample_rate, rms),
             "ids": rng.integers(0, vocab_size, n), "bytes": n}
            for v, (s, n) in enumerate(voice_sizes(params))]


def chunk_order(frames: List[int], params: dict, seed: int, count: int) -> np.ndarray:
    """``count`` pool indices: rounds of one chunk from each frame-count
    stratum, as ``speak_lines``' ``line_order`` makes them."""
    rng = np.random.default_rng([seed, 14])
    by_size = sorted(range(len(frames)), key=frames.__getitem__)
    strata = np.array_split(np.asarray(by_size), params["strata"])
    cycles = [rng.permutation(st) for st in strata]
    out, r = [], 0
    while len(out) < count:
        for k in rng.permutation(len(strata)):
            out.append(int(cycles[k][r % len(cycles[k])]))
        r += 1
    return np.asarray(out[:count])


def check_sample(params: dict, seed: int, finished, frames: List[int]) -> list:
    """The chunks the check reads: a seeded draw of ``check_chunks`` and
    the longest."""
    finished = sorted(finished)
    rng = np.random.default_rng([seed, 15])
    k = min(params["check_chunks"], len(finished))
    sample = set(int(i) for i in rng.choice(finished, k, replace=False))
    sample.add(max(finished, key=frames.__getitem__))
    return sorted(sample)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: Path):
        self.config, self.params, self.seed = config, traffic, seed
        self.device, self.workdir = device, Path(workdir)

    def prepare(self) -> None:
        """The package from the seed's weights, the voices and the pool."""
        import torch

        from stylish_tts_torch.config import F5Config
        from stylish_tts_torch.export import open_package
        from stylish_tts_torch.export.package import export_checkpoint
        from stylish_tts_torch.models import build_models
        from stylish_tts_torch.models.f5 import chunk_frames
        # imported here, not in the window: its scipy import takes seconds
        from stylish_tts_torch.tts.loudness import normalize_loudness
        from ttsbench.reference import f5 as R

        self.normalize = normalize_loudness
        model = self.config["model"]
        mc = self.mc = F5Config.model_validate(model)
        sampler = mc.sampler
        weights = R.make_weights(model, self.device, self.seed)
        with torch.device(self.device):
            models = build_models(mc)
        for k, m in models.items():
            m.load_state_dict(weights[k])
        del weights
        pkg_dir = self.workdir / "package"
        export_checkpoint(models, mc, None, str(pkg_dir))
        del models
        self.pkg = open_package(str(pkg_dir), device=self.device)
        self.voice_inputs = make_voices(self.params, self.seed, mc.vocab_size, mc.sample_rate,
                                        R.TARGET_RMS)
        self.voices = [self.pkg.make_voice(v["audio"], v["ids"], v["bytes"])
                       for v in self.voice_inputs]
        self.pool = make_pool(self.params, self.seed, mc.vocab_size, sampler.max_seconds)
        for c in self.pool:
            v = self.voices[c["voice"]]
            c["frames"] = chunk_frames(v.audio_frames, v.text_bytes, c["bytes"],
                                       v.ids.shape[0] + c["bytes"], SPEED, R.MAX_FRAMES)
            c["generated"] = c["frames"] - v.audio_frames
        self.frames = [c["frames"] for c in self.pool]
        self.outputs: Dict[int, np.ndarray] = {}
        self.attempted = 0

    def setup(self) -> None:
        import torch

        t0 = time.perf_counter()
        self.prepare()
        t_pkg = time.perf_counter()
        built = self.pkg.warmup([self._args(c) for c in self.pool])
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        log(f"set-up: package and voices {t_pkg - t0:.2f} s; programs (sample, vocode) "
            f"{built} for {len(self.pool)} chunks ({min(self.frames)}-{max(self.frames)} "
            f"frames, median {int(np.median(self.frames))}) {time.perf_counter() - t_pkg:.2f} s")
        self.order = chunk_order(self.frames, self.params, self.seed, 100_000)
        rng = np.random.default_rng([self.seed, 16])
        longest = sorted(range(len(self.pool)), key=lambda i: -self.frames[i])[:4]
        draw = min(4 * self.params["check_chunks"], len(self.pool))
        self.keep = set(int(i) for i in rng.choice(len(self.pool), draw, replace=False))
        self.keep |= set(longest)

    def _args(self, c: dict) -> tuple:
        return c["ids"], self.voices[c["voice"]], c["bytes"], SPEED, c["noise_seed"]

    def serve(self, i: int) -> np.ndarray:
        ids, voice, n, speed, seed = self._args(self.pool[i])
        audio = self.pkg.generate_speech(ids, voice, gen_bytes=n, speed=speed, seed=seed)
        return self.normalize(audio, self.mc.sample_rate)

    def _run(self, seconds: float, spans: Dict[str, list]) -> tuple:
        lat, audio_s, n, served = [], 0.0, 0, []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = int(self.order[self.pos])
            self.pos += 1
            ids, voice, nbytes, speed, seed = self._args(self.pool[i])
            a = time.perf_counter()
            s0 = time.time_ns()
            audio = self.pkg.generate_speech(ids, voice, gen_bytes=nbytes, speed=speed,
                                             seed=seed)
            s1 = time.time_ns()
            out = self.normalize(audio, self.mc.sample_rate)
            s2 = time.time_ns()
            lat.append(time.perf_counter() - a)
            spans["generate_speech"].append((s0, s1))
            spans["loudness"].append((s1, s2))
            audio_s += out.shape[0] / self.mc.sample_rate
            served.append(i)
            if i in self.keep and i not in self.outputs:
                self.outputs[i] = out
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

        from ttsbench.reference.f5 import attention_flops

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
        record = trace.record(n, lo, hi, spans, audio_s=audio_s,
                              peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)
        # the attention's FLOPs of the traced chunks at their real frames,
        # for attention_roofline.synth
        record.attention_flops = sum(attention_flops(self.config["model"], self.frames[i])
                                     for i in served)
        return record

    def info(self) -> str:
        from stylish_tts_torch.export.programs import FRAMES

        means = {k: sum(e - b for b, e in v) / max(len(v), 1) / 1e6
                 for k, v in self.spans.items()}
        return (f"chunks served {self.attempted}; mean ms: "
                + ", ".join(f"{k} {v:.2f}" for k, v in means.items())
                + f"; frames (speak.frames) real {FRAMES['real']}, bucket {FRAMES['bucket']}")

    def release(self) -> None:
        """Probe the chunks the check reads (the program's first guided
        velocity, the residual stream's range), then free the program."""
        import torch

        self.sample = check_sample(self.params, self.seed, self.outputs, self.frames)
        self.probes = {i: self.pkg.probe(*self._args(self.pool[i])) for i in self.sample}
        log("residual stream's largest magnitude, last block: " + ", ".join(
            f"{self.frames[i]} frames {p['residual_max']:.4g}" for i, p in self.probes.items()))
        del self.pkg
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, traced: bool = False) -> tuple:
        """(numbers, FLOPs of the traced window's chunks or None)."""
        import torch

        from ttsbench.reference import f5 as R
        from ttsbench.reference import precision
        from ttsbench.reference.stts.tts.loudness import normalize_loudness

        model = self.config["model"]
        mel = self.mc.mel_spec
        settings = {"n_fft": mel.n_fft, "hop_length": mel.hop_length,
                    "win_length": mel.win_length, "n_mels": mel.n_mel_channels,
                    "sample_rate": mel.target_sample_rate}
        models = R.make_models(model, self.device, self.seed)
        mels, waves, velocities = [], [], []
        with torch.no_grad(), precision.exact():
            for i in self.sample:
                c = self.pool[i]
                v = self.voice_inputs[c["voice"]]
                chunk = R.make_chunk(model, v["audio"], v["ids"], v["bytes"], c["ids"],
                                     c["bytes"], c["noise_seed"], self.device, speed=SPEED)
                out = R.speak_chunk(models, model, chunk)
                ref = normalize_loudness(out["audio"].cpu().numpy(), mel.target_sample_rate,
                                         -25.0)
                prog = self.outputs[i]
                mels.append(checks.mel_gap(prog, ref, mel.hop_length, settings))
                waves.append(checks.wave_gap(prog, ref, mel.hop_length))
                want = out["velocity"].double().cpu()
                got = torch.as_tensor(self.probes[i]["velocity"]).double()
                velocities.append(float(torch.linalg.vector_norm(got - want)
                                        / torch.linalg.vector_norm(want)))
        self.checked = len(self.sample)
        numbers = {"mel_gap": max(mels), "wave_gap": max(waves),
                   "velocity_gap": max(velocities),
                   "residual_max": max(p["residual_max"] for p in self.probes.values())}
        flops = None
        if traced:
            count = R.ChunkFlops(model)
            flops = sum(count(self.frames[i], self.pool[i]["generated"]) for i in self.served)
        return numbers, flops
