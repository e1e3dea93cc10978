"""Traffic kind ``speak_lines``: one client, closed loop, each line
through ``InferencePackage.generate_speech`` (the fused path through its
bucket programs) and ``normalize_loudness``, as ``speak`` serves a line.

Parameters (``ttsbench/traffic/<mix>.json``): ``pool`` lines whose sizes
are made as ``prepare-book`` makes them, from ``sizes_seed`` (the same for
every run, so every seed does the same work): sentence lengths in tokens
log-normal (``sentence_median_tokens``, ``sentence_sigma``), capped at
``max_tokens``, packed greedily into lines of at most ``max_tokens`` tokens
(the two pads and one space between sentences counted) within chapters of
``chapter_sentences`` sentences. From ``--seed``: each line's symbols, its
voice (one of ``voices`` seeded style triples), and the order: rounds of
one line from each of ``strata`` length strata, the strata and the lines
within each in seeded orders, so that every round carries nearly the same
work. ``check_lines``: how many finished lines, drawn from the seed, and
the longest, are held against the reference; ``trace_seconds``: the traced
window.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from ttsbench import checks
from ttsbench.harness import DeviceTrace, RunRecord, log, p95, rate

PADS = 2  # the tokenizer's pad at each end


def sentence_lengths(params: dict, rng) -> np.ndarray:
    n = params["chapter_sentences"]
    raw = rng.lognormal(np.log(params["sentence_median_tokens"]), params["sentence_sigma"], n)
    return np.clip(np.round(raw), 1, params["max_tokens"] - PADS).astype(int)


def pack(lengths, budget: int) -> List[int]:
    """Greedy packing of sentence lengths into lines of at most ``budget``
    symbols (one space between sentences), ``pack_utterances``' rule."""
    out, cur = [], 0
    for s in lengths:
        if cur and cur + 1 + s > budget:
            out.append(cur)
            cur = s
        else:
            cur = cur + 1 + s if cur else s
    if cur:
        out.append(cur)
    return out


def pool_sizes(params: dict) -> List[int]:
    """The symbol count of each line of the pool (without the pads)."""
    rng = np.random.default_rng(params["sizes_seed"])
    sizes: List[int] = []
    while len(sizes) < params["pool"]:
        sizes += pack(sentence_lengths(params, rng), params["max_tokens"] - PADS)
    return sizes[:params["pool"]]


def make_pool(params: dict, seed: int, symbols: str, cleaner) -> List[dict]:
    """The pool of lines: tokens and voice of each."""
    rng = np.random.default_rng([seed, 11])
    letters = list(symbols)
    table = letters + [" "] * 8
    pool = []
    for n in pool_sizes(params):
        chars = rng.choice(table, size=n)
        chars[0], chars[-1] = rng.choice(letters, size=2)
        tokens = np.asarray(cleaner("".join(chars)), np.int32)
        pool.append({"tokens": tokens, "voice": int(rng.integers(params["voices"]))})
    return pool


def make_voices(params: dict, seed: int, style_dim: int) -> np.ndarray:
    """(voices, 3, style_dim): speech, pitch/energy and duration styles."""
    rng = np.random.default_rng([seed, 12])
    return (0.5 * rng.standard_normal((params["voices"], 3, style_dim))).astype(np.float32)


def line_order(params: dict, seed: int, count: int) -> np.ndarray:
    """``count`` pool indices: rounds of one line from each length stratum
    (the pool sorted by size, cut into ``strata`` groups), the strata in a
    seeded order each round, each stratum's lines in a seeded cycle."""
    rng = np.random.default_rng([seed, 13])
    sizes = pool_sizes(params)
    by_size = sorted(range(params["pool"]), key=sizes.__getitem__)
    strata = np.array_split(np.asarray(by_size), params["strata"])
    cycles = [rng.permutation(st) for st in strata]
    out, r = [], 0
    while len(out) < count:
        for k in rng.permutation(len(strata)):
            out.append(int(cycles[k][r % len(cycles[k])]))
        r += 1
    return np.asarray(out[:count])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: Path):
        self.config, self.params, self.seed = config, traffic, seed
        self.device, self.workdir = device, Path(workdir)

    def setup(self) -> None:
        import torch

        from stylish_tts_torch.config import ModelConfig
        from stylish_tts_torch.export.package import InferencePackage, export_checkpoint
        from stylish_tts_torch.models import INFERENCE_MODULES, build_models
        from stylish_tts_torch.trainer.normalization import NormalizationStats
        from ttsbench.reference import train as ref
        from ttsbench.reference.stts.text import TextCleaner

        t0 = time.perf_counter()
        mc = ModelConfig.model_validate(self.config["model"])
        self.mc = mc
        ref_mc = ref.model_config(self.config["model"])
        self.pool = make_pool(self.params, self.seed,
                              ref_mc.symbol.letters_ipa.replace("'", ""),
                              TextCleaner(ref_mc.symbol))
        self.voices = make_voices(self.params, self.seed, mc.style_dim)
        weights, _ = ref.make_weights(self.config["model"], self.device, self.seed,
                                      self.config["f0_bias_hz"], with_wavlm=False,
                                      duration_head=self.config["duration_head"])
        with torch.device(self.device):
            models = build_models(mc)
        models = {k: models[k] for k in INFERENCE_MODULES}
        for k, m in models.items():
            m.load_state_dict(weights[k])
        del weights
        pkg_dir = self.workdir / "package"
        export_checkpoint(models, mc, NormalizationStats(), str(pkg_dir),
                          duration_stats=self.config["duration_stats"])
        del models
        self.pkg = InferencePackage(str(pkg_dir), device=self.device)
        t_pkg = time.perf_counter()

        # every line of the pool once, largest first, through the timed entry
        for i in sorted(range(len(self.pool)), key=lambda i: -self.pool[i]["tokens"].shape[0]):
            self._serve(i)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        built = {name: sum(len(v) for v in getattr(self.pkg, name).values())
                 for name in ("_fused_fns", "_acoustic_fns", "_duration_fns")}
        lengths = [p["tokens"].shape[0] for p in self.pool]
        log(f"set-up: package {t_pkg - t0:.2f} s; warm-up of {len(self.pool)} lines "
            f"({min(lengths)}-{max(lengths)} tokens, median {int(np.median(lengths))}) "
            f"{time.perf_counter() - t_pkg:.2f} s; programs built {built}")
        self.order = line_order(self.params, self.seed, 100_000)
        rng = np.random.default_rng([self.seed, 14])
        longest = sorted(range(len(self.pool)),
                         key=lambda i: -self.pool[i]["tokens"].shape[0])[:4]
        # lines whose output the check may read: a seeded draw and the longest
        draw = min(4 * self.params["check_lines"], len(self.pool))
        self.keep = set(int(i) for i in rng.choice(len(self.pool), draw, replace=False))
        self.keep |= set(longest)
        self.outputs: Dict[int, np.ndarray] = {}

    def _serve(self, i: int) -> np.ndarray:
        from stylish_tts_torch.tts.loudness import normalize_loudness

        line = self.pool[i]
        speech, pe, dur = self.voices[line["voice"]]
        audio = self.pkg.generate_speech(line["tokens"], speech, pe, dur)
        return normalize_loudness(audio, self.mc.sample_rate)

    def _run(self, seconds: float, spans: Dict[str, list]) -> tuple:
        from stylish_tts_torch.tts.loudness import normalize_loudness

        lat, audio_s, n = [], 0.0, 0
        served = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = int(self.order[self.pos])
            self.pos += 1
            line = self.pool[i]
            speech, pe, dur = self.voices[line["voice"]]
            a = time.perf_counter()
            s0 = time.time_ns()
            audio = self.pkg.generate_speech(line["tokens"], speech, pe, dur)
            s1 = time.time_ns()
            out = normalize_loudness(audio, self.mc.sample_rate)
            s2 = time.time_ns()
            lat.append(time.perf_counter() - a)
            spans["generate_speech"].append((s0, s1))
            spans["loudness"].append((s1, s2))
            audio_s += out.shape[0] / self.mc.sample_rate
            served.append((i, out.shape[0]))
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
        return record

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
        from ttsbench.reference.synth import LineFlops, Synthesizer

        finished = sorted(self.outputs)
        rng = np.random.default_rng([self.seed, 15])
        k = min(self.params["check_lines"], len(finished))
        sample = set(int(i) for i in rng.choice(finished, k, replace=False))
        sample.add(max(finished, key=lambda i: self.pool[i]["tokens"].shape[0]))
        synth = Synthesizer(self.config, self.device, self.seed)
        hop = self.mc.hop_length * self.mc.coarse_multiplier
        pairs = []
        for i in sorted(sample):
            line = self.pool[i]
            pairs.append((self.outputs[i], synth.line(line["tokens"],
                                                      *self.voices[line["voice"]])))
        self.checked = len(pairs)
        numbers = checks.line_numbers(pairs, hop, checks.mel_settings(synth.mc))
        flops = None
        if traced:
            count = LineFlops(self.config["model"])
            flops = sum(count(self.pool[i]["tokens"].shape[0], samples // hop)
                        for i, samples in self.served)
        return numbers, flops
