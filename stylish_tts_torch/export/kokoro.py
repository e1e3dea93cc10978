"""A Kokoro-82M inference package: export, and synthesis on the two-phase
path through bucket programs.

A package directory holds:

  params.safetensors   the five modules' weights, ``<module>.<parameter>``
                       (``models/kokoro.py`` ``KOKORO_MODULES``)
  model_config.json    the ``KokoroConfig`` (``"family": "kokoro"``)
  metadata.json        ``framework`` and ``family``

``export.open_package(dir)`` opens such a directory as a ``KokoroPackage``.
A line runs in two programs, as Kokoro's own inference is in effect: the
duration program at text bucket L (the line's ids with their two 0 pads)
gives the integer durations and the duration encoder's output; the host
reads the durations and sums them to the line's frames f; the acoustic
program at (L, frame_bucket(f)) builds the one-hot alignment in the graph
and gives the audio. Both are ``programs.BucketProgram``s (CUDA graphs on
the card) in the package's one pool, cached in ``_duration_fns[L]`` and
``_acoustic_fns[(L, F)]`` (``programs.BucketPackage``'s caches), at batch
1. The source's noise of a frame bucket's program is drawn once, from a
generator seeded 0.

Spans (``utils/trace.py``): ``speak.line`` around a call, with
``speak.prep``, ``speak.durations`` (from the duration program's replay to
the durations on the host; it holds that ``speak.fetch``) and the final
``speak.fetch`` inside. The counter ``speak.frames``
(``programs.FRAMES``) adds each line's frames (``real``) and its frame
bucket's (``bucket``).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Mapping

import numpy as np
import torch
from safetensors.torch import load_file, save_file
from torch import nn

from ..config import KokoroConfig
from ..models import kokoro as K
from ..utils.trace import span
from .programs import FRAMES, SOURCE_SEED, BucketPackage, frame_bucket


def export_kokoro(models: Mapping[str, nn.Module], config: KokoroConfig, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    flat = {f"{name}.{key}": value.detach().cpu().contiguous()
            for name in K.KOKORO_MODULES for key, value in models[name].state_dict().items()}
    save_file(flat, osp.join(out_dir, "params.safetensors"))
    with open(osp.join(out_dir, "model_config.json"), "w", encoding="utf-8") as f:
        f.write(config.model_dump_json(indent=2))
    with open(osp.join(out_dir, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump({"framework": "stylish_tts_torch", "family": "kokoro"}, f, indent=2)
    return out_dir


def load_voice(path: str) -> np.ndarray:
    """A Kokoro voicepack, (510, 256) float32: kokoro's own ``.pt`` tensor
    (510, 1, 256), or a ``.safetensors`` file of one tensor."""
    if path.endswith(".pt"):
        pack = torch.load(path, map_location="cpu", weights_only=True)
    else:
        pack = next(iter(load_file(path).values()))
    return pack.reshape(pack.shape[0], -1).float().numpy()


def voice_row(pack: np.ndarray, n_ids: int) -> np.ndarray:
    """The row of a line of ``n_ids`` ids (its phonemes and two pads)."""
    return pack[min(max(n_ids - 3, 0), pack.shape[0] - 1)]


class KokoroPackage(BucketPackage):
    """A Kokoro package on ``device``; ``generate_speech(ids, ref_s)``."""

    SPEAK_COUNTERS = BucketPackage.SPEAK_COUNTERS + (("frames", FRAMES),)

    def __init__(self, package_dir: str, device: str = "cuda"):
        with open(osp.join(package_dir, "model_config.json"), encoding="utf-8") as f:
            self.mc = KokoroConfig.model_validate_json(f.read())
        super().__init__(device)
        params = load_file(osp.join(package_dir, "params.safetensors"))
        built = K.build_kokoro_models(self.mc)
        for name, module in built.items():
            prefix = name + "."
            module.load_state_dict({k[len(prefix):]: v for k, v in params.items()
                                    if k.startswith(prefix)})
            module.to(self.device).eval()
        self.models = built
        self.hop = self.mc.frame_samples
        self._noise: Dict[int, torch.Tensor] = {}
        self.last_durations = None  # the integer durations of the last line

    @torch.inference_mode()
    def noise(self, frames: int) -> torch.Tensor:
        """The source's draws of a frame bucket's program, made once."""
        if frames not in self._noise:
            self._noise[frames] = K.draw_noise(frames, self.hop, SOURCE_SEED, self.device)
        return self._noise[frames]

    # ---- the phases ------------------------------------------------------

    @torch.inference_mode()
    def durations(self, ids, lengths, ref_s, speed):
        return K.durations(self.models, ids, lengths, ref_s, speed)

    @torch.inference_mode()
    def acoustic(self, ids, lengths, dur, d, ref_s, frames: int, noise):
        return K.acoustic(self.models, ids, lengths, dur, d, ref_s, frames, noise)

    def _duration_fn(self, L: int, example):
        """(ids, lengths, ref_s, speed) -> (durations, d) at text bucket L;
        built on a miss from ``example``, a line's own inputs."""
        return self._program("duration", self._duration_fns, L, 1, self.durations, example)

    def _acoustic_fn(self, L: int, F: int, example):
        """(ids, lengths, durations, d, ref_s) -> audio at (L, F); built on
        a miss from ``example``, a line's own inputs."""
        noise = self.noise(F)

        def fn(ids, lengths, dur, d, ref_s):
            return self.acoustic(ids, lengths, dur, d, ref_s, F, noise)

        return self._program("acoustic", self._acoustic_fns, (L, F), 1, fn, example)

    def warmup(self, lines) -> int:
        """Build the programs that ``lines``, (ids, ref_s) pairs, reach: the
        duration program of each line's text bucket, replayed on the line to
        learn its frame bucket at speed 1, then one acoustic program per (text
        bucket, frame bucket) pair, the largest frame bucket first (as
        ``InferencePackage.warmup`` orders its captures), each from its
        first line's own inputs and replayed on them once: a graph's first
        launch costs more than its later ones (under the profiler, seconds
        for the 19 graphs of a book). Returns the number of acoustic
        programs."""
        examples = {}
        for tokens, ref_s in lines:
            L, host, inputs = self._line_durations(tokens, ref_s, 1.0)
            key = (L, frame_bucket(int(host.sum())))
            if key not in examples:
                examples[key] = tuple(t.clone() for t in inputs)
        for L, F in sorted(examples, key=lambda k: (-k[1], -k[0])):
            self._acoustic_fn(L, F, examples[(L, F)])(*examples[(L, F)])
        return len(examples)

    # ---- public API ------------------------------------------------------

    load_voice = staticmethod(load_voice)

    def speak_line(self, text: str, voice, speed: float = 1.0) -> np.ndarray:
        ids = self.tokenize(text)
        return self.generate_speech(ids, voice_row(voice, ids.shape[0]), speed=speed)

    def tokenize(self, text: str) -> np.ndarray:
        """Phoneme text -> ids through the configuration's vocabulary, with
        the two 0 pads (characters outside it are dropped, as kokoro does)."""
        if not self.mc.vocab:
            raise ValueError("the package's configuration has no vocabulary")
        ids = [self.mc.vocab[c] for c in text if c in self.mc.vocab]
        return np.asarray([0] + ids + [0], np.int32)

    def generate_speech(self, tokens: np.ndarray, ref_s, speed: float = 1.0) -> np.ndarray:
        """ids (n,), the line's phoneme ids between two 0 pads, and the
        voice's row ref_s (256,) -> waveform float32 (600 f,) at 24 kHz."""
        with self._line():
            L, host, inputs = self._line_durations(tokens, ref_s, speed)
            with span("speak.prep"):
                total = int(host.sum())
                F = frame_bucket(total)
                self._count_frames(total, F)
            self.last_durations = host[:tokens.shape[0]].astype(np.int64)
            audio = self._acoustic_fn(L, F, inputs)(*inputs)
            with span("speak.fetch"):
                return audio[0, :total * self.hop].cpu().numpy()

    def _line_durations(self, tokens, ref_s, speed):
        """The duration program on one line: (text bucket, the durations on
        the host, the acoustic program's inputs)."""
        with span("speak.prep"):
            ids, lengths = self._texts([np.asarray(tokens)])
            style = self._tensor(ref_s)[None]
            inputs = (ids, lengths, style, self._tensor(speed))
        with span("speak.durations"):
            dur, d = self._duration_fn(ids.shape[1], inputs)(*inputs)
            with span("speak.fetch"):
                host = dur[0].cpu().numpy()
        return ids.shape[1], host, (ids, lengths, dur, d, style)
