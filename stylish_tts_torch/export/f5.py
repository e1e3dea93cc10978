"""An F5-TTS v1 Base package: export, and synthesis of text chunks through
bucket programs.

A package directory holds:

  params.safetensors   the DiT's and Vocos's weights, ``dit.<parameter>``
                       and ``vocos.<parameter>``, float32
  model_config.json    the ``F5Config`` (``"family": "f5"``)
  metadata.json        ``framework`` and ``family``

``export.open_package(dir)`` opens such a directory as an ``F5Package``. A
voice is a reference clip and its transcript (``load_voice``): the clip's
log-mel and the transcript's ids and bytes. A line is cut into chunks by
F5-TTS's ``chunk_text`` at the voice's budget; a chunk of T frames (the
reference's and the generated text's, ``models.f5.chunk_frames``) runs in
two programs, each a ``programs.BucketProgram`` (a CUDA graph on the card)
in the package's one pool: the sample program at ``frame_bucket(T)``
(the text conditioning of both guidance rows, all the guided Euler steps
and the output mel; ``_sample_fns[F]``) and the Vocos program at
``frame_bucket(g)`` of the g generated frames (``_vocode_fns[G]``). The
chunks' waveforms are joined with F5-TTS's cross-fade.

The DiT runs in ``F5Config.dit_dtype`` on a card (float16, as F5-TTS casts
it) and in float32 on the CPU; Vocos and the mel in float32.

Spans (``utils/trace.py``): ``speak.line`` around a chunk, with
``speak.prep``, ``speak.sample`` (the sample program's replay until its mel
is on hand; it holds that wait as a ``speak.fetch``), ``speak.vocode`` (the
Vocos program's replay) and the final ``speak.fetch`` inside. Counters:
``speak.nfe`` (``cond``, ``uncond``: DiT evaluations of each guidance row),
``speak.frames`` (a chunk's frames and its frame bucket's) and
``programs.built.f5`` (``sample``, ``vocode``).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from safetensors.torch import load_file, save_file
from torch import nn

from ..config import F5Config
from ..dsp.mel import MelSpectrogram
from ..models import f5 as M
from ..utils.trace import counter, span
from .programs import FRAMES, BucketPackage, frame_bucket

# DiT evaluations of each guidance row
NFE = counter("speak.nfe", ("cond", "uncond"))
# the family's programs built, by phase (``programs.built`` keeps the
# Stylish and Kokoro phases)
BUILT = counter("programs.built.f5", ("sample", "vocode"))
LOG_FLOOR = 1e-5  # F5-TTS's clamp before the mel's log
TARGET_RMS = 0.1  # a quieter reference clip is raised to it (``infer_process``)
MAX_FRAMES = 4096  # a chunk's frames at most (``CFM.sample``'s ``max_duration``)
CROSS_FADE_S = 0.15  # the overlap of two chunks' waveforms (``infer_process``)


def export_f5(models: Mapping[str, nn.Module], config: F5Config, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    flat = {f"{name}.{key}": value.detach().float().cpu().contiguous()
            for name in M.F5_MODULES for key, value in models[name].state_dict().items()}
    save_file(flat, osp.join(out_dir, "params.safetensors"))
    with open(osp.join(out_dir, "model_config.json"), "w", encoding="utf-8") as f:
        f.write(config.model_dump_json(indent=2))
    with open(osp.join(out_dir, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump({"framework": "stylish_tts_torch", "family": "f5"}, f, indent=2)
    return out_dir


@dataclass
class F5Voice:
    """A reference clip as F5-TTS conditions on it."""

    mel: np.ndarray  # (frames, mels) float32: the clip's log-mel, every centred frame
    ids: np.ndarray  # the transcript's ids
    text_bytes: int  # the transcript's UTF-8 bytes
    audio_frames: int  # the clip's samples // hop
    seconds: float  # the clip's length


def cross_fade(waves, samples: int) -> np.ndarray:
    """F5-TTS's join of its chunks' waveforms: each overlap of ``samples``
    (at most either wave's length) faded linearly."""
    out = waves[0]
    for nxt in waves[1:]:
        n = min(samples, len(out), len(nxt))
        if n <= 0:
            out = np.concatenate([out, nxt])
            continue
        faded = out[-n:] * np.linspace(1, 0, n) + nxt[:n] * np.linspace(0, 1, n)
        out = np.concatenate([out[:-n], faded, nxt[n:]]).astype(np.float32)
    return out


class F5Package(BucketPackage):
    """An F5-TTS package on ``device``; ``generate_speech(ids, voice)``.
    ``dtype`` is the DiT's: the configuration's on a card, float32 on the
    CPU."""

    BUILT = BUILT
    SPEAK_COUNTERS = (("programs built while speaking", BUILT), ("frames", FRAMES),
                      ("DiT evaluations", NFE))

    def __init__(self, package_dir: str, device: str = "cuda"):
        with open(osp.join(package_dir, "model_config.json"), encoding="utf-8") as f:
            self.mc = F5Config.model_validate_json(f.read())
        super().__init__(device)
        self.dtype = dtype = (getattr(torch, self.mc.dit_dtype) if self.device.type == "cuda"
                              else torch.float32)
        params = load_file(osp.join(package_dir, "params.safetensors"))
        built = M.build_f5_models(self.mc)
        for name, module in built.items():
            prefix = name + "."
            module.load_state_dict({k[len(prefix):]: v for k, v in params.items()
                                    if k.startswith(prefix)})
            module.to(self.device).eval()
        self.dit = built["dit"].to(dtype)
        self.vocos = built["vocos"]
        mel = self.mc.mel_spec
        self.mels = mel.n_mel_channels
        self.hop = mel.hop_length
        self.mel = MelSpectrogram(n_mels=mel.n_mel_channels, n_fft=mel.n_fft,
                                  win_length=mel.win_length, hop_length=mel.hop_length,
                                  sample_rate=mel.target_sample_rate, power=1.0,
                                  log_floor=LOG_FLOOR)
        sampler = self.mc.sampler
        self.times = M.sway_times(sampler.nfe_step, sampler.sway_sampling_coef)
        self._sample_fns: Dict[int, Dict[int, object]] = {}
        self._vocode_fns: Dict[int, Dict[int, object]] = {}

    # ---- voices ------------------------------------------------------------

    def tokenize(self, text: str) -> np.ndarray:
        """Text -> ids, a character each (F5-TTS's ``list_str_to_idx``:
        characters outside the vocabulary take id 0)."""
        if not self.mc.vocab:
            raise ValueError("the package's configuration has no vocabulary")
        return np.asarray([self.mc.vocab.get(c, 0) for c in text], np.int64)

    @torch.inference_mode()
    def make_voice(self, audio: np.ndarray, ids: np.ndarray, text_bytes: int) -> F5Voice:
        """A voice from a clip at the package's sample rate (raised to
        ``TARGET_RMS`` where quieter) and its transcript's ids and bytes."""
        audio = np.asarray(audio, np.float32)
        rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64))))
        if 0 < rms < TARGET_RMS:
            audio = audio * np.float32(TARGET_RMS / rms)
        mel = self.mel(self._tensor(audio)[None])[0].T.cpu().numpy()
        return F5Voice(mel=mel, ids=np.asarray(ids, np.int64), text_bytes=int(text_bytes),
                       audio_frames=audio.shape[0] // self.hop,
                       seconds=audio.shape[0] / self.mc.sample_rate)

    def load_voice(self, path: str) -> F5Voice:
        """A reference clip (a wav file) and its transcript, the text file of
        the same name with the suffix ``.txt``; the transcript ends in
        ``". "`` and one more space (after a one-byte character), as F5-TTS
        prepares it."""
        from ..data.wav import read_wav

        audio = read_wav(path, self.mc.sample_rate)
        with open(osp.splitext(path)[0] + ".txt", encoding="utf-8") as f:
            text = f.read().strip()
        if not text.endswith("。"):
            text += " " if text.endswith(".") else ". "
        if len(text[-1].encode("utf-8")) == 1:
            text += " "
        return self.make_voice(audio, self.tokenize(text), len(text.encode("utf-8")))

    # ---- the phases --------------------------------------------------------

    def _chunk(self, gen_ids, voice: F5Voice, gen_bytes, speed: float, seed: int):
        """(frames, generated frames, the sample program's inputs)."""
        ids = np.concatenate([voice.ids, np.asarray(gen_ids, np.int64)])
        sampler = self.mc.sampler
        total = M.chunk_frames(voice.audio_frames, voice.text_bytes,
                               len(gen_ids) if gen_bytes is None else gen_bytes,
                               ids.shape[0], speed, MAX_FRAMES)
        size = frame_bucket(total)
        text = np.zeros((1, size), np.int64)
        n = min(ids.shape[0], total)
        text[0, :n] = ids[:n] + 1
        cond = np.zeros((1, size, self.mels), np.float32)
        ref = min(voice.mel.shape[0], total)
        cond[0, :ref] = voice.mel[:ref]
        noise = np.zeros((1, size, self.mels), np.float32)
        noise[0, :total] = M.draw_noise(total, self.mels, seed).numpy()
        inputs = (self._tensor(text, torch.long), self._tensor(cond), self._tensor(noise),
                  self._tensor([ref], torch.long), self._tensor([total], torch.long))
        return total, total - voice.audio_frames, inputs

    @torch.inference_mode()
    def sample(self, ids, cond, noise, ref_len, total):
        return M.sample(self.dit, ids, cond, noise, ref_len, total, self.times,
                        self.mc.sampler.cfg_strength)

    @torch.inference_mode()
    def vocode(self, mel, frames):
        return M.vocode(self.vocos, mel, frames)

    def _sample_fn(self, size: int, example):
        return self._program("sample", self._sample_fns, size, 1, self.sample, example)

    def _vocode_fn(self, size: int, example):
        return self._program("vocode", self._vocode_fns, size, 1, self.vocode, example)

    def _vocode_inputs(self, mel, cut: int, total: int):
        """The generated frames of a sampled mel (1, F, mels) as the Vocos
        program's inputs at their frame bucket."""
        g = total - cut
        vin = torch.zeros((1, self.mels, frame_bucket(g)), device=self.device)
        vin[0, :, :g] = mel[0, cut:total].T
        return vin, self._tensor([g], torch.long)

    def warmup(self, chunks: Iterable[tuple]) -> tuple:
        """Build the programs that ``chunks``, (ids, voice, bytes, speed,
        seed) tuples, reach: one sample program per frame bucket and one
        Vocos program per bucket of generated frames, the largest first,
        each from its first chunk's own inputs and replayed on them once (a
        graph's first launch costs more than its later ones). Returns the
        numbers of sample and Vocos programs."""
        samples, vocodes = {}, {}
        for gen_ids, voice, gen_bytes, speed, seed in chunks:
            total, g, inputs = self._chunk(gen_ids, voice, gen_bytes, speed, seed)
            samples.setdefault(inputs[0].shape[1], inputs)
            vocodes.setdefault(frame_bucket(g), g)
        for size in sorted(samples, reverse=True):
            self._sample_fn(size, samples[size])(*samples[size])
        for size in sorted(vocodes, reverse=True):
            example = (torch.zeros((1, self.mels, size), device=self.device),
                       self._tensor([vocodes[size]], torch.long))
            self._vocode_fn(size, example)(*example)
        return len(samples), len(vocodes)

    # ---- public API --------------------------------------------------------

    def speak_line(self, text: str, voice: F5Voice, speed: float = 1.0) -> np.ndarray:
        """A line of text: its chunks at the voice's budget (chunk k drawn
        from seed k), joined with F5-TTS's cross-fade."""
        sampler = self.mc.sampler
        budget = M.max_chars(voice.text_bytes, voice.seconds, sampler.max_seconds, speed)
        waves = [self.generate_speech(self.tokenize(chunk), voice,
                                      gen_bytes=len(chunk.encode("utf-8")), speed=speed,
                                      seed=k)
                 for k, chunk in enumerate(M.chunk_text(text, budget))]
        if not waves:
            return np.zeros(0, np.float32)
        return cross_fade(waves, int(CROSS_FADE_S * self.mc.sample_rate))

    def generate_speech(self, gen_ids: np.ndarray, voice: F5Voice,
                        gen_bytes: Optional[int] = None, speed: float = 1.0,
                        seed: int = 0) -> np.ndarray:
        """One chunk: the generated text's ids (``gen_bytes`` its UTF-8 bytes,
        by default one an id) in ``voice``, x_0 drawn from ``seed`` ->
        the generated frames' waveform, float32 (hop g,) at 24 kHz."""
        with self._line():
            with span("speak.prep"):
                total, g, inputs = self._chunk(gen_ids, voice, gen_bytes, speed, seed)
                self._count_frames(total, inputs[0].shape[1])
                nfe = self.mc.sampler.nfe_step
                NFE["cond"] += nfe
                NFE["uncond"] += nfe
            with span("speak.sample"):
                mel = self._sample_fn(inputs[0].shape[1], inputs)(*inputs)
                with span("speak.fetch"):
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
            with span("speak.prep"):
                vin = self._vocode_inputs(mel, voice.audio_frames, total)
            with span("speak.vocode"):
                audio = self._vocode_fn(vin[0].shape[-1], vin)(*vin)
            with span("speak.fetch"):
                return audio[0, :g * self.hop].cpu().numpy()

    @torch.inference_mode()
    def probe(self, gen_ids: np.ndarray, voice: F5Voice, gen_bytes: Optional[int] = None,
              speed: float = 1.0, seed: int = 0) -> dict:
        """One chunk's sampler run eagerly, for checks: ``velocity``, the
        first step's guided velocity on the chunk's frames (total, mels)
        float32, and ``residual_max``, the largest magnitude of the last
        block's residual stream over every step."""
        total, _, (ids, cond, noise, ref_len, tot) = self._chunk(gen_ids, voice, gen_bytes,
                                                                 speed, seed)
        cfg = self.mc.sampler.cfg_strength
        seen = []
        hook = self.dit.transformer_blocks[-1].register_forward_hook(
            lambda module, args, out: seen.append(out.float().abs().amax()))
        try:
            M.sample(self.dit, ids, cond, noise, ref_len, tot, self.times, cfg)
        finally:
            hook.remove()
        c = M.conditioning(self.dit, ids, cond, ref_len, tot)
        velocity = M.guided_velocity(self.dit, noise, c, self.times[0], cfg)
        return {"velocity": velocity[0, :total].cpu().numpy(),
                "residual_max": float(torch.stack(seen).max())}
