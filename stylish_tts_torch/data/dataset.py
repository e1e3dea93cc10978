"""Dataset: file lists, duration binning, center padding, caches.

The port's copy of ``stylish_tts_tpu/data/dataset.py`` (the port imports
nothing of the JAX package).

Capability parity with the reference FilePathDataset
(reference: train/dataloader.py:20-181):
  * `file|phonemes|speaker|text` 4-field lists with hard validation
  * duration bins in 0.25 s steps (get_time_bin dataloader.py:425,
    get_frame_count dataloader.py:421), >= 0.25 s, <= 510 phonemes,
    phonemes <= frames
  * audio center-padded with zeros to its bin's frame boundary
    (dataloader.py:166-175)
  * pitch/alignment caches loaded wholesale into RAM
  * per-class duration weights from the alignment histogram
    (dataloader.py:36-51)

The duration-bucketed, center-padded design is already a static-shape
pipeline — exactly what TPU/XLA wants (SURVEY.md §2.8).
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..text import TextCleaner
from .caches import load_cache
from .wav import read_wav, wav_info

MAX_PHONEMES = 510
DURATION_CLASSES = 16


def get_frame_count(time_bin: int) -> int:
    return time_bin * 20 + 60


def get_time_bin(
    sample_count: int, coarse_hop_length: int, quantize: int = 1
) -> int:
    """Duration bin in 0.25 s steps (reference dataloader.py:425).

    quantize > 1 merges bins into groups of N steps by rounding the bin
    index UP to the top of its group — segments pad to the group
    boundary, so the number of distinct (bin, stage) compiled programs
    drops ~N× at the cost of up to N×0.25 s extra zero padding per
    segment. A TPU-only knob (`dataset.time_bin_quantize`): the
    reference recompiles nothing so never needs it; here each occupied
    bin is a fresh XLA program (PERF.md round-4 compile-budget table).
    """
    frames = sample_count // coarse_hop_length
    if frames < 20:
        return -1
    b = (frames - 20) // 20
    if quantize > 1:
        b = (b // quantize) * quantize + (quantize - 1)
    return b


@dataclass
class Segment:
    index: int
    wav_path: str
    phonemes: str
    speaker: int
    text: str
    time_bin: int = -1
    resampled_frames: int = 0


class DatasetError(ValueError):
    pass


class FilePathDataset:
    def __init__(
        self,
        *,
        data_list: List[str],
        root_path: str,
        text_cleaner: TextCleaner,
        sample_rate: int,
        coarse_hop_length: int,
        pitch_path: Optional[str] = None,
        alignment_path: Optional[str] = None,
        dur_to_class=None,
        slm_path: Optional[str] = None,
        time_bin_quantize: int = 1,
    ):
        self.root_path = root_path
        self.sample_rate = sample_rate
        self.coarse_hop_length = coarse_hop_length
        self.text_cleaner = text_cleaner
        # see get_time_bin: must match the value the pitch/alignment/slm
        # caches were generated with (collate detects a mismatch)
        self.time_bin_quantize = max(int(time_bin_quantize), 1)

        self.pitch: Dict[str, np.ndarray] = {}
        if pitch_path and osp.isfile(pitch_path):
            self.pitch = load_cache(pitch_path)

        # optional precomputed GT WavLM embeddings (dataprep/slm_cache)
        self.slm: Dict[str, np.ndarray] = {}
        if slm_path and osp.isfile(slm_path):
            self.slm = load_cache(slm_path)

        self.alignment: Dict[str, np.ndarray] = {}
        duration_hist = np.zeros(DURATION_CLASSES, np.float64)
        if alignment_path and osp.isfile(alignment_path):
            self.alignment = load_cache(alignment_path)
            if dur_to_class is not None:
                for arr in self.alignment.values():
                    classes = np.asarray(dur_to_class(arr[0])).astype(np.int64)
                    duration_hist += np.bincount(
                        classes, minlength=DURATION_CLASSES
                    )[:DURATION_CLASSES]
        with np.errstate(divide="ignore", invalid="ignore"):
            self.duration_weights = duration_hist.sum() / (
                duration_hist * DURATION_CLASSES
            )
        self.duration_weights = np.nan_to_num(
            self.duration_weights, nan=0.0, posinf=0.0
        ).astype(np.float32)

        self.segments: List[Segment] = []
        for line in data_list:
            line = line.strip()
            if not line:
                continue
            fields = line.split("|")
            if len(fields) != 4:
                raise DatasetError(
                    "Dataset lines must have 4 |-delimited fields: " + line
                )
            self.segments.append(
                Segment(
                    index=len(self.segments),
                    wav_path=fields[0],
                    phonemes=fields[1],
                    speaker=int(fields[2]),
                    text=fields[3],
                )
            )

    def __len__(self):
        return len(self.segments)

    def time_bins(self) -> Tuple[Dict[int, List[int]], Dict[int, float]]:
        """Scan headers, validate, and bucket segment indices by bin."""
        bins: Dict[int, List[int]] = {}
        seconds_per_bin: Dict[int, float] = {}
        for seg in self.segments:
            info = wav_info(osp.join(self.root_path, seg.wav_path))
            frames = info.frames
            if info.samplerate != self.sample_rate:
                frames = int(info.frames * self.sample_rate / info.samplerate)
            seg.resampled_frames = frames
            bin_num = get_time_bin(
                frames, self.coarse_hop_length, self.time_bin_quantize
            )
            n_ph = len(seg.phonemes)
            if bin_num == -1:
                raise DatasetError(
                    f"Segment too short (< 0.25 s): {seg.wav_path}"
                )
            if get_frame_count(bin_num) < n_ph:
                raise DatasetError(
                    f"Audio too short for phoneme count: {seg.wav_path}"
                )
            if n_ph < 1:
                raise DatasetError(f"Segment has no phonemes: {seg.wav_path}")
            if n_ph > MAX_PHONEMES:
                raise DatasetError(
                    f"Too many phonemes (>{MAX_PHONEMES}): {seg.wav_path}"
                )
            seg.time_bin = bin_num
            bins.setdefault(bin_num, []).append(seg.index)
            seconds_per_bin[bin_num] = (
                seconds_per_bin.get(bin_num, 0.0) + frames / self.sample_rate
            )
        return bins, seconds_per_bin

    def load_segment(self, idx: int, load_audio: bool = True) -> dict:
        """Load one padded segment with tokens and cached pitch/durations.

        load_audio=False skips the wav read (the prefetch loader batches
        audio through the native C++ loader instead); "audio" is None and
        "time_bin" comes from the header scan.
        """
        seg = self.segments[idx]
        if load_audio:
            audio = read_wav(
                osp.join(self.root_path, seg.wav_path), self.sample_rate
            )
            time_bin = get_time_bin(
                audio.shape[0], self.coarse_hop_length, self.time_bin_quantize
            )
            if time_bin != -1:
                frame_count = get_frame_count(time_bin)
                total = frame_count * self.coarse_hop_length
                pad_start = (total - audio.shape[0]) // 2
                pad_end = total - audio.shape[0] - pad_start
                audio = np.pad(audio, (pad_start, pad_end))
        else:
            audio = None
            time_bin = seg.time_bin
        tokens = np.asarray(
            self.text_cleaner(seg.phonemes), dtype=np.int32
        )
        pitch = self.pitch.get(seg.wav_path)
        if pitch is not None:
            pitch = np.asarray(pitch, np.float32)
        durations = self.alignment.get(seg.wav_path)
        if durations is not None:
            durations = np.asarray(durations[0], np.float32)
        return {
            "audio": audio.astype(np.float32) if audio is not None else None,
            "tokens": tokens,
            "pitch": pitch,
            "durations": durations,
            "slm": self.slm.get(seg.wav_path),
            "path": seg.wav_path,
            "speaker": seg.speaker,
            "time_bin": time_bin,
        }
