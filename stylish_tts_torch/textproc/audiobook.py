"""Audiobook -> training-dataset preparation.

The port's copy of ``stylish_tts_tpu/textproc/audiobook.py`` (the port imports
nothing of the JAX package).

Capability counterpart of the reference's ttab dataset scripts
(reference train/dataprep/ttab/* — whose own imports are broken
upstream): given long-form narration audio plus the book text, produce
an LJSpeech-style dataset (wav-dir of <=10 s segments + train/val
lists with phonemes) ready for `stylish-train pitch/train-align/...`.

Pipeline:
  1. energy VAD splits each audio file at silence valleys into
     utterance segments within [min_s, max_s];
  2. the book text is chapter-split and sentence-packed
     (textproc/book.py), phonemized with homograph resolution;
  3. segments pair with packed utterances in reading order, warning on
     count mismatch (narration and text drift is expected — the pair
     confidence is re-checked later by the alignment score file the
     `align` step emits).
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class Segment:
    audio: np.ndarray
    start_s: float
    end_s: float


def vad_split(
    audio: np.ndarray,
    sample_rate: int,
    min_s: float = 1.0,
    max_s: float = 10.0,
    frame_ms: float = 25.0,
    threshold_db: float = -38.0,
) -> List[Segment]:
    """Split long audio at silence valleys into [min_s, max_s] segments."""
    frame = max(int(sample_rate * frame_ms / 1000), 1)
    n_frames = len(audio) // frame
    if n_frames == 0:
        return [Segment(audio, 0.0, len(audio) / sample_rate)]
    x = audio[: n_frames * frame].reshape(n_frames, frame)
    rms = np.sqrt(np.mean(np.square(x), axis=1) + 1e-12)
    ref = np.percentile(rms, 95) + 1e-12
    silent = 20 * np.log10(rms / ref) < threshold_db

    # candidate cut points = centers of LONG silent runs (>=200 ms —
    # shorter gaps are word pauses, not utterance boundaries)
    min_sil = max(int(200.0 / frame_ms), 1)
    cuts = [0]
    run_start = None
    for i, s in enumerate(silent):
        if s and run_start is None:
            run_start = i
        elif not s and run_start is not None:
            if i - run_start >= min_sil:
                cuts.append((run_start + i) // 2)
            run_start = None
    if run_start is not None and n_frames - run_start >= min_sil:
        cuts.append((run_start + n_frames) // 2)
    cuts.append(n_frames)

    segments: List[Segment] = []
    seg_start = 0
    min_f, max_f = int(min_s * 1000 / frame_ms), int(max_s * 1000 / frame_ms)
    for j in range(1, len(cuts)):
        length = cuts[j] - seg_start
        last = j == len(cuts) - 1
        if length >= max_f or (length >= min_f and (last or silent[min(cuts[j], n_frames - 1)])):
            a, b = seg_start * frame, cuts[j] * frame
            segments.append(
                Segment(audio[a:b], a / sample_rate, b / sample_rate)
            )
            seg_start = cuts[j]
    if seg_start < n_frames:
        a = seg_start * frame
        tail = audio[a:]
        if len(tail) >= min_s * sample_rate / 2 and segments:
            segments.append(
                Segment(tail, a / sample_rate, len(audio) / sample_rate)
            )
        elif segments:
            prev = segments[-1]
            segments[-1] = Segment(
                np.concatenate([prev.audio, tail]), prev.start_s,
                len(audio) / sample_rate,
            )
        else:
            segments.append(Segment(tail, a / sample_rate, len(audio) / sample_rate))
    return segments


def prepare_dataset(
    audio_paths: List[str],
    book_text: str,
    out_dir: str,
    sample_rate: int = 24000,
    val_fraction: float = 0.05,
    max_phonemes: int = 510,
) -> Tuple[int, int]:
    """Segment + pair + phonemize; writes wav-dir and train/val lists.

    Returns (n_train, n_val)."""
    from ..data.wav import read_wav, write_wav
    from .book import pack_utterances, split_chapters
    from .g2p import phonemize
    from .normalize import normalize_text

    chapters = split_chapters(book_text)
    sentences: List[str] = []
    for ch in chapters:
        sentences.extend(ch.sentences)
    utterances = pack_utterances(
        sentences, lambda s: len(phonemize(normalize_text(s))),
        budget=max_phonemes,
    )

    wav_dir = osp.join(out_dir, "wav-dir")
    os.makedirs(wav_dir, exist_ok=True)
    segments: List[Segment] = []
    for path in audio_paths:
        audio = read_wav(path, sample_rate)
        segments.extend(vad_split(audio, sample_rate))

    n = min(len(segments), len(utterances))
    if len(segments) != len(utterances):
        print(
            f"WARNING: {len(segments)} audio segments vs {len(utterances)} "
            f"text utterances; pairing the first {n} in order — verify with "
            "the align step's scores file."
        )
    lines = []
    for i in range(n):
        name = f"seg{i:05d}.wav"
        write_wav(osp.join(wav_dir, name), segments[i].audio, sample_rate)
        text = normalize_text(utterances[i])
        phonemes = phonemize(text)
        lines.append(f"{name}|{phonemes}|0|{text}")

    n_val = max(int(n * val_fraction), 1) if n > 1 else 0
    with open(osp.join(out_dir, "train-list.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[n_val:]) + "\n")
    with open(osp.join(out_dir, "val-list.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:n_val]) + "\n")
    return n - n_val, n_val
