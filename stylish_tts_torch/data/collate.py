"""Fixed-shape batch assembly for bucketed training.

The port's copy of ``stylish_tts_tpu/data/collate.py``; it builds the
port's own ``Batch`` of numpy arrays (the trainer moves it to the device).
``MAX_TEXT`` also sets the largest CTC state count the kernels see:
2 * 512 + 1 = 1025.

Collation parity with the reference Collater (dataloader.py:184-260),
with one TPU-native change: text is padded to a *static text bucket*
(next multiple of TEXT_BUCKET_STEP) instead of the batch max, so every
(time_bin, text_bucket) pair maps to exactly one compiled program.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..trainer.steps import Batch

TEXT_BUCKET_STEP = 32
MAX_TEXT = 512


def text_bucket(max_len: int) -> int:
    return min(
        ((max_len + TEXT_BUCKET_STEP - 1) // TEXT_BUCKET_STEP)
        * TEXT_BUCKET_STEP,
        MAX_TEXT,
    )


def collate_batch(items: List[dict], hop_length: int, require_pitch=True):
    """items: list of dataset.load_segment dicts from the SAME time bin."""
    b = len(items)
    samples = items[0]["audio"].shape[0]
    frames = samples // hop_length
    ltext = text_bucket(max(it["tokens"].shape[0] for it in items))

    audio = np.zeros((b, samples), np.float32)
    text = np.zeros((b, ltext), np.int32)
    text_lengths = np.zeros((b,), np.int32)
    pitch = np.zeros((b, frames), np.float32)
    durations = np.zeros((b, ltext), np.int32)
    paths = []

    # precomputed GT WavLM states ride along only when every item has
    # them (same time bin -> same T, so the stack is static-shape)
    slm = None
    if all(it.get("slm") is not None for it in items):
        slm = np.stack([np.asarray(it["slm"]) for it in items])

    for i, it in enumerate(items):
        assert it["audio"].shape[0] == samples, "mixed bins in one batch"
        audio[i] = it["audio"]
        n = it["tokens"].shape[0]
        text[i, :n] = it["tokens"]
        text_lengths[i] = n
        paths.append(it["path"])
        if it["pitch"] is not None:
            p = it["pitch"]
            if p.shape[0] != frames:
                # The pitch cache bakes the padded length; center padding
                # means ANY length mismatch misaligns every frame, so fail
                # loudly instead of silently truncating/zero-filling.
                raise ValueError(
                    f"pitch cache length {p.shape[0]} != padded frame "
                    f"count {frames} for {it['path']}: the pitch/alignment"
                    "/slm caches were generated with a different "
                    "dataset.time_bin_quantize (or padding scheme) than "
                    "this run — regenerate `pitch` and `align` (and "
                    "`slm-cache` if used) with the same config"
                )
            pitch[i] = p
        elif require_pitch:
            raise ValueError(f"Pitch not found for segment {it['path']}")
        if it["durations"] is not None:
            d = it["durations"][:n]
            durations[i, : d.shape[0]] = d.astype(np.int32)

    batch = Batch(
        audio_gt=audio,
        text=text,
        text_lengths=text_lengths,
        pitch=pitch,
        durations=durations,
        slm_gt=slm,
    )
    return batch, paths
