"""Host-side WAV IO: fast header scan, read, downmix, resample.

The port's copy of ``stylish_tts_tpu/data/wav.py`` (the port imports
nothing of the JAX package).

Replaces the reference's soundfile/librosa dependency
(reference: dataloader.py:159-164, sf.info in time_bins
dataloader.py:71-95).  A native C++ batched loader can be plugged in
via the JAX package's native module; this module is the portable path
(scipy WAV IO + polyphase resampling).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


@dataclass
class WavInfo:
    frames: int
    samplerate: int
    channels: int


def wav_info(path: str) -> WavInfo:
    """Parse RIFF/WAVE headers without reading sample data (fast scan)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        channels = 1
        samplerate = 0
        bits = 16
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                channels = struct.unpack("<H", fmt[2:4])[0]
                samplerate = struct.unpack("<I", fmt[4:8])[0]
                bits = struct.unpack("<H", fmt[14:16])[0]
            elif cid == b"data":
                data_size = size
                break
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)
        if data_size is None or samplerate == 0:
            raise ValueError(f"malformed WAV: {path}")
        frames = data_size // (channels * max(bits // 8, 1))
        return WavInfo(frames=frames, samplerate=samplerate, channels=channels)


def read_wav(path: str, target_sr: int) -> np.ndarray:
    """Read, downmix to mono (first channel, matching the reference),
    resample to target_sr, return float32 in [-1, 1]."""
    sr, data = wavfile.read(path)
    if data.ndim == 2:
        data = data[:, 0]
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        audio = resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
    return audio


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    audio = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sample_rate, (audio * 32767.0).astype(np.int16))
