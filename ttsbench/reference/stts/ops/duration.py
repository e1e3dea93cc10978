"""Duration class tables and the soft alignment.

Counterpart of ``stylish_tts_tpu/ops/duration.py`` (``DurationProcessor``):
16 ordinal duration classes with the fixed class -> duration and
duration -> class tables, softmax-expected durations, and the
parabolic-window soft alignment, softmax-normalised over ALL text rows of
the bucket, padded rows included (so the text bucket is part of the
function). ``total_frames`` is the frame bucket.

``class_count`` and ``max_dur`` clip the inputs of the two table lookups,
as in JAX; the tables stay fixed at 16 classes and durations up to 50, and
an index past a table's end reads its last entry (a JAX gather clamps).
The tables are copied to a device once (``_device_table``), so that a call
on the card moves nothing from the host and can be captured in a CUDA
graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CLASS_TO_DUR = np.array(
    [1, 2, 3, 4, 5, 6, 7, 9, 12, 15, 18, 22, 27, 32, 38, 46], dtype=np.float32
)

# dur (clamped 1..50) -> ordinal class id
DUR_TO_CLASS = np.array(
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 7, 7, 8, 8, 8, 9, 9, 9, 10, 10, 10]
    + [11] * 5
    + [12] * 5
    + [13] * 5
    + [14] * 7
    + [15] * 9,
    dtype=np.int32,
)


@functools.lru_cache(maxsize=8)
@torch.inference_mode(False)
def _device_table(name: str, device: torch.device) -> torch.Tensor:
    """The table ``name`` on ``device``, made once (outside inference mode,
    so that training can save it for a backward after synthesis made it)."""
    return torch.as_tensor({"class_to_dur": CLASS_TO_DUR, "dur_to_class": DUR_TO_CLASS}[name],
                           device=device)


def _lookup(name: str, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with out-of-range indices clamped to the table."""
    t = _device_table(name, idx.device)
    return t[idx.long().clamp(0, t.shape[0] - 1)]


class DurationProcessor:
    def __init__(self, class_count: int = 16, max_dur: int = 50):
        self.class_count = class_count
        self.max_dur = max_dur

    def class_to_dur_hard(self, classes: torch.Tensor) -> torch.Tensor:
        return _lookup("class_to_dur", torch.clamp(classes, 0, self.class_count - 1))

    def dur_to_class(self, durs: torch.Tensor) -> torch.Tensor:
        """Durations (frames, int or float; a float is clipped, then
        truncated) -> ordinal class ids (int32)."""
        durs = torch.clamp(durs, 1, self.max_dur).to(torch.int32)
        return _lookup("dur_to_class", durs)

    def align_to_class(self, alignment: torch.Tensor) -> torch.Tensor:
        """(..., frames) alignment rows -> the class of each row's sum."""
        return self.dur_to_class(torch.clamp(alignment.sum(dim=-1), 1, self.max_dur))

    def class_to_dur_soft(self, softdur: torch.Tensor) -> torch.Tensor:
        """(..., classes) softmax weights -> expected duration."""
        table = _device_table("class_to_dur", softdur.device)
        num = torch.sum(softdur * table, dim=-1)
        return num / (torch.sum(softdur, dim=-1) + 1e-9)

    def prediction_to_duration(self, pred: torch.Tensor,
                               text_lengths: torch.Tensor) -> torch.Tensor:
        """(B, T, classes) logits -> (B, T) expected durations, masked."""
        confidence = torch.exp(pred - pred.amax(dim=-1, keepdim=True))
        confidence = confidence / confidence.sum(dim=-1, keepdim=True)
        softdur = self.class_to_dur_soft(confidence)
        pos = torch.arange(pred.shape[1], device=pred.device)[None, :]
        return softdur * (pos < text_lengths[:, None]).to(softdur.dtype)

    def duration_to_alignment(self, duration: torch.Tensor, total_frames: int,
                              multiplier: int = 1) -> torch.Tensor:
        """(B, T_text) durations -> (B, T_text, total_frames) soft alignment:
        a clipped inverted parabola per token around its cumulative span,
        softmax over tokens per frame."""
        duration = duration.to(torch.float32) * multiplier
        upper = torch.cumsum(duration, dim=1)
        lower = upper - duration
        mean = (lower + upper) / 2.0
        frames = torch.arange(total_frames, dtype=torch.float32,
                              device=duration.device)[None, None, :]
        x = frames - mean[..., None]
        window = 1.0 - torch.square(x * 2.0 / (duration[..., None] + 6.0))
        keep = (frames > (lower - 3.0)[..., None]) & (frames < (upper + 3.0)[..., None])
        window = torch.where(keep, window, torch.zeros_like(window))
        window = torch.clamp_min(window, 0.0)
        return torch.softmax(window, dim=1)
