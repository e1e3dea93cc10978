"""Forced-alignment cache generation (the ``align`` command).

Counterpart of ``stylish_tts_tpu/dataprep/align.py``: the trained aligner's
CTC posteriors over both splits, the Viterbi forced alignment
(``ops/ctc.py`` ``ctc_forced_align``), per-token durations, written as
the alignment safetensors cache ({wav filename: (1, n_tokens) float32},
``data/caches.py``) plus per-segment confidences in
``scores_{train,val}.txt``.
"""

from __future__ import annotations

import logging
import os.path as osp
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.caches import save_cache
from ..data.collate import collate_batch
from ..dsp.mel import MelSpectrogram
from ..ops.ctc import ForcedAlignResult, ctc_forced_align
from ..trainer.normalization import NormalizationStats

logger = logging.getLogger("stylish_tts_torch")

METHODS = ("k2", "torch")


def k2_pad_attribution(
    onsets: np.ndarray,  # (T,) bool: token-onset frames (inner tokens)
    argmax_blank: np.ndarray,  # (T,) bool: posterior argmax is blank/silence
    total_frames: int,
) -> np.ndarray:
    """The default duration attribution (``--method k2``): forced alignment
    ran over the inner tokens only, and this re-synthesises the pad
    durations. Leading silence goes to the prefix pad, each inner token
    owns its onset frame plus the silence after it, the last token's
    length is read from the posterior argmax (the first predicted-silence
    frame after its onset), and what remains goes to the suffix pad.
    Returns [prefix, inner..., suffix] durations."""
    token_idx = np.nonzero(onsets[:total_frames])[0]
    if token_idx.size == 0:
        # untrained model: no onset at all
        return np.asarray([total_frames], np.float32)
    first_idx, last_idx = int(token_idx[0]), int(token_idx[-1])
    prefix_dur = first_idx
    token_durs = []
    current = 0
    for t in range(first_idx, last_idx):
        if onsets[t]:
            if current > 0:
                token_durs.append(current)
            current = 1
        else:
            current += 1
    if current > 0 and token_idx.size > 1:
        token_durs.append(current)
    tail = argmax_blank[last_idx:total_frames]
    sil = np.nonzero(tail)[0]
    last_dur = int(sil[0]) if sil.size else int(tail.size)
    last_dur = max(1, last_dur)
    token_durs.append(last_dur)
    suffix_dur = max(0, total_frames - (last_idx + last_dur))
    return np.asarray([prefix_dur] + token_durs + [suffix_dur], np.float32)


def align_mel_transform(model_config) -> MelSpectrogram:
    mc = model_config
    return MelSpectrogram(
        n_mels=mc.text_aligner.n_mels, n_fft=mc.text_aligner.n_fft,
        win_length=mc.text_aligner.win_length,
        hop_length=mc.hop_length * mc.coarse_multiplier,
        sample_rate=mc.sample_rate,
    )


def posteriors(aligner, to_align_mel, normalization: NormalizationStats,
               audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) audio -> the aligner's (B, T, C) log-probs over an even frame
    count, and the (B,) lengths."""
    with torch.no_grad():
        mel = to_align_mel(audio)
        mel = (torch.log(1e-5 + mel) - normalization.mel_log_mean) / (
            normalization.mel_log_std)
        frames = mel.shape[-1] - (mel.shape[-1] % 2)
        mel = mel[:, :, :frames].transpose(1, 2).contiguous()
        lengths = torch.full((mel.shape[0],), frames, dtype=torch.int32,
                             device=mel.device)
        return aligner(mel, lengths), lengths


def forced_align_batch(log_probs, lengths, text, text_lengths, blank_id: int,
                       method: str) -> Tuple[ForcedAlignResult, torch.Tensor]:
    """The Viterbi over the full padded text (``torch``), or over the inner
    tokens with the pads stripped (``k2``); with the per-frame "posterior
    argmax is blank" mask that the k2 attribution reads."""
    if method == "k2":
        inner = torch.cat([text[:, 1:], torch.zeros_like(text[:, :1])], dim=1)
        res = ctc_forced_align(log_probs, lengths, inner,
                               torch.clamp(text_lengths - 2, min=1), blank_id)
        return res, torch.argmax(log_probs, dim=-1) == blank_id
    res = ctc_forced_align(log_probs, lengths, text, text_lengths, blank_id)
    return res, torch.zeros(log_probs.shape[:2], dtype=torch.bool,
                            device=log_probs.device)


def calculate_alignments(
    dataset,
    aligner,
    model_config,
    normalization: NormalizationStats,
    batch_size: int = 8,
    method: str = "k2",
) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Returns ({wav_path: (1, n_tokens) durations}, {wav_path: confidence}),
    running ``aligner`` (in eval mode, on its device) over ``dataset``
    batched per duration bin.

    method: "k2" aligns the inner tokens and gives leading/trailing
    silence to the pad tokens (``k2_pad_attribution``); "torch" aligns the
    full padded sequence and leaves blanks with the preceding token."""
    if method not in METHODS:
        raise ValueError(f"unknown align method {method!r}")
    mc = model_config
    device = next(aligner.parameters()).device
    to_align_mel = align_mel_transform(mc)
    blank_id = mc.text_encoder.tokens
    aligner.eval()

    bins, _ = dataset.time_bins()
    durations: Dict[str, np.ndarray] = {}
    confidences: Dict[str, float] = {}
    for _bin, idxs in sorted(bins.items()):
        for i in range(0, len(idxs), batch_size):
            items = [dataset.load_segment(j) for j in idxs[i: i + batch_size]]
            batch, paths = collate_batch(items, hop_length=mc.hop_length,
                                         require_pitch=False)
            log_probs, lengths = posteriors(
                aligner, to_align_mel, normalization,
                torch.from_numpy(batch.audio_gt).to(device))
            res, arg_blank = forced_align_batch(
                log_probs, lengths, torch.from_numpy(batch.text).to(device),
                torch.from_numpy(batch.text_lengths).to(device), blank_id, method)
            durs = res.durations.cpu().numpy()
            scores = res.scores.cpu().numpy()
            onsets = res.onsets.cpu().numpy()
            arg_blank = arg_blank.cpu().numpy()
            frames_total = onsets.shape[1]
            for k, path in enumerate(paths):
                n = int(batch.text_lengths[k])
                if method == "k2":
                    d = k2_pad_attribution(onsets[k], arg_blank[k], frames_total)
                    if d.shape[0] != n:
                        # only without onsets (an untrained model): the
                        # Viterbi's inner-token durations, zero-length pads
                        logger.warning(
                            "k2 attribution length %d != text length %d for "
                            "%s; falling back to Viterbi attribution",
                            d.shape[0], n, path,
                        )
                        d = np.concatenate([[0.0], durs[k, : n - 2], [0.0]])
                    durations[path] = d[None, :].astype(np.float32)
                else:
                    durations[path] = durs[k: k + 1, :n].astype(np.float32)
                confidences[path] = float(np.exp(scores[k]))
                if confidences[path] < 0.1:
                    logger.warning("low alignment confidence %.3f for %s",
                                   confidences[path], path)
    return durations, confidences


def write_alignment_outputs(
    out_root: str,
    alignment_path: str,
    split_durations: Dict[str, Dict[str, np.ndarray]],
    split_confidences: Dict[str, Dict[str, float]],
) -> None:
    merged = {}
    for split, durs in split_durations.items():
        merged.update(durs)
        scores_file = osp.join(out_root, f"scores_{split}.txt")
        with open(scores_file, "w", encoding="utf-8") as f:
            for path, score in sorted(
                split_confidences[split].items(), key=lambda kv: kv[1]
            ):
                f.write(f"{score:.6f} {path}\n")
    save_cache(alignment_path, merged)
