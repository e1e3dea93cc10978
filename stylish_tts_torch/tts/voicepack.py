"""Voicepack: precomputed style vectors for inference.

The port's copy of ``stylish_tts_tpu/tts/voicepack.py``:
  * ``encode_all_styles``: the speech, pitch/energy and duration styles of
    every segment of a dataset, from its style mel (the three style
    encoders in eval mode, float32);
  * static pack: 512 rows indexed by token count, each the average of
    the >=100 nearest-by-text-length segment styles;
  * dynamic pack: per-segment styles + sentence embeddings for kNN
    blending.
The pack files hold the JAX keys (``static/...``, ``dynamic/...``), so
either package reads what the other writes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..data.caches import load_cache, save_cache

STATIC_ROWS = 512
MIN_NEIGHBORHOOD = 100


def encode_all_styles(dataset, models: Mapping[str, nn.Module], norm, model_config,
                      batch_size: int = 8) -> Dict[str, np.ndarray]:
    """Per-segment style vectors {"speech"|"pe"|"duration": (N, style_dim)}
    and "lengths": (N,) token counts, in the order of the sorted time bins,
    in batches of ``batch_size`` within a bin. Runs on the device of
    ``models`` in float32 with autocast off (TF32 as the caller set it: the
    CLI's ``Trainer`` turns it off). Each mel is normalised as
    ``(log(1e-5 + mel) - mel_log_mean) / mel_log_std`` and cropped to an even
    frame count; the energy is the log L2 norm over the mel axis of the
    denormalised main mel."""
    from ..data.collate import collate_batch
    from ..dsp.mel import MelSpectrogram

    mc = model_config
    se = mc.style_encoder
    to_style_mel = MelSpectrogram(n_mels=se.n_mels, n_fft=se.n_fft,
                                  win_length=se.win_length, hop_length=se.hop_length,
                                  sample_rate=mc.sample_rate)
    to_mel = MelSpectrogram(n_mels=mc.n_mels, n_fft=mc.n_fft, win_length=mc.win_length,
                            hop_length=mc.hop_length, sample_rate=mc.sample_rate)
    speech_enc, pe_enc, dur_enc = (models[k].eval() for k in (
        "speech_style_encoder", "pe_style_encoder", "duration_style_encoder"))
    device = next(speech_enc.parameters()).device

    def norm_mel(transform, audio):
        mel = (torch.log(1e-5 + transform(audio)) - norm.mel_log_mean) / norm.mel_log_std
        return mel[:, :, :mel.shape[-1] - mel.shape[-1] % 2]

    bins, _ = dataset.time_bins()
    out = {"speech": [], "pe": [], "duration": []}
    lengths = []
    with torch.no_grad(), torch.autocast(device.type, enabled=False):
        for _bin, idxs in sorted(bins.items()):
            for i in range(0, len(idxs), batch_size):
                items = [dataset.load_segment(j) for j in idxs[i:i + batch_size]]
                batch, _ = collate_batch(items, hop_length=mc.hop_length,
                                         require_pitch=False)
                audio = torch.from_numpy(batch.audio_gt).to(device)
                pitch = torch.from_numpy(batch.pitch).to(device)
                style_mel = norm_mel(to_style_mel, audio)
                mel = norm_mel(to_mel, audio)
                denorm = torch.exp(mel * norm.mel_log_std + norm.mel_log_mean)
                energy = torch.log(torch.linalg.vector_norm(denorm, dim=1) + 1e-9)
                frames = mel.shape[-1]
                out["speech"].append(speech_enc(style_mel))
                out["pe"].append(pe_enc(style_mel, pitch[:, :frames], energy))
                out["duration"].append(dur_enc(style_mel))
                lengths.extend(int(n) for n in batch.text_lengths)
    styles = {k: torch.cat(v).cpu().numpy() for k, v in out.items()}
    styles["lengths"] = np.asarray(lengths, np.int32)
    return styles


def build_static_pack(styles: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """512 rows indexed by token count; row L averages the styles of the
    segments closest in text length (window grown until >=100 samples)."""
    lengths = styles["lengths"]
    n = lengths.shape[0]
    need = min(MIN_NEIGHBORHOOD, n)
    pack = {}
    for key in ("speech", "pe", "duration"):
        vecs = styles[key]
        rows = np.zeros((STATIC_ROWS, vecs.shape[1]), np.float32)
        for row in range(STATIC_ROWS):
            radius = 0
            while np.sum(np.abs(lengths - row) <= radius) < need:
                radius += 1
                if radius > STATIC_ROWS:
                    break
            sel = np.abs(lengths - row) <= radius
            rows[row] = vecs[sel].mean(axis=0)
        pack[key] = rows
    return pack


def save_static_voicepack(path: str, pack: Dict[str, np.ndarray]) -> None:
    save_cache(path, {f"static/{k}": v for k, v in pack.items()})


def build_dynamic_pack(
    styles: Dict[str, np.ndarray], texts, embed_fn
) -> Dict[str, np.ndarray]:
    """Per-segment styles + sentence embeddings."""
    emb = embed_fn(list(texts)).astype(np.float32)
    return {
        "speech": styles["speech"],
        "pe": styles["pe"],
        "duration": styles["duration"],
        "embedding": emb,
    }


def save_dynamic_voicepack(path: str, pack: Dict[str, np.ndarray]) -> None:
    save_cache(path, {f"dynamic/{k}": v for k, v in pack.items()})


def load_voicepack(path: str) -> Dict[str, np.ndarray]:
    """Returns {"kind": "static"|"dynamic", ...arrays}."""
    raw = load_cache(path)
    kind = "dynamic" if any(k.startswith("dynamic/") for k in raw) else "static"
    out = {k.split("/", 1)[1]: v for k, v in raw.items() if k.startswith(kind + "/")}
    out["kind"] = kind
    return out


def lookup_static_style(pack: Dict[str, np.ndarray], token_count: int):
    row = min(token_count, STATIC_ROWS - 1)
    return pack["speech"][row], pack["pe"][row], pack["duration"][row]


def lookup_dynamic_style(
    pack: Dict[str, np.ndarray], query_embedding: np.ndarray, k: int = 8
):
    """Blend the k nearest segments' styles by cosine similarity."""
    emb = pack["embedding"]
    q = query_embedding / (np.linalg.norm(query_embedding) + 1e-9)
    e = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    sims = e @ q
    k = min(k, sims.shape[0])
    idx = np.argpartition(-sims, k - 1)[:k]
    w = np.maximum(sims[idx], 0.0) + 1e-6
    w = w / w.sum()

    def blend(arr):
        return (arr[idx] * w[:, None]).sum(axis=0)

    return blend(pack["speech"]), blend(pack["pe"]), blend(pack["duration"])
