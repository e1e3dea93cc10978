"""Fold torch reparametrizations into plain weights (numpy in, numpy out).

The port's copy of ``stylish_tts_tpu/convert/folding.py``. The reference
models use three reparametrizations that have exact closed-form folds at
inference time:

  * new-style weight norm (torch.nn.utils.parametrizations.weight_norm,
    reference e.g. ada_norm.py:16): state_dict keys
    ``<base>.parametrizations.weight.original0`` (g) and ``original1``
    (v); effective weight = v * g / ||v||_2 with the norm taken over all
    dims except dim 0.
  * old-style spectral norm (torch.nn.utils.spectral_norm, reference
    mel_style_encoder.py:17): keys ``<base>.weight_orig``,
    ``<base>.weight_u``, ``<base>.weight_v``; in eval mode torch computes
    sigma = u . (W_mat @ v) with the STORED u and v and divides.
  * BatchNorm eval (reference conformer.py:183, discriminator.py:108,
    text_aligner.py:168): running stats fold into a per-channel affine
    scale = gamma / sqrt(var + eps), bias = beta - mean * scale.

Every function takes and returns numpy float32 arrays; a torch tensor is
copied out (``_np``), so a live parameter is never shared.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        # .numpy() SHARES memory with the live torch parameter: a later
        # in-place optimizer update would silently rewrite the "converted"
        # weights. The np.array(copy=True) below breaks the sharing.
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float32, copy=True)


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """w = v * g / ||v|| with the norm over all dims except dim 0."""
    g, v = _np(g), _np(v)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
    return v * (g / norm)


def fold_spectral_norm(
    weight_orig: np.ndarray, u: np.ndarray, v: np.ndarray
) -> np.ndarray:
    """w = weight_orig / sigma, sigma = u . (W_mat @ v) (stored buffers)."""
    w = _np(weight_orig)
    u, v = _np(u), _np(v)
    w_mat = w.reshape(w.shape[0], -1)
    sigma = float(u @ (w_mat @ v))
    return w / sigma


def fold_batch_norm(
    running_mean: np.ndarray,
    running_var: np.ndarray,
    weight: np.ndarray | None = None,
    bias: np.ndarray | None = None,
    eps: float = 1e-5,
) -> Tuple[np.ndarray, np.ndarray]:
    """BatchNorm eval -> (scale, bias): y = x * scale + bias."""
    mean, var = _np(running_mean), _np(running_var)
    gamma = _np(weight) if weight is not None else np.ones_like(var)
    beta = _np(bias) if bias is not None else np.zeros_like(mean)
    scale = gamma / np.sqrt(var + eps)
    return scale, beta - mean * scale


def fold_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Bake all weight-norm/spectral-norm parametrizations in a torch
    state_dict into plain ``<base>.weight`` entries.

    BatchNorm running stats are left in place (the per-module converters
    fold them into Norm1d affine params, since the target shape depends
    on the site).
    """
    out: Dict[str, np.ndarray] = {}
    handled = set()
    for key in sd:
        if key.endswith(".parametrizations.weight.original0"):
            base = key[: -len(".parametrizations.weight.original0")]
            g = sd[key]
            v = sd[f"{base}.parametrizations.weight.original1"]
            out[f"{base}.weight"] = fold_weight_norm(g, v)
            handled.add(key)
            handled.add(f"{base}.parametrizations.weight.original1")
        elif key.endswith(".weight_orig"):
            base = key[: -len(".weight_orig")]
            out[f"{base}.weight"] = fold_spectral_norm(
                sd[key], sd[f"{base}.weight_u"], sd[f"{base}.weight_v"]
            )
            handled.add(key)
            handled.add(f"{base}.weight_u")
            handled.add(f"{base}.weight_v")
    for key, val in sd.items():
        if key in handled or key.endswith("num_batches_tracked"):
            continue
        if key not in out:
            out[key] = _np(val)
    return out
