"""Weight bridge between the JAX package's flax trees and the port.

A flax tree arrives as numpy arrays, nested (``{"params": {...}}`` as
``Module.init`` returns it) or flat with ``/``-joined keys (the layout of
``stylish_tts_tpu/utils/params_io.py``, which ``alignment_model.safetensors``
uses). Layout rules:

* conv kernels (K, Cin, Cout) <-> torch (Cout, Cin, K);
* Dense kernels (in, out) <-> torch Linear weights (out, in);
* ``Norm1d`` has no parameters in ``group`` mode and ``scale``/``bias``
  in ``affine`` mode.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

N_TDNN = 3
N_FFN = 5


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> flat ``/``-keyed dict (flat input passes through)."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def text_aligner_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax TextAligner variables -> ``TextAligner.state_dict()``."""
    flat = flatten(params)
    flat = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in flat.items()}
    sd: Dict[str, torch.Tensor] = {}

    def take(key):
        return torch.tensor(flat.pop(key), dtype=torch.float32)

    for i in range(N_TDNN):
        sd[f"tdnn.{i}.weight"] = take(f"tdnn_{i}/Conv_0/kernel").permute(2, 1, 0).contiguous()
        sd[f"tdnn.{i}.bias"] = take(f"tdnn_{i}/Conv_0/bias")
        if f"tdnn_norm_{i}/scale" in flat:
            sd[f"tdnn_norm.{i}.scale"] = take(f"tdnn_norm_{i}/scale")
            sd[f"tdnn_norm.{i}.bias"] = take(f"tdnn_norm_{i}/bias")
    for name in [f"ffn.{i}" for i in range(N_FFN)] + ["out"]:
        jname = name.replace(".", "_")
        sd[f"{name}.weight"] = take(f"{jname}/kernel").T.contiguous()
        sd[f"{name}.bias"] = take(f"{jname}/bias")
    if flat:
        raise KeyError(f"unmapped TextAligner params: {sorted(flat)}")
    return sd


def text_aligner_to_jax_flat(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``TextAligner.state_dict()`` -> the flat ``params/...`` layout that
    ``stylish_tts_tpu.utils.params_io.load_params_safetensors`` reads."""
    sd = {k: v.detach().cpu().to(torch.float32).numpy() for k, v in state_dict.items()}
    flat: Dict[str, np.ndarray] = {}
    for i in range(N_TDNN):
        flat[f"params/tdnn_{i}/Conv_0/kernel"] = sd.pop(f"tdnn.{i}.weight").transpose(2, 1, 0)
        flat[f"params/tdnn_{i}/Conv_0/bias"] = sd.pop(f"tdnn.{i}.bias")
        if f"tdnn_norm.{i}.scale" in sd:
            flat[f"params/tdnn_norm_{i}/scale"] = sd.pop(f"tdnn_norm.{i}.scale")
            flat[f"params/tdnn_norm_{i}/bias"] = sd.pop(f"tdnn_norm.{i}.bias")
    for name in [f"ffn.{i}" for i in range(N_FFN)] + ["out"]:
        jname = name.replace(".", "_")
        flat[f"params/{jname}/kernel"] = sd.pop(f"{name}.weight").T
        flat[f"params/{jname}/bias"] = sd.pop(f"{name}.bias")
    if sd:
        raise KeyError(f"unmapped TextAligner weights: {sorted(sd)}")
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}
