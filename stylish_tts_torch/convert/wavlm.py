"""WavLM weights between the port's ``WavLMEncoder`` and the JAX package's
flax ``WavLMEncoder`` tree.

The port's numpy copy of the layout map of ``stylish_tts_tpu/models/slm.py``
``convert_torch_wavlm``: the port's state_dict carries the ``transformers``
names, the flax tree ``{"params": {"conv_0": {"kernel"}, ..., "layer_11":
{...}}}``. Conv kernels (Cout, Cin, K) -> (K, Cin, Cout), Linear weights
transposed, norms' ``weight`` -> ``scale``, and the weight-normed positional
conv folded into one kernel, ``g * v / ||v||`` over the in and kernel axes
(numpy float32, op for op as the JAX function, so the two trees are equal
bitwise). ``wavlm_from_jax`` goes back: the folded kernel becomes ``v`` and
its norm ``g`` (so the port's weight norm gives the kernel again, to
rounding), and the unused ``masked_spec_embed`` is zero.

``jax_leaves`` lists a tree's leaves with the string that JAX's
``tree_flatten_with_path`` gives each path (``"(DictKey(key='params'),
DictKey(key='conv_0'), DictKey(key='kernel'))"``), which the slm cache's
fingerprint hashes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

N_CONV = 7
LAYERS = 12
HEADS = 12
POS_CONV = "encoder.pos_conv_embed.conv"
POS_G = f"{POS_CONV}.parametrizations.weight.original0"
POS_V = f"{POS_CONV}.parametrizations.weight.original1"
REL_EMBED = "encoder.layers.0.attention.rel_attn_embed.weight"

# flax Dense / LayerNorm children of each encoder layer -> torch prefix
_DENSE = {
    "gru_rel_pos_linear": "attention.gru_rel_pos_linear",
    "q_proj": "attention.q_proj",
    "k_proj": "attention.k_proj",
    "v_proj": "attention.v_proj",
    "out_proj": "attention.out_proj",
    "intermediate_dense": "feed_forward.intermediate_dense",
    "output_dense": "feed_forward.output_dense",
}
_LAYER_NORMS = {"layer_norm": "layer_norm", "final_layer_norm": "final_layer_norm"}
# top-level norms and the projection: flax name -> torch prefix
_TOP_NORMS = {
    "conv_group_norm": "feature_extractor.conv_layers.0.layer_norm",
    "fp_layer_norm": "feature_projection.layer_norm",
    "encoder_layer_norm": "encoder.layer_norm",
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True) + 1e-12)
    return g * v / norm


def wavlm_to_jax(state_dict: Mapping) -> Dict:
    """``WavLMEncoder.state_dict()`` (or a ``transformers`` WavLM's) -> the
    flax tree ``{"params": ...}`` of the JAX ``convert_torch_wavlm``."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    p: Dict = {}
    for i in range(N_CONV):
        w = sd[f"feature_extractor.conv_layers.{i}.conv.weight"]
        p[f"conv_{i}"] = {"kernel": np.transpose(w, (2, 1, 0))}
    for name, pre in _TOP_NORMS.items():
        p[name] = {"scale": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]}
    p["fp_projection"] = {
        "kernel": sd["feature_projection.projection.weight"].T,
        "bias": sd["feature_projection.projection.bias"],
    }
    w = _fold_weight_norm(sd[POS_G], sd[POS_V])
    p["pos_conv"] = {"kernel": np.transpose(w, (2, 1, 0)), "bias": sd[f"{POS_CONV}.bias"]}
    for i in range(LAYERS):
        pre = f"encoder.layers.{i}."
        layer: Dict = {}
        for name, sub in _DENSE.items():
            layer[name] = {"kernel": sd[f"{pre}{sub}.weight"].T,
                           "bias": sd[f"{pre}{sub}.bias"]}
        layer["gru_rel_pos_const"] = sd[pre + "attention.gru_rel_pos_const"].reshape(
            1, HEADS, 1, 1)
        for name, sub in _LAYER_NORMS.items():
            layer[name] = {"scale": sd[f"{pre}{sub}.weight"], "bias": sd[f"{pre}{sub}.bias"]}
        if i == 0:
            layer["rel_attn_embed"] = (sd["encoder.rel_attn_embed.weight"]
                                       if "encoder.rel_attn_embed.weight" in sd
                                       else sd[REL_EMBED])
        p[f"layer_{i}"] = layer
    return {"params": p}


def wavlm_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax tree (``{"params": ...}`` or its inside) -> a
    ``WavLMEncoder.state_dict()``."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {"masked_spec_embed": np.zeros(768, np.float32)}
    for i in range(N_CONV):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = np.transpose(
            _np(p[f"conv_{i}"]["kernel"]), (2, 1, 0))
    for name, pre in _TOP_NORMS.items():
        sd[f"{pre}.weight"] = _np(p[name]["scale"])
        sd[f"{pre}.bias"] = _np(p[name]["bias"])
    sd["feature_projection.projection.weight"] = _np(p["fp_projection"]["kernel"]).T
    sd["feature_projection.projection.bias"] = _np(p["fp_projection"]["bias"])
    w = np.transpose(_np(p["pos_conv"]["kernel"]), (2, 1, 0))
    sd[POS_G] = np.sqrt((w**2).sum(axis=(0, 1), keepdims=True))
    sd[POS_V] = w
    sd[f"{POS_CONV}.bias"] = _np(p["pos_conv"]["bias"])
    for i in range(LAYERS):
        pre = f"encoder.layers.{i}."
        layer = p[f"layer_{i}"]
        for name, sub in _DENSE.items():
            sd[f"{pre}{sub}.weight"] = _np(layer[name]["kernel"]).T
            sd[f"{pre}{sub}.bias"] = _np(layer[name]["bias"])
        sd[pre + "attention.gru_rel_pos_const"] = _np(layer["gru_rel_pos_const"])
        for name, sub in _LAYER_NORMS.items():
            sd[f"{pre}{sub}.weight"] = _np(layer[name]["scale"])
            sd[f"{pre}{sub}.bias"] = _np(layer[name]["bias"])
        if i == 0:
            sd[REL_EMBED] = _np(layer["rel_attn_embed"])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}


def jax_leaves(tree: Mapping, keys: Tuple[str, ...] = ()) -> List[Tuple[str, np.ndarray]]:
    """(JAX key-path string, leaf) for every leaf of a nested dict."""
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.extend(jax_leaves(v, keys + (k,)))
        else:
            path = ", ".join(f"DictKey(key={key!r})" for key in keys + (k,))
            out.append((f"({path},)" if len(keys) == 0 else f"({path})", v))
    return out
