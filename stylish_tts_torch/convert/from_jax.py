"""Weight bridge between the JAX package's flax trees and the port.

A flax tree arrives as numpy arrays, nested (``{"params": {...}}`` as
``Module.init`` returns it) or flat with ``/``-joined keys (the layout of
``stylish_tts_tpu/utils/params_io.py``, which ``alignment_model.safetensors``
and an inference package's ``params.safetensors`` use). Layout rules:

* conv kernels (K, Cin/groups, Cout) <-> torch (Cout, Cin/groups, K);
* 2D conv kernels (H, W, Cin/groups, Cout) <-> torch (Cout, Cin/groups, H, W);
  the spectrally-normalised convs of the style encoder carry their RAW
  kernel on both sides (each side normalises in its forward);
* Dense kernels (in, out) <-> torch Linear weights (out, in);
* LayerNorm and GroupNorm ``scale`` <-> ``weight``; ``embedding`` <->
  ``Embedding.weight``;
* per-channel (1, 1, C) parameters (GRN ``gamma``/``beta``, ``snake``,
  ``alpha1_i``/``alpha2_i``) <-> the port's (1, C, 1);
* ``Norm1d`` has no parameters in the aligner's ``group`` mode and
  ``scale``/``bias`` in ``affine`` mode.

Every module maps by one generic rule (``flax_layout``): its attribute
names are the flax names, the items of a ``ModuleList`` attribute ``x`` are
flax's ``x_0``, ``x_1``, ..., and the auto-named flax children (``Conv_0``,
``LayerNorm_0``, ``StyleFiLM_0``, ``GRN_0``, ``Dense_i``) come from each
port class's ``FLAX_WRAP`` / ``FLAX_NAMES``; the leaf's kind follows from
the module that owns it. Any leaf left unmapped on either side raises.

A FreeGAN tree of a ``generator.scan_stacks`` model rolls each of the
two ConvNeXt stacks into one ``<stack>_scan/block`` subtree whose leaves
carry a leading layer axis (``amp_convnext_scan``, ``phase_convnext_scan``);
the port's modules stay unrolled (``amp_convnext_i``, ``phase_convnext_i``).
``module_from_jax`` unstacks such a tree, and ``module_to_jax_flat`` with
``scan_stacks=True`` writes the stacked layout back.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

SCAN_STACKS = ("amp_convnext", "phase_convnext")
_SCANNED = re.compile(rf"(^|/)({'|'.join(SCAN_STACKS)})_scan/block/")
_UNROLLED = re.compile(rf"(^|/)({'|'.join(SCAN_STACKS)})_(\d+)/")


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


def unstack_scans(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``<stack>_scan/block/<leaf>`` (n, ...) -> ``<stack>_i/<leaf>`` for
    i < n; other keys pass through."""
    out: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        m = _SCANNED.search(key)
        if m is None:
            out[key] = value
            continue
        for i in range(value.shape[0]):
            out[key[:m.start()] + f"{m.group(1)}{m.group(2)}_{i}/" + key[m.end():]] = value[i]
    return out


def restack_scans(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse of ``unstack_scans``: ``<stack>_i/<leaf>`` -> one
    ``<stack>_scan/block/<leaf>`` stacked over i."""
    out: Dict[str, np.ndarray] = {}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for key, value in flat.items():
        m = _UNROLLED.search(key)
        if m is None:
            out[key] = value
            continue
        scan_key = key[:m.start()] + f"{m.group(1)}{m.group(2)}_scan/block/" + key[m.end():]
        layers.setdefault(scan_key, {})[int(m.group(3))] = value
    for scan_key, by_index in layers.items():
        out[scan_key] = np.stack([by_index[i] for i in sorted(by_index)])
    return out


def _strip_params(params: Mapping) -> Dict[str, np.ndarray]:
    flat = flatten(params)
    return {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in flat.items()}


def _aligner_skeleton(norm_mode: str) -> nn.Module:
    """A one-channel ``TextAligner``: its layout is that of every width."""
    from ..models.text_aligner import TextAligner

    return TextAligner(n_mels=1, n_tokens=1, hidden_dim=1, norm_mode=norm_mode)


def text_aligner_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax TextAligner variables -> ``TextAligner.state_dict()``."""
    flat = _strip_params(params)
    mode = "affine" if "tdnn_norm_0/scale" in flat else "group"
    return module_from_jax(_aligner_skeleton(mode), flat)


def text_aligner_to_jax_flat(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``TextAligner.state_dict()`` -> the flat ``params/...`` layout that
    ``stylish_tts_tpu.utils.params_io.load_params_safetensors`` reads."""
    mode = "affine" if "tdnn_norm.0.scale" in state_dict else "group"
    return module_to_jax_flat(_aligner_skeleton(mode), state_dict)


def _leaf(owner: nn.Module, name: str, param: torch.Tensor) -> Tuple[str, str]:
    """(flax leaf name, layout kind) of the parameter ``name`` of ``owner``."""
    if name == "weight":
        if isinstance(owner, nn.Conv1d):
            return "kernel", "conv"
        if isinstance(owner, nn.Conv2d):
            return "kernel", "conv2d"
        if isinstance(owner, nn.Linear):
            return "kernel", "dense"
        if isinstance(owner, nn.Embedding):
            return "embedding", "same"
        if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
            return "scale", "same"
    if param.dim() == 3:
        return name, "channel"
    return name, "same"


def flax_layout(module: nn.Module) -> Dict[str, Tuple[str, str]]:
    """``module.state_dict()`` key -> (flax path below ``params/``, kind)."""
    out: Dict[str, Tuple[str, str]] = {}

    def walk(mod: nn.Module, key: str, path: str) -> None:
        wrap = getattr(mod, "FLAX_WRAP", None)
        own = f"{path}/{wrap}" if wrap else path
        for name, param in mod.named_parameters(recurse=False):
            leaf, kind = _leaf(mod, name, param)
            out[key + name] = (f"{own}/{leaf}".lstrip("/"), kind)
        names = getattr(mod, "FLAX_NAMES", {})
        for name, child in mod.named_children():
            if isinstance(mod, nn.ModuleList):  # flax names list items attr_i
                child_path = f"{path}_{name}"
            else:
                child_path = f"{path}/{names.get(name, name)}".lstrip("/")
            walk(child, f"{key}{name}.", child_path)

    walk(module, "", "")
    return out


def _transposed(x: np.ndarray, kind: str, to_torch: bool) -> np.ndarray:
    """flax <-> torch layout of one leaf, as a view; each rule but conv2d's
    is its own inverse."""
    if kind == "conv2d":
        return x.transpose(3, 2, 0, 1) if to_torch else x.transpose(2, 3, 1, 0)
    if kind == "conv":
        return x.transpose(2, 1, 0)
    if kind == "dense":
        return x.T
    if kind == "channel":
        return x.transpose(0, 2, 1)
    return x


def _relayout(x: np.ndarray, kind: str, to_torch: bool) -> np.ndarray:
    return np.array(_transposed(np.asarray(x, dtype=np.float32), kind, to_torch), order="C")


def module_from_jax(module: nn.Module, params: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of ``module``'s JAX counterpart (unrolled or with
    scanned stacks) -> its ``state_dict``."""
    flat = unstack_scans(_strip_params(params))
    sd: Dict[str, torch.Tensor] = {}
    missing = []
    for key, (path, kind) in flax_layout(module).items():
        if path not in flat:
            missing.append(path)
            continue
        sd[key] = torch.from_numpy(_relayout(flat.pop(path), kind, to_torch=True))
    if missing or flat:
        raise KeyError(f"{type(module).__name__}: flax leaves missing {sorted(missing)}, "
                       f"unmapped {sorted(flat)}")
    return sd


def module_jax_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The flat ``params/...`` leaf shapes of ``module``'s JAX counterpart,
    read from its parameters' shapes alone (a module on the ``meta`` device
    serves)."""
    shapes = {}
    for key, (path, kind) in flax_layout(module).items():
        torch_shape = tuple(module.get_parameter(key).shape)
        view = np.broadcast_to(np.float32(0), torch_shape)  # no copy
        shapes[f"params/{path}"] = _transposed(view, kind, to_torch=False).shape
    return shapes


def module_to_jax_flat(module: nn.Module,
                       state_dict: Mapping[str, torch.Tensor] | None = None,
                       scan_stacks: bool = False) -> Dict[str, np.ndarray]:
    """``module``'s parameters (or ``state_dict``, laid out as ``module``'s)
    -> the flat ``params/...`` layout of its JAX counterpart, with the
    ConvNeXt stacks rolled as a ``scan_stacks`` model's when asked."""
    sd = dict(module.state_dict() if state_dict is None else state_dict)
    flat = {}
    for key, (path, kind) in flax_layout(module).items():
        flat[f"params/{path}"] = _relayout(sd.pop(key).detach().cpu().numpy(), kind,
                                           to_torch=False)
    if sd:
        raise KeyError(f"{type(module).__name__}: unmapped weights {sorted(sd)}")
    return restack_scans(flat) if scan_stacks else flat
