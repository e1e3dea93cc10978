"""Import a full reference training checkpoint (accelerate save_state
directory) into the flax parameter layout, and from there into the port's
modules.

The port's copy of ``stylish_tts_tpu/convert/checkpoint_import.py``. The
reference saves one ``pytorch_model.bin`` / ``pytorch_model_{i}.bin`` per
model in build_model insertion order (reference
train/models/models.py:69-83, train/train.py:453-469 via
accelerator.save_state). This module loads those files (weights only:
checkpoints are untrusted third-party data), folds every parametrization,
and converts each model with the mappers of ``torch_import.py`` into the
tree the JAX import gives, leaf for leaf (numpy). ``imported_models``
loads that tree into the port's modules through the weight bridge
(``from_jax.module_from_jax``), built with
``ModelConfig.imported_weights=True`` so that BatchNorm sites run as frozen
affine and spectral-norm kernels are taken as pre-folded.

Validation is against the port's own modules (``module_jax_shapes`` of
``build_models`` and ``build_text_aligner``, built on the ``meta`` device),
where the JAX import traces its ``init_all_params``. A
``generator.type: ringformer`` config cannot import: the speech predictor's
converter reads the FreeGAN ``MultiGenerator`` layout, and the JAX import
fails on it too.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from . import torch_import as ti
from .folding import fold_state_dict

# reference build_model Munch insertion order (models.py:69-83): the
# accelerate save_state file order.
REFERENCE_MODEL_ORDER = [
    "text_aligner",
    "duration_predictor",
    "pitch_energy_predictor",
    "speech_predictor",
    "disc",
    "mrd0",
    "mrd1",
    "mrd2",
    "speech_style_encoder",
    "pe_style_encoder",
    "duration_style_encoder",
    "pitch_disc",
    "dur_disc",
]


def accelerate_model_file(ckpt_dir: str, index: int) -> str:
    name = "pytorch_model.bin" if index == 0 else f"pytorch_model_{index}.bin"
    return osp.join(ckpt_dir, name)


def load_accelerate_state_dicts(ckpt_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Load the 13 per-model torch state_dicts from an accelerate
    save_state directory (weights only: no pickled code runs)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for i, name in enumerate(REFERENCE_MODEL_ORDER):
        path = accelerate_model_file(ckpt_dir, i)
        if not osp.exists(path):
            raise FileNotFoundError(
                f"{path} missing — not an accelerate save_state checkpoint "
                f"(expected {len(REFERENCE_MODEL_ORDER)} pytorch_model files)"
            )
        sd = torch.load(path, map_location="cpu", weights_only=True)
        out[name] = {
            k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()
        }
    return out


def convert_model(name: str, sd: Mapping[str, np.ndarray], mc: ModelConfig):
    """Convert one folded reference state_dict to flax params."""
    text_layers = mc.text_encoder.layers
    if name == "text_aligner":
        return ti.convert_text_aligner(sd)
    if name == "duration_predictor":
        return ti.convert_duration_predictor(
            sd, text_layers, mc.duration_predictor.n_layer
        )
    if name == "pitch_energy_predictor":
        return ti.convert_pitch_energy_predictor(sd, text_layers)
    if name == "speech_predictor":
        return ti.convert_speech_predictor(
            sd, text_layers, mc.generator.conformer_layers,
            mc.generator.conv_layers,
        )
    if name == "disc":
        return ti.convert_context_free_discriminator(sd)
    if name in ("mrd0", "mrd1", "mrd2"):
        return ti.convert_spec_discriminator(sd)
    if name in ("speech_style_encoder", "duration_style_encoder"):
        return ti.convert_mel_style_encoder(sd)
    if name == "pe_style_encoder":
        return ti.convert_pitch_style_encoder(sd)
    if name in ("pitch_disc", "dur_disc"):
        return ti.convert_pitch_discriminator(sd)
    raise KeyError(name)


def _tree_shapes(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _tree_shapes(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = tuple(np.shape(tree))
    return out


def validate_against(params: Dict[str, Any], reference_tree: Dict[str, Any]):
    """Raise with a readable diff if converted params don't match the
    reference tree (missing/extra paths or shape mismatches)."""
    got = _tree_shapes(params)
    want = _tree_shapes(reference_tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = sorted(
        k for k in set(got) & set(want) if got[k] != want[k]
    )
    if missing or extra or bad:
        lines = []
        for k in missing[:20]:
            lines.append(f"missing: {k} {want[k]}")
        for k in extra[:20]:
            lines.append(f"extra:   {k} {got[k]}")
        for k in bad[:20]:
            lines.append(f"shape:   {k} got {got[k]} want {want[k]}")
        raise ValueError("converted params mismatch:\n" + "\n".join(lines))


def port_tree_shapes(mc: ModelConfig) -> Dict[str, Any]:
    """{model: {"params": tree}} of the port's 13 modules under ``mc``,
    each leaf a zero-stride array of the flax leaf's shape."""
    from ..utils.params_io import unflatten
    from .from_jax import module_jax_shapes
    from .reference_layout import reference_models

    return {
        name: unflatten({path: np.broadcast_to(np.float32(0), shape)
                         for path, shape in module_jax_shapes(module).items()})
        for name, module in reference_models(mc).items()
    }


def import_torch_checkpoint(
    ckpt_dir: str, mc: ModelConfig, validate: bool = True
) -> Dict[str, Any]:
    """accelerate checkpoint dir -> {model_name: {"params": subtree}}.

    Sets ``mc.imported_weights = True`` and ``mc.generator.norm_mode =
    "affine"`` (the JAX ``build_model`` sets the second); callers build the
    modules from this same config so that the frozen-affine norm sites line
    up."""
    if mc.generator.type != "freegan":
        raise ValueError(
            f"generator.type {mc.generator.type!r} cannot import: the reference "
            "speech predictor's converter reads the FreeGAN MultiGenerator layout "
            "(the JAX import fails on this config too)"
        )
    mc.imported_weights = True
    mc.generator.norm_mode = "affine"
    raw = load_accelerate_state_dicts(ckpt_dir)
    params: Dict[str, Any] = {}
    for name, sd in raw.items():
        folded = fold_state_dict(sd)
        params[name] = {"params": convert_model(name, folded, mc)}
    if validate:
        validate_against(params, port_tree_shapes(mc))
    return params


def imported_models(params: Mapping[str, Any], mc: ModelConfig) -> Dict[str, torch.nn.Module]:
    """The 13 modules (``build_models``' twelve and the aligner, by their
    registry names) of an imported tree, on the CPU in eval mode; ``mc``
    must have ``imported_weights`` set."""
    from ..models import build_models, build_text_aligner
    from .from_jax import module_from_jax

    if not mc.imported_weights:
        raise ValueError("imported weights need ModelConfig.imported_weights = True")
    models = {**build_models(mc), "text_aligner": build_text_aligner(mc)}
    for name, module in models.items():
        module.load_state_dict(module_from_jax(module, params[name]))
        module.eval()
    return {name: models[name] for name in REFERENCE_MODEL_ORDER}
