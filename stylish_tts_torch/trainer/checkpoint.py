"""Checkpoint / resume: the port's ``stylish_tts_tpu/trainer/checkpoint.py``.

Directory naming ``checkpoint_{epoch:05d}_step_{step:09d}`` and the JSON
sidecars (``manifest.json``, ``config.json``, ``model_config.json``,
``normalization.json``) are the JAX package's. The tensor state is the
port's own: ``state.pt``, the stage state's ``state_dict()`` (``TrainState``
for alignment, ``StageTrainState`` for the later stages) written with
``torch.save`` and read back with ``weights_only=True`` (the JAX package
writes an orbax tree, which the port does not read). Resume semantics
live in ``trainer/loop.py``: same stage -> fast-forward the sampler by
``current_step``; another stage -> fresh counters. Any later stage's
checkpoint loads into ``StageTrainState``, also an acoustic one that holds
only the acoustic stage's six modules (the rest keep their init). A
checkpoint of ``import-torch`` holds the twelve modules in ``state.pt``
and the aligner beside it (``ALIGNER_FILE``), where the JAX orbax tree
holds all thirteen. Data parallel, ``save_checkpoint`` runs on every
rank (the state's ``state_dict`` gathers every rank's generator states),
rank 0 alone writes, and the others wait for it at a barrier.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
from dataclasses import asdict, dataclass, field
from typing import Optional

import torch

from .. import parallel
from ..config import Config, ModelConfig
from .normalization import NormalizationStats
from .state import StageTrainState, TrainState

STATE_FILE = "state.pt"
# an imported checkpoint's aligner, beside ``state.pt`` (which holds the
# twelve later-stage modules) in the JAX flat layout of train-align's output
ALIGNER_FILE = "alignment_model.safetensors"


@dataclass
class Manifest:
    """Training progress counters (the JAX ``Manifest``, same fields)."""

    current_epoch: int = 1
    current_step: int = 1
    current_total_step: int = 0
    steps_per_epoch: int = 0
    stage: str = "alignment"
    best_loss: float = float("inf")
    training_log: list = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        return cls(**json.loads(text))


def checkpoint_dir_name(epoch: int, step: int) -> str:
    return f"checkpoint_{epoch:05d}_step_{step:09d}"


def save_checkpoint(
    out_dir: str,
    state: TrainState | StageTrainState,
    manifest: Manifest,
    config: Config,
    model_config: ModelConfig,
    normalization: NormalizationStats,
    max_keep: int = 4,
) -> str:
    path = osp.join(
        out_dir, checkpoint_dir_name(manifest.current_epoch, manifest.current_total_step)
    )
    saved = state.state_dict()
    if parallel.is_writer():
        _write_checkpoint(path, out_dir, saved, manifest, config, model_config,
                          normalization, max_keep)
    parallel.barrier()
    return path


def _write_checkpoint(path, out_dir, saved, manifest, config, model_config,
                      normalization, max_keep) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save(saved, osp.join(path, STATE_FILE))
    with open(osp.join(path, "manifest.json"), "w", encoding="utf-8") as f:
        f.write(manifest.to_json())
    with open(osp.join(path, "config.json"), "w", encoding="utf-8") as f:
        f.write(config.model_dump_json(indent=2))
    with open(osp.join(path, "model_config.json"), "w", encoding="utf-8") as f:
        f.write(model_config.model_dump_json(indent=2))
    normalization.save(osp.join(path, "normalization.json"))

    # prune old checkpoints (keep the newest max_keep)
    siblings = sorted(
        d for d in os.listdir(out_dir) if d.startswith("checkpoint_")
    )
    for old in siblings[:-max_keep]:
        shutil.rmtree(osp.join(out_dir, old), ignore_errors=True)


def load_checkpoint(
    path: str, state: TrainState | StageTrainState
) -> tuple:
    """Restore ``state`` in place from ``path``. The file is read onto the
    CPU; ``load_state_dict`` moves each tensor where the live state keeps
    it (AdamW's step counts stay on the CPU, as a fresh AdamW keeps them)."""
    saved = torch.load(osp.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    state.load_state_dict(saved)
    manifest = read_manifest(path)
    norm = NormalizationStats.load(osp.join(path, "normalization.json"))
    return state, manifest, norm


def load_stage_models(path: str, model_config: ModelConfig, device) -> tuple:
    """The twelve modules of a later stage's checkpoint (``build_models``
    names; an acoustic checkpoint of six loads, the rest at their init) on
    ``device``, and its normalization stats: what ``convert`` and
    ``voicepack`` read. Only the weights are read: the optimizers and the
    generator streams stay in the file."""
    from ..models import build_models

    saved = torch.load(osp.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if "models" not in saved:
        raise ValueError("the checkpoint holds no module of the acoustic, textual "
                         "or duration stage (an alignment checkpoint?)")
    models = build_models(model_config)
    for k, sd in saved["models"].items():
        models[k].load_state_dict(sd)
    norm = NormalizationStats.load(osp.join(path, "normalization.json"))
    return {k: m.to(device) for k, m in models.items()}, norm


def read_manifest(path: str) -> Manifest:
    with open(osp.join(path, "manifest.json"), "r", encoding="utf-8") as f:
        return Manifest.from_json(f.read())


def find_latest_checkpoint(out_dir: str) -> Optional[str]:
    if not osp.isdir(out_dir):
        return None
    cands = sorted(
        d for d in os.listdir(out_dir) if d.startswith("checkpoint_")
    )
    return osp.join(out_dir, cands[-1]) if cands else None
