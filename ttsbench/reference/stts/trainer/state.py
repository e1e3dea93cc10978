"""Training state: the port's ``stylish_tts_tpu/trainer/state.py`` for the
acoustic and textual stages, on one device.

The JAX state is an immutable pytree threaded through a pure step; here
it is one mutable object that the step updates in place: the twelve
modules of ``build_models`` by their registry names, one AdamW for each
module the current stage trains and each of its discriminators
(``STAGE_TRAIN_MODELS`` / ``STAGE_DISCRIMINATORS``), the discriminators'
loss EMAs (host float32), three generators in place of the JAX key's
per-step splits (dropout and model on the device; the disc index on the
host, since it picks which MRD runs), the step, and the frozen WavLM of
the acoustic stage (the JAX ``frozen``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..models.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS
from .optim import init_disc_ema, make_optimizer


@dataclass
class StageTrainState:
    models: Dict[str, nn.Module]
    optimizers: Dict[str, torch.optim.Optimizer]
    disc_ema: Dict[str, torch.Tensor]
    dropout_generator: torch.Generator
    model_generator: torch.Generator
    disc_index_generator: torch.Generator
    step: int = 0
    wavlm: Optional[nn.Module] = None

    def begin_stage(self, stage: str) -> None:
        """Fresh AdamW for the modules ``stage`` trains and its
        discriminators, and step 0."""
        names = STAGE_TRAIN_MODELS[stage] + STAGE_DISCRIMINATORS[stage]
        self.optimizers = {k: make_optimizer(self.models[k].parameters()) for k in names}
        self.step = 0


def create_stage_train_state(models: Dict[str, nn.Module], device, stage: str = "acoustic",
                             seed: int = 0) -> StageTrainState:
    """The generators are seeded ``3 * seed + i``: dropout, model, disc index."""
    models = {k: m.to(device) for k, m in models.items()}
    gens = []
    for i, dev in enumerate((device, device, "cpu")):
        g = torch.Generator(device=dev)
        g.manual_seed(seed * 3 + i)
        gens.append(g)
    state = StageTrainState(
        models=models,
        optimizers={},
        disc_ema=init_disc_ema(),
        dropout_generator=gens[0],
        model_generator=gens[1],
        disc_index_generator=gens[2],
    )
    state.begin_stage(stage)
    return state
