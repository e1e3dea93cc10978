"""Training state: the port's ``stylish_tts_tpu/trainer/state.py``.

The JAX state is an immutable pytree threaded through a pure step; here
it is one mutable object that the step updates in place:

* ``TrainState`` (alignment): the aligner module holds its parameters,
  its AdamW the moments and step count, the label-prior accumulators are
  device tensors, and a ``torch.Generator`` on the device replaces the JAX
  ``rng`` key;
* ``StageTrainState`` (acoustic, textual, duration): the twelve modules
  of ``build_models`` by their registry names, one AdamW for each module
  the current stage trains and each of its discriminators
  (``STAGE_TRAIN_MODELS`` / ``STAGE_DISCRIMINATORS``), the discriminators'
  loss EMAs (host float32), three generators in place of the JAX key's
  per-step splits (dropout and model on the device; the disc index on the
  host, since it picks which MRD runs), the step, and the frozen WavLM of
  the acoustic stage, held by reference and never checkpointed (the JAX
  ``frozen``). ``begin_stage`` is the JAX advance: fresh AdamW moments and
  step 0; the weights, EMAs and generators carry on.

``state_dict`` / ``load_state_dict`` carry everything but the WavLM through
a checkpoint (``trainer/checkpoint.py``). A later stage's checkpoint
carries every module, as the JAX tree does.

``update_begun`` (never checkpointed) is the step's mark: the loop clears
it before each step and the step sets it where its first optimizer update
begins. An out-of-memory failure before it leaves the state as it was but
for the generators' draws; after it the state is partly updated (the JAX
donated buffers), and the loop raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..models.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS
from .optim import init_disc_ema, make_optimizer


@dataclass
class TrainState:
    aligner: torch.nn.Module
    optimizer: torch.optim.Optimizer
    # CTC label priors ("Less Peaky CTC"); C = n_tokens + 1
    log_priors: torch.Tensor
    log_priors_sum: torch.Tensor
    prior_count: torch.Tensor
    generator: torch.Generator
    step: int = 0
    update_begun: bool = False

    def state_dict(self) -> dict:
        """Everything a resume needs, as tensors, numbers and containers of
        them (loadable with ``torch.load(weights_only=True)``)."""
        return {
            "aligner": self.aligner.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "log_priors": self.log_priors,
            "log_priors_sum": self.log_priors_sum,
            "prior_count": self.prior_count,
            "generator": self.generator.get_state(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore in place from ``state_dict()``'s output (on any device)."""
        device = self.log_priors.device
        self.aligner.load_state_dict(state["aligner"])
        self.optimizer.load_state_dict(state["optimizer"])
        for name in ("log_priors", "log_priors_sum", "prior_count"):
            setattr(self, name, state[name].to(device))
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])


def create_train_state(aligner: torch.nn.Module, n_classes: int,
                       device, seed: int = 0) -> TrainState:
    aligner = aligner.to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return TrainState(
        aligner=aligner,
        optimizer=make_optimizer(aligner.parameters()),
        log_priors=torch.zeros((n_classes,), dtype=torch.float32, device=device),
        log_priors_sum=torch.full((n_classes,), -1e30, dtype=torch.float32,
                                  device=device),
        prior_count=torch.zeros((), dtype=torch.float32, device=device),
        generator=generator,
    )


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
    update_begun: bool = False

    GENERATORS = ("dropout_generator", "model_generator", "disc_index_generator")

    def begin_stage(self, stage: str) -> None:
        """Fresh AdamW for the modules ``stage`` trains and its
        discriminators, and step 0."""
        names = STAGE_TRAIN_MODELS[stage] + STAGE_DISCRIMINATORS[stage]
        self.optimizers = {k: make_optimizer(self.models[k].parameters()) for k in names}
        self.step = 0

    def state_dict(self) -> dict:
        """Everything a resume needs but the WavLM, as tensors, numbers and
        containers of them (loadable with ``torch.load(weights_only=True)``)."""
        return {
            "models": {k: m.state_dict() for k, m in self.models.items()},
            "optimizers": {k: o.state_dict() for k, o in self.optimizers.items()},
            "disc_ema": dict(self.disc_ema),
            "generators": {g: getattr(self, g).get_state() for g in self.GENERATORS},
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore in place from ``state_dict()``'s output (on any device).
        A module the saved state lacks (an acoustic checkpoint holds only
        the acoustic stage's six) keeps its weights; an optimizer is loaded
        where the saved state has one for the same module, so a checkpoint
        of another stage leaves the current stage's moments fresh."""
        if "models" not in state:
            raise ValueError("the checkpoint holds no module of the acoustic, textual "
                             "or duration stage (an alignment checkpoint?)")
        for k, sd in state["models"].items():
            self.models[k].load_state_dict(sd)
        for k, o in self.optimizers.items():
            if k in state["optimizers"]:
                o.load_state_dict(state["optimizers"][k])
        self.disc_ema.update({k: v.to("cpu", torch.float32)
                              for k, v in state["disc_ema"].items()})
        for g in self.GENERATORS:
            getattr(self, g).set_state(state["generators"][g])
        self.step = int(state["step"])


def create_stage_train_state(models: Dict[str, nn.Module], device, stage: str = "acoustic",
                             seed: int = 0) -> StageTrainState:
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
