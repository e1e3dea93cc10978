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

Data parallel: every rank holds the whole state. The dropout and model
generators (the aligner's one generator) are seeded with the rank's offset
(``RANK_SEED_STRIDE``; rank 0 keeps the one-card seeds), the disc-index
generator alike on every rank. ``state_dict`` is a collective there: it
keeps every rank's generator states (``rank_generators``, in rank order),
so that a run resumed at the same world size continues as the
uninterrupted one; resumed at another world size, the weights, moments and
counters are restored and the rank-offset generators re-derived from the
saved ones and the rank (logged).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from .. import parallel
from ..models.models import STAGE_DISCRIMINATORS, STAGE_TRAIN_MODELS
from .optim import init_disc_ema, make_optimizer

logger = logging.getLogger("stylish_tts_torch")

# the seed offset of each rank's dropout and model generators
RANK_SEED_STRIDE = 1_000_003


def _rank_seed(seed: int) -> int:
    return seed + RANK_SEED_STRIDE * parallel.rank()


def _gather_states(states: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Every rank's generator states (``name -> get_state()``), in rank
    order (a collective)."""
    names = sorted(states)
    packed = parallel.gather_host(torch.cat([states[n] for n in names]))
    sizes = [states[n].numel() for n in names]
    return [dict(zip(names, row.split(sizes))) for row in packed]


def _own_states(state: dict, one_card: Dict[str, torch.Tensor],
                rank_offset: tuple) -> Dict[str, torch.Tensor]:
    """The generator states this rank resumes with: its own where the
    checkpoint was saved at this world size; otherwise those of rank 0 with
    the ``rank_offset`` streams re-derived from them and the rank (returned
    as None, for ``manual_seed`` with ``_derived_seed``)."""
    saved = state.get("rank_generators") or [one_card]
    if len(saved) == parallel.world_size():
        return saved[parallel.rank()]
    logger.warning("checkpoint saved at world size %d, resumed at %d: weights, moments "
                   "and counters restored; generators %s re-derived for rank %d",
                   len(saved), parallel.world_size(), list(rank_offset), parallel.rank())
    return {k: (None if k in rank_offset else v) for k, v in saved[0].items()}


def _derived_seed(saved: torch.Tensor) -> int:
    digest = hashlib.sha256(saved.numpy().tobytes() + parallel.rank().to_bytes(4, "little"))
    return int.from_bytes(digest.digest()[:8], "little")


def _restore(generator: torch.Generator, own, saved0: torch.Tensor) -> None:
    if own is None:
        generator.manual_seed(_derived_seed(saved0))
    else:
        generator.set_state(own)


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
            **({"rank_generators": _gather_states({"generator": self.generator.get_state()})}
               if parallel.world_size() > 1 else {}),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore in place from ``state_dict()``'s output (on any device)."""
        device = self.log_priors.device
        self.aligner.load_state_dict(state["aligner"])
        self.optimizer.load_state_dict(state["optimizer"])
        for name in ("log_priors", "log_priors_sum", "prior_count"):
            setattr(self, name, state[name].to(device))
        own = _own_states(state, {"generator": state["generator"]}, ("generator",))
        _restore(self.generator, own["generator"], state["generator"])
        self.step = int(state["step"])


def create_train_state(aligner: torch.nn.Module, n_classes: int,
                       device, seed: int = 0) -> TrainState:
    aligner = aligner.to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(_rank_seed(seed))
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
    RANK_OFFSET = ("dropout_generator", "model_generator")

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
            "generators": self._generator_states(),
            "step": self.step,
            **({"rank_generators": _gather_states(self._generator_states())}
               if parallel.world_size() > 1 else {}),
        }

    def _generator_states(self) -> Dict[str, torch.Tensor]:
        return {g: getattr(self, g).get_state() for g in self.GENERATORS}

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
        own = _own_states(state, state["generators"], self.RANK_OFFSET)
        for g in self.GENERATORS:
            _restore(getattr(self, g), own[g], state["generators"][g])
        self.step = int(state["step"])


def create_stage_train_state(models: Dict[str, nn.Module], device, stage: str = "acoustic",
                             seed: int = 0) -> StageTrainState:
    models = {k: m.to(device) for k, m in models.items()}
    gens = []
    for i, dev in enumerate((device, device, "cpu")):
        g = torch.Generator(device=dev)
        g.manual_seed(seed * 3 + i if i == 2 else _rank_seed(seed * 3 + i))
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
