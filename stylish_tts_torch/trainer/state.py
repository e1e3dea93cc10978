"""Training state, the alignment part of ``stylish_tts_tpu/trainer/state.py``.

The JAX state is an immutable pytree threaded through a pure step; here
it is one mutable object that the step updates in place: the aligner
module holds its parameters, its AdamW holds the moments and step count,
the label-prior accumulators are device tensors, and a
``torch.Generator`` on the device replaces the JAX ``rng`` key.
``state_dict`` / ``load_state_dict`` carry all of it through a checkpoint
(``trainer/checkpoint.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .optim import make_optimizer


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
