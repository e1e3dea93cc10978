"""Training state, the alignment part of ``stylish_tts_tpu/trainer/state.py``.

The JAX state is an immutable pytree threaded through a pure step; here
it is one mutable object that the step updates in place: the aligner
module holds its parameters, its AdamW holds the moments and step count,
the label-prior accumulators are device tensors, and a
``torch.Generator`` on the device replaces the JAX ``rng`` key.
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
