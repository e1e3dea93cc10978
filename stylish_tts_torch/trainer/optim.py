"""Per-module optimization: AdamW + cosine schedule + nonfinite guard.

Counterpart of ``stylish_tts_tpu/trainer/optim.py`` (the parts the
alignment stage uses). optax's ``scale_by_adam`` then
``add_decayed_weights``, scaled by ``-lr``, is the same update as
``torch.optim.AdamW`` with the same betas, eps and weight decay:
p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

LOGICAL_STEP_LIMIT = 10_000
PLATEAU = 0.9

ADAM_B1 = 0.85
ADAM_B2 = 0.99
ADAM_EPS = 1e-9
WEIGHT_DECAY = 1e-4


def make_optimizer(params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """AdamW with the reference's constants; the step sets the live LR."""
    return torch.optim.AdamW(
        params, lr=0.0, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
        weight_decay=WEIGHT_DECAY,
    )


def grads_finite(module: torch.nn.Module) -> bool:
    """True when every gradient of ``module`` is finite (one host sync)."""
    flags = [
        torch.isfinite(p.grad).all()
        for p in module.parameters() if p.grad is not None
    ]
    return bool(torch.stack(flags).all()) if flags else True


def apply_module_update(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        lr: float) -> bool:
    """One AdamW step on ``module`` from its ``.grad``s at ``lr``.

    Nonfinite guard: if ANY gradient entry of the module is inf/nan, the
    step is skipped, so the params, the moments and the step count all keep
    their old values. Returns whether the update was applied."""
    if not grads_finite(module):
        return False
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return True


def cosine_lr(base_lr: float, step: int, stage_steps: int) -> float:
    """Cosine decay over the stage, expressed in 10k logical steps with a
    plateau at 90%, in the JAX package's float32 arithmetic."""
    steps = max(int(stage_steps), 1)
    rem = np.float32(step % steps)
    logical = (step // steps) * LOGICAL_STEP_LIMIT + int(
        np.floor(rem * np.float32(LOGICAL_STEP_LIMIT) / np.float32(steps))
    )
    logical = min(logical, int(LOGICAL_STEP_LIMIT * PLATEAU))
    progress = np.float32(logical) / np.float32(LOGICAL_STEP_LIMIT)
    lr = np.float32(base_lr) * np.float32(0.5) * (
        np.float32(1.0) + np.cos(np.float32(math.pi) * progress)
    )
    return float(np.float32(lr))
