"""Per-module optimization: AdamW + cosine schedule + nonfinite guard +
the discriminators' loss EMAs.

Counterpart of ``stylish_tts_tpu/trainer/optim.py``. optax's
``scale_by_adam`` then ``add_decayed_weights``, scaled by ``-lr``, is the
same update as ``torch.optim.AdamW`` with the same betas, eps and weight
decay: p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). optax steps
every leaf, one whose gradient is zero (stop-gradient, unused) included,
so a parameter that the backward did not reach gets a zero ``.grad``
before the step instead of being skipped by AdamW.

The EMAs live on the host as float32 0-d tensors: the gap-aware LR of a
step is read from them before the step, so no device value is needed to
launch it.
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

from .. import parallel
from ..utils.trace import span

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


def _finite_flag(module: torch.nn.Module) -> torch.Tensor:
    """A device bool: every gradient of ``module`` is finite."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return torch.ones((), dtype=torch.bool, device=next(module.parameters()).device)
    # the largest |g| of each tensor: NaN or inf exactly where one is there
    return torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()


def modules_finite(modules) -> list:
    """Whether every gradient of each module is finite, with one host sync
    for all. On a model axis the flags are reduced by MIN over the model
    group first (one collective), so that a NaN in one rank's shard skips the
    module's update on every rank, as JAX's ``isfinite`` over the global
    array does."""
    flags = torch.stack([_finite_flag(m) for m in modules])
    if parallel.model_size() > 1:
        flags = parallel.model_all_min(flags.to(torch.float32)) > 0
    with span("train.sync.finite"):
        return flags.tolist()


def apply_module_update(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        lr: float, finite: bool | None = None) -> bool:
    """One AdamW step on ``module`` from its ``.grad``s at ``lr``.

    Nonfinite guard: if ANY gradient entry of the module is inf/nan, the
    step is skipped, so the params, the moments and the step count all keep
    their old values. ``finite`` passes a flag already read (see
    ``modules_finite``). Returns whether the update was applied."""
    if finite is None:
        finite = modules_finite([module])[0]
    if not finite:
        return False
    for p in module.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
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


# EMA sub-counts per discriminator (number of score heads: the MRDs, pitch
# and duration discs have 5, the waveform disc 1)
DISC_SUB_COUNT = {
    "mrd0": 5.0,
    "mrd1": 5.0,
    "mrd2": 5.0,
    "disc": 1.0,
    "pitch_disc": 5.0,
    "dur_disc": 5.0,
}


def init_disc_ema() -> dict:
    return {name: torch.tensor(0.5 * count, dtype=torch.float32)
            for name, count in DISC_SUB_COUNT.items()}


def update_disc_ema(ema: torch.Tensor, raw_loss: torch.Tensor) -> torch.Tensor:
    """last = 0.95 * last + 0.05 * loss in float32; a nonfinite result keeps
    the old EMA (the same step the gradient guard skips)."""
    new = ema * 0.95 + raw_loss.detach().to(ema) * 0.05
    return torch.where(torch.isfinite(new), new, ema)
