from .ctc import (
    accumulate_label_priors,
    ctc_loss_with_priors,
    update_log_priors,
)
from .ctc_cuda import ctc_loss_with_priors_cuda

__all__ = [
    "accumulate_label_priors",
    "ctc_loss_with_priors",
    "ctc_loss_with_priors_cuda",
    "update_log_priors",
]
