"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on. Entry points run on ``cuda`` unless the
    caller asks for ``cpu``; asking for CUDA where there is none raises
    instead of carrying on on the CPU. Under ``torchrun`` (``LOCAL_RANK``
    set) a bare ``cuda`` is this process's card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev
