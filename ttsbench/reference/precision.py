"""The precisions the reference computes in.

``exact``: float32 with TF32 off for cuBLAS and cuDNN; the reference's own.

The control (the reference put in the program's place one precision
below what the configuration states): TF32 on for every float32 matrix
product and convolution, and, where the configuration runs a phase under
bf16 autocast, float8 (e4m3, one scale per tensor) inputs to that phase's
matrix products and convolutions (``Fp8Inputs``), computed as autocast
would compute them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0

_PRODUCTS = {
    F.linear, F.conv1d, F.conv2d, F.conv_transpose1d, F.conv_transpose2d,
    torch.matmul, torch.bmm, torch.mm, torch.baddbmm, torch.addmm, torch.einsum,
    torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.bmm, torch.Tensor.mm,
}


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def exact():
    """float32 with TF32 off, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    set_tf32(False)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    set_tf32(True)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor, in
    ``x``'s dtype; the gradient passes the rounding unchanged."""
    with torch.no_grad():
        amax = x.abs().amax().float().clamp_min(1e-12)
        scale = E4M3_MAX / amax
        rounded = ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)
    return x + (rounded - x).detach()


def _autocast_on(device_type: str) -> bool:
    try:
        return torch.is_autocast_enabled(device_type)
    except TypeError:  # older torch: no argument, CUDA only
        if device_type == "cpu":
            return torch.is_autocast_cpu_enabled()
        return torch.is_autocast_enabled()


class Fp8Inputs(TorchFunctionMode):
    """Rounds the floating inputs of every matrix product and convolution
    to e4m3 where autocast is on (so a float32 island stays float32)."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and _autocast_on(self.device_type):
            args = tuple(to_e4m3(a) if isinstance(a, torch.Tensor) and a.is_floating_point()
                         else a for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def fp8_autocast(device: torch.device):
    """The control's generator phase: bf16 autocast with e4m3 inputs to its
    products."""
    with torch.autocast(device.type, dtype=torch.bfloat16), Fp8Inputs(device.type):
        yield
