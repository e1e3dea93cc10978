"""Shared building blocks.

Counterpart of ``stylish_tts_tpu/models/common.py``. The JAX modules take
(B, T, C); these take PyTorch's (B, C, T), and a model that takes the
JAX layout at its boundary transposes once there.

Submodules keep the flax names as attribute names. Where flax named a
child itself (``Conv_0``, ``LayerNorm_0``, ``StyleFiLM_0``, ``GRN_0``,
``Dense_0``), the class says so in ``FLAX_WRAP`` (the auto-named flax
child that holds this module's own parameters) or ``FLAX_NAMES``
(attribute -> flax path); ``convert/from_jax.py`` reads both.

Epsilons are the JAX sites' own: flax ``nn.LayerNorm`` 1e-6,
``LayerNormChannels`` 1e-4, ``AdaptiveLayerNorm`` and
``AdaptiveInstanceNorm`` 1e-5 (1e-6 where a caller says so), GroupNorm
1e-6, GRN 1e-12 and 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask, True inside the sequence."""
    pos = torch.arange(max_length, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha*x)/alpha."""
    return x + (1.0 / alpha) * torch.square(torch.sin(alpha * x))


def spectral_normalize(weight: torch.Tensor, n_iter: int = 3) -> torch.Tensor:
    """Stateless spectral normalization of a conv or dense weight (the JAX
    ``spectral_normalize``): 3 power iterations from the normalised ones
    vector over the kernel flattened as flax lays it out, (..., in, out) ->
    (-1, out); sigma is a constant of the backward pass (stop-gradient).

    Not ``torch.nn.utils.spectral_norm``, which keeps a random, stateful
    ``u`` across calls and so computes another function."""
    with torch.no_grad():
        if weight.dim() > 2:  # torch (out, in, *k) -> flax (*k, in, out)
            w = weight.permute(*range(2, weight.dim()), 1, 0)
        else:  # nn.Linear (out, in) -> flax (in, out)
            w = weight.t()
        w = w.reshape(-1, w.shape[-1])
        u = torch.ones(w.shape[0], dtype=w.dtype, device=w.device) / math.sqrt(w.shape[0])
        for _ in range(n_iter):
            v = w.t() @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
        sigma = torch.clamp_min(u @ (w @ v), 1e-12)
    return weight / sigma


def channel_param(channels: int, value: float) -> nn.Parameter:
    """A (1, C, 1) per-channel parameter (flax keeps it as (1, 1, C))."""
    return nn.Parameter(torch.full((1, channels, 1), value))


class Conv1d(nn.Conv1d):
    """1D conv over (B, C, T) with symmetric "same" padding, as the JAX
    ``Conv1d(pad="same")``."""

    FLAX_WRAP = "Conv_0"

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 stride: int = 1):
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride, dilation=dilation,
            padding=get_padding(kernel_size, dilation), groups=groups, bias=bias,
        )


class Pointwise(nn.Linear):
    """flax ``nn.Dense`` over the channels of a (B, C, T) tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight[:, :, None], self.bias)


Linear = nn.Linear  # flax ``nn.Dense`` over the last dim


class ChannelLayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` (default epsilon 1e-6) over the channels of a
    (B, C, T) tensor."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class LayerNormChannels(ChannelLayerNorm):
    """Plain LayerNorm over channels with epsilon 1e-4 (the JAX
    ``LayerNormChannels``, which wraps a flax ``LayerNorm_0``)."""

    FLAX_WRAP = "LayerNorm_0"

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__(channels, eps=eps)


class Norm1d(nn.Module):
    """Feature-axis norm over (B, C, T) with the JAX package's two modes.

    * ``group``  — GroupNorm(1) over (C, T), padded frames included, with
      flax's epsilon 1e-6 (torch's default is 1e-5); with a per-channel
      ``norm.weight``/``norm.bias`` when ``use_scale_bias`` (the conformer's
      ``bn``), without (the aligner's).
    * ``affine`` — frozen per-channel ``scale`` and ``bias`` (folded
      BatchNorm eval stats of an imported torch checkpoint).
    """

    def __init__(self, channels: int, mode: str = "group",
                 use_scale_bias: bool = False):
        super().__init__()
        if mode not in ("group", "affine"):
            raise ValueError(f"unknown Norm1d mode {mode!r}")
        self.mode = mode
        if mode == "group":
            self.norm = nn.GroupNorm(1, channels, eps=1e-6, affine=use_scale_bias)
        else:
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "group":
            return self.norm(x)
        return x * self.scale[:, None] + self.bias[:, None]


class _StyleFiLM(nn.Module):
    """Base of the style-modulated norms: ``fc`` maps the style vector to
    (gamma, beta), applied as (1 + gamma) * x + beta over the channels."""

    FLAX_NAMES = {"fc": "StyleFiLM_0/fc"}

    def __init__(self, channels: int, style_dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.fc = nn.Linear(style_dim, 2 * channels)

    def film(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.fc(style).chunk(2, dim=-1)
        return (1.0 + gamma[:, :, None]) * x + beta[:, :, None]


class AdaptiveLayerNorm(_StyleFiLM):
    """LayerNorm over channels (no scale or bias) with style FiLM."""

    def __init__(self, channels: int, style_dim: int, eps: float = 1e-5):
        super().__init__(channels, style_dim, eps)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        x = F.layer_norm(x.transpose(1, 2), (c,), eps=self.eps).transpose(1, 2)
        return self.film(x, style)


class AdaptiveInstanceNorm(_StyleFiLM):
    """Instance norm over time per channel with style FiLM; the biased
    variance over all T frames, padded ones included."""

    def __init__(self, channels: int, style_dim: int, eps: float = 1e-5):
        super().__init__(channels, style_dim, eps)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True)
        var = x.var(dim=2, keepdim=True, unbiased=False)
        return self.film((x - mean) * torch.rsqrt(var + self.eps), style)


class GRN(nn.Module):
    """Global Response Normalization: L2 norm over time, normalised by its
    mean over channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = channel_param(dim, 0.0)
        self.beta = channel_param(dim, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt(torch.sum(torch.square(x), dim=2, keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class AdaptiveDecoderBlock(nn.Module):
    """AdaIN residual conv block, with dropout after each leaky ReLU in
    ``train()`` mode. The decoder builds it with rate 0 (the JAX default);
    the pitch/energy heads with ``pitch_energy_predictor.dropout``."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int,
                 kernel_size: int = 3, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm1 = AdaptiveInstanceNorm(dim_in, style_dim)
        self.conv1 = Conv1d(dim_in, dim_out, kernel_size)
        self.norm2 = AdaptiveInstanceNorm(dim_out, style_dim)
        self.conv2 = Conv1d(dim_out, dim_out, kernel_size)
        self.shortcut = (
            Conv1d(dim_in, dim_out, 1, bias=False) if dim_in != dim_out else None
        )

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = F.leaky_relu(self.norm1(x, style), 0.2)
        h = self.conv1(dropout(h, self.dropout, self.training, generator))
        h = F.leaky_relu(self.norm2(h, style), 0.2)
        h = self.conv2(dropout(h, self.dropout, self.training, generator))
        res = x if self.shortcut is None else self.shortcut(x)
        return (h + res) / math.sqrt(2.0)


class AdaptiveGeneratorBlock(nn.Module):
    """Snake + AdaIN dilated resblock, one residual unit per dilation."""

    def __init__(self, channels: int, style_dim: int, kernel_size: int = 3,
                 dilations=(1, 3, 5)):
        super().__init__()
        self.n_units = len(dilations)
        for i, dilation in enumerate(dilations):
            setattr(self, f"alpha1_{i}", channel_param(channels, 1.0))
            setattr(self, f"alpha2_{i}", channel_param(channels, 1.0))
            self.add_module(f"adain1_{i}", AdaptiveInstanceNorm(channels, style_dim))
            self.add_module(f"conv1_{i}", Conv1d(channels, channels, kernel_size,
                                                 dilation=dilation))
            self.add_module(f"adain2_{i}", AdaptiveInstanceNorm(channels, style_dim))
            self.add_module(f"conv2_{i}", Conv1d(channels, channels, kernel_size))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_units):
            h = getattr(self, f"adain1_{i}")(x, style)
            h = snake(h, getattr(self, f"alpha1_{i}"))
            h = getattr(self, f"conv1_{i}")(h)
            h = getattr(self, f"adain2_{i}")(h, style)
            h = snake(h, getattr(self, f"alpha2_{i}"))
            x = x + getattr(self, f"conv2_{i}")(h)
        return x


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawing its mask from an explicit generator (flax
    ``nn.Dropout``: keep with probability 1 - rate, scale by 1/(1-rate))."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    # float32 draws whatever x's dtype (a bf16 uniform would move the rate)
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth over the batch axis (the JAX ``DropPath``): keep each
    row with probability 1 - rate, scaled by 1/(1-rate)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(shape, generator=generator, device=x.device, dtype=torch.float32)
    return x * (u < keep).to(x.dtype) / keep


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` and autograd recording, through
    ``torch.utils.checkpoint`` (non-reentrant): only the inputs are kept and
    the forward runs again in the backward, under the autocast of the
    first run (the JAX ``nn.remat``). No RNG state is saved, since the
    blocks wrapped so draw no random numbers. Without autograd (synthesis,
    validation) it is a plain call."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)
