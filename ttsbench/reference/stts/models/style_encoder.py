"""Mel and pitch reference style encoders.

Counterpart of ``stylish_tts_tpu/models/style_encoder.py``
(``SNConv2d``, ``_torch_avg_pool_half``, ``ResBlk2d``,
``MelStyleEncoderCore``, ``MelStyleEncoder``, ``PitchStyleEncoder``): a 2D
conv stem, 4 spectrally-normalised residual downsample blocks, a 5x5 valid
conv, a global average pool and a linear layer -> style vector. The pitch
encoder (the textual stage's ``pe_style_encoder``) first stacks the
resized F0 and energy curves under the mel rows and maps them back to the
mel rows with a pointwise ``preconv``.

The JAX module runs NHWC with H = mel, W = frames; here it is NCHW with
the same H and W. Every conv holds its RAW kernel and normalises it in
the forward with the stateless ``spectral_normalize`` (3 power iterations
from the ones vector; ``sn=False`` for imported, pre-folded weights), so
the weight bridge moves raw kernels both ways.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import Linear, Pointwise, spectral_normalize


class SNConv2d(nn.Conv2d):
    """Conv2d whose kernel is spectrally normalised at every call. Padding
    is "SAME" for the odd stride-1 kernels (k // 2), or explicit."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int | None = None, groups: int = 1,
                 bias: bool = True, sn: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding,
                         groups=groups, bias=bias)
        self.sn = sn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = spectral_normalize(self.weight) if self.sn else self.weight
        return self._conv_forward(x, weight, self.bias)


def _torch_avg_pool_half(x: torch.Tensor) -> torch.Tensor:
    """DownSample('half'): replicate-pad the frame axis (W) to even, drop an
    odd last mel row (H), then the 2x2 mean."""
    if x.shape[3] % 2:
        x = torch.cat([x, x[:, :, :, -1:]], dim=3)
    if x.shape[2] % 2:
        x = x[:, :, :-1]
    return F.avg_pool2d(x, 2)


class ResBlk2d(nn.Module):
    """Downsampling residual block."""

    def __init__(self, dim_in: int, dim_out: int, downsample: str = "half",
                 sn: bool = True):
        super().__init__()
        self.downsample = downsample
        if dim_in != dim_out:
            self.conv1x1 = SNConv2d(dim_in, dim_out, 1, bias=False, sn=sn)
        else:
            self.conv1x1 = None
        self.conv1 = SNConv2d(dim_in, dim_in, 3, sn=sn)
        if downsample == "half":
            # learned strided depthwise downsample, torch Conv2d(stride=2, padding=1)
            self.down = SNConv2d(dim_in, dim_in, 3, stride=2, padding=1,
                                 groups=dim_in, sn=sn)
        self.conv2 = SNConv2d(dim_in, dim_out, 3, sn=sn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = x if self.conv1x1 is None else self.conv1x1(x)
        if self.downsample == "half":
            sc = _torch_avg_pool_half(sc)
        h = self.conv1(F.leaky_relu(x, 0.2))
        if self.downsample == "half":
            h = self.down(h)
        h = self.conv2(F.leaky_relu(h, 0.2))
        return (sc + h) / math.sqrt(2.0)


class MelStyleEncoderCore(nn.Module):
    def __init__(self, dim_in: int, style_dim: int, max_conv_dim: int,
                 skip_last_downsample: bool, sn: bool = True):
        super().__init__()
        self.stem = SNConv2d(1, dim_in, 3, sn=sn)
        for i in range(4):
            dim_out = min(dim_in * 2, max_conv_dim)
            down = "none" if (i == 3 and skip_last_downsample) else "half"
            self.add_module(f"res_{i}", ResBlk2d(dim_in, dim_out, down, sn=sn))
            dim_in = dim_out
        self.post = SNConv2d(dim_in, dim_in, 5, padding=0, sn=sn)
        self.out = Linear(dim_in, style_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, mel, frames) -> (B, style_dim)."""
        h = self.stem(x)
        for i in range(4):
            h = getattr(self, f"res_{i}")(h)
        h = self.post(F.leaky_relu(h, 0.2))
        h = F.leaky_relu(h.mean(dim=(2, 3)), 0.2)  # global average pool
        return self.out(h)


class MelStyleEncoder(nn.Module):
    """(B, mel, frames) style mel -> (B, style_dim)."""

    def __init__(self, dim_in: int = 80, style_dim: int = 64, max_conv_dim: int = 384,
                 skip_last_downsample: bool = True, sn: bool = True):
        super().__init__()
        self.core = MelStyleEncoderCore(dim_in, style_dim, max_conv_dim,
                                        skip_last_downsample, sn=sn)

    def forward(self, style_mel: torch.Tensor) -> torch.Tensor:
        return self.core(style_mel[:, None])


def resize_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T) -> (B, size) by linear interpolation at half-pixel centres,
    the edges held (``jax.image.resize(..., "linear", antialias=False)``)."""
    return F.interpolate(x[:, None], size=size, mode="linear", align_corners=False)[:, 0]


class PitchStyleEncoder(nn.Module):
    """(style_mel (B, mel, frames'), pitch (B, T), energy (B, T)) -> style.

    The curves go to ``T // coarse_multiplier`` points, then to the style
    mel's frame count, and are stacked under its rows; ``preconv`` maps the
    mel + 2 rows back to ``dim_in`` over the frames zero-padded by one on
    each side (the reference's kernel-1, padding-1 conv: the two edge
    columns are bias only)."""

    def __init__(self, dim_in: int = 80, style_dim: int = 64, max_conv_dim: int = 384,
                 skip_last_downsample: bool = True, coarse_multiplier: int = 1,
                 sn: bool = True):
        super().__init__()
        self.coarse_multiplier = coarse_multiplier
        self.preconv = Pointwise(dim_in + 2, dim_in)
        self.core = MelStyleEncoderCore(dim_in, style_dim, max_conv_dim,
                                        skip_last_downsample, sn=sn)

    def forward(self, style_mel: torch.Tensor, pitch: torch.Tensor,
                energy: torch.Tensor) -> torch.Tensor:
        coarse = pitch.shape[-1] // self.coarse_multiplier
        frames = style_mel.shape[-1]
        curves = [resize_linear(resize_linear(c, coarse), frames) for c in (pitch, energy)]
        x = torch.cat([style_mel, curves[0][:, None], curves[1][:, None]], dim=1)
        x = self.preconv(F.pad(x, (1, 1)))
        return self.core(x[:, None])
