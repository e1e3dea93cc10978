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

Tensor parallelism (``parallel/sharding_rules.py``). ``shard_state``
replaces the kernels that the JAX rules shard by this model rank's
contiguous slice and marks their module with ``tp_dim``: 0 (column: the
output features) or 1 (row: the input features). ``tp_apply`` is then the
Megatron product: a column layer reads its input through
``copy_to_model`` and its bias through ``scatter_to_model`` and gives this
rank's output slice; a row layer takes the matching input slice, its
partial products are summed by one ``reduce_from_model``, and its bias is
added once after the sum. Between a pair, per-channel operations take
their slice of a replicated parameter or activation (``scatter_to_model``:
the column bias, the ``_StyleFiLM`` output, the snake alphas, GRN's
``gamma`` and ``beta``), and dropout draws the full mask and takes its
slice, so that a rank draws what one process draws. The invariant: a
replicated tensor is read into sharded compute only through a function
whose backward all-reduces over the model group, so after a backward every
rank of a model group holds the full gradient of each replicated parameter
(alike across the group up to the rounding of its own kernels, which
``parallel.pmean_grads`` removes by taking model rank 0's) and its slice of
the one-process gradient of each sharded one. Places where a pair is not
elementwise: GRN's mean over the channels (``sum_over_model``), the
spectral norm's sigma (from the full kernel, gathered under ``no_grad``),
the conformer's fused ``to_kv`` and attention heads that do not divide
(``conformer.py``, ``text_encoder.py``).
A module without ``tp_dim`` computes exactly as before.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import mesh as pmesh


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask, True inside the sequence."""
    pos = torch.arange(max_length, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha*x)/alpha."""
    return x + (1.0 / alpha) * torch.square(torch.sin(alpha * x))


def spectral_normalize(weight: torch.Tensor, n_iter: int = 3,
                       shard_dim: int | None = None) -> torch.Tensor:
    """Stateless spectral normalization of a conv or dense weight (the JAX
    ``spectral_normalize``): 3 power iterations from the normalised ones
    vector over the kernel flattened as flax lays it out, (..., in, out) ->
    (-1, out); sigma is a constant of the backward pass (stop-gradient).
    ``shard_dim``: ``weight`` is this model rank's shard along that dim;
    sigma is then the full kernel's (gathered without a gradient).

    Not ``torch.nn.utils.spectral_norm``, which keeps a random, stateful
    ``u`` across calls and so computes another function."""
    with torch.no_grad():
        full = weight if shard_dim is None else pmesh.gather_model_tensor(weight, shard_dim)
        if full.dim() > 2:  # torch (out, in, *k) -> flax (*k, in, out)
            w = full.permute(*range(2, full.dim()), 1, 0)
        else:  # nn.Linear (out, in) -> flax (in, out)
            w = full.t()
        w = w.reshape(-1, w.shape[-1])
        u = torch.ones(w.shape[0], dtype=w.dtype, device=w.device) / math.sqrt(w.shape[0])
        for _ in range(n_iter):
            v = w.t() @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
        sigma = torch.clamp_min(u @ (w @ v), 1e-12)
    return weight / sigma


def tp_dim(module: nn.Module) -> int | None:
    """The dim of ``module``'s weight that the model axis shards (0 column,
    1 row), or None."""
    return getattr(module, "tp_dim", None)


def tp_pair(column: nn.Module, row: nn.Module) -> bool:
    """Whether the pair ``column`` -> ``row`` runs sharded (the rules shard
    both or neither)."""
    col, r = tp_dim(column), tp_dim(row)
    if (col, r) not in ((None, None), (0, 1)):
        raise ValueError(f"a column/row pair sharded as ({col}, {r})")
    return col == 0


def tp_apply(module: nn.Module, x: torch.Tensor, op, weight: torch.Tensor | None = None,
             channel_dim: int = 1) -> torch.Tensor:
    """``op(x, weight, bias)`` (``weight`` defaults to the module's) as the
    module's ``tp_dim`` says: unsharded, column (x alike on every model rank;
    this rank's output slice) or row (x this rank's input slice; the full
    output, its bias added after the sum). ``channel_dim``: the output's
    feature dim."""
    w = module.weight if weight is None else weight
    d = tp_dim(module)
    if d is None:
        return op(x, w, module.bias)
    if d == 0:
        bias = None if module.bias is None else pmesh.scatter_to_model(module.bias, 0)
        return op(pmesh.copy_to_model(x), w, bias)
    y = pmesh.reduce_from_model(op(x, w, None))
    if module.bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + module.bias.view(shape).to(y.dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_apply(self, x, self._conv_forward)


def _pointwise(x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
    return F.conv1d(x, weight[:, :, None], bias)


class Pointwise(nn.Linear):
    """flax ``nn.Dense`` over the channels of a (B, C, T) tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_apply(self, x, _pointwise)


class Linear(nn.Linear):
    """``nn.Linear`` (flax ``nn.Dense``) over the last dim, tensor-parallel
    where the rules shard it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_apply(self, x, F.linear, channel_dim=-1)


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

    def film(self, x: torch.Tensor, style: torch.Tensor,
             sharded: bool = False) -> torch.Tensor:
        """``sharded``: x holds this model rank's slice of the channels, and
        gamma and beta are read through theirs."""
        gamma, beta = self.fc(style).chunk(2, dim=-1)
        if sharded:
            gamma, beta = pmesh.scatter_to_model(gamma, 1), pmesh.scatter_to_model(beta, 1)
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

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                sharded: bool = False) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True)
        var = x.var(dim=2, keepdim=True, unbiased=False)
        return self.film((x - mean) * torch.rsqrt(var + self.eps), style, sharded)


class GRN(nn.Module):
    """Global Response Normalization: L2 norm over time, normalised by its
    mean over channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = channel_param(dim, 0.0)
        self.beta = channel_param(dim, 0.0)

    def forward(self, x: torch.Tensor, sharded: bool = False) -> torch.Tensor:
        """``sharded``: x holds this model rank's slice of the channels; the
        mean over the channels is then one all-reduce of the slices' sums."""
        gx = torch.sqrt(torch.sum(torch.square(x), dim=2, keepdim=True) + 1e-12)
        gamma, beta = self.gamma, self.beta
        if sharded:
            total = pmesh.sum_over_model(gx.sum(dim=1, keepdim=True))
            mean = total / (gx.shape[1] * pmesh.model_size())
            gamma, beta = pmesh.scatter_to_model(gamma, 1), pmesh.scatter_to_model(beta, 1)
        else:
            mean = gx.mean(dim=1, keepdim=True)
        nx = gx / (mean + 1e-6)
        return gamma * (x * nx) + beta + x


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
        sharded = tp_pair(self.conv1, self.conv2)
        h = F.leaky_relu(self.norm1(x, style), 0.2)
        h = self.conv1(dropout(h, self.dropout, self.training, generator))
        h = F.leaky_relu(self.norm2(h, style, sharded), 0.2)
        h = self.conv2(dropout(h, self.dropout, self.training, generator,
                               shard_dim=1 if sharded else None))
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
            conv1, conv2 = getattr(self, f"conv1_{i}"), getattr(self, f"conv2_{i}")
            sharded = tp_pair(conv1, conv2)
            alpha2 = getattr(self, f"alpha2_{i}")
            h = getattr(self, f"adain1_{i}")(x, style)
            h = snake(h, getattr(self, f"alpha1_{i}"))
            h = conv1(h)
            h = getattr(self, f"adain2_{i}")(h, style, sharded)
            h = snake(h, pmesh.scatter_to_model(alpha2, 1) if sharded else alpha2)
            x = x + conv2(h)
        return x


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None,
            shard_dim: int | None = None) -> torch.Tensor:
    """Inverted dropout drawing its mask from an explicit generator (flax
    ``nn.Dropout``: keep with probability 1 - rate, scale by 1/(1-rate)).
    ``shard_dim``: x is this model rank's slice along that dim; the full
    mask is drawn and its slice taken, as one process draws it."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if shard_dim is not None:
        shape[shard_dim] *= pmesh.model_size()
    # float32 draws whatever x's dtype (a bf16 uniform would move the rate)
    u = torch.rand(shape, generator=generator, device=x.device, dtype=torch.float32)
    if shard_dim is not None:
        n = x.shape[shard_dim]
        u = u.narrow(shard_dim, pmesh.model_rank() * n, n)
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
