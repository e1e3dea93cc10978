"""Kokoro-82M for inference, padding-exact in buckets.

The model of hexgrad/Kokoro-82M (the ``kokoro`` package's ``model.py``,
``modules.py`` and ``istftnet.py``, Apache-2.0): a 12-pass ALBERT over the
phonemes, the prosody predictor (a duration encoder of bidirectional LSTMs
and AdaLayerNorms, a duration head, and the F0 and energy branches of
AdainResBlk1d over the alignment frames), a text encoder (convolutions and
a bidirectional LSTM), and the iSTFTNet decoder (AdainResBlk1d, then a
generator of transposed convolutions, AdaIN/snake resblocks, an Hn-NSF
sine source and an iSTFT). Weight norm is folded into the plain conv
weights at build time (the same function at inference); dropout is off.

Kokoro's own forward is one unpadded line at batch 1. Here a line runs in
a text bucket L and a frame bucket F, and its output equals that unpadded
forward to rounding. Four things make padding exact:

* ``LengthLSTM``: the forward direction runs over the bucket as it is (a
  causal pass: padding after the line changes nothing before it); the
  reverse direction runs over each row's valid prefix reversed (a per-row
  gather before and after a unidirectional pass with the reverse weights),
  so that it starts at the line's last real token or frame;
* ``AdaIN1d``: instance-norm statistics over the valid frames only;
* every conv or transposed conv whose window reaches past the line's end
  reads zeros there (its input is multiplied by the line's mask), as the
  unpadded conv reads its zero padding;
* the source's linear resampling clamps at the line's own last frame, and
  the STFT reflects at the line's own last sample; the iSTFT adds no
  frame past the line's and normalises by the window envelope of the
  line's own frames.

Shapes: a line of ``n`` ids (the phonemes between two 0 pads) at text
bucket L; ``f`` alignment frames (the sum of its integer durations) at
frame bucket F; the F0 curve at 2F; audio at 600 F samples (two F0
frames a frame, ``prod(upsample_rates) x gen_istft_hop_size`` samples an
F0 frame).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import KokoroConfig

# kokoro's (res + shortcut) * torch.rsqrt(torch.tensor(2)), a float32 value
RSQRT2 = float(torch.rsqrt(torch.tensor(2.0)))
HARMONICS = 9  # SourceModuleHnNSF(harmonic_num=8): the fundamental and 8 overtones
SINE_AMP = 0.1
NOISE_STD = 0.003
VOICED_THRESHOLD = 10.0

KOKORO_MODULES = ("bert", "bert_encoder", "predictor", "text_encoder", "decoder")


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms while a Kokoro phase runs (or is
    captured): its transposed convolutions otherwise take a backward-data
    engine that accumulates with atomics, and two replays of one program
    differ by rounding (``PolyphaseConvTranspose1d`` keeps the generator's
    upsampling off that engine). Set around Kokoro's calls alone, so that
    the Stylish programs keep their kernels."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


# ---------------------------------------------------------------- masks


def length_mask(lengths: torch.Tensor, size: int, dtype: torch.dtype) -> tuple:
    """(mask (B, 1, size) in ``dtype``, 1 where a position is inside its
    row's length; the count (B, 1, 1))."""
    mask = (torch.arange(size, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)
    return mask[:, None, :], lengths.to(dtype)[:, None, None]


def reverse_index(lengths: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size): position t of a row of length n reads n - 1 - t inside
    the row and stays in place in its padding (an involution)."""
    t = torch.arange(size, device=lengths.device)[None, :]
    n = lengths[:, None]
    return torch.where(t < n, n - 1 - t, t)


# ---------------------------------------------------------------- blocks


class LengthLSTM(nn.Module):
    """A bidirectional LSTM over (B, T, C) whose reverse direction starts at
    each row's last valid step: two unidirectional ``nn.LSTM`` (cuDNN on
    the card), ``fwd`` over the bucket as it is and ``rev`` over each row's
    valid prefix reversed. Outputs (B, T, 2 H), [forward | reverse], as a
    bidirectional ``nn.LSTM`` lays them out; what lies in the padding is
    left for the caller to mask."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.fwd = nn.LSTM(input_size, hidden, batch_first=True)
        self.rev = nn.LSTM(input_size, hidden, batch_first=True)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        idx = reverse_index(lengths, x.shape[1])[:, :, None]
        xr = torch.gather(x, 1, idx.expand(-1, -1, x.shape[2]))
        hf, _ = self.fwd(x)
        hr, _ = self.rev(xr)
        hr = torch.gather(hr, 1, idx.expand(-1, -1, hr.shape[2]))
        return torch.cat([hf, hr], dim=-1)


class AdaIN1d(nn.Module):
    """kokoro's AdaIN1d: ``InstanceNorm1d(affine=True)`` (eps 1e-5), then
    ``(1 + gamma) * n + beta`` from the style; the statistics over the
    valid frames of ``m`` (mask, count)."""

    def __init__(self, style_dim: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.InstanceNorm1d(channels, affine=True, eps=eps)
        self.fc = nn.Linear(style_dim, 2 * channels)

    def forward(self, x: torch.Tensor, s: torch.Tensor, m: tuple) -> torch.Tensor:
        mask, count = m
        gamma, beta = self.fc(s)[:, :, None].chunk(2, dim=1)
        mean = (x * mask).sum(dim=2, keepdim=True) / count
        var = torch.square((x - mean) * mask).sum(dim=2, keepdim=True) / count
        n = (x - mean) * torch.rsqrt(var + self.norm.eps)
        n = n * self.norm.weight[:, None] + self.norm.bias[:, None]
        return (1 + gamma) * n + beta


class AdaLayerNorm(nn.Module):
    """kokoro's AdaLayerNorm over the last axis of (B, T, C), eps 1e-5."""

    def __init__(self, style_dim: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels, self.eps = channels, eps
        self.fc = nn.Linear(style_dim, 2 * channels)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.fc(s)[:, None, :].chunk(2, dim=2)
        x = F.layer_norm(x, (self.channels,), eps=self.eps)
        return (1 + gamma) * x + beta


class ChannelNorm(nn.Module):
    """kokoro's modules.LayerNorm: layer norm over the channels of
    (B, C, T), with ``gamma`` and ``beta``, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels, self.eps = channels, eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.transpose(1, -1), (self.channels,), self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)


class AdainResBlk1d(nn.Module):
    """kokoro's AdainResBlk1d(i, o, up): residual AdaIN, LeakyReLU 0.2, (up:
    a depthwise transposed conv, stride 2), conv3, AdaIN, LeakyReLU, conv3;
    shortcut nearest x2 (up) then a 1x1 conv without bias (i != o); the
    sum over sqrt(2). ``m_in`` and ``m_out``: (mask, count) at the input's
    and the output's rate."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int, upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.conv1 = nn.Conv1d(dim_in, dim_out, 3, 1, 1)
        self.conv2 = nn.Conv1d(dim_out, dim_out, 3, 1, 1)
        self.norm1 = AdaIN1d(style_dim, dim_in)
        self.norm2 = AdaIN1d(style_dim, dim_out)
        self.learned_sc = dim_in != dim_out
        if self.learned_sc:
            self.conv1x1 = nn.Conv1d(dim_in, dim_out, 1, 1, 0, bias=False)
        if upsample:
            self.pool = nn.ConvTranspose1d(dim_in, dim_in, 3, stride=2, groups=dim_in,
                                           padding=1, output_padding=1)

    def forward(self, x: torch.Tensor, s: torch.Tensor, m_in: tuple,
                m_out: tuple) -> torch.Tensor:
        r = F.leaky_relu(self.norm1(x, s, m_in), 0.2) * m_in[0]
        if self.upsample:
            r = self.pool(r) * m_out[0]
        r = self.conv1(r)
        r = F.leaky_relu(self.norm2(r, s, m_out), 0.2) * m_out[0]
        r = self.conv2(r)
        short = F.interpolate(x, scale_factor=2.0, mode="nearest") if self.upsample else x
        if self.learned_sc:
            short = self.conv1x1(short)
        return (r + short) * RSQRT2


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class AdaINResBlock1(nn.Module):
    """kokoro's AdaINResBlock1: three residual pairs of (AdaIN, snake with
    alpha, dilated conv, AdaIN, snake, conv)."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int],
                 style_dim: int):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, 1, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, 1, dilation=1,
                      padding=get_padding(kernel_size, 1)) for _ in dilation)
        self.adain1 = nn.ModuleList(AdaIN1d(style_dim, channels) for _ in dilation)
        self.adain2 = nn.ModuleList(AdaIN1d(style_dim, channels) for _ in dilation)
        self.alpha1 = nn.ParameterList(nn.Parameter(torch.ones(1, channels, 1))
                                       for _ in dilation)
        self.alpha2 = nn.ParameterList(nn.Parameter(torch.ones(1, channels, 1))
                                       for _ in dilation)

    def forward(self, x: torch.Tensor, s: torch.Tensor, m: tuple) -> torch.Tensor:
        for c1, c2, n1, n2, a1, a2 in zip(self.convs1, self.convs2, self.adain1,
                                          self.adain2, self.alpha1, self.alpha2):
            xt = n1(x, s, m)
            xt = xt + (1 / a1) * (torch.sin(a1 * xt) ** 2)
            xt = c1(xt * m[0])
            xt = n2(xt, s, m)
            xt = xt + (1 / a2) * (torch.sin(a2 * xt) ** 2)
            xt = c2(xt * m[0])
            x = xt + x
        return x


# ---------------------------------------------------------------- ALBERT


class AlbertEmbeddings(nn.Module):
    def __init__(self, vocab: int, size: int, positions: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, size)
        self.position_embeddings = nn.Embedding(positions, size)
        self.token_type_embeddings = nn.Embedding(2, size)
        self.LayerNorm = nn.LayerNorm(size, eps=1e-12)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = self.word_embeddings(ids) + self.token_type_embeddings(torch.zeros_like(ids))
        return self.LayerNorm(x + self.position_embeddings(pos))


class AlbertLayer(nn.Module):
    """The one ALBERT layer: self-attention (``heads`` of hidden/heads,
    padded keys masked), LayerNorm(x + attn), FFN with gelu_new (the tanh
    form), LayerNorm(h + ffn); eps 1e-12."""

    def __init__(self, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.dense = nn.Linear(hidden, hidden)
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-12)
        self.ffn = nn.Linear(hidden, intermediate)
        self.ffn_output = nn.Linear(intermediate, hidden)
        self.full_layer_layer_norm = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        d = c // self.heads

        def heads(y):
            return y.view(b, t, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d) + key_bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        ctx = ctx.transpose(1, 2).reshape(b, t, c)
        h = self.attention_norm(x + self.dense(ctx))
        ffn = self.ffn_output(F.gelu(self.ffn(h), approximate="tanh"))
        return self.full_layer_layer_norm(ffn + h)


class AlbertEncoder(nn.Module):
    def __init__(self, embedding: int, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.embedding_hidden_mapping_in = nn.Linear(embedding, hidden)
        self.layer = AlbertLayer(hidden, heads, intermediate)


class Albert(nn.Module):
    """ALBERT (``plbert``): the embeddings (word, position, token type 0),
    LayerNorm, a map to ``hidden_size``, then the one layer applied
    ``num_hidden_layers`` times. ``valid`` (B, L): 1 on the line's ids."""

    def __init__(self, cfg, vocab: int):
        super().__init__()
        self.passes = cfg.num_hidden_layers
        self.embeddings = AlbertEmbeddings(vocab, cfg.embedding_size,
                                           cfg.max_position_embeddings)
        self.encoder = AlbertEncoder(cfg.embedding_size, cfg.hidden_size,
                                     cfg.num_attention_heads, cfg.intermediate_size)

    def forward(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        x = self.encoder.embedding_hidden_mapping_in(self.embeddings(ids))
        key_bias = ((1.0 - valid) * torch.finfo(x.dtype).min)[:, None, None, :]
        for _ in range(self.passes):
            x = self.encoder.layer(x, key_bias)
        return x


# ---------------------------------------------------------------- predictor


class DurationEncoder(nn.Module):
    """Three times: BiLSTM (d_model + style -> d_model), AdaLayerNorm,
    concatenate the style, mask. (B, T, d_model) -> (B, T, d_model + style)."""

    def __init__(self, sty_dim: int, d_model: int, nlayers: int):
        super().__init__()
        blocks = []
        for _ in range(nlayers):
            blocks += [LengthLSTM(d_model + sty_dim, d_model // 2),
                       AdaLayerNorm(sty_dim, d_model)]
        self.lstms = nn.ModuleList(blocks)

    def forward(self, x, style, lengths, valid):
        s = style[:, None, :].expand(-1, x.shape[1], -1)
        keep = valid[:, :, None]
        x = torch.cat([x, s], dim=-1) * keep
        for block in self.lstms:
            if isinstance(block, AdaLayerNorm):
                x = torch.cat([block(x, style), s], dim=-1) * keep
            else:
                x = block(x, lengths)
        return x


class LinearNorm(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.linear_layer = nn.Linear(dim_in, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class ProsodyPredictor(nn.Module):
    def __init__(self, style_dim: int, d_hid: int, nlayers: int, max_dur: int):
        super().__init__()
        self.text_encoder = DurationEncoder(style_dim, d_hid, nlayers)
        self.lstm = LengthLSTM(d_hid + style_dim, d_hid // 2)
        self.duration_proj = LinearNorm(d_hid, max_dur)
        self.shared = LengthLSTM(d_hid + style_dim, d_hid // 2)
        half = d_hid // 2
        for name in ("F0", "N"):
            setattr(self, name, nn.ModuleList([
                AdainResBlk1d(d_hid, d_hid, style_dim),
                AdainResBlk1d(d_hid, half, style_dim, upsample=True),
                AdainResBlk1d(half, half, style_dim)]))
        self.F0_proj = nn.Conv1d(half, 1, 1, 1, 0)
        self.N_proj = nn.Conv1d(half, 1, 1, 1, 0)

    def f0_n(self, en: torch.Tensor, s: torch.Tensor, frames: torch.Tensor) -> tuple:
        """en (B, d_hid + style, F) -> the F0 and energy curves (B, 2F)."""
        x = self.shared(en.transpose(1, 2), frames).transpose(1, 2)
        m1 = length_mask(frames, x.shape[2], x.dtype)
        m2 = length_mask(2 * frames, 2 * x.shape[2], x.dtype)
        out = []
        for blocks, proj in ((self.F0, self.F0_proj), (self.N, self.N_proj)):
            y = x
            for block, (a, b) in zip(blocks, ((m1, m1), (m1, m2), (m2, m2))):
                y = block(y, s, a, b)
            out.append(proj(y)[:, 0])
        return tuple(out)


class TextEncoder(nn.Module):
    """Embedding, then ``depth`` times conv (kernel k), channel LayerNorm,
    LeakyReLU 0.2 and the mask, then a BiLSTM and the mask: (B, C, L)."""

    def __init__(self, channels: int, kernel_size: int, depth: int, n_symbols: int):
        super().__init__()
        self.embedding = nn.Embedding(n_symbols, channels)
        pad = (kernel_size - 1) // 2
        self.cnn = nn.ModuleList(nn.Sequential(
            nn.Conv1d(channels, channels, kernel_size, padding=pad), ChannelNorm(channels),
            nn.LeakyReLU(0.2)) for _ in range(depth))
        self.lstm = LengthLSTM(channels, channels // 2)

    def forward(self, ids, lengths, valid):
        m = valid[:, None, :]
        x = self.embedding(ids).transpose(1, 2) * m
        for c in self.cnn:
            x = c(x) * m
        return self.lstm(x.transpose(1, 2), lengths).transpose(1, 2) * m


# ---------------------------------------------------------------- generator


@functools.lru_cache(maxsize=8)
@torch.inference_mode(False)
def dft_bases(n_fft: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """The periodic Hann window w of scipy's ``get_window('hann', n_fft)``
    in float32 (kokoro's TorchSTFT), K = n_fft // 2 + 1 bins: (w cos
    (n_fft, K); w sin at n = 1 .. n_fft/2 - 1 (n_fft/2 - 1, K); the
    inverse (2K, 1, n_fft), torch.istft's irfft times w (bins 1..K-2
    doubled, the imaginary parts of DC and Nyquist ignored); w squared
    (1, 1, n_fft)). The sine rows of DC and Nyquist are exact zeros."""
    n = torch.arange(n_fft, dtype=torch.float64)
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float().double()
    angle = (2.0 * math.pi / n_fft) * torch.remainder(n[:, None] * k[None, :], n_fft)
    cos, sin = torch.cos(angle), torch.sin(angle)
    sin[:, 0] = 0.0
    sin[:, -1] = 0.0
    cos[:, -1] = torch.where(n.long() % 2 == 0, 1.0, -1.0).double()
    scale = torch.full((k.shape[0],), 2.0 / n_fft, dtype=torch.float64)
    scale[0] = scale[-1] = 1.0 / n_fft
    inv = torch.cat([(cos * scale).T * window, -(sin * scale).T * window])[:, None, :]
    half = n_fft // 2
    out = (cos * window[:, None], (sin * window[:, None])[1:half], inv,
           torch.square(window)[None, None])
    return tuple(t.to(device=device, dtype=dtype).contiguous() for t in out)


@functools.lru_cache(maxsize=32)
@torch.inference_mode(False)
def linear_upsample_table(size: int, scale: int, device: torch.device) -> tuple:
    """F.interpolate(mode="linear", scale_factor=scale)'s source index and
    weight per output sample of a ``size`` input (align_corners False):
    (lower index (size * scale,) long, its upper weight (size * scale,)
    float64)."""
    i = torch.arange(size * scale, dtype=torch.float64)
    real = torch.clamp((1.0 / scale) * (i + 0.5) - 0.5, min=0.0)
    lo = real.long()
    return lo.to(device), (real - lo).to(device)


def linear_upsample_to_length(y: torch.Tensor, lengths: torch.Tensor, scale: int) -> torch.Tensor:
    """y (B, T, C) linearly resampled by ``scale`` along T, as
    F.interpolate does on a row of ``lengths`` steps: the upper neighbour
    of the row's last step is that step itself, not the padding."""
    lo, lam = linear_upsample_table(y.shape[1], scale, y.device)
    lam = lam.to(y.dtype)[None, :, None]
    hi = torch.minimum(lo[None, :] + 1, (lengths - 1)[:, None])
    c = y.shape[2]
    y_lo = torch.gather(y, 1, lo[None, :, None].expand(y.shape[0], -1, c))
    y_hi = torch.gather(y, 1, hi[:, :, None].expand(-1, -1, c))
    return (1 - lam) * y_lo + lam * y_hi


class SourceModuleHnNSF(nn.Module):
    """The Hn-NSF source: harmonics 1..9 of the F0 curve, their phase
    integrated at F0-frame rate (kokoro's per-sample values resampled by
    1/upsample_scale read inside one frame's copies) and resampled back
    linearly, sines at 0.1 where voiced (F0 > 10 Hz), noise of std 0.003
    voiced and 0.1/3 unvoiced; ``l_linear`` merges them and tanh bounds
    them. Kokoro's initial-phase draw lands on sample 0, which the 1/scale
    resampling never reads, so it is left out."""

    def __init__(self, sampling_rate: int, upsample_scale: int):
        super().__init__()
        self.sampling_rate, self.upsample_scale = sampling_rate, upsample_scale
        self.l_linear = nn.Linear(HARMONICS, 1)

    def forward(self, f0: torch.Tensor, lengths: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """f0 (B, T) Hz at F0-frame rate, ``lengths`` valid F0 frames a
        row, ``noise`` (B, T * scale, 9) standard normal -> (B, T * scale)."""
        scale = self.upsample_scale
        harmonics = torch.arange(1, HARMONICS + 1, device=f0.device, dtype=f0.dtype)
        rad = (f0[:, :, None] * harmonics / self.sampling_rate) % 1
        phase = torch.cumsum(rad, dim=1) * 2 * math.pi
        sines = torch.sin(linear_upsample_to_length(phase * scale, lengths, scale)) * SINE_AMP
        f0_up = f0[:, :, None].expand(-1, -1, scale).reshape(f0.shape[0], -1, 1)
        uv = (f0_up > VOICED_THRESHOLD).to(f0.dtype)
        noise_amp = uv * NOISE_STD + (1 - uv) * SINE_AMP / 3
        return torch.tanh(self.l_linear(sines * uv + noise_amp * noise))[:, :, 0]


def stft_to_length(x: torch.Tensor, lengths: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """x (B, S) -> [magnitude; angle] (B, n_fft + 2, S / hop + 1), as
    torch.stft(center=True, reflect) and abs / angle give them for each
    row's first ``lengths`` samples: the reflection at the row's own end.
    The imaginary part is summed over pairs, -sum_n w[n] sin(2 pi k n / N)
    (x[n] - x[N - n]): exactly 0 on a frame that the reflection makes
    symmetric (the first), where an FFT's rounding would pick the angle
    +pi or -pi of a negative real part."""
    pad = n_fft // 2
    n = lengths[:, None]
    p = torch.arange(-pad, x.shape[1] + pad, device=x.device)[None, :].abs()
    p = torch.where(p >= n, 2 * (n - 1) - p, p).clamp(0, x.shape[1] - 1)
    w_cos, w_sin, _, _ = dft_bases(n_fft, x.dtype, x.device)
    frames = torch.gather(x, 1, p).unfold(1, n_fft, hop)
    re = torch.matmul(frames, w_cos)
    im = -torch.matmul(frames[..., 1:pad] - frames[..., pad + 1:].flip(-1), w_sin)
    return torch.cat([torch.hypot(re, im), torch.atan2(im + 0.0, re)], dim=-1).transpose(1, 2)


def istft_to_length(mag: torch.Tensor, phase: torch.Tensor, frames: torch.Tensor,
                    n_fft: int, hop: int) -> torch.Tensor:
    """torch.istft(mag * exp(i phase), center=True) of each row's first
    ``frames`` frames -> (B, hop * (T - 1)): the frames after a row's last
    add nothing, and the window envelope is that of the row's own frames."""
    _, _, inv, wsq = dft_bases(n_fft, mag.dtype, mag.device)
    valid, _ = length_mask(frames, mag.shape[2], mag.dtype)
    spec = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1) * valid
    y = F.conv_transpose1d(spec, inv, stride=hop)[:, 0]
    env = F.conv_transpose1d(valid, wsq, stride=hop)[:, 0]
    pad = n_fft // 2
    end = pad + hop * (mag.shape[2] - 1)
    return (y / env.clamp_min(1e-11))[:, pad:end]


class PolyphaseConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` (its parameters and its function) computed as
    one convolution and an interleave: with kernel K = m * stride, output
    phase r of input step q is sum_t W[:, :, r + stride t] x[q - t], so
    the stride phases are the output channels of an m-tap conv, shuffled
    into time, then the padding cut from both ends. The same products as
    the transposed conv, through cuDNN's forward convolutions, which are
    deterministic; its own engine accumulates with atomics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, k, p = self.stride[0], self.kernel_size[0], self.padding[0]
        m = k // s
        c_in, c_out = self.weight.shape[0], self.weight.shape[1]
        # (c_in, c_out, m, s) -> (c_out, s, c_in, m), taps reversed
        w = self.weight.view(c_in, c_out, m, s).flip(2).permute(1, 3, 0, 2)
        z = F.conv1d(F.pad(x, (m - 1, m - 1)), w.reshape(c_out * s, c_in, m),
                     self.bias.repeat_interleave(s))
        b, _, t = z.shape
        y = z.view(b, c_out, s, t).transpose(2, 3).reshape(b, c_out, t * s)
        return y[:, :, p:t * s - p]


class Generator(nn.Module):
    """kokoro's iSTFTNet generator."""

    def __init__(self, style_dim: int, cfg, sample_rate: int):
        super().__init__()
        self.n_fft, self.hop = cfg.gen_istft_n_fft, cfg.gen_istft_hop_size
        self.rates = list(cfg.upsample_rates)
        self.kernels = len(cfg.resblock_kernel_sizes)
        self.m_source = SourceModuleHnNSF(sample_rate, math.prod(self.rates) * self.hop)
        self.noise_convs = nn.ModuleList()
        self.noise_res = nn.ModuleList()
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        c0 = cfg.upsample_initial_channel
        for i, (u, k) in enumerate(zip(self.rates, cfg.upsample_kernel_sizes)):
            ch = c0 // 2 ** (i + 1)
            if k % u:
                raise ValueError(f"upsample kernel {k} is not a multiple of its rate {u}")
            self.ups.append(PolyphaseConvTranspose1d(c0 // 2 ** i, ch, k, u,
                                                     padding=(k - u) // 2))
            for kk, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(AdaINResBlock1(ch, kk, d, style_dim))
            if i + 1 < len(self.rates):
                stride = math.prod(self.rates[i + 1:])
                self.noise_convs.append(nn.Conv1d(self.n_fft + 2, ch, stride * 2, stride,
                                                  padding=(stride + 1) // 2))
                self.noise_res.append(AdaINResBlock1(ch, 7, [1, 3, 5], style_dim))
            else:
                self.noise_convs.append(nn.Conv1d(self.n_fft + 2, ch, 1))
                self.noise_res.append(AdaINResBlock1(ch, 11, [1, 3, 5], style_dim))
        self.conv_post = nn.Conv1d(ch, self.n_fft + 2, 7, 1, padding=3)

    def forward(self, x: torch.Tensor, s: torch.Tensor, f0: torch.Tensor,
                lengths: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x (B, C, T) and f0 (B, T) at F0-frame rate with ``lengths`` valid
        frames a row -> audio (B, T * prod(rates) * hop)."""
        scale = self.m_source.upsample_scale
        har = self.m_source(f0, lengths, noise)
        har_frames = lengths * (scale // self.hop) + 1
        mh, _ = length_mask(har_frames, har.shape[1] // self.hop + 1, x.dtype)
        har = stft_to_length(har, lengths * scale, self.n_fft, self.hop) * mh
        n = lengths
        for i, up in enumerate(self.ups):
            x = F.leaky_relu(x, 0.1) * length_mask(n, x.shape[2], x.dtype)[0]
            last = i == len(self.ups) - 1
            n = n * self.rates[i] + (1 if last else 0)
            x = up(x)
            if last:
                x = F.pad(x, (1, 0), mode="reflect")
            m = length_mask(n, x.shape[2], x.dtype)
            x = x + self.noise_res[i](self.noise_convs[i](har), s, m)
            blocks = self.resblocks[i * self.kernels:(i + 1) * self.kernels]
            xs = None
            for block in blocks:
                xs = block(x, s, m) if xs is None else xs + block(x, s, m)
            x = xs / self.kernels
        x = self.conv_post(F.leaky_relu(x, 0.01) * m[0])
        bins = self.n_fft // 2 + 1
        return istft_to_length(torch.exp(x[:, :bins]), torch.sin(x[:, bins:]), n,
                               self.n_fft, self.hop)


class Decoder(nn.Module):
    """kokoro's istftnet.Decoder: the F0 and energy curves down to frame
    rate (conv3, stride 2), ``encode``, four ``decode`` blocks (the last
    upsamples to F0-frame rate), the generator."""

    def __init__(self, cfg: KokoroConfig):
        super().__init__()
        dim_in, sty = cfg.hidden_dim, cfg.style_dim
        wide, res = cfg.decoder_dim, cfg.asr_res_dim
        cat = wide + 2 + res
        self.encode = AdainResBlk1d(dim_in + 2, wide, sty)
        self.decode = nn.ModuleList([
            AdainResBlk1d(cat, wide, sty), AdainResBlk1d(cat, wide, sty),
            AdainResBlk1d(cat, wide, sty),
            AdainResBlk1d(cat, cfg.istftnet.upsample_initial_channel, sty, upsample=True)])
        self.F0_conv = nn.Conv1d(1, 1, 3, 2, 1)
        self.N_conv = nn.Conv1d(1, 1, 3, 2, 1)
        self.asr_res = nn.Sequential(nn.Conv1d(dim_in, res, 1))
        self.generator = Generator(sty, cfg.istftnet, cfg.sample_rate)

    def forward(self, asr, f0_curve, n_curve, s, frames, noise):
        f0 = self.F0_conv(f0_curve[:, None])
        en = self.N_conv(n_curve[:, None])
        m1 = length_mask(frames, asr.shape[2], asr.dtype)
        m2 = length_mask(2 * frames, 2 * asr.shape[2], asr.dtype)
        x = self.encode(torch.cat([asr, f0, en], dim=1), s, m1, m1)
        asr_res = self.asr_res(asr)
        for block in self.decode:
            if not block.upsample:
                x = block(torch.cat([x, asr_res, f0, en], dim=1), s, m1, m1)
            else:
                x = block(torch.cat([x, asr_res, f0, en], dim=1), s, m1, m2)
        return self.generator(x, s, f0_curve, 2 * frames, noise)


# ---------------------------------------------------------------- the model


def build_kokoro_models(cfg: KokoroConfig) -> Dict[str, nn.Module]:
    """kokoro's KModel modules by its names."""
    return {
        "bert": Albert(cfg.plbert, cfg.n_token),
        "bert_encoder": nn.Linear(cfg.plbert.hidden_size, cfg.hidden_dim),
        "predictor": ProsodyPredictor(cfg.style_dim, cfg.hidden_dim, cfg.n_layer, cfg.max_dur),
        "text_encoder": TextEncoder(cfg.hidden_dim, cfg.text_encoder_kernel_size,
                                    cfg.n_layer, cfg.n_token),
        "decoder": Decoder(cfg),
    }


def text_valid(ids: torch.Tensor, lengths: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < lengths[:, None]).to(dtype)


def durations(models, ids: torch.Tensor, lengths: torch.Tensor, ref_s: torch.Tensor,
              speed: torch.Tensor) -> tuple:
    """ids (B, L) at the text bucket, ``lengths`` ids a row, the voice rows
    ref_s (B, 2 * style: the acoustic style, then the prosody style),
    ``speed`` a 0-d tensor -> (integer durations
    (B, L) as floats, 0 on the padding: round(sum of sigmoids / speed) at
    least 1; the duration encoder's output d (B, L, hidden + style))."""
    with deterministic_convs():
        return _durations(models, ids, lengths, ref_s, speed)


def _durations(models, ids, lengths, ref_s, speed):
    dtype = ref_s.dtype
    valid = text_valid(ids, lengths, dtype)
    bert = models["bert"](ids, valid)
    d_en = models["bert_encoder"](bert)
    predictor = models["predictor"]
    s = ref_s[:, ref_s.shape[1] // 2:]
    d = predictor.text_encoder(d_en, s, lengths, valid)
    x = predictor.lstm(d, lengths)
    dur = torch.sigmoid(predictor.duration_proj(x)).sum(dim=-1) / speed
    return torch.round(dur).clamp(min=1) * valid, d


def alignment(dur: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, L, frames): 1 where frame f belongs to token t (the integer
    durations laid end to end), 0 past a row's last frame."""
    ends = torch.cumsum(dur, dim=1)
    f = torch.arange(frames, device=dur.device, dtype=dur.dtype)
    return ((f >= (ends - dur)[:, :, None]) & (f < ends[:, :, None])).to(dur.dtype)


def acoustic(models, ids: torch.Tensor, lengths: torch.Tensor, dur: torch.Tensor,
             d: torch.Tensor, ref_s: torch.Tensor, frames: int,
             noise: torch.Tensor) -> torch.Tensor:
    """The durations and d of ``durations`` -> audio (B, frames * 600) at
    frame bucket ``frames``; ``noise`` (B, frames * 600, 9) the source's
    standard normal draws."""
    with deterministic_convs():
        return _acoustic(models, ids, lengths, dur, d, ref_s, frames, noise)


def _acoustic(models, ids, lengths, dur, d, ref_s, frames, noise):
    aln = alignment(dur, frames)
    n_frames = dur.sum(dim=1).long()
    predictor = models["predictor"]
    en = torch.matmul(d.transpose(1, 2), aln)
    f0, n = predictor.f0_n(en, ref_s[:, ref_s.shape[1] // 2:], n_frames)
    valid = text_valid(ids, lengths, ref_s.dtype)
    t_en = models["text_encoder"](ids, lengths, valid)
    asr = torch.matmul(t_en, aln)
    return models["decoder"](asr, f0, n, ref_s[:, :ref_s.shape[1] // 2], n_frames, noise)


def draw_noise(frames: int, samples_per_frame: int, seed: int, device) -> torch.Tensor:
    """(1, frames * samples_per_frame, 9) standard normal draws from a
    generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((1, frames * samples_per_frame, HARMONICS), generator=gen, device=device)
