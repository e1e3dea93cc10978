"""The plain reference of Kokoro-82M (hexgrad/Kokoro-82M: the ``kokoro``
package's ``model.py``, ``modules.py`` and ``istftnet.py``), inference
only, in plain PyTorch. Imports nothing of the program and nothing of JAX.

Two ways to run a line, on the same modules (their parameters named as
the program's, so that one state dict loads into both):

* ``forward_unpadded``: Kokoro's own forward, one line of ids at batch 1
  and its own length: the LSTM cell written out step by step (gates i, f,
  g, o in PyTorch's layout), ``F.instance_norm``, ``F.interpolate`` for the
  source's resampling, ``torch.stft`` and ``torch.istft``. Weight norm is
  folded (plain conv weights); dropout is off.
* ``durations_bucket`` and ``acoustic_bucket``: the same equations at a
  text bucket and a frame bucket, padding-exact (valid-frame instance
  norms, zeros before every conv that reaches the line's end, the reverse
  LSTM from the line's last step, the resampling and the STFT reflection
  at the line's own end), with the same ``nn.LSTM``, conv and DFT-basis
  operations as the program's bucket programs and cuDNN's deterministic
  algorithms, so that a sound program reads bitwise equal to it.

The source's noise is an explicit input: (samples, 9) standard normal
draws, of which the unpadded forward reads the first 600 f rows.
``float32`` with TF32 off unless the caller sets otherwise.
"""

from __future__ import annotations

import contextlib
import functools
import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

HARMONICS = 9
SINE_AMP = 0.1
NOISE_STD = 0.003
VOICED_THRESHOLD = 10.0
SOURCE_SEED = 0


def config(model: dict) -> SimpleNamespace:
    """The configuration file's ``model`` as attributes (nested groups
    too)."""
    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) and k != "vocab" else v
                                  for k, v in d.items()})
    return ns(model)


def frame_samples(cfg) -> int:
    ist = cfg.istftnet
    return 2 * math.prod(ist.upsample_rates) * ist.gen_istft_hop_size


# ---------------------------------------------------------------- masks


def length_mask(lengths, size, dtype):
    mask = (torch.arange(size, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)
    return mask[:, None, :], lengths.to(dtype)[:, None, None]


def reverse_index(lengths, size):
    t = torch.arange(size, device=lengths.device)[None, :]
    n = lengths[:, None]
    return torch.where(t < n, n - 1 - t, t)


# ---------------------------------------------------------------- LSTM


def lstm_cell_run(x: torch.Tensor, lstm: nn.LSTM) -> torch.Tensor:
    """x (T, C) -> h (T, H): one direction of an LSTM, step by step:
    g = W_ih x_t + b_ih + W_hh h + b_hh; i, f, g, o = g's four quarters;
    c = sigmoid(f) c + sigmoid(i) tanh(g); h = sigmoid(o) tanh(c). On the
    ``meta`` device (FLOP counting) the T recurrent products are one
    product of the same FLOPs."""
    w_ih, w_hh = lstm.weight_ih_l0, lstm.weight_hh_l0
    b = lstm.bias_ih_l0 + lstm.bias_hh_l0
    hidden = w_hh.shape[1]
    gx = x @ w_ih.T + b
    if x.device.type == "meta":
        return (torch.zeros(x.shape[0], hidden, device="meta", dtype=x.dtype) @ w_hh.T)[:, :hidden]
    h = torch.zeros(hidden, dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    out = []
    for t in range(x.shape[0]):
        gates = gx[t] + w_hh @ h
        i, f, g, o = gates.chunk(4)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


class BiLSTM(nn.Module):
    """A bidirectional LSTM as two unidirectional ``nn.LSTM`` (``fwd``,
    ``rev``; the program's layout of the weights)."""

    def __init__(self, input_size, hidden):
        super().__init__()
        self.fwd = nn.LSTM(input_size, hidden, batch_first=True)
        self.rev = nn.LSTM(input_size, hidden, batch_first=True)

    def unpadded(self, x):
        """(T, C) -> (T, 2H), the cell written out."""
        hf = lstm_cell_run(x, self.fwd)
        hr = lstm_cell_run(x.flip(0), self.rev).flip(0)
        return torch.cat([hf, hr], dim=-1)

    def bucket(self, x, lengths):
        idx = reverse_index(lengths, x.shape[1])[:, :, None]
        xr = torch.gather(x, 1, idx.expand(-1, -1, x.shape[2]))
        hf, _ = self.fwd(x)
        hr, _ = self.rev(xr)
        hr = torch.gather(hr, 1, idx.expand(-1, -1, hr.shape[2]))
        return torch.cat([hf, hr], dim=-1)


# ---------------------------------------------------------------- blocks


class AdaIN1d(nn.Module):
    def __init__(self, style_dim, channels):
        super().__init__()
        self.norm = nn.InstanceNorm1d(channels, affine=True)
        self.fc = nn.Linear(style_dim, 2 * channels)

    def forward(self, x, s, m=None):
        gamma, beta = self.fc(s)[:, :, None].chunk(2, dim=1)
        if m is None:
            n = F.instance_norm(x, weight=self.norm.weight, bias=self.norm.bias,
                                eps=self.norm.eps)
        else:
            mask, count = m
            mean = (x * mask).sum(dim=2, keepdim=True) / count
            var = torch.square((x - mean) * mask).sum(dim=2, keepdim=True) / count
            n = (x - mean) * torch.rsqrt(var + self.norm.eps)
            n = n * self.norm.weight[:, None] + self.norm.bias[:, None]
        return (1 + gamma) * n + beta


class AdaLayerNorm(nn.Module):
    def __init__(self, style_dim, channels):
        super().__init__()
        self.channels = channels
        self.fc = nn.Linear(style_dim, 2 * channels)

    def forward(self, x, s):
        gamma, beta = self.fc(s)[:, None, :].chunk(2, dim=2)
        return (1 + gamma) * F.layer_norm(x, (self.channels,), eps=1e-5) + beta


class ChannelNorm(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.channels = channels
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x.transpose(1, -1), (self.channels,), self.gamma, self.beta,
                            1e-5).transpose(1, -1)


class AdainResBlk1d(nn.Module):
    def __init__(self, dim_in, dim_out, style_dim, upsample=False):
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

    def forward(self, x, s, m_in=None, m_out=None):
        if m_in is None:
            r = F.leaky_relu(self.norm1(x, s), 0.2)
            if self.upsample:
                r = self.pool(r)
            r = self.conv2(F.leaky_relu(self.norm2(self.conv1(r), s), 0.2))
            short = F.interpolate(x, scale_factor=2, mode="nearest") if self.upsample else x
            if self.learned_sc:
                short = self.conv1x1(short)
            return (r + short) * torch.rsqrt(torch.tensor(2))
        r = F.leaky_relu(self.norm1(x, s, m_in), 0.2) * m_in[0]
        if self.upsample:
            r = self.pool(r) * m_out[0]
        r = self.conv1(r)
        r = F.leaky_relu(self.norm2(r, s, m_out), 0.2) * m_out[0]
        r = self.conv2(r)
        short = F.interpolate(x, scale_factor=2.0, mode="nearest") if self.upsample else x
        if self.learned_sc:
            short = self.conv1x1(short)
        return (r + short) * float(torch.rsqrt(torch.tensor(2.0)))


def get_padding(k, d=1):
    return (k * d - d) // 2


class AdaINResBlock1(nn.Module):
    def __init__(self, channels, kernel_size, dilation, style_dim):
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

    def forward(self, x, s, m=None):
        keep = 1 if m is None else m[0]
        for c1, c2, n1, n2, a1, a2 in zip(self.convs1, self.convs2, self.adain1,
                                          self.adain2, self.alpha1, self.alpha2):
            xt = n1(x, s, m)
            xt = xt + (1 / a1) * (torch.sin(a1 * xt) ** 2)
            xt = c1(xt if m is None else xt * keep)
            xt = n2(xt, s, m)
            xt = xt + (1 / a2) * (torch.sin(a2 * xt) ** 2)
            xt = c2(xt if m is None else xt * keep)
            x = xt + x
        return x


# ---------------------------------------------------------------- ALBERT


class AlbertEmbeddings(nn.Module):
    def __init__(self, vocab, size, positions):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, size)
        self.position_embeddings = nn.Embedding(positions, size)
        self.token_type_embeddings = nn.Embedding(2, size)
        self.LayerNorm = nn.LayerNorm(size, eps=1e-12)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = self.word_embeddings(ids) + self.token_type_embeddings(torch.zeros_like(ids))
        return self.LayerNorm(x + self.position_embeddings(pos))


class AlbertLayer(nn.Module):
    def __init__(self, hidden, heads, intermediate):
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

    def forward(self, x, key_bias=None, gelu_tanh_form=False):
        b, t, c = x.shape
        d = c // self.heads

        def heads(y):
            return y.view(b, t, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        if key_bias is not None:
            scores = scores + key_bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, c)
        h = self.attention_norm(x + self.dense(ctx))
        y = self.ffn(h)
        if gelu_tanh_form:
            y = F.gelu(y, approximate="tanh")
        else:  # transformers' gelu_new
            y = 0.5 * y * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                            * (y + 0.044715 * torch.pow(y, 3.0))))
        return self.full_layer_layer_norm(self.ffn_output(y) + h)


class AlbertEncoder(nn.Module):
    def __init__(self, embedding, hidden, heads, intermediate):
        super().__init__()
        self.embedding_hidden_mapping_in = nn.Linear(embedding, hidden)
        self.layer = AlbertLayer(hidden, heads, intermediate)


class Albert(nn.Module):
    def __init__(self, cfg, vocab):
        super().__init__()
        self.passes = cfg.num_hidden_layers
        self.embeddings = AlbertEmbeddings(vocab, cfg.embedding_size,
                                           cfg.max_position_embeddings)
        self.encoder = AlbertEncoder(cfg.embedding_size, cfg.hidden_size,
                                     cfg.num_attention_heads, cfg.intermediate_size)

    def forward(self, ids, valid=None):
        x = self.encoder.embedding_hidden_mapping_in(self.embeddings(ids))
        bias = None
        if valid is not None:
            bias = ((1.0 - valid) * torch.finfo(x.dtype).min)[:, None, None, :]
        for _ in range(self.passes):
            x = self.encoder.layer(x, bias, gelu_tanh_form=valid is not None)
        return x


# ---------------------------------------------------------------- predictor


class DurationEncoder(nn.Module):
    def __init__(self, sty_dim, d_model, nlayers):
        super().__init__()
        blocks = []
        for _ in range(nlayers):
            blocks += [BiLSTM(d_model + sty_dim, d_model // 2), AdaLayerNorm(sty_dim, d_model)]
        self.lstms = nn.ModuleList(blocks)

    def forward(self, x, style, lengths=None, valid=None):
        s = style[:, None, :].expand(-1, x.shape[1], -1)
        keep = 1 if valid is None else valid[:, :, None]
        x = torch.cat([x, s], dim=-1) * keep
        for block in self.lstms:
            if isinstance(block, AdaLayerNorm):
                x = torch.cat([block(x, style), s], dim=-1) * keep
            elif valid is None:
                x = block.unpadded(x[0])[None]
            else:
                x = block.bucket(x, lengths)
        return x


class LinearNorm(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.linear_layer = nn.Linear(dim_in, dim_out)

    def forward(self, x):
        return self.linear_layer(x)


class ProsodyPredictor(nn.Module):
    def __init__(self, style_dim, d_hid, nlayers, max_dur):
        super().__init__()
        self.text_encoder = DurationEncoder(style_dim, d_hid, nlayers)
        self.lstm = BiLSTM(d_hid + style_dim, d_hid // 2)
        self.duration_proj = LinearNorm(d_hid, max_dur)
        self.shared = BiLSTM(d_hid + style_dim, d_hid // 2)
        half = d_hid // 2
        for name in ("F0", "N"):
            setattr(self, name, nn.ModuleList([
                AdainResBlk1d(d_hid, d_hid, style_dim),
                AdainResBlk1d(d_hid, half, style_dim, upsample=True),
                AdainResBlk1d(half, half, style_dim)]))
        self.F0_proj = nn.Conv1d(half, 1, 1, 1, 0)
        self.N_proj = nn.Conv1d(half, 1, 1, 1, 0)

    def f0_n(self, en, s, frames=None):
        if frames is None:
            x = self.shared.unpadded(en[0].T).T[None]
            masks = ((None, None),) * 3
        else:
            x = self.shared.bucket(en.transpose(1, 2), frames).transpose(1, 2)
            m1 = length_mask(frames, x.shape[2], x.dtype)
            m2 = length_mask(2 * frames, 2 * x.shape[2], x.dtype)
            masks = ((m1, m1), (m1, m2), (m2, m2))
        out = []
        for blocks, proj in ((self.F0, self.F0_proj), (self.N, self.N_proj)):
            y = x
            for block, (a, b) in zip(blocks, masks):
                y = block(y, s, a, b)
            out.append(proj(y)[:, 0])
        return tuple(out)


class TextEncoder(nn.Module):
    def __init__(self, channels, kernel_size, depth, n_symbols):
        super().__init__()
        self.embedding = nn.Embedding(n_symbols, channels)
        pad = (kernel_size - 1) // 2
        self.cnn = nn.ModuleList(nn.Sequential(
            nn.Conv1d(channels, channels, kernel_size, padding=pad), ChannelNorm(channels),
            nn.LeakyReLU(0.2)) for _ in range(depth))
        self.lstm = BiLSTM(channels, channels // 2)

    def forward(self, ids, lengths=None, valid=None):
        x = self.embedding(ids).transpose(1, 2)
        if valid is None:
            for c in self.cnn:
                x = c(x)
            return self.lstm.unpadded(x[0].T).T[None]
        m = valid[:, None, :]
        x = x * m
        for c in self.cnn:
            x = c(x) * m
        return self.lstm.bucket(x.transpose(1, 2), lengths).transpose(1, 2) * m


# ---------------------------------------------------------------- generator


def hann(n_fft, dtype, device):
    """scipy's get_window('hann', n_fft) in float32 (kokoro's TorchSTFT)."""
    n = torch.arange(n_fft, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float().to(device, dtype)


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
def linear_upsample_table(size, scale, device):
    i = torch.arange(size * scale, dtype=torch.float64)
    real = torch.clamp((1.0 / scale) * (i + 0.5) - 0.5, min=0.0)
    lo = real.long()
    return lo.to(device), (real - lo).to(device)


def linear_upsample_to_length(y, lengths, scale):
    lo, lam = linear_upsample_table(y.shape[1], scale, y.device)
    lam = lam.to(y.dtype)[None, :, None]
    hi = torch.minimum(lo[None, :] + 1, (lengths - 1)[:, None])
    c = y.shape[2]
    y_lo = torch.gather(y, 1, lo[None, :, None].expand(y.shape[0], -1, c))
    y_hi = torch.gather(y, 1, hi[:, :, None].expand(-1, -1, c))
    return (1 - lam) * y_lo + lam * y_hi


class SourceModuleHnNSF(nn.Module):
    def __init__(self, sampling_rate, upsample_scale):
        super().__init__()
        self.sampling_rate, self.upsample_scale = sampling_rate, upsample_scale
        self.l_linear = nn.Linear(HARMONICS, 1)

    def unpadded(self, f0, noise):
        """kokoro's SineGen on f0 (1, T) at F0-frame rate, upsampled by
        nearest, then merged. The initial-phase draw of the overtones lands
        on sample 0, which the 1/scale resampling never reads: left out."""
        scale = self.upsample_scale
        f0 = F.interpolate(f0[:, None], scale_factor=scale).transpose(1, 2)  # (1, S, 1)
        harmonics = torch.tensor([[list(range(1, HARMONICS + 1))]], dtype=f0.dtype,
                                 device=f0.device)
        rad = (f0 * harmonics / self.sampling_rate) % 1
        rad = F.interpolate(rad.transpose(1, 2), scale_factor=1 / scale,
                            mode="linear").transpose(1, 2)
        phase = torch.cumsum(rad, dim=1) * 2 * torch.pi
        phase = F.interpolate(phase.transpose(1, 2) * scale, scale_factor=scale,
                              mode="linear").transpose(1, 2)
        sines = torch.sin(phase) * SINE_AMP
        uv = (f0 > VOICED_THRESHOLD).to(f0.dtype)
        noise_amp = uv * NOISE_STD + (1 - uv) * SINE_AMP / 3
        return torch.tanh(self.l_linear(sines * uv + noise_amp * noise))[:, :, 0]

    def bucket(self, f0, lengths, noise):
        scale = self.upsample_scale
        harmonics = torch.arange(1, HARMONICS + 1, device=f0.device, dtype=f0.dtype)
        rad = (f0[:, :, None] * harmonics / self.sampling_rate) % 1
        phase = torch.cumsum(rad, dim=1) * 2 * math.pi
        sines = torch.sin(linear_upsample_to_length(phase * scale, lengths, scale)) * SINE_AMP
        f0_up = f0[:, :, None].expand(-1, -1, scale).reshape(f0.shape[0], -1, 1)
        uv = (f0_up > VOICED_THRESHOLD).to(f0.dtype)
        noise_amp = uv * NOISE_STD + (1 - uv) * SINE_AMP / 3
        return torch.tanh(self.l_linear(sines * uv + noise_amp * noise))[:, :, 0]


def stft(x, lengths, n_fft, hop):
    """[|X|; angle X] (B, n_fft + 2, S / hop + 1) of each row's first
    ``lengths`` samples, centred with reflection at both of the row's ends
    (torch.stft(center=True, pad_mode="reflect") on the row alone), Hann
    window; the imaginary part summed over pairs (x[n] - x[N - n]), so
    that it is exactly 0 on the frame that the reflection makes symmetric
    (the first), where an FFT's rounding picks +pi or -pi."""
    pad = n_fft // 2
    n = lengths[:, None]
    p = torch.arange(-pad, x.shape[1] + pad, device=x.device)[None, :].abs()
    p = torch.where(p >= n, 2 * (n - 1) - p, p).clamp(0, x.shape[1] - 1)
    w_cos, w_sin, _, _ = dft_bases(n_fft, x.dtype, x.device)
    frames = torch.gather(x, 1, p).unfold(1, n_fft, hop)
    re = torch.matmul(frames, w_cos)
    im = -torch.matmul(frames[..., 1:pad] - frames[..., pad + 1:].flip(-1), w_sin)
    return torch.cat([torch.hypot(re, im), torch.atan2(im + 0.0, re)], dim=-1).transpose(1, 2)


def istft_bucket(mag, phase, frames, n_fft, hop):
    _, _, inv, wsq = dft_bases(n_fft, mag.dtype, mag.device)
    valid, _ = length_mask(frames, mag.shape[2], mag.dtype)
    spec = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1) * valid
    y = F.conv_transpose1d(spec, inv, stride=hop)[:, 0]
    env = F.conv_transpose1d(valid, wsq, stride=hop)[:, 0]
    pad = n_fft // 2
    return (y / env.clamp_min(1e-11))[:, pad:pad + hop * (mag.shape[2] - 1)]


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
    def __init__(self, style_dim, cfg, sample_rate):
        super().__init__()
        self.n_fft, self.hop = cfg.gen_istft_n_fft, cfg.gen_istft_hop_size
        self.rates = list(cfg.upsample_rates)
        self.kernels = len(cfg.resblock_kernel_sizes)
        self.m_source = SourceModuleHnNSF(sample_rate, math.prod(self.rates) * self.hop)
        self.noise_convs, self.noise_res = nn.ModuleList(), nn.ModuleList()
        self.ups, self.resblocks = nn.ModuleList(), nn.ModuleList()
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

    def unpadded(self, x, s, f0, noise):
        """kokoro's Generator.forward at batch 1 and the line's length."""
        har = self.m_source.unpadded(f0, noise)
        lengths = torch.tensor([har.shape[1]], device=har.device)
        har = stft(har, lengths, self.n_fft, self.hop)
        for i, up in enumerate(self.ups):
            x = F.leaky_relu(x, negative_slope=0.1)
            x_source = self.noise_res[i](self.noise_convs[i](har), s)
            x = nn.ConvTranspose1d.forward(up, x)
            if i == len(self.ups) - 1:
                x = F.pad(x, (1, 0), mode="reflect")
            x = x + x_source
            xs = None
            for j in range(self.kernels):
                y = self.resblocks[i * self.kernels + j](x, s)
                xs = y if xs is None else xs + y
            x = xs / self.kernels
        x = self.conv_post(F.leaky_relu(x))
        bins = self.n_fft // 2 + 1
        if x.device.type == "meta":  # FLOP counting: the iSTFT's FFT is no product
            return x.new_empty((1, self.hop * (x.shape[2] - 1)))
        spec = torch.exp(x[:, :bins]) * torch.exp(torch.sin(x[:, bins:]) * 1j)
        window = hann(self.n_fft, x.dtype, x.device)
        return torch.istft(spec, self.n_fft, self.hop, self.n_fft, window=window)

    def bucket(self, x, s, f0, lengths, noise):
        scale = self.m_source.upsample_scale
        har = self.m_source.bucket(f0, lengths, noise)
        mh, _ = length_mask(lengths * (scale // self.hop) + 1, har.shape[1] // self.hop + 1,
                            x.dtype)
        har = stft(har, lengths * scale, self.n_fft, self.hop) * mh
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
        return istft_bucket(torch.exp(x[:, :bins]), torch.sin(x[:, bins:]), n,
                            self.n_fft, self.hop)


class Decoder(nn.Module):
    def __init__(self, cfg):
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

    def forward(self, asr, f0_curve, n_curve, s, noise, frames=None):
        f0 = self.F0_conv(f0_curve[:, None])
        en = self.N_conv(n_curve[:, None])
        if frames is None:
            m1 = m2 = None
        else:
            m1 = length_mask(frames, asr.shape[2], asr.dtype)
            m2 = length_mask(2 * frames, 2 * asr.shape[2], asr.dtype)
        x = self.encode(torch.cat([asr, f0, en], dim=1), s, m1, m1)
        asr_res = self.asr_res(asr)
        for block in self.decode:
            x = block(torch.cat([x, asr_res, f0, en], dim=1), s, m1,
                      m2 if block.upsample else m1)
        if frames is None:
            return self.generator.unpadded(x, s, f0_curve, noise)
        return self.generator.bucket(x, s, f0_curve, 2 * frames, noise)


# ---------------------------------------------------------------- the model


def build(cfg) -> dict:
    return {
        "bert": Albert(cfg.plbert, cfg.n_token),
        "bert_encoder": nn.Linear(cfg.plbert.hidden_size, cfg.hidden_dim),
        "predictor": ProsodyPredictor(cfg.style_dim, cfg.hidden_dim, cfg.n_layer, cfg.max_dur),
        "text_encoder": TextEncoder(cfg.hidden_dim, cfg.text_encoder_kernel_size,
                                    cfg.n_layer, cfg.n_token),
        "decoder": Decoder(cfg),
    }


def duration_bias(frames_per_token: float, max_dur: int) -> float:
    """The bias at which ``max_dur`` sigmoids sum to ``frames_per_token``."""
    p = frames_per_token / max_dur
    return math.log(p / (1.0 - p))


def make_models(model: dict, device, seed: int, f0_bias_hz: float,
                duration_head: dict) -> dict:
    """The modules from ``seed`` on ``device`` (the constructors' own
    initialisation), with ``F0_proj``'s bias at ``f0_bias_hz`` and the
    duration head's projection scaled by ``duration_head['weight_scale']``,
    its bias set so that every token speaks
    ``duration_head['frames_per_token']`` frames."""
    cfg = config(model)
    with torch.device(device):
        torch.manual_seed(seed)
        models = build(cfg)
    with torch.no_grad():
        pred = models["predictor"]
        pred.F0_proj.bias.fill_(f0_bias_hz)
        proj = pred.duration_proj.linear_layer
        proj.weight.mul_(duration_head["weight_scale"])
        proj.bias.fill_(duration_bias(duration_head["frames_per_token"], cfg.max_dur))
    return {k: m.eval() for k, m in models.items()}


def make_weights(model: dict, device, seed: int, f0_bias_hz: float, duration_head: dict):
    return {k: m.state_dict() for k, m in
            make_models(model, device, seed, f0_bias_hz, duration_head).items()}


def make_voicepacks(count: int, seed: int, rows: int = 510, width: int = 256) -> np.ndarray:
    """(count, rows, width) seeded voicepacks; a line of n phonemes speaks
    with row n - 1."""
    rng = np.random.default_rng([seed, 21])
    return (0.5 * rng.standard_normal((count, rows, width))).astype(np.float32)


def voice_style(pack: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Kokoro's ``ref_s = pack[len(phonemes) - 1]``, for ``ids`` with their
    two 0 pads around the phonemes."""
    return pack[ids.shape[0] - 3]


def source_noise(batch: int, frames: int, samples_per_frame: int, device,
                 dtype=torch.float32) -> torch.Tensor:
    """(batch, frames * samples_per_frame, 9) standard normal draws, each row
    from a generator seeded ``SOURCE_SEED``."""
    rows = [torch.randn((frames * samples_per_frame, HARMONICS),
                        generator=torch.Generator(device=device).manual_seed(SOURCE_SEED),
                        device=device, dtype=dtype) for _ in range(batch)]
    return torch.stack(rows)


# ---------------------------------------------------------------- forwards


def durations_unpadded(models, ids, ref_s, speed=1.0):
    """ids (n,) with their two 0 pads, ref_s (256,) -> (durations (n,),
    d (n, hidden + style))."""
    ids, ref_s = ids[None], ref_s[None]
    s = ref_s[:, ref_s.shape[1] // 2:]
    d_en = models["bert_encoder"](models["bert"](ids))
    pred = models["predictor"]
    d = pred.text_encoder(d_en, s)
    x = pred.lstm.unpadded(d[0])[None]
    dur = torch.sigmoid(pred.duration_proj(x)).sum(dim=-1) / speed
    return torch.round(dur).clamp(min=1)[0], d[0]


def acoustic_unpadded(models, ids, dur, d, ref_s, noise, frames=None):
    """kokoro's forward_with_tokens after the durations, at the line's own
    frame count (``frames``: given where the durations are not readable,
    as on the ``meta`` device) -> audio (600 f,)."""
    frames = int(dur.sum()) if frames is None else frames
    idx = torch.repeat_interleave(torch.arange(ids.shape[0], device=ids.device),
                                  dur.long(), output_size=frames)
    aln = torch.zeros((ids.shape[0], frames), device=ids.device, dtype=ref_s.dtype)
    aln[idx, torch.arange(frames, device=ids.device)] = 1
    ref_s = ref_s[None]
    s = ref_s[:, ref_s.shape[1] // 2:]
    en = d.T[None] @ aln[None]
    f0, n = models["predictor"].f0_n(en, s)
    t_en = models["text_encoder"](ids[None])
    asr = t_en @ aln[None]
    samples = frames * 2 * models["decoder"].generator.m_source.upsample_scale
    audio = models["decoder"](asr, f0, n, ref_s[:, :ref_s.shape[1] // 2], noise[None, :samples])
    return audio[0]


def forward_unpadded(models, ids, ref_s, noise, speed=1.0):
    """Kokoro's forward of one line -> (durations (n,), audio (600 f,))."""
    dur, d = durations_unpadded(models, ids, ref_s, speed)
    return dur, acoustic_unpadded(models, ids, dur, d, ref_s, noise)


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms (the bucket programs' own: the
    transposed convolutions' default engine accumulates with atomics)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


@deterministic_convs()
def durations_bucket(models, texts, lengths, ref_s, speed):
    dtype = ref_s.dtype
    valid = (torch.arange(texts.shape[1], device=texts.device)[None, :]
             < lengths[:, None]).to(dtype)
    d_en = models["bert_encoder"](models["bert"](texts, valid))
    pred = models["predictor"]
    d = pred.text_encoder(d_en, ref_s[:, ref_s.shape[1] // 2:], lengths, valid)
    x = pred.lstm.bucket(d, lengths)
    dur = torch.sigmoid(pred.duration_proj(x)).sum(dim=-1) / speed
    return torch.round(dur).clamp(min=1) * valid, d


@deterministic_convs()
def acoustic_bucket(models, texts, lengths, dur, d, ref_s, frames, noise):
    ends = torch.cumsum(dur, dim=1)
    f = torch.arange(frames, device=dur.device, dtype=dur.dtype)
    aln = ((f >= (ends - dur)[:, :, None]) & (f < ends[:, :, None])).to(dur.dtype)
    n_frames = dur.sum(dim=1).long()
    pred = models["predictor"]
    en = torch.matmul(d.transpose(1, 2), aln)
    f0, n = pred.f0_n(en, ref_s[:, ref_s.shape[1] // 2:], n_frames)
    valid = (torch.arange(texts.shape[1], device=texts.device)[None, :]
             < lengths[:, None]).to(ref_s.dtype)
    asr = torch.matmul(models["text_encoder"](texts, lengths, valid), aln)
    return models["decoder"](asr, f0, n, ref_s[:, :ref_s.shape[1] // 2], noise, n_frames)


class LineFlops:
    """Matrix-product and convolution FLOPs of one Kokoro line at its real
    id count and frame count (no bucket), counted on the ``meta`` device
    over the unpadded forward (an LSTM's T recurrent products counted as
    one product of the same FLOPs)."""

    def __init__(self, model: dict):
        self.cfg = config(model)
        with torch.device("meta"):
            self.models = {k: m.eval() for k, m in build(self.cfg).items()}
        self.cache = {}

    def __call__(self, n_ids: int, frames: int) -> float:
        key = (n_ids, frames)
        if key not in self.cache:
            from ttsbench.flops import count_flops

            ids = torch.zeros((n_ids,), dtype=torch.long, device="meta")
            ref_s = torch.zeros((2 * self.cfg.style_dim,), device="meta")
            dur = torch.zeros((n_ids,), device="meta")
            noise = torch.zeros((frames * frame_samples(self.cfg), HARMONICS), device="meta")

            def work():
                with torch.no_grad():
                    _, d = durations_unpadded(self.models, ids, ref_s)
                    acoustic_unpadded(self.models, ids, dur, d, ref_s, noise, frames)

            self.cache[key] = count_flops(work)
        return self.cache[key]
