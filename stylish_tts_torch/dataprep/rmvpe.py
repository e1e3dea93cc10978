"""RMVPE neural pitch estimator.

The port's ``stylish_tts_tpu/dataprep/rmvpe.py``: the E2E0 network (a
deep U-net of residual conv blocks over the log-mel, a conv head, a BiGRU
and a sigmoid salience over 360 bins of 20 cents), its log-mel front end
and the local weighted-average decode. The JAX package writes the network
as functions over a converted tree (BatchNorm folded, the transposed conv
as an input-dilated conv, the GRU as two ``lax.scan``); the port builds it
from ``nn.Module``s with the reference's state_dict names
(``unet.encoder.bn``, ``unet.encoder.layers.{i}.conv.{j}.conv.{0,1,3,4}``,
``unet.decoder.layers.{i}.conv1.{0,1}``, ``cnn``, ``fc.0.gru``, ``fc.1``),
so a reference ``rmvpe.safetensors`` loads with ``load_state_dict`` as it
is, and the JAX ``convert_rmvpe_torch`` reads the port's ``state_dict()``.
The network runs in eval mode (BatchNorm on its running statistics) and is
never trained. The weights are a local file: nothing is downloaded.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.mel import mel_filterbank
from ..dsp.stft import stft
from ..models.slm import resample_24k_to_16k
from ..utils.device import resolve_device

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30.0
MEL_FMAX = SAMPLE_RATE / 2
WINDOW_LENGTH = 1024
CONST = 1997.3794084376191
EN_DE_LAYERS = 5
INTER_LAYERS = 4
N_BLOCKS = 4
EN_OUT = 16
BN_MOMENTUM = 0.01


class ConvBlockRes(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1, bias=False),
            nn.BatchNorm2d(cout, momentum=BN_MOMENTUM),
            nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1, bias=False),
            nn.BatchNorm2d(cout, momentum=BN_MOMENTUM),
            nn.ReLU(),
        )
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.shortcut(x) if hasattr(self, "shortcut") else x
        return self.conv(x) + skip


class ResEncoderBlock(nn.Module):
    """``N_BLOCKS`` residual blocks; with ``pool``, returns (x, avg-pooled x)."""

    def __init__(self, cin: int, cout: int, pool: bool):
        super().__init__()
        self.conv = nn.ModuleList(
            ConvBlockRes(cin if j == 0 else cout, cout) for j in range(N_BLOCKS))
        self.pool = nn.AvgPool2d(2) if pool else None

    def forward(self, x: torch.Tensor):
        for block in self.conv:
            x = block(x)
        return x if self.pool is None else (x, self.pool(x))


class ResDecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1,
                               bias=False),
            nn.BatchNorm2d(cout, momentum=BN_MOMENTUM),
            nn.ReLU(),
        )
        self.conv2 = nn.ModuleList(
            ConvBlockRes(2 * cout if j == 0 else cout, cout) for j in range(N_BLOCKS))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.conv1(x), skip], dim=1)
        for block in self.conv2:
            x = block(x)
        return x


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.bn = nn.BatchNorm2d(1, momentum=BN_MOMENTUM)
        chans = [1] + [EN_OUT * 2**i for i in range(EN_DE_LAYERS)]
        self.layers = nn.ModuleList(
            ResEncoderBlock(chans[i], chans[i + 1], pool=True) for i in range(EN_DE_LAYERS))


class Intermediate(nn.Module):
    def __init__(self):
        super().__init__()
        top = EN_OUT * 2**EN_DE_LAYERS  # 512
        self.layers = nn.ModuleList(
            ResEncoderBlock(top // 2 if i == 0 else top, top, pool=False)
            for i in range(INTER_LAYERS))


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        top = EN_OUT * 2**EN_DE_LAYERS
        self.layers = nn.ModuleList(
            ResDecoderBlock(top >> i, top >> (i + 1)) for i in range(EN_DE_LAYERS))


class DeepUnet(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.intermediate = Intermediate()
        self.decoder = Decoder()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder.bn(x)
        skips = []
        for layer in self.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.intermediate.layers:
            x = layer(x)
        for i, layer in enumerate(self.decoder.layers):
            x = layer(x, skips[-1 - i])
        return x


class BiGRU(nn.Module):
    def __init__(self, features: int, hidden: int):
        super().__init__()
        self.gru = nn.GRU(features, hidden, batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gru(x)[0]


class E2E0(nn.Module):
    """log-mel (B, N_MELS, T) -> salience (B, T, N_CLASS); T a multiple of 32."""

    def __init__(self):
        super().__init__()
        self.unet = DeepUnet()
        self.cnn = nn.Conv2d(EN_OUT, 3, 3, padding=1)
        self.fc = nn.Sequential(BiGRU(3 * N_MELS, 256), nn.Linear(512, N_CLASS),
                                nn.Dropout(0.25), nn.Sigmoid())

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.unet(mel.transpose(-1, -2)[:, None])  # (B, 16, T, M)
        x = self.cnn(x).transpose(1, 2).flatten(-2)  # (B, T, 3 * M), channel-major
        return self.fc(x)


@functools.lru_cache(maxsize=1)
def _mel_basis() -> np.ndarray:
    """(N_MELS, freq): the HTK mel filterbank with Slaney area normalisation
    (2 / (f_hi - f_lo) per filter), as ``librosa.filters.mel(htk=True)``."""
    fb = mel_filterbank(N_MELS, WINDOW_LENGTH, SAMPLE_RATE, f_min=MEL_FMIN,
                        f_max=MEL_FMAX)

    def h2m(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def m2h(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    pts = m2h(np.linspace(h2m(MEL_FMIN), h2m(MEL_FMAX), N_MELS + 2))
    enorm = 2.0 / (pts[2:] - pts[:-2])
    return (fb * enorm[None, :]).T.astype(np.float32)


def rmvpe_log_mel(audio16k: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, S) 16 kHz audio -> log-mel (B, N_MELS, T): the reflect-centred
    STFT at n_fft = win = 1024, its magnitude (+1e-18 under the root), the
    mel matmul and the log clamped at 1e-5."""
    real, imag = stft(audio16k, WINDOW_LENGTH, hop_length, WINDOW_LENGTH,
                      center=True, pad_mode="reflect")
    mag = torch.sqrt(real * real + imag * imag + 1e-18)
    basis = torch.from_numpy(_mel_basis()).to(mag.device)
    mel = torch.einsum("mf,bft->bmt", basis, mag)
    return torch.log(torch.clamp(mel, min=1e-5))


def decode_f0(salience: torch.Tensor, thred: float = 0.03) -> torch.Tensor:
    """(B, T, N_CLASS) -> F0 Hz (B, T): the salience-weighted mean of the
    cents of the 9 bins around the peak; 0 where the peak is under
    ``thred``."""
    idx = torch.arange(N_CLASS, device=salience.device)[None, None, :]
    cents_map = idx * 20.0 + CONST
    center = torch.argmax(salience, dim=2, keepdim=True)
    mask = (idx >= torch.clamp(center - 4, min=0)) & (idx < torch.clamp(center + 5,
                                                                        max=N_CLASS))
    weights = salience * mask
    product = torch.sum(weights * cents_map, dim=2)
    total = torch.sum(weights, dim=2)
    cents = product / (total + (total == 0))
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    unvoiced = torch.amax(salience, dim=2) < thred
    return torch.where(unvoiced, torch.zeros_like(f0), f0)


def load_rmvpe(weights_path: str, device="cuda") -> E2E0:
    """E2E0 from a safetensors file in the reference layout, in eval mode,
    on ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
    from safetensors.torch import load_file

    device = resolve_device(device)
    model = E2E0()
    model.load_state_dict(load_file(weights_path))
    return model.to(device).eval().requires_grad_(False)


class RMVPEPitchExtractor:
    """24 kHz (or 16 kHz) audio -> per-frame F0 at the framework's frame rate:
    the 16 kHz hop is ``16000 // (sample_rate // hop_length)``."""

    def __init__(self, weights_path: str, sample_rate: int = 24000,
                 hop_length: int = 300, device="cuda"):
        self.device = resolve_device(device)
        self.model = load_rmvpe(weights_path, self.device)
        self.sample_rate = sample_rate
        self.hop16 = SAMPLE_RATE // (sample_rate // hop_length)

    def salience(self, audio: np.ndarray) -> torch.Tensor:
        """(B, S) audio -> salience (B, frames, N_CLASS) on the device, the
        log-mel reflect-padded to a multiple of 32 frames for the U-net."""
        x = torch.as_tensor(np.asarray(audio), dtype=torch.float32, device=self.device)
        with torch.no_grad(), torch.autocast(self.device.type, enabled=False):
            if self.sample_rate != SAMPLE_RATE:
                if self.sample_rate != 24000:
                    raise ValueError(f"RMVPE resamples 24 kHz only, not {self.sample_rate}")
                x = resample_24k_to_16k(x)
            mel = rmvpe_log_mel(x, self.hop16)
            n_frames = mel.shape[-1]
            pad = 32 * ((n_frames - 1) // 32 + 1) - n_frames
            mel = F.pad(mel, (0, pad), mode="reflect")
            return self.model(mel)[:, :n_frames]

    def infer(self, audio: np.ndarray) -> np.ndarray:
        """(B, S) audio at ``sample_rate`` -> (B, frames) F0 Hz."""
        with torch.no_grad():
            return decode_f0(self.salience(audio)).cpu().numpy()


def random_rmvpe_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded weights in the reference layout: the default init, and each
    BatchNorm's affine and running statistics drawn away from 0 and 1, so
    that a layout or folding fault shows. Structural only: not a pitch
    estimator."""
    torch.manual_seed(seed)
    model = E2E0()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return model.state_dict()
