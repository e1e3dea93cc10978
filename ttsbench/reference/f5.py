"""The plain reference of F5-TTS v1 Base (github.com/SWivid/F5-TTS:
``model/backbones/dit.py``, ``model/modules.py``, ``model/cfm.py``,
``infer/utils_infer.py``) with the Vocos vocoder (charactr/vocos-mel-24khz),
inference only, in plain PyTorch. Imports nothing of the program and
nothing of JAX.

F5-TTS's own forward of one chunk: unpadded at the chunk's T frames, batch
1, each guidance row its own forward (the conditioned row with the text and
the reference's mel, the unconditioned row with filler text and no mel),
attention written out (matmul, softmax, matmul), RoPE written out on the
even and odd channels, GRN's norm over the chunk's frames, the guided Euler
steps at the sway schedule's times, then Vocos and its iSTFT through
``torch.fft.irfft``. The modules' parameters carry the published names, as
the program's do, so that one state dict loads into both. Float32 with TF32
off unless the caller sets otherwise.

Inputs a run shares with the program: x_0 (``draw_noise``, from a seed on
the host), the times, the ids; the reference clip's log-mel is computed
here from the same clip (``log_mel``: ``torch.stft``'s magnitude, the HTK
filterbank, ``log(max(., 1e-5))``).
"""

from __future__ import annotations

import math
import re
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ttsbench.reference.stts.dsp.mel import mel_filterbank

INIT_STD = 0.02  # the layers F5-TTS zero-initialises, drawn from N(0, INIT_STD)
TARGET_RMS = 0.1  # a quieter reference clip is raised to it (``infer_process``)
MAX_FRAMES = 4096  # a chunk's frames at most (``CFM.sample``'s ``max_duration``)


def config(model: dict) -> SimpleNamespace:
    """The ``model`` dict of an F5 configuration as attributes."""

    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})

    return ns(model)


# ---------------------------------------------------------------- DiT


class GRN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x):  # (T, C)
        gx = torch.sqrt(torch.sum(x * x, dim=0, keepdim=True))
        nx = gx / (gx.mean() + 1e-6)
        return self.gamma[0] * (x * nx) + self.beta[0] + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, inner)
        self.grn = GRN(inner)
        self.pwconv2 = nn.Linear(inner, dim)

    def forward(self, x):  # (T, C)
        h = self.dwconv(x.T[None])[0].T
        h = F.gelu(self.pwconv1(self.norm(h)))
        return x + self.pwconv2(self.grn(h))


class TextEmbedding(nn.Module):
    def __init__(self, vocab, arch):
        super().__init__()
        self.text_embed = nn.Embedding(vocab + 1, arch.text_dim)
        self.text_blocks = nn.ModuleList(ConvNeXtV2Block(arch.text_dim,
                                                         arch.text_dim * arch.conv_mult)
                                         for _ in range(arch.conv_layers))
        self.text_dim = arch.text_dim

    def forward(self, ids, drop_text):
        """ids (T,) (id + 1, 0 the filler) -> (T, text_dim)."""
        filler = ids == 0
        if drop_text:
            ids = torch.zeros_like(ids)
        half = self.text_dim // 2
        freqs = 1.0 / (10000.0 ** (torch.arange(0, self.text_dim, 2, device=ids.device)[:half]
                                   .float() / self.text_dim))
        pos = torch.outer(torch.arange(ids.shape[0], device=ids.device).float(), freqs)
        x = self.text_embed(ids) + torch.cat([pos.cos(), pos.sin()], -1).to(
            self.text_embed.weight.dtype)
        x = x.masked_fill(filler[:, None], 0.0)
        for block in self.text_blocks:
            x = block(x).masked_fill(filler[:, None], 0.0)
        return x


class DiTBlock(nn.Module):
    def __init__(self, arch):
        super().__init__()
        inner = arch.heads * arch.dim_head
        self.heads = arch.heads
        self.attn_norm = nn.Module()
        self.attn_norm.linear = nn.Linear(arch.dim, 6 * arch.dim)
        self.attn = nn.Module()
        self.attn.to_q = nn.Linear(arch.dim, inner)
        self.attn.to_k = nn.Linear(arch.dim, inner)
        self.attn.to_v = nn.Linear(arch.dim, inner)
        self.attn.to_out = nn.ModuleList([nn.Linear(inner, arch.dim)])
        self.ff = nn.Module()
        self.ff.ff = nn.Sequential(nn.Sequential(nn.Linear(arch.dim, arch.dim * arch.ff_mult)),
                                   nn.Identity(), nn.Linear(arch.dim * arch.ff_mult, arch.dim))

    def attention(self, h, cos, sin):
        t = h.shape[0]

        def heads(y):
            return y.view(t, self.heads, -1).transpose(0, 1)  # (H, T, d)

        def rope(y):
            even, odd = y[..., 0::2], y[..., 1::2]
            return torch.stack((even * cos - odd * sin, odd * cos + even * sin),
                               dim=-1).flatten(-2)

        q = rope(heads(self.attn.to_q(h)))
        k = rope(heads(self.attn.to_k(h)))
        v = heads(self.attn.to_v(h))
        p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), dim=-1)
        return self.attn.to_out[0]((p @ v).transpose(0, 1).reshape(t, -1))

    def forward(self, x, emb, cos, sin):
        shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = \
            self.attn_norm.linear(F.silu(emb)).chunk(6)
        h = layer_norm(x) * (1 + scale_a) + shift_a
        x = x + gate_a * self.attention(h, cos, sin)
        h = layer_norm(x) * (1 + scale_f) + shift_f
        ff = self.ff.ff
        return x + gate_f * ff[2](F.gelu(ff[0][0](h), approximate="tanh"))


def layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class DiT(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        arch, mels = cfg.arch, cfg.mel_spec.n_mel_channels
        self.arch = arch
        self.time_embed = nn.Module()
        self.time_embed.time_mlp = nn.Sequential(nn.Linear(arch.freq_embed_dim, arch.dim),
                                                 nn.SiLU(), nn.Linear(arch.dim, arch.dim))
        self.text_embed = TextEmbedding(cfg.vocab_size, arch)
        self.input_embed = nn.Module()
        self.input_embed.proj = nn.Linear(2 * mels + arch.text_dim, arch.dim)
        self.input_embed.conv_pos_embed = nn.Module()
        k, g = arch.pos_kernel, arch.pos_groups
        self.input_embed.conv_pos_embed.conv1d = nn.Sequential(
            nn.Conv1d(arch.dim, arch.dim, k, groups=g, padding=k // 2), nn.Mish(),
            nn.Conv1d(arch.dim, arch.dim, k, groups=g, padding=k // 2), nn.Mish())
        self.transformer_blocks = nn.ModuleList(DiTBlock(arch) for _ in range(arch.depth))
        self.norm_out = nn.Module()
        self.norm_out.linear = nn.Linear(arch.dim, 2 * arch.dim)
        self.proj_out = nn.Linear(arch.dim, mels)

    def time(self, t: float, device):
        half = self.arch.freq_embed_dim // 2
        freq = torch.exp(torch.arange(half, device=device).float() * -(math.log(10000) / (half - 1)))
        emb = 1000.0 * torch.tensor(t, device=device, dtype=torch.float32) * freq
        emb = torch.cat((emb.sin(), emb.cos()))
        return self.time_embed.time_mlp(emb.to(self.proj_out.weight.dtype))

    def row(self, x, cond, text, t: float):
        """One guidance row at its own T frames: x, cond (T, mels), text (T,
        text_dim) -> the velocity (T, mels)."""
        emb = self.time(t, x.device)
        h = self.input_embed.proj(torch.cat((x, cond, text), dim=-1))
        h = h + self.input_embed.conv_pos_embed.conv1d(h.T[None])[0].T
        dh = self.arch.dim_head
        inv = 1.0 / (10000.0 ** (torch.arange(0, dh, 2, device=x.device).float() / dh))
        angles = torch.arange(x.shape[0], device=x.device).float()[:, None] * inv[None]
        cos, sin = angles.cos().to(h.dtype), angles.sin().to(h.dtype)
        for block in self.transformer_blocks:
            h = block(h, emb, cos, sin)
        scale, shift = self.norm_out.linear(F.silu(emb)).chunk(2)
        return self.proj_out(layer_norm(h) * (1 + scale) + shift)


# ---------------------------------------------------------------- Vocos


class VocosBlock(nn.Module):
    def __init__(self, dim, inner, layer_scale):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, inner)
        self.pwconv2 = nn.Linear(inner, dim)
        self.gamma = nn.Parameter(layer_scale * torch.ones(dim))

    def forward(self, x):  # (T, C)
        h = self.dwconv(x.T[None])[0].T
        return x + self.gamma * self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))


class Vocos(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.backbone = nn.Module()
        self.backbone.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7, padding=3)
        self.backbone.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.backbone.convnext = nn.ModuleList(
            VocosBlock(cfg.dim, cfg.intermediate_dim, 1.0 / cfg.num_layers)
            for _ in range(cfg.num_layers))
        self.backbone.final_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.head = nn.Module()
        self.head.out = nn.Linear(cfg.dim, cfg.n_fft + 2)

    def features(self, mel):
        """mel (T, mels) -> the head's output (T, n_fft + 2)."""
        b = self.backbone
        x = b.norm(b.embed(mel.T[None])[0].T)
        for block in b.convnext:
            x = block(x)
        return self.head.out(b.final_layer_norm(x))

    def forward(self, mel):
        """mel (T, mels) -> audio (T * hop): Vocos's ISTFT head with "same"
        padding, through ``torch.fft.irfft``."""
        y = self.features(mel).T
        bins = self.cfg.n_fft // 2 + 1
        mag = torch.clamp(torch.exp(y[:bins]), max=1e2)
        p = y[bins:]
        spec = torch.complex(mag * torch.cos(p), mag * torch.sin(p))
        n_fft, hop = self.cfg.n_fft, self.cfg.hop_length
        window = torch.hann_window(n_fft, device=mel.device, dtype=mag.dtype)
        frames = torch.fft.irfft(spec, n_fft, dim=0) * window[:, None]  # (n_fft, T)
        count = frames.shape[1]
        size = (count - 1) * hop + n_fft
        out = torch.zeros(size, device=mel.device, dtype=frames.dtype)
        env = torch.zeros(size, device=mel.device, dtype=frames.dtype)
        for j in range(count):
            out[j * hop:j * hop + n_fft] += frames[:, j]
            env[j * hop:j * hop + n_fft] += window * window
        pad = (n_fft - hop) // 2
        return out[pad:-pad] / env[pad:-pad]


# ---------------------------------------------------------------- the model


def build(cfg) -> dict:
    return {"dit": DiT(cfg), "vocos": Vocos(cfg.vocos)}


def zero_initialised(dit: DiT) -> list:
    """The parameters F5-TTS zero-initialises: every block's modulation, the
    output norm's modulation and projection, and the text blocks' GRN."""
    out = [dit.norm_out.linear.weight, dit.norm_out.linear.bias, dit.proj_out.weight,
           dit.proj_out.bias]
    for block in dit.transformer_blocks:
        out += [block.attn_norm.linear.weight, block.attn_norm.linear.bias]
    for block in dit.text_embed.text_blocks:
        out += [block.grn.gamma, block.grn.beta]
    return out


def make_models(model: dict, device, seed: int) -> dict:
    """The modules from ``seed`` on ``device``: PyTorch's default
    initialisation, with the parameters F5-TTS zero-initialises (which with
    random weights would make every velocity 0) drawn from N(0, 0.02)."""
    cfg = config(model)
    with torch.device(device):
        torch.manual_seed(seed)
        models = build(cfg)
        with torch.no_grad():
            for p in zero_initialised(models["dit"]):
                p.normal_(0.0, INIT_STD)
    return {k: m.eval() for k, m in models.items()}


def make_weights(model: dict, device, seed: int) -> dict:
    return {k: m.state_dict() for k, m in make_models(model, device, seed).items()}


# ---------------------------------------------------------------- inference


def sway_times(nfe: int, coef: float) -> list:
    return [k / nfe + coef * (math.cos(math.pi / 2 * (k / nfe)) - 1 + k / nfe)
            for k in range(nfe + 1)]


def draw_noise(frames: int, mels: int, seed: int) -> torch.Tensor:
    return torch.randn((frames, mels), generator=torch.Generator().manual_seed(seed))


def chunk_frames(audio_frames, ref_bytes, gen_bytes, text_len, speed, max_frames) -> int:
    local_speed = 0.3 if gen_bytes < 10 else speed
    total = audio_frames + int(audio_frames / ref_bytes * gen_bytes / local_speed)
    return min(max(total, text_len + 1, audio_frames + 2), max_frames)


def chunk_text(text: str, max_chars: int) -> list:
    """F5-TTS's ``chunk_text``, as ``infer/utils_infer.py`` has it."""
    chunks = []
    current_chunk = ""
    sentences = re.split(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])", text)
    for sentence in sentences:
        if len(current_chunk.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current_chunk += (sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1
                              else sentence)
        else:
            if current_chunk:
                chunks.append(current_chunk.strip())
            current_chunk = (sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1
                             else sentence)
    if current_chunk:
        chunks.append(current_chunk.strip())
    return chunks


def log_mel(audio: torch.Tensor, mel) -> torch.Tensor:
    """audio (n,) -> (n // hop + 1, mels): the magnitude mel, centred and
    reflected, through the HTK filterbank, ``log(max(., 1e-5))``."""
    spec = torch.stft(audio, mel.n_fft, mel.hop_length, mel.win_length,
                      window=torch.hann_window(mel.win_length, device=audio.device,
                                               dtype=audio.dtype),
                      center=True, pad_mode="reflect", return_complex=True).abs()
    fb = torch.as_tensor(mel_filterbank(mel.n_mel_channels, mel.n_fft,
                                        mel.target_sample_rate), device=audio.device,
                         dtype=audio.dtype)
    return torch.log(torch.clamp(fb.T @ spec, min=1e-5)).T


def raise_rms(audio: np.ndarray, target: float) -> np.ndarray:
    rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64))))
    return audio * np.float32(target / rms) if 0 < rms < target else audio


class Chunk(SimpleNamespace):
    """One chunk's inputs: ``ids`` (the transcript's and the generated
    text's, id + 1), ``cond`` (the reference's log-mel), ``noise`` (x_0 at
    the chunk's frames), ``audio_frames`` (the reference clip's samples //
    hop)."""


def make_chunk(model: dict, ref_audio: np.ndarray, ref_ids, ref_bytes: int, gen_ids,
               gen_bytes: int, seed: int, device, dtype=torch.float32, speed: float = 1.0):
    cfg = config(model)
    hop = cfg.mel_spec.hop_length
    audio = raise_rms(np.asarray(ref_audio, np.float32), TARGET_RMS)
    ids = np.concatenate([np.asarray(ref_ids), np.asarray(gen_ids)]).astype(np.int64)
    audio_frames = audio.shape[0] // hop
    total = chunk_frames(audio_frames, ref_bytes, gen_bytes, ids.shape[0], speed,
                         MAX_FRAMES)
    text = torch.zeros(total, dtype=torch.long)
    n = min(ids.shape[0], total)
    text[:n] = torch.as_tensor(ids[:n]) + 1
    cond = log_mel(torch.as_tensor(audio, device=device, dtype=torch.float32), cfg.mel_spec)
    return Chunk(ids=text.to(device), cond=cond.to(dtype),
                 noise=draw_noise(total, cfg.mel_spec.n_mel_channels, seed).to(device, dtype),
                 audio_frames=audio_frames)


def guided_velocity(dit: DiT, x, cond, text_c, text_u, t: float, cfg_strength: float):
    """v_c + cfg_strength (v_c - v_u): each row its own forward."""
    v_c = dit.row(x, cond, text_c, t)
    v_u = dit.row(x, torch.zeros_like(cond), text_u, t)
    return v_c + cfg_strength * (v_c - v_u)


def sample(models: dict, model: dict, chunk: Chunk) -> dict:
    """F5-TTS's guided Euler sampler over one chunk at its own frames ->
    ``mel`` (T, mels), the reference's on its frames and the last state
    after them, and ``velocity``, the first step's guided velocity."""
    cfg = config(model)
    dit = models["dit"]
    s = cfg.sampler
    times = sway_times(s.nfe_step, s.sway_sampling_coef)
    ref = min(chunk.cond.shape[0], chunk.noise.shape[0])
    step_cond = torch.zeros_like(chunk.noise)
    step_cond[:ref] = chunk.cond[:ref]
    text_c = dit.text_embed(chunk.ids, drop_text=False)
    text_u = dit.text_embed(chunk.ids, drop_text=True)
    x, first = chunk.noise, None
    for k in range(len(times) - 1):
        v = guided_velocity(dit, x, step_cond, text_c, text_u, times[k], s.cfg_strength)
        first = v if first is None else first
        x = x + (times[k + 1] - times[k]) * v
    out = x.clone()
    out[:ref] = chunk.cond[:ref]
    return {"mel": out, "velocity": first}


def speak_chunk(models: dict, model: dict, chunk: Chunk) -> dict:
    """The chunk's ``mel``, ``velocity`` and ``audio``: Vocos over the
    generated frames (those after the reference clip's samples // hop, as
    ``infer_batch_process`` cuts them), float32."""
    out = sample(models, model, chunk)
    mel = out["mel"][chunk.audio_frames:].float()
    out["audio"] = models["vocos"].float()(mel)
    return out


# ---------------------------------------------------------------- FLOPs


def attention_flops(model: dict, frames: int) -> float:
    """The attention's products of one chunk at its real frames: q k^T and
    p v, 4 T^2 dim_head per head, in every block, both guidance rows and
    every step."""
    a = config(model).arch
    return 4.0 * frames * frames * a.dim_head * a.heads * a.depth * 2 * \
        config(model).sampler.nfe_step


class ChunkFlops:
    """Matrix-product and convolution FLOPs of one chunk at its real frames
    (no bucket), counted on the ``meta`` device over the reference: both
    rows' text embedding, 2 x nfe row forwards, Vocos's backbone and head
    over the generated frames (the iSTFT's FFT is not counted)."""

    def __init__(self, model: dict):
        self.model = model
        self.cfg = config(model)
        with torch.device("meta"):
            self.models = {k: m.eval() for k, m in build(self.cfg).items()}
        self.cache = {}

    def __call__(self, frames: int, generated: int) -> float:
        key = (frames, generated)
        if key not in self.cache:
            from ttsbench.flops import count_flops

            mels = self.cfg.mel_spec.n_mel_channels
            dit, vocos = self.models["dit"], self.models["vocos"]
            ids = torch.zeros(frames, dtype=torch.long, device="meta")
            x = torch.zeros((frames, mels), device="meta")
            text = torch.zeros((frames, self.cfg.arch.text_dim), device="meta")
            gen = torch.zeros((generated, mels), device="meta")

            def text_work():
                with torch.no_grad():
                    dit.text_embed(ids, drop_text=False)

            def row_work():
                with torch.no_grad():
                    dit.row(x, x, text, 0.5)

            def vocos_work():
                with torch.no_grad():
                    vocos.features(gen)

            self.cache[key] = (2 * count_flops(text_work)
                               + 2 * self.cfg.sampler.nfe_step * count_flops(row_work)
                               + count_flops(vocos_work))
        return self.cache[key]
