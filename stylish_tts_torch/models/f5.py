"""F5-TTS v1 Base (github.com/SWivid/F5-TTS, arXiv:2410.06885) and the
Vocos vocoder (charactr/vocos-mel-24khz, arXiv:2306.00814), for synthesis.

The modules follow ``model/backbones/dit.py`` and ``model/modules.py``
(``TextEmbedding`` with its ConvNeXt V2 blocks, ``InputEmbedding`` with its
convolutional position embedding, ``TimestepEmbedding``, ``DiTBlock`` with
AdaLN-zero modulation and rotary attention, ``AdaLayerNorm_Final``) and
Vocos's ``VocosBackbone`` and ``ISTFTHead``; their parameters carry the
published state dicts' names. ``sample`` is ``model/cfm.py``'s guided Euler
sampler as one function of fixed shapes, and ``vocode`` the vocoder's.

**Buckets.** A chunk runs at a frame bucket F larger than its own T frames.
Every operation that mixes frames sees only the chunk's own: the attention
masks the padding keys, the position convolutions and the text blocks'
depthwise convolutions read zeros there, GRN's norm over time sums the
chunk's frames only, and Vocos's convolutions and iSTFT envelope stop at
the generated frames' end. So a bucketed chunk equals F5-TTS's own batch-1
forward at T frames, which has no mask (``ttsbench/reference/f5.py``).

**Precision.** The DiT runs in the dtype of its parameters (float16 on a
card, as F5-TTS casts it there); the sampler's state, its guided update and
the output mel stay float32 (or the DiT's dtype where wider), and Vocos
runs in float32. RoPE's angles are
computed in float32 and rounded once to the DiT's dtype.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import F5ArchConfig, F5Config, VocosConfig
from ..dsp.stft import istft

F5_MODULES = ("dit", "vocos")


# ---------------------------------------------------------------- tables


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0) -> torch.Tensor:
    """The text embedding's sinusoid table (end, dim): ``[cos | sin]``."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2)[: dim // 2].float() / dim))
    t = torch.arange(end, device=freqs.device)
    freqs = torch.outer(t, freqs).float()
    return torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def rope_tables(length: int, dim_head: int, device, dtype) -> tuple:
    """x-transformers' ``RotaryEmbedding(dim_head)`` at positions 0..length-1:
    (cos, sin), each (length, dim_head), every frequency repeated for its
    pair of adjacent channels; angles in float32, rounded to ``dtype``."""
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, dim_head, 2, device=device).float()
                                  / dim_head))
    angles = torch.arange(length, device=device).float()[:, None] * inv_freq[None, :]
    angles = angles.repeat_interleave(2, dim=-1)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotation of adjacent channel pairs (x-transformers' ``rotate_half``)."""
    pairs = x.unflatten(-1, (-1, 2))
    rotated = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return x * cos + rotated * sin


# ---------------------------------------------------------------- text


class GRN(nn.Module):
    """ConvNeXt V2's GRN over (B, T, C): the L2 norm over time (of the
    frames in ``mask``, (B, T, 1) bool, where given) over its mean across
    channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        seen = x if mask is None else x.masked_fill(~mask, 0.0)
        gx = torch.norm(seen, p=2, dim=1, keepdim=True)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = F.gelu(self.pwconv1(self.norm(h)))
        return x + self.pwconv2(self.grn(h, mask))


class TextEmbedding(nn.Module):
    """Ids (id + 1; 0 is the filler) -> (B, T, text_dim): the embedding, the
    sinusoid table, filler positions zeroed, the ConvNeXt V2 blocks with
    the filler zeroed after each (v1's ``text_mask_padding``)."""

    def __init__(self, vocab_size: int, arch: F5ArchConfig):
        super().__init__()
        self.text_embed = nn.Embedding(vocab_size + 1, arch.text_dim)
        self.register_buffer("freqs_cis", precompute_freqs_cis(arch.text_dim,
                                                               arch.text_max_pos),
                             persistent=False)
        self.text_blocks = nn.ModuleList(
            ConvNeXtV2Block(arch.text_dim, arch.text_dim * arch.conv_mult)
            for _ in range(arch.conv_layers))

    def forward(self, ids: torch.Tensor, filler: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """``filler`` (B, T) bool: the positions to zero (the text's filler,
        as its ids were before any drop); ``mask`` (B, T, 1): the chunk's
        frames, for GRN."""
        x = self.text_embed(ids) + self.freqs_cis[: ids.shape[1]].to(self.text_embed.weight.dtype)
        keep = filler[:, :, None]
        x = x.masked_fill(keep, 0.0)
        for block in self.text_blocks:
            x = block(x, mask).masked_fill(keep, 0.0)
        return x

    def conditioning(self, ids: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """(2, T, text_dim): the conditioned row's text and the unconditioned
        row's, whose ids are all filler and whose zeroed positions are the
        text's own filler (F5-TTS takes the mask before the drop)."""
        filler = (ids == 0).expand(2, -1)
        both = torch.cat([ids, torch.zeros_like(ids)])
        return self.forward(both, filler, None if mask is None else mask.expand(2, -1, -1))


# ---------------------------------------------------------------- input, time


class ConvPositionEmbedding(nn.Module):
    def __init__(self, dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.conv1d = nn.Sequential(
            nn.Conv1d(dim, dim, kernel_size, groups=groups, padding=kernel_size // 2),
            nn.Mish(),
            nn.Conv1d(dim, dim, kernel_size, groups=groups, padding=kernel_size // 2),
            nn.Mish(),
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, T, D); ``mask`` (B, T, 1): each convolution reads zeros
        outside the chunk's frames."""
        if mask is None:
            return self.conv1d(x.transpose(1, 2)).transpose(1, 2)
        cmask = mask.transpose(1, 2)
        y = x.masked_fill(~mask, 0.0).transpose(1, 2)
        y = F.mish(self.conv1d[0](y)).masked_fill(~cmask, 0.0)
        y = F.mish(self.conv1d[2](y)).transpose(1, 2)
        return y.masked_fill(~mask, 0.0)


class InputEmbedding(nn.Module):
    def __init__(self, mel_dim: int, arch: F5ArchConfig):
        super().__init__()
        self.proj = nn.Linear(mel_dim * 2 + arch.text_dim, arch.dim)
        self.conv_pos_embed = ConvPositionEmbedding(arch.dim, arch.pos_kernel, arch.pos_groups)

    def forward(self, x, cond, text, mask=None):
        h = self.proj(torch.cat((x, cond, text), dim=-1))
        return self.conv_pos_embed(h, mask) + h


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.time_mlp = nn.Sequential(nn.Linear(freq_embed_dim, dim), nn.SiLU(),
                                      nn.Linear(dim, dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t (B,) float32 -> (B, dim): the sinusoid (scale 1000, ``[sin |
        cos]``) in float32, then the MLP in its weights' dtype."""
        half = self.freq_embed_dim // 2
        freq = torch.exp(torch.arange(half, device=t.device).float()
                         * -(math.log(10000) / (half - 1)))
        emb = 1000.0 * t.float()[:, None] * freq[None, :]
        emb = torch.cat((emb.sin(), emb.cos()), dim=-1)
        return self.time_mlp(emb.to(self.time_mlp[0].weight.dtype))


# ---------------------------------------------------------------- blocks


class AdaLayerNorm(nn.Module):
    def __init__(self, dim: int, chunks: int):
        super().__init__()
        self.linear = nn.Linear(dim, dim * chunks)

    def forward(self, emb: torch.Tensor) -> tuple:
        return self.linear(F.silu(emb))[:, None, :].chunk(self.linear.out_features
                                                          // self.linear.in_features, dim=-1)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, rope, key_mask=None):
        """x (B, T, D); rope (cos, sin) on every head; ``key_mask`` (B, 1,
        1, T) bool: the keys a query may attend to."""
        b, t, _ = x.shape

        def heads(y):
            return y.view(b, t, self.heads, -1).transpose(1, 2)

        q = apply_rope(heads(self.to_q(x)), *rope)
        k = apply_rope(heads(self.to_k(x)), *rope)
        o = F.scaled_dot_product_attention(q, k, heads(self.to_v(x)), attn_mask=key_mask)
        return self.to_out[0](o.transpose(1, 2).reshape(b, t, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        inner = dim * mult
        self.ff = nn.Sequential(nn.Sequential(nn.Linear(dim, inner), nn.GELU(approximate="tanh")),
                                nn.Dropout(0.0), nn.Linear(inner, dim))

    def forward(self, x):
        return self.ff(x)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class DiTBlock(nn.Module):
    def __init__(self, arch: F5ArchConfig):
        super().__init__()
        self.attn_norm = AdaLayerNorm(arch.dim, 6)
        self.attn = Attention(arch.dim, arch.heads, arch.dim_head)
        self.ff = FeedForward(arch.dim, arch.ff_mult)

    def forward(self, x, t, rope, key_mask=None):
        shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = self.attn_norm(t)
        x = x + gate_a * self.attn(_norm(x) * (1 + scale_a) + shift_a, rope, key_mask)
        return x + gate_f * self.ff(_norm(x) * (1 + scale_f) + shift_f)


class DiT(nn.Module):
    def __init__(self, cfg: F5Config):
        super().__init__()
        arch, mels = cfg.arch, cfg.mel_spec.n_mel_channels
        self.arch = arch
        self.time_embed = TimestepEmbedding(arch.dim, arch.freq_embed_dim)
        self.text_embed = TextEmbedding(cfg.vocab_size, arch)
        self.input_embed = InputEmbedding(mels, arch)
        self.transformer_blocks = nn.ModuleList(DiTBlock(arch) for _ in range(arch.depth))
        self.norm_out = AdaLayerNorm(arch.dim, 2)
        self.proj_out = nn.Linear(arch.dim, mels)
        # F5-TTS zero-initialises the modulation and the output projection
        for block in self.transformer_blocks:
            nn.init.zeros_(block.attn_norm.linear.weight)
            nn.init.zeros_(block.attn_norm.linear.bias)
        for layer in (self.norm_out.linear, self.proj_out):
            nn.init.zeros_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(self, x, cond, text2, t, rope, key_mask=None, mask=None):
        """One guided evaluation: x, cond (1, T, mels), text2 (2, T, text_dim)
        (``TextEmbedding.conditioning``), t (1,) -> velocities (2, T, mels),
        the conditioned row first; the unconditioned row has no audio
        condition."""
        emb = self.time_embed(t).expand(2, -1)
        h = self.input_embed(torch.cat([x, x]), torch.cat([cond, torch.zeros_like(cond)]),
                             text2, None if mask is None else mask.expand(2, -1, -1))
        for block in self.transformer_blocks:
            h = block(h, emb, rope, key_mask)
        scale, shift = self.norm_out(emb)
        return self.proj_out(_norm(h) * (1 + scale) + shift)


# ---------------------------------------------------------------- Vocos


class VocosBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(layer_scale * torch.ones(dim))

    def forward(self, x):
        h = self.dwconv(x).transpose(1, 2)
        h = self.gamma * self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
        return x + h.transpose(1, 2)


class VocosBackbone(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, kernel_size=7, padding=3)
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.convnext = nn.ModuleList(
            VocosBlock(cfg.dim, cfg.intermediate_dim, 1.0 / cfg.num_layers)
            for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-6)

    def forward(self, mel, mask=None):
        """mel (B, mels, T) -> (B, T, dim); ``mask`` (B, 1, T) bool: every
        convolution reads zeros past the frames."""
        if mask is not None:
            mel = mel.masked_fill(~mask, 0.0)
        x = self.norm(self.embed(mel).transpose(1, 2)).transpose(1, 2)
        for block in self.convnext:
            if mask is not None:
                x = x.masked_fill(~mask, 0.0)
            x = block(x)
        return self.final_layer_norm(x.transpose(1, 2))


class ISTFTHead(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.cfg = cfg
        self.out = nn.Linear(cfg.dim, cfg.n_fft + 2)

    def forward(self, x, frame_mask=None):
        """x (B, T, dim) -> audio (B, T * hop_length)."""
        mag, p = self.out(x).transpose(1, 2).chunk(2, dim=1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        c = self.cfg
        return istft(mag * torch.cos(p), mag * torch.sin(p), c.n_fft, c.hop_length, c.n_fft,
                     padding=c.padding, frame_mask=frame_mask)


class Vocos(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.backbone = VocosBackbone(cfg)
        self.head = ISTFTHead(cfg)


def build_f5_models(cfg: F5Config) -> Dict[str, nn.Module]:
    return {"dit": DiT(cfg), "vocos": Vocos(cfg.vocos)}


# ---------------------------------------------------------------- the sampler


def sway_times(nfe: int, coef: float) -> List[float]:
    """The nfe + 1 times of the Euler steps: u_k = k / nfe, t_k = u_k +
    coef * (cos(pi/2 u_k) - 1 + u_k), in float64."""
    return [k / nfe + coef * (math.cos(math.pi / 2 * (k / nfe)) - 1 + k / nfe)
            for k in range(nfe + 1)]


def draw_noise(frames: int, mels: int, seed: int) -> torch.Tensor:
    """x_0 of a chunk: (frames, mels) standard normal float32 draws on the
    host, from a generator seeded ``seed``."""
    return torch.randn((frames, mels), generator=torch.Generator().manual_seed(seed))


def chunk_frames(audio_frames: int, ref_bytes: int, gen_bytes: int, text_len: int,
                 speed: float, max_frames: int) -> int:
    """The chunk's frames (``infer_batch_process`` and ``CFM.sample``): the
    reference clip's ``audio_frames`` plus the generated text's share at the
    reference's rate (speed 0.3 for text under 10 bytes), at least one
    more than the text's ids and the reference's mel frames, at most
    ``max_frames``."""
    local_speed = 0.3 if gen_bytes < 10 else speed
    total = audio_frames + int(audio_frames / ref_bytes * gen_bytes / local_speed)
    return min(max(total, text_len + 1, audio_frames + 2), max_frames)


def max_chars(ref_bytes: int, ref_seconds: float, max_seconds: float, speed: float) -> int:
    """``infer_process``'s budget of generated bytes a chunk."""
    return int(ref_bytes / ref_seconds * (max_seconds - ref_seconds) * speed)


def chunk_text(text: str, max_chars: int) -> List[str]:
    """F5-TTS's ``chunk_text``: sentences (split after punctuation and
    spaces) packed greedily into chunks of at most ``max_chars`` bytes."""
    chunks, current = [], ""
    for sentence in re.split(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])", text):
        piece = (sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1
                 else sentence)
        if len(current.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current += piece
        else:
            if current:
                chunks.append(current.strip())
            current = piece
    if current:
        chunks.append(current.strip())
    return chunks


class Conditioning(NamedTuple):
    """What every step of a chunk's sampler shares."""

    mask: torch.Tensor  # (1, F, 1) bool: the chunk's frames
    in_ref: torch.Tensor  # (1, F, 1) bool: the reference's frames
    key_mask: torch.Tensor  # (1, 1, 1, F) bool
    rope: tuple
    text2: torch.Tensor  # (2, F, text_dim): both guidance rows' text
    cond: torch.Tensor  # (1, F, mels): the reference's mel on its frames, DiT dtype


def conditioning(dit: DiT, ids: torch.Tensor, cond: torch.Tensor, ref_len: torch.Tensor,
                 total: torch.Tensor) -> Conditioning:
    """ids (1, F) (id + 1, 0 the filler), cond (1, F, mels) (the reference's
    mel on its frames), ref_len and total (1,) at frame bucket F."""
    dtype = dit.proj_out.weight.dtype
    frame = torch.arange(ids.shape[1], device=ids.device)[None, :]
    mask = (frame < total[:, None])[:, :, None]
    in_ref = (frame < ref_len[:, None])[:, :, None]
    return Conditioning(mask, in_ref, mask.transpose(1, 2)[:, None],
                        rope_tables(ids.shape[1], dit.arch.dim_head, ids.device, dtype),
                        dit.text_embed.conditioning(ids, mask),
                        torch.where(in_ref, cond, 0.0).to(dtype))


def state_dtype(dit: DiT) -> torch.dtype:
    """The sampler's state's dtype: float32, or the DiT's where wider."""
    return torch.promote_types(dit.proj_out.weight.dtype, torch.float32)


def guided_velocity(dit: DiT, x: torch.Tensor, c: Conditioning, t: float,
                    cfg_strength: float) -> torch.Tensor:
    """x (1, F, mels) at time t -> v_c + cfg_strength (v_c - v_u), in the
    state's dtype."""
    time = torch.full((1,), t, device=x.device)
    v2 = dit(x.to(c.cond.dtype), c.cond, c.text2, time, c.rope, c.key_mask, c.mask)
    v2 = v2.to(state_dtype(dit))
    return v2[:1] + cfg_strength * (v2[:1] - v2[1:])


def sample(dit: DiT, ids: torch.Tensor, cond: torch.Tensor, noise: torch.Tensor,
           ref_len: torch.Tensor, total: torch.Tensor, times: Sequence[float],
           cfg_strength: float) -> torch.Tensor:
    """The guided Euler sampler of one chunk at frame bucket F (inputs as
    ``conditioning``'s; noise (1, F, mels), x_0 on the chunk's frames) ->
    the mel (1, F, mels) in the state's dtype: the reference's on its
    frames, the last state after them, 0 past ``total``."""
    c = conditioning(dit, ids, cond, ref_len, total)
    x = noise.to(state_dtype(dit))
    for k in range(len(times) - 1):
        v = guided_velocity(dit, x, c, times[k], cfg_strength)
        x = torch.where(c.mask, x + (times[k + 1] - times[k]) * v, 0.0)
    return torch.where(c.in_ref, cond.to(x.dtype), x)


def vocode(vocos: Vocos, mel: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """mel (1, mels, G) float32 at a bucket of G frames, of which the first
    ``frames`` (1,) exist -> audio (1, G * hop_length)."""
    valid = torch.arange(mel.shape[-1], device=mel.device)[None, :] < frames[:, None]
    return vocos.head(vocos.backbone(mel, valid[:, None, :]), valid)
