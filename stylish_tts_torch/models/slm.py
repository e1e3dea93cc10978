"""WavLM-base encoder: the frozen network of the slm perceptual loss.

Counterpart of ``stylish_tts_tpu/models/slm.py`` (``WavLMEncoder``,
``resample_24k_to_16k``, ``wavlm_loss``, ``wavlm_embed``,
``wavlm_loss_cached``): a 7-layer conv feature extractor (GroupNorm on
the first), feature projection, the grouped positional conv (k = 128,
16 groups, pad 64, last frame dropped, weight-normed over the kernel
axis), and 12 post-norm transformer layers with WavLM's gated relative
position bias (T5-style log buckets, the bias table on layer 0 and shared
downstream). It returns 13 hidden states (B, T, 768).

Parameter names are those of ``transformers``' ``WavLMModel.state_dict()``
(including the unused ``masked_spec_embed``), so a local Hugging Face
checkpoint directory loads without ``transformers`` (``load_wavlm``), and
the JAX package's ``convert_torch_wavlm`` maps this module's weights onto
its flax encoder. The epsilons are the JAX module's (flax LayerNorm and
GroupNorm, 1e-6); ``transformers`` uses 1e-5.

Precision: under bf16 autocast the attention logits (with the gated
bias) and the softmax are float32, and the resampler runs with autocast
off, as in the JAX module.
"""

from __future__ import annotations

import functools
import logging
import math
import os.path as osp
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.stft import fp32_island
from ..utils.device import resolve_device

logger = logging.getLogger("stylish_tts_torch")

CONV_DIMS = (512, 512, 512, 512, 512, 512, 512)
CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)
HIDDEN = 768
LAYERS = 12
HEADS = 12
FFN = 3072
NUM_BUCKETS = 320
MAX_DISTANCE = 800
POS_CONV_KERNEL = 128
POS_CONV_GROUPS = 16
EPS = 1e-6


def _relative_position_buckets(q_len: int, k_len: int) -> np.ndarray:
    """T5-style log-bucketed relative positions (the JAX function)."""
    num_buckets = NUM_BUCKETS // 2
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    rel = mem - ctx
    buckets = (rel > 0).astype(np.int64) * num_buckets
    rel = np.abs(rel)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / math.log(MAX_DISTANCE / max_exact)
    large = (max_exact + large * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)
def position_buckets(t: int, device: torch.device) -> torch.Tensor:
    """The (t, t) buckets on ``device``, made once per length (so that a
    step copies nothing from the host, which would wait for the device)."""
    return torch.from_numpy(_relative_position_buckets(t, t)).to(device)


class _ConvLayer(nn.Module):
    def __init__(self, i: int):
        super().__init__()
        cin = 1 if i == 0 else CONV_DIMS[i - 1]
        self.conv = nn.Conv1d(cin, CONV_DIMS[i], CONV_KERNELS[i], stride=CONV_STRIDES[i],
                              bias=False)
        if i == 0:
            self.layer_norm = nn.GroupNorm(CONV_DIMS[i], CONV_DIMS[i], eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if hasattr(self, "layer_norm"):
            x = self.layer_norm(x)
        return F.gelu(x, approximate="none")


class _FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_layers = nn.ModuleList(_ConvLayer(i) for i in range(len(CONV_DIMS)))


class _FeatureProjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.layer_norm = nn.LayerNorm(CONV_DIMS[-1], eps=EPS)
        self.projection = nn.Linear(CONV_DIMS[-1], HIDDEN)


class _PosConvEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        conv = nn.Conv1d(HIDDEN, HIDDEN, POS_CONV_KERNEL, padding=POS_CONV_KERNEL // 2,
                         groups=POS_CONV_GROUPS)
        # HF's init, before the weight-norm split
        nn.init.normal_(conv.weight, mean=0.0,
                        std=2 * math.sqrt(1 / (POS_CONV_KERNEL * HIDDEN)))
        nn.init.zeros_(conv.bias)
        self.conv = nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)


class _Attention(nn.Module):
    def __init__(self, has_bias_embed: bool):
        super().__init__()
        self.q_proj = nn.Linear(HIDDEN, HIDDEN)
        self.k_proj = nn.Linear(HIDDEN, HIDDEN)
        self.v_proj = nn.Linear(HIDDEN, HIDDEN)
        self.out_proj = nn.Linear(HIDDEN, HIDDEN)
        self.gru_rel_pos_linear = nn.Linear(HIDDEN // HEADS, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, HEADS, 1, 1))
        if has_bias_embed:
            self.rel_attn_embed = nn.Embedding(NUM_BUCKETS, HEADS)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor | None):
        b, t, _ = x.shape
        head_dim = HIDDEN // HEADS
        if position_bias is None:
            buckets = position_buckets(t, x.device)
            position_bias = self.rel_attn_embed.weight[buckets].permute(2, 0, 1)
        position_bias = position_bias.float()  # (heads, T, T)

        # gated relative position bias
        gated = x.reshape(b, t, HEADS, head_dim).transpose(1, 2)
        proj = self.gru_rel_pos_linear(gated).reshape(b, HEADS, t, 2, 4).sum(-1)
        gate = torch.sigmoid(proj.float())
        gate_a, gate_b = gate[..., 0], gate[..., 1]
        gate_out = gate_a * (gate_b * self.gru_rel_pos_const[0, :, :, 0].float()[None]
                             - 1.0) + 2.0
        gated_bias = gate_out[..., None] * position_bias[None]  # (B, H, T, T)

        def heads(z):
            return z.reshape(b, t, HEADS, head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        # float32 logits and softmax (the JAX preferred_element_type island)
        with torch.autocast(x.device.type, enabled=False):
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(head_dim)
            attn = torch.softmax(scores + gated_bias, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, t, HIDDEN)
        return self.out_proj(out), position_bias


class _FeedForward(nn.Module):
    def __init__(self):
        super().__init__()
        self.intermediate_dense = nn.Linear(HIDDEN, FFN)
        self.output_dense = nn.Linear(FFN, HIDDEN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x), approximate="none"))


class _EncoderLayer(nn.Module):
    def __init__(self, has_bias_embed: bool):
        super().__init__()
        self.attention = _Attention(has_bias_embed)
        self.layer_norm = nn.LayerNorm(HIDDEN, eps=EPS)
        self.feed_forward = _FeedForward()
        self.final_layer_norm = nn.LayerNorm(HIDDEN, eps=EPS)

    def forward(self, x, position_bias):
        out, position_bias = self.attention(x, position_bias)
        x = self.layer_norm(x + out)
        x = self.final_layer_norm(x + self.feed_forward(x))
        return x, position_bias


class _Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed()
        self.layer_norm = nn.LayerNorm(HIDDEN, eps=EPS)
        self.layers = nn.ModuleList(_EncoderLayer(i == 0) for i in range(LAYERS))


class WavLMEncoder(nn.Module):
    """16 kHz audio (B, S) -> list of 13 hidden states (B, T, 768)."""

    def __init__(self):
        super().__init__()
        self.masked_spec_embed = nn.Parameter(torch.zeros(HIDDEN).uniform_())
        self.feature_extractor = _FeatureExtractor()
        self.feature_projection = _FeatureProjection()
        self.encoder = _Encoder()

    def forward(self, audio: torch.Tensor) -> List[torch.Tensor]:
        x = audio[:, None, :]
        for layer in self.feature_extractor.conv_layers:
            x = layer(x)
        x = x.transpose(1, 2)  # (B, T, 512)
        fp = self.feature_projection
        x = fp.projection(fp.layer_norm(x))
        enc = self.encoder
        pos = enc.pos_conv_embed.conv(x.transpose(1, 2))[:, :, :-1]
        x = x + F.gelu(pos, approximate="none").transpose(1, 2)
        x = enc.layer_norm(x)
        hidden_states = [x]
        position_bias = None
        for layer in enc.layers:
            x, position_bias = layer(x, position_bias)
            hidden_states.append(x)
        return hidden_states


def random_wavlm(seed: int = 0) -> WavLMEncoder:
    """The base-plus architecture with a seeded random init in the manner of
    ``transformers`` (Linear N(0, 0.02), kaiming-normal feature convs, the
    positional conv N(0, 2/sqrt(k * 768)), norms at one and zero):
    structural only, not a perceptual network."""
    torch.manual_seed(seed)
    model = WavLMEncoder()
    for module in model.modules():
        if isinstance(module, nn.Linear):
            nn.init.normal_(module.weight, std=0.02)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Conv1d) and module.groups == 1:
            nn.init.kaiming_normal_(module.weight)
    return model


def _hf_state_dict(path: str) -> dict:
    """The tensors of a local Hugging Face WavLM checkpoint directory (or
    file), with the ``wavlm.`` prefix of a task head and the old weight-norm
    names (``weight_g``/``weight_v``) mapped onto ``WavLMEncoder``'s."""
    if osp.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            if osp.isfile(osp.join(path, name)):
                path = osp.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {path}")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        k = k[len("wavlm."):] if k.startswith("wavlm.") else k
        k = k.replace("pos_conv_embed.conv.weight_g",
                      "pos_conv_embed.conv.parametrizations.weight.original0")
        k = k.replace("pos_conv_embed.conv.weight_v",
                      "pos_conv_embed.conv.parametrizations.weight.original1")
        out[k] = v
    keys = set(WavLMEncoder().state_dict())
    return {k: v for k, v in out.items() if k in keys}


def load_wavlm(model_name: str, allow_random_fallback: bool = False,
               device="cuda") -> WavLMEncoder:
    """The frozen WavLM of the slm loss, in eval mode with
    ``requires_grad_(False)``, on ``device`` (``cuda`` unless the caller
    asks for ``cpu``): from a local Hugging Face directory or file
    (nothing is downloaded), else, only with
    ``model.slm.allow_random_fallback: true``, the seeded random init.
    Without either it raises the JAX package's error."""
    device = resolve_device(device)
    model = None
    try:
        sd = _hf_state_dict(model_name)
        model = WavLMEncoder()
        model.load_state_dict(sd)
    except Exception as exc:  # noqa: BLE001 - any unreadable source falls through
        logger.warning("WavLM weights not loadable from %s (%s)", model_name, exc)
        model = None
    if model is None and allow_random_fallback:
        model = random_wavlm(0)
        logger.warning(
            "using RANDOM-INIT WavLM (base-plus arch, seed 0) — slm term "
            "is structural only, not perceptual"
        )
    if model is None:
        raise RuntimeError(
            f"slm loss weight > 0 but WavLM weights for {model_name!r} are "
            "not locally available. Either provide the weights, set "
            "loss_weight.slm: 0, or opt in to the structural-only "
            "random-init net with model.slm.allow_random_fallback: true."
        )
    logger.info("loaded WavLM slm weights (%s)", model_name)
    return model.to(device).eval().requires_grad_(False)


# --------------------------------------------------------------------------
# 24 kHz -> 16 kHz polyphase resampler
# --------------------------------------------------------------------------


def _resample_kernel(orig: int, new: int, lowpass_width: int = 6) -> np.ndarray:
    """Windowed-sinc polyphase kernel (new, taps) (the JAX function)."""
    g = np.gcd(orig, new)
    orig, new = orig // g, new // g
    base = min(orig, new)
    cutoff = 0.99 * 0.5 * base
    width = int(np.ceil(lowpass_width * orig / base))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * cutoff * 2
    t = np.clip(t, -lowpass_width, lowpass_width)
    window = np.cos(t * np.pi / lowpass_width / 2) ** 2
    kernel = np.where(t == 0, 1.0, np.sin(t * np.pi) / (t * np.pi + 1e-20))
    kernel = kernel * window * (cutoff * 2 / orig)
    return kernel.astype(np.float32)


@functools.lru_cache(maxsize=4)
@torch.inference_mode(False)
def resample_kernel(device: torch.device) -> torch.Tensor:
    """The 24 -> 16 kHz kernel on ``device``, made once per device."""
    return torch.from_numpy(_resample_kernel(24000, 16000)).to(device)


@fp32_island
def resample_24k_to_16k(audio: torch.Tensor) -> torch.Tensor:
    """(B, S) 24 kHz -> (B, ceil(S*2/3)) 16 kHz, float32."""
    orig, new = 3, 2
    kernel = resample_kernel(audio.device)
    width = (kernel.shape[1] - orig) // 2
    x = F.pad(audio.float(), (width, width + orig))[:, None, :]
    out = F.conv1d(x, kernel[:, None, :], stride=orig)  # (B, new, frames)
    out = out.transpose(1, 2).reshape(audio.shape[0], -1)
    return out[:, : int(math.ceil(audio.shape[1] * new / orig))]


def wavlm_loss(model: WavLMEncoder, target_audio: torch.Tensor,
               pred_audio: torch.Tensor) -> torch.Tensor:
    """Mean over the 13 hidden states of the L1 between the target's and the
    prediction's, at 16 kHz; the target side carries no gradient."""
    with torch.no_grad():
        t_states = model(resample_24k_to_16k(target_audio))
    p_states = model(resample_24k_to_16k(pred_audio))
    loss = 0.0
    for ts, ps in zip(t_states, p_states):
        loss = loss + torch.mean(torch.abs(ts.float() - ps.float()))
    return loss / len(t_states)


def wavlm_embed(model: WavLMEncoder, audio24k: torch.Tensor) -> torch.Tensor:
    """24 kHz audio (B, S) -> stacked hidden states (B, 13, T, 768), the GT
    side of the slm loss that ``slm-cache`` precomputes."""
    with torch.no_grad():
        return torch.stack(model(resample_24k_to_16k(audio24k)), dim=1)


def wavlm_loss_cached(model: WavLMEncoder, gt_states: torch.Tensor,
                      pred_audio: torch.Tensor) -> torch.Tensor:
    """The slm loss against precomputed GT hidden states (B, 13, T, 768);
    equal to ``wavlm_loss`` when ``gt_states = wavlm_embed(target)``."""
    p_states = model(resample_24k_to_16k(pred_audio))
    gt = gt_states.detach().float()
    loss = 0.0
    for i, ps in enumerate(p_states):
        t = min(gt.shape[2], ps.shape[1])
        loss = loss + torch.mean(torch.abs(gt[:, i, :t] - ps[:, :t].float()))
    return loss / len(p_states)
