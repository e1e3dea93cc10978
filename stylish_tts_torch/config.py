"""Configuration schemas.

The PyTorch port's own copy of ``stylish_tts_tpu/config.py``: the port
imports nothing of the JAX package, and the Stylish schemas of the two
copies stay identical so the same ``configs/*.yml`` files load in both.
``KokoroConfig`` (Kokoro-82M, a model the JAX package does not run) is
the port's own.

YAML-compatible with the reference's two config files
(reference: src/stylish_tts/lib/config_loader.py:322,348 and
train/config/model.yml / config/config.yml): the same keys load
unchanged, so a user of the reference can reuse their configs.

Both configs expose ``state_dict``/``load_state_dict`` so they can be
serialized into checkpoints (reference: config_loader.py:341-345).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Literal

import yaml
from pydantic import BaseModel, Field


# --------------------------------------------------------------------------
# Run config (training plan, dataset paths, loss weights)
# --------------------------------------------------------------------------


class TrainingConfig(BaseModel):
    log_interval: int = 10
    save_interval: int = 2000
    val_interval: int = 2000
    device: str = "tpu"
    mixed_precision: str = "bf16"  # "bf16" or "no" — fp32 islands stay fp32 anyway
    # Kept for config compat with the reference (VRAM probe reserve);
    # on TPU batch sizes come from the static memory planner instead.
    vram_reserve: int = 0
    data_workers: int = 4
    # Acoustic discriminator phase: compute forward+backward for only the
    # per-step sampled MRD (lax.switch) instead of all three. The torch
    # reference computes the loss over all 3 MRDs every step and lets each
    # helper's last_loss EMA move on call (losses.py:191-207, :287) but
    # only *optimizer-steps* the sampled one (stage.py:138-144) — so two
    # of the three MRD backwards buy nothing but EMA movement. True (the
    # default) skips them: ~⅓ the MRD disc-phase FLOPs, EMAs advance only
    # when their MRD is sampled. False reproduces the reference
    # trajectory exactly (used by the torch-parity harness).
    sampled_mrd_only: bool = True


class StagePlan(BaseModel):
    epochs: int = 1
    # Maximum batch size considered by the static batch planner
    # (reference calls this probe_batch_max and discovers sizes by OOM probing).
    probe_batch_max: int = 16
    lr: float = 1e-4


class TrainingPlan(BaseModel):
    alignment: StagePlan = StagePlan(epochs=20, probe_batch_max=128, lr=1e-5)
    acoustic: StagePlan = StagePlan(epochs=20, probe_batch_max=16, lr=1e-4)
    textual: StagePlan = StagePlan(epochs=40, probe_batch_max=32, lr=3e-5)
    style: StagePlan = StagePlan(epochs=20, probe_batch_max=64, lr=1e-5)
    joint: StagePlan = StagePlan(epochs=10, probe_batch_max=16, lr=1e-5)
    duration: StagePlan = StagePlan(epochs=80, probe_batch_max=32, lr=1e-4)

    def get_stage(self, name: str) -> StagePlan:
        return getattr(self, name)


class DatasetConfig(BaseModel):
    path: str = "."
    train_data: str = "train-list.txt"
    val_data: str = "val-list.txt"
    wav_path: str = "wav-dir"
    pitch_path: str = "pitch.safetensors"
    alignment_path: str = "alignment.safetensors"
    alignment_model_path: str = "alignment_model.safetensors"
    # optional precomputed GT WavLM-embedding cache (`stylish-train
    # slm-cache`); when the file exists the acoustic step trains the
    # slm loss against it instead of re-embedding GT audio every step
    slm_path: str = "slm.safetensors"
    # Merge duration bins into groups of N 0.25 s steps (N=1: reference
    # binning). Each occupied (bin, stage) pair is one compiled XLA
    # program, so on a fresh compile cache a many-bin corpus pays
    # minutes per bin (PERF.md round-4 compile-budget table); N=2/3
    # cuts that ~2-3x for up to N*0.25 s extra zero padding per
    # segment. MUST match across `pitch`/`align`/`slm-cache`/`train` —
    # the caches bake the padded length; collation raises on mismatch.
    time_bin_quantize: int = 1


class ValidationConfig(BaseModel):
    sample_count: int = 10
    force_samples: List[str] = Field(default_factory=list)


class LossWeightConfig(BaseModel):
    mel: float = 5.0
    generator: float = 1.0
    slm: float = 0.2
    pitch: float = 8.0
    energy: float = 8.0
    duration: float = 8.0
    duration_ce: float = 8.0
    style: float = 1.0
    mag: float = 1.0
    phase: float = 8.0
    voiced: float = 1.0
    multi_phase: float = 8.0
    confidence: float = 1.0
    align_loss: float = 1.0
    discriminator: float = 1.0


class Config(BaseModel):
    training: TrainingConfig = TrainingConfig()
    training_plan: TrainingPlan = TrainingPlan()
    dataset: DatasetConfig = DatasetConfig()
    validation: ValidationConfig = ValidationConfig()
    loss_weight: LossWeightConfig = LossWeightConfig()

    def state_dict(self) -> dict:
        return {"json": self.model_dump_json()}

    def load_state_dict(self, state: dict) -> None:
        loaded = Config.model_validate(json.loads(state["json"]))
        for field in Config.model_fields:
            setattr(self, field, getattr(loaded, field))


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------


class TextAlignerConfig(BaseModel):
    n_mels: int = 80
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300
    hidden_dim: int = 256
    token_embedding_dim: int = 512


class DecoderConfig(BaseModel):
    hidden_dim: int = 128
    residual_dim: int = 64


class GeneratorConfig(BaseModel):
    type: str = "freegan"  # or "ringformer"
    input_dim: int = 128
    hidden_dim: int = 256
    conv_intermediate_dim: int = 768
    io_conv_kernel_size: int = 21
    conformer_layers: int = 1
    conv_layers: int = 8
    # rematerialize the audio-rate ConvNeXt stacks in backward
    # (jax.checkpoint): ~2x larger training batches for ~15% extra FLOPs
    remat: bool = False
    # roll the identical amp/phase ConvNeXt stacks with lax.scan: one
    # compiled block body instead of conv_layers inlined copies —
    # ~conv_layers-fold smaller HLO for those stacks (faster compiles,
    # smaller executables; the B=64 remat blocker was a 42.6 MB
    # StableHLO upload). Param layout gains a leading stacked axis, so
    # checkpoints are NOT interchangeable with the unrolled layout;
    # from-scratch training only (torch imports keep unrolled).
    scan_stacks: bool = False
    # "group" (TPU-first GroupNorm training norm) or "affine" (frozen
    # per-channel scale/bias = folded torch BatchNorm eval stats; set by
    # convert/torch_import.py when importing reference checkpoints)
    norm_mode: str = "group"
    # ringformer variant fields (reference config_loader.py:213 schema;
    # the reference keeps its ringformer YAML block commented out)
    resblock_kernel_sizes: List[int] = [3, 7, 11]
    upsample_rates: List[int] = [4, 5]
    upsample_initial_channel: int = 256
    upsample_last_channel: int = 64
    resblock_dilation_sizes: List[List[int]] = [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    upsample_kernel_sizes: List[int] = [8, 10]
    gen_istft_n_fft: int = 60
    gen_istft_hop_size: int = 15
    depth: int = 2


class TextEncoderConfig(BaseModel):
    tokens: int = 178
    hidden_dim: int = 128
    filter_channels: int = 512
    heads: int = 8
    layers: int = 8
    kernel_size: int = 3
    dropout: float = 0.2


class StyleEncoderConfig(BaseModel):
    n_mels: int = 80
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300
    max_channels: int = 384
    skip_downsample: bool = True


class DurationPredictorConfig(BaseModel):
    n_layer: int = 3
    duration_classes: int = 16
    max_duration: int = 50
    dropout: float = 0.5
    last_dropout: float = 0.5


class PitchEnergyPredictorConfig(BaseModel):
    inter_dim: int = 256
    dropout: float = 0.2


class SlmConfig(BaseModel):
    model: str = "microsoft/wavlm-base-plus"
    sr: int = 16000
    # Opt-in: fall back to a random-init WavLM when the pretrained
    # weights are not locally available. Off by default — a random
    # perceptual net silently changes training semantics, so like the
    # reference (losses.py:376-394 would fail in from_pretrained) a
    # missing model with slm weight > 0 is an error unless the user
    # explicitly asks for the structural-only fallback.
    allow_random_fallback: bool = False


class SymbolConfig(BaseModel):
    pad: str = "$"
    punctuation: str = ';:,.!?¡¿—…"()“” '
    letters: str = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    letters_ipa: str = (
        "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁᵊǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
    )


class ModelConfig(BaseModel):
    multispeaker: bool = False
    sample_rate: int = 24000
    n_mels: int = 80
    n_fft: int = 512
    win_length: int = 512
    hop_length: int = 300
    coarse_multiplier: int = 1
    style_dim: int = 64
    inter_dim: int = 128
    # True when parameters were imported from a trained torch reference
    # checkpoint: BatchNorm sites become frozen affine (exact eval-mode
    # function) and spectral-norm kernels are taken as already folded.
    imported_weights: bool = False

    text_aligner: TextAlignerConfig = TextAlignerConfig()
    decoder: DecoderConfig = DecoderConfig()
    generator: GeneratorConfig = GeneratorConfig()
    text_encoder: TextEncoderConfig = TextEncoderConfig()
    style_encoder: StyleEncoderConfig = StyleEncoderConfig()
    duration_predictor: DurationPredictorConfig = DurationPredictorConfig()
    pitch_energy_predictor: PitchEnergyPredictorConfig = PitchEnergyPredictorConfig()
    slm: SlmConfig = SlmConfig()
    symbol: SymbolConfig = SymbolConfig()

    def state_dict(self) -> dict:
        return {"json": self.model_dump_json()}

    def load_state_dict(self, state: dict) -> None:
        loaded = ModelConfig.model_validate(json.loads(state["json"]))
        for field in ModelConfig.model_fields:
            setattr(self, field, getattr(loaded, field))


# --------------------------------------------------------------------------
# Kokoro-82M (hexgrad/Kokoro-82M config.json), inference only
# --------------------------------------------------------------------------


class PlbertConfig(BaseModel):
    """The ALBERT encoder: one layer applied ``num_hidden_layers`` times."""

    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    num_hidden_layers: int = 12
    embedding_size: int = 128


class IstftnetConfig(BaseModel):
    upsample_kernel_sizes: List[int] = [20, 12]
    upsample_rates: List[int] = [10, 6]
    gen_istft_hop_size: int = 5
    gen_istft_n_fft: int = 20
    resblock_dilation_sizes: List[List[int]] = [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    resblock_kernel_sizes: List[int] = [3, 7, 11]
    upsample_initial_channel: int = 512


class KokoroConfig(BaseModel):
    """Kokoro-82M's ``config.json`` (the StyleTTS2 line: ALBERT, prosody
    predictor, text encoder and iSTFTNet decoder); its defaults are the
    published widths. ``vocab`` maps a phoneme to its id (empty until the
    published map is given; ``speak`` needs it, the benchmark feeds ids).
    Only the fields the inference forward reads are here: the published
    file's others (``dim_in``, ``dropout``, ``max_conv_dim``,
    ``multispeaker``, ``n_mels``, ``plbert.dropout``) load and are
    ignored."""

    family: Literal["kokoro"] = "kokoro"
    istftnet: IstftnetConfig = IstftnetConfig()
    hidden_dim: int = 512
    max_dur: int = 50
    n_layer: int = 3
    n_token: int = 178
    style_dim: int = 128
    text_encoder_kernel_size: int = 5
    plbert: PlbertConfig = PlbertConfig()
    vocab: Dict[str, int] = {}
    sample_rate: int = 24000
    # literals of kokoro's istftnet.Decoder (encode and decode widths, the
    # asr residual's channels), named here so that a test can cut them
    decoder_dim: int = 1024
    asr_res_dim: int = 64

    @property
    def frame_samples(self) -> int:
        """Samples per alignment frame: two F0 frames, each
        prod(upsample_rates) x the iSTFT hop."""
        ist = self.istftnet
        return 2 * math.prod(ist.upsample_rates) * ist.gen_istft_hop_size


class F5ArchConfig(BaseModel):
    """The DiT of ``F5TTS_v1_Base.yaml``'s ``arch`` (``dim_head``, the text
    blocks' ``conv_mult``, the position convolution and the time and text
    position tables are the constructors' defaults in ``dit.py`` and
    ``modules.py``)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    text_dim: int = 512
    conv_layers: int = 4
    conv_mult: int = 2
    pos_kernel: int = 31
    pos_groups: int = 16
    freq_embed_dim: int = 256
    text_max_pos: int = 4096


class F5MelConfig(BaseModel):
    """``mel_spec`` of the published yaml: Vocos's magnitude mel."""

    target_sample_rate: int = 24000
    n_mel_channels: int = 100
    hop_length: int = 256
    win_length: int = 1024
    n_fft: int = 1024
    mel_spec_type: Literal["vocos"] = "vocos"


class VocosConfig(BaseModel):
    """``charactr/vocos-mel-24khz``'s backbone and iSTFT head."""

    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    padding: Literal["same"] = "same"


class F5SamplerConfig(BaseModel):
    """``infer_process``'s defaults: 32 Euler steps with classifier-free
    guidance and sway sampling, chunks of reference plus generated audio
    near ``max_seconds``."""

    nfe_step: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0
    speed: float = 1.0
    max_seconds: float = 22.0


class F5Config(BaseModel):
    """F5-TTS v1 Base (github.com/SWivid/F5-TTS ``F5TTS_v1_Base.yaml``) with
    the Vocos vocoder. ``vocab`` maps a character to its id (empty until the
    published ``vocab.txt`` is given; ``speak`` needs it, the benchmark
    feeds ids); ``vocab_size`` sizes the text embedding. ``dit_dtype`` is
    the DiT's and the text embedding's precision on a card (F5-TTS casts
    the model to float16 there); Vocos and the mel run in float32."""

    family: Literal["f5"] = "f5"
    arch: F5ArchConfig = F5ArchConfig()
    mel_spec: F5MelConfig = F5MelConfig()
    vocos: VocosConfig = VocosConfig()
    sampler: F5SamplerConfig = F5SamplerConfig()
    vocab_size: int = 2545
    vocab: Dict[str, int] = {}
    dit_dtype: Literal["float16", "bfloat16", "float32"] = "float16"

    @property
    def sample_rate(self) -> int:
        return self.mel_spec.target_sample_rate


# --------------------------------------------------------------------------
# Loading helpers
# --------------------------------------------------------------------------


def load_config_yaml(path: str) -> Config:
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    return Config.model_validate(raw)


def load_model_config_yaml(path: str) -> ModelConfig:
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    return ModelConfig.model_validate(raw)
