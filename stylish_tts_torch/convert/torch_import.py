"""Per-module torch->flax weight conversion for the reference models.

The port's copy of ``stylish_tts_tpu/convert/torch_import.py``. Each
``convert_<module>`` takes a FOLDED torch state_dict (see
folding.fold_state_dict) restricted to that module (keys relative to the
module root) and returns the flax-layout ``params`` subtree of the
matching module as numpy arrays: the tree the JAX import gives, leaf for
leaf. The port's modules take it through the weight bridge
(``convert/from_jax.py`` ``module_from_jax``). Layout rules:

  * torch Conv1d weight (O, I/g, K)      -> flax Conv kernel (K, I/g, O)
  * torch Conv2d weight (O, I/g, Kh, Kw) -> flax kernel (Kh, Kw, I/g, O)
  * torch Linear weight (O, I)           -> flax Dense kernel (I, O)
  * 1x1 Conv1d used as a pointwise layer -> flax Dense kernel (I, O)
  * BatchNorm eval running stats         -> Norm1d("affine") scale/bias

Reference module structure citations are given per converter.
``convert/reference_layout.py`` inverts these rules to write a seeded
checkpoint in the reference layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .folding import fold_batch_norm

Params = Dict[str, object]


# ---------------------------------------------------------------- helpers


def _sub(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def conv(sd, base) -> Params:
    """torch ConvNd -> flax nn.Conv kernel/bias."""
    w = np.asarray(sd[f"{base}.weight"])
    if w.ndim == 3:
        kernel = w.transpose(2, 1, 0)
    elif w.ndim == 4:
        kernel = w.transpose(2, 3, 1, 0)
    else:
        raise ValueError(f"{base}: unexpected conv weight ndim {w.ndim}")
    out: Params = {"kernel": kernel}
    if f"{base}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{base}.bias"])
    return out


def conv1d_w(sd, base) -> Params:
    """torch Conv1d -> my Conv1d wrapper ({'Conv_0': ...})."""
    return {"Conv_0": conv(sd, base)}


def dense(sd, base) -> Params:
    out: Params = {"kernel": np.asarray(sd[f"{base}.weight"]).T}
    if f"{base}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{base}.bias"])
    return out


def dense_from_conv1(sd, base) -> Params:
    """1x1 torch Conv1d -> flax Dense."""
    w = np.asarray(sd[f"{base}.weight"])
    assert w.ndim == 3 and w.shape[2] == 1, (base, w.shape)
    out: Params = {"kernel": w[:, :, 0].T}
    if f"{base}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{base}.bias"])
    return out


def layer_norm(sd, base) -> Params:
    """torch nn.LayerNorm -> flax nn.LayerNorm."""
    return {
        "scale": np.asarray(sd[f"{base}.weight"]),
        "bias": np.asarray(sd[f"{base}.bias"]),
    }


def gamma_beta_norm(sd, base) -> Params:
    """reference text_encoder.LayerNorm (gamma/beta) -> flax LayerNorm."""
    return {
        "scale": np.asarray(sd[f"{base}.gamma"]),
        "bias": np.asarray(sd[f"{base}.beta"]),
    }


def affine_norm(sd, base, eps: float = 1e-5) -> Params:
    """BatchNorm running stats -> Norm1d('affine') scale/bias."""
    scale, bias = fold_batch_norm(
        sd[f"{base}.running_mean"],
        sd[f"{base}.running_var"],
        sd.get(f"{base}.weight"),
        sd.get(f"{base}.bias"),
        eps=eps,
    )
    return {"scale": scale, "bias": bias}


def film(sd, base) -> Params:
    """AdaptiveLayerNorm / AdaptiveInstance fc -> StyleFiLM."""
    return {"StyleFiLM_0": {"fc": dense(sd, f"{base}.fc")}}


# ------------------------------------------------------------ shared blocks


def ada_decoder_block(sd, base) -> Params:
    """reference ada_norm.AdaptiveDecoderBlock (ada_norm.py:143-192)."""
    out: Params = {
        "norm1": film(sd, f"{base}.norm1"),
        "conv1": conv1d_w(sd, f"{base}.conv1"),
        "norm2": film(sd, f"{base}.norm2"),
        "conv2": conv1d_w(sd, f"{base}.conv2"),
    }
    if f"{base}.conv1x1.weight" in sd:
        out["shortcut"] = conv1d_w(sd, f"{base}.conv1x1")
    return out


def ada_generator_block(sd, base) -> Params:
    """reference ada_norm.AdaptiveGeneratorBlock (ada_norm.py:11-120)."""
    out: Params = {}
    for i in range(3):
        out[f"alpha1_{i}"] = np.asarray(sd[f"{base}.alpha1.{i}"]).transpose(0, 2, 1)
        out[f"alpha2_{i}"] = np.asarray(sd[f"{base}.alpha2.{i}"]).transpose(0, 2, 1)
        out[f"adain1_{i}"] = film(sd, f"{base}.adain1.{i}")
        out[f"adain2_{i}"] = film(sd, f"{base}.adain2.{i}")
        out[f"conv1_{i}"] = conv1d_w(sd, f"{base}.convs1.{i}")
        out[f"conv2_{i}"] = conv1d_w(sd, f"{base}.convs2.{i}")
    return out


def grn(sd, base) -> Params:
    return {
        "gamma": np.asarray(sd[f"{base}.gamma"]),
        "beta": np.asarray(sd[f"{base}.beta"]),
    }


def generator_convnext_block(sd, base) -> Params:
    """reference conv_next.GeneratorConvNeXtBlock (conv_next.py:57-93)."""
    return {
        "dwconv": conv1d_w(sd, f"{base}.dwconv"),
        "norm": film(sd, f"{base}.norm"),
        "pwconv1": dense(sd, f"{base}.pwconv1"),
        "snake": np.asarray(sd[f"{base}.snake"]),
        "GRN_0": grn(sd, f"{base}.grn"),
        "pwconv2": dense(sd, f"{base}.pwconv2"),
    }


def adaptive_convnext_block(sd, base) -> Params:
    """reference conv_next.AdaptiveConvNeXtBlock (conv_next.py:96-132)."""
    return {
        "dwconv": conv1d_w(sd, f"{base}.dwconv"),
        "norm": film(sd, f"{base}.norm"),
        "pwconv1": dense(sd, f"{base}.pwconv1"),
        "GRN_0": grn(sd, f"{base}.grn"),
        "pwconv2": dense(sd, f"{base}.pwconv2"),
    }


def mha(sd, base) -> Params:
    """reference text_encoder.MultiHeadAttention (1x1 convs) -> RoPE MHA."""
    return {
        "q": dense_from_conv1(sd, f"{base}.conv_q"),
        "k": dense_from_conv1(sd, f"{base}.conv_k"),
        "v": dense_from_conv1(sd, f"{base}.conv_v"),
        "out": dense_from_conv1(sd, f"{base}.conv_o"),
    }


def conv_ffn(sd, base) -> Params:
    """reference text_encoder.FFN -> ConvFFN."""
    return {
        "conv1": conv1d_w(sd, f"{base}.conv_1"),
        "conv2": conv1d_w(sd, f"{base}.conv_2"),
    }


def conformer_conv_module(sd, base) -> Params:
    """reference conformer.ConformerConvModule (conformer.py:160-193).

    net.1 = 1x1 pointwise in, net.3.conv = depthwise, net.4 = BatchNorm,
    net.6 = 1x1 pointwise out.
    """
    return {
        "pw_in": dense_from_conv1(sd, f"{base}.net.1"),
        "dwconv": conv1d_w(sd, f"{base}.net.3.conv"),
        "bn": affine_norm(sd, f"{base}.net.4"),
        "pw_out": dense_from_conv1(sd, f"{base}.net.6"),
    }


def conformer_block(sd, base) -> Params:
    """reference conformer.ConformerBlock (conformer.py:199-250).

    ff1/ff2 are Scale(0.5, PreNorm(...)) wrappers -> .fn.norm / .fn.fn;
    attn is PreNorm -> .norm / .fn.
    """

    def ff(b):
        return {
            "Dense_0": dense(sd, f"{b}.net.0"),
            "Dense_1": dense(sd, f"{b}.net.3"),
        }

    return {
        "ff1_norm": film(sd, f"{base}.ff1.fn.norm"),
        "ff1": ff(f"{base}.ff1.fn.fn"),
        "attn_norm": film(sd, f"{base}.attn.norm"),
        "attn": {
            "to_q": dense(sd, f"{base}.attn.fn.to_q"),
            "to_kv": dense(sd, f"{base}.attn.fn.to_kv"),
            "to_out": dense(sd, f"{base}.attn.fn.to_out"),
        },
        "conv_norm": film(sd, f"{base}.conv.norm"),
        "conv": conformer_conv_module(sd, f"{base}.conv"),
        "ff2_norm": film(sd, f"{base}.ff2.fn.norm"),
        "ff2": ff(f"{base}.ff2.fn.fn"),
        "post_norm": film(sd, f"{base}.post_norm"),
    }


def conformer(sd, base, depth: int) -> Params:
    return {
        f"block_{i}": conformer_block(sd, f"{base}.layers.{i}")
        for i in range(depth)
    }


# --------------------------------------------------------------- modules


def convert_text_encoder(sd, n_layers: int, prenet_layers: int = 3) -> Params:
    """reference text_encoder.TextEncoder (text_encoder.py:397-463)."""
    prenet: Params = {
        "proj": dense_from_conv1(sd, "prenet.proj"),
    }
    for i in range(prenet_layers):
        prenet[f"conv_{i}"] = conv1d_w(sd, f"prenet.conv_layers.{i}")
        prenet[f"norm_{i}"] = {
            "LayerNorm_0": gamma_beta_norm(sd, f"prenet.norm_layers.{i}")
        }
    encoder: Params = {}
    for i in range(n_layers):
        encoder[f"attn_{i}"] = mha(sd, f"encoder.attn_layers.{i}")
        encoder[f"norm1_{i}"] = {
            "LayerNorm_0": gamma_beta_norm(sd, f"encoder.norm_layers_1.{i}")
        }
        encoder[f"ffn_{i}"] = conv_ffn(sd, f"encoder.ffn_layers.{i}")
        encoder[f"norm2_{i}"] = {
            "LayerNorm_0": gamma_beta_norm(sd, f"encoder.norm_layers_2.{i}")
        }
    return {
        "emb": {"embedding": np.asarray(sd["emb.weight"])},
        "prenet": prenet,
        "encoder": encoder,
        "proj": dense_from_conv1(sd, "proj_m"),
    }


def convert_decoder(sd) -> Params:
    """reference decoder.Decoder (decoder.py:7-90)."""
    return {
        "f0_conv": conv1d_w(sd, "F0_conv"),
        "n_conv": conv1d_w(sd, "N_conv"),
        "voiced_conv": conv1d_w(sd, "voiced_conv"),
        "encode": ada_decoder_block(sd, "encode"),
        "asr_res": conv1d_w(sd, "asr_res.0"),
        **{f"decode_{i}": ada_decoder_block(sd, f"decode.{i}") for i in range(4)},
    }


def convert_generator(sd, conv_layers: int, upsample_rates=(3, 5, 5)) -> Params:
    """reference generator.Generator (generator.py:513-799)."""
    n_up = len(upsample_rates)
    amp_layers = conv_layers - n_up
    out: Params = {
        "source": {"merge": dense(sd, "m_source.l_linear")},
        "amp_prior_conv": conv1d_w(sd, "amp_prior_conv"),
        "amp_prior_block": ada_generator_block(sd, "amp_prior_block"),
        "phase_prior_conv": conv1d_w(sd, "phase_prior_conv"),
        "phase_prior_block": ada_generator_block(sd, "phase_prior_block"),
        "amp_final_norm": layer_norm(sd, "amp_final_layer_norm"),
        "amp_output_conv": conv1d_w(sd, "amp_output_conv"),
        "phase_input_conv": conv1d_w(sd, "phase_input_conv"),
        "phase_norm": layer_norm(sd, "phase_norm"),
        "phase_final_norm": layer_norm(sd, "phase_final_layer_norm"),
        "phase_real_conv": conv1d_w(sd, "phase_output_real_conv"),
        "phase_imag_conv": conv1d_w(sd, "phase_output_imag_conv"),
    }
    for i in range(amp_layers):
        out[f"amp_convnext_{i}"] = generator_convnext_block(sd, f"amp_convnext.{i}")
    for i in range(n_up):
        out[f"upconv_{i}"] = conv1d_w(sd, f"upconvs.{i}")
        out[f"upblock_{i}"] = generator_convnext_block(sd, f"upblocks.{i}")
    for i in range(conv_layers):
        out[f"phase_convnext_{i}"] = generator_convnext_block(
            sd, f"phase_convnext.{i}"
        )
    return out


def convert_upsample_generator(
    sd, n_up: int, num_kernels: int = 3, conformer_depth: int = 2
) -> Params:
    """reference generator.UpsampleGenerator (generator.py:66-259), the
    ringformer vocoder — for models.ringformer.UpsampleGenerator with
    faithful=True (exact transposed-conv upsampling).

    The weight-normed ConvTranspose1d kernels (in, out, k) are folded by
    fold_state_dict, then flipped along k and laid out (k, in, out) so
    TransposeConv1d's lhs-dilated regular conv computes the identical
    function."""
    out: Params = {"conv_post": conv1d_w(sd, "conv_post")}
    for i in range(n_up + 1):
        a = np.asarray(sd[f"alphas.{i}"])  # (1, C, 1)
        name = f"alpha_{i}" if i < n_up else "alpha_post"
        out[name] = a.transpose(0, 2, 1)
    for i in range(n_up):
        w = np.asarray(sd[f"ups.{i}.weight"])  # (in, out, k)
        out[f"up_{i}"] = {
            "kernel": w.transpose(2, 0, 1)[::-1].copy(),
            "bias": np.asarray(sd[f"ups.{i}.bias"]),
        }
        out[f"conformer_{i}"] = conformer(sd, f"conformers.{i}", conformer_depth)
        out[f"noise_conv_{i}"] = conv(sd, f"noise_convs.{i}")
        out[f"noise_res_{i}"] = ada_generator_block(sd, f"noise_res.{i}")
        for j in range(num_kernels):
            out[f"resblock_{i}_{j}"] = ada_generator_block(
                sd, f"resblocks.{i * num_kernels + j}"
            )
    return out


def convert_multi_generator(sd, conformer_layers: int, conv_layers: int) -> Params:
    """reference generator.MultiGenerator (generator.py:802-901)."""
    return {
        "amp_input_conv": conv1d_w(sd, "amp_input_conv"),
        "amp_norm": layer_norm(sd, "amp_norm"),
        "amp_conformer": conformer(sd, "amp_conformer", conformer_layers),
        "basegen": convert_generator(_sub(sd, "basegen"), conv_layers),
    }


def convert_mel_style_encoder(sd) -> Params:
    """reference mel_style_encoder.MelStyleEncoder (mel_style_encoder.py:121).

    shared.0 = stem conv, shared.1..4 = ResBlks, shared.6 = post conv,
    unshared = output Linear.
    """

    def sn_conv(base) -> Params:
        w = np.asarray(sd[f"{base}.weight"])
        out: Params = {"kernel": w.transpose(2, 3, 1, 0)}
        if f"{base}.bias" in sd:
            out["bias"] = np.asarray(sd[f"{base}.bias"])
        return out

    def res_blk(base) -> Params:
        out: Params = {
            "conv1": sn_conv(f"{base}.conv1"),
            "conv2": sn_conv(f"{base}.conv2"),
        }
        if f"{base}.conv1x1.weight" in sd:
            out["conv1x1"] = sn_conv(f"{base}.conv1x1")
        if f"{base}.downsample_res.conv.weight" in sd:
            out["down"] = sn_conv(f"{base}.downsample_res.conv")
        return out

    core: Params = {
        "stem": sn_conv("shared.0"),
        "post": sn_conv("shared.6"),
        "out": dense(sd, "unshared"),
    }
    for i in range(4):
        core[f"res_{i}"] = res_blk(f"shared.{i + 1}")
    return {"core": core}


def convert_pitch_style_encoder(sd) -> Params:
    """reference mel_style_encoder.PitchStyleEncoder (mel_style_encoder.py:155)."""
    out = convert_mel_style_encoder(sd)
    out["preconv"] = dense_from_conv1(sd, "preconv")
    return out


def convert_spec_discriminator(sd) -> Params:
    """reference discriminator.SpecDiscriminator (discriminator.py:13-68)."""
    out: Params = {}
    for i in range(5):
        out[f"conv_{i}"] = conv(sd, f"discriminators.{i}")
        out[f"out_{i}"] = conv(sd, f"out.{i}")
    return out


def convert_context_free_discriminator(sd) -> Params:
    """reference discriminator.ContextFreeDiscriminator (discriminator.py:116)."""

    def block(base) -> Params:
        return {
            "conv": conv1d_w(sd, f"{base}.net.0"),
            "norm": affine_norm(sd, f"{base}.net.1"),
        }

    return {
        "conv0": block("conv.0"),
        "conv1": block("conv.1"),
        "conv2": block("conv.2"),
        "conv3": block("conv.3"),
        "attn_fc": dense_from_conv1(sd, "attn.1"),
        "t0": block("temporal.0"),
        "t1": block("temporal.1"),
        "s0": block("spectral.0"),
        "s1": block("spectral.1"),
        "fusion": block("fusion"),
        "last0": dense_from_conv1(sd, "last.0"),
        "last1": dense_from_conv1(sd, "last.2"),
    }


def convert_pitch_discriminator(sd) -> Params:
    """reference pitch_discriminator.PitchDiscriminator."""
    out: Params = {}
    for i in range(5):
        out[f"conv_{i}"] = conv1d_w(sd, f"discriminators.{i}")
        out[f"out_{i}"] = conv1d_w(sd, f"out.{i}")
    return out


def convert_text_aligner(sd) -> Params:
    """reference text_aligner.tdnn_blstm_ctc_model_base (text_aligner.py:33).

    encoder.layers.{0,1,2}.0 = TDNN convs, .2 = BatchNorm(affine=False);
    encoder.layers.3.ffn.{0,3,6,9,12} = FFN linears; encoder_output_layer.
    """
    out: Params = {"out": dense(sd, "encoder_output_layer")}
    for i in range(3):
        out[f"tdnn_{i}"] = conv1d_w(sd, f"encoder.layers.{i}.0")
        out[f"tdnn_norm_{i}"] = affine_norm(sd, f"encoder.layers.{i}.2")
    for i in range(5):
        out[f"ffn_{i}"] = dense(sd, f"encoder.layers.3.ffn.{i * 3}")
    return out


def convert_prosody_encoder(sd, n_layers: int = 3) -> Params:
    """reference prosody_encoder.ProsodyEncoder (prosody_encoder.py:10-81)."""
    out: Params = {}
    for i in range(n_layers):
        out[f"attn_{i}"] = mha(sd, f"attn_layers.{i}")
        out[f"norm1_{i}"] = film(sd, f"norm_layers_1.{i}")
        out[f"ffn_{i}"] = conv_ffn(sd, f"ffn_layers.{i}")
        out[f"norm2_{i}"] = film(sd, f"norm_layers_2.{i}")
        out[f"proj_{i}"] = dense_from_conv1(sd, f"proj_layers.{i}")
    return out


def convert_duration_predictor(sd, text_layers: int, n_layer: int) -> Params:
    """reference duration_predictor.DurationPredictor (duration_predictor.py:15)."""
    out: Params = {
        "text_encoder": convert_text_encoder(_sub(sd, "text_encoder"), text_layers),
        "query_norm": film(sd, "query_norm"),
        "key_norm": film(sd, "key_norm"),
        "cross_attention": mha(sd, "cross_attention"),
        "cross_post_dw": conv1d_w(sd, "cross_post.0"),
        "cross_post_pw": dense_from_conv1(sd, "cross_post.2"),
        "duration_proj": dense(sd, "duration_proj.linear_layer"),
    }
    for i in range(n_layer):
        out[f"convnext_{i}"] = adaptive_convnext_block(sd, f"conv_next.{i}")
    return out


def convert_pitch_energy_predictor(sd, text_layers: int) -> Params:
    """reference pitch_energy_predictor.PitchEnergyPredictor."""
    out: Params = {
        "text_encoder": convert_text_encoder(_sub(sd, "text_encoder"), text_layers),
        "prosody_encoder": convert_prosody_encoder(_sub(sd, "prosody_encoder")),
        "f0_proj": dense_from_conv1(sd, "F0_proj"),
        "n_proj": dense_from_conv1(sd, "N_proj"),
    }
    for i in range(4):
        out[f"f0_{i}"] = ada_decoder_block(sd, f"F0.{i}")
        out[f"n_{i}"] = ada_decoder_block(sd, f"N.{i}")
    return out


def convert_speech_predictor(
    sd, text_layers: int, conformer_layers: int, conv_layers: int
) -> Params:
    """reference speech_predictor.SpeechPredictor (speech_predictor.py:11-73)."""
    return {
        "text_encoder": convert_text_encoder(_sub(sd, "text_encoder"), text_layers),
        "decoder": convert_decoder(_sub(sd, "decoder")),
        "generator": convert_multi_generator(
            _sub(sd, "generator"), conformer_layers, conv_layers
        ),
    }
