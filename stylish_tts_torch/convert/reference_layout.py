"""A seeded checkpoint in the reference's accelerate layout.

The inverse of ``convert/torch_import.py``: each ``_Inverse`` method undoes
one converter's rule, so that the import of what it writes gives back the
tree it started from. Structural only, as ``dataprep/rmvpe.py``
``random_rmvpe_state_dict`` is for RMVPE: the keys and layouts are those
the converters read, the values seeded numpy, and no reference module is
built. ``random_reference_checkpoint`` writes the 13 ``pytorch_model.bin``
/ ``pytorch_model_{i}.bin`` files of an accelerate ``save_state``
directory, in ``REFERENCE_MODEL_ORDER``, as ``torch.save`` of plain tensors
(``torch.load(weights_only=True)`` reads them).

The values start as a flax-layout tree of the port's modules under
``imported_weights`` (shapes from ``module_jax_shapes``; kernels N(0,
1/(3 fan_in)), torch's default-init variance; embeddings N(0, 1/dim);
scales, snake and alpha parameters 1 + N(0, 0.01); biases, GRN gamma/beta
N(0, 0.01)), and each rule is then inverted:

* conv kernels (K, I, O) -> weights (O, I, K), (Kh, Kw, I, O) -> (O, I, Kh,
  Kw); Dense -> Linear (O, I); a pointwise Dense -> a 1x1 Conv1d (O, I, 1);
  the text encoder's LayerNorm -> ``gamma`` / ``beta``; per-channel
  (1, 1, C) alphas -> (1, C, 1);
* the three reparametrizations at the sites the folding docstring cites.
  Weight norm (``<base>.parametrizations.weight.original0`` / ``original1``)
  on every ``AdaptiveGeneratorBlock`` conv and on the ringformer ``ups``:
  v is the kernel and g = ||v|| (1 + 0.1 N(0, 1)), so folding moves the
  weight. Spectral norm (``weight_orig``, ``weight_u``, ``weight_v``) on
  every conv of the three style encoders, u and v from a few power
  iterations, so that sigma is near the top singular value. BatchNorm
  running statistics (mean N(0, 0.5), variance U(0.5, 2), and
  ``num_batches_tracked``) at the conformers' ``net.4`` and the
  ``ContextFreeDiscriminator`` blocks' ``net.1`` (affine: the tree's scale
  and bias as gamma and beta) and at the aligner's TDNN norms
  (``affine=False``: no weight, no bias).

So the plain sites import back to the tree bitwise; the reparametrized
ones import to what their folds give.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from .from_jax import module_jax_shapes

POWER_ITERATIONS = 5


def _seeded_tree(module: torch.nn.Module, rng: np.random.Generator) -> Dict:
    """The flax-layout tree of ``module`` (below ``params``), seeded by leaf
    name."""
    from ..utils.params_io import unflatten

    flat = {}
    for path, shape in module_jax_shapes(module).items():
        name = path.rsplit("/", 1)[-1]
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            value = noise / np.float32(np.sqrt(3.0 * np.prod(shape[:-1])))
        elif name == "embedding":
            value = noise / np.float32(np.sqrt(shape[-1]))
        elif name in ("scale", "snake") or name.startswith("alpha"):
            value = 1.0 + 0.1 * noise
        elif name in ("bias", "beta", "gamma"):
            value = 0.1 * noise
        else:
            raise KeyError(f"no fill rule for the flax leaf {path!r}")
        flat[path[len("params/"):]] = value
    return unflatten(flat)


def _count(tree: Mapping, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit())


class _Inverse:
    """Writes one module's reference state_dict from its flax tree; the
    methods mirror ``torch_import``'s helpers and converters by name."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.sd: Dict[str, np.ndarray] = {}

    def _put(self, key: str, value) -> None:
        if key in self.sd:
            raise KeyError(f"{key} written twice")
        self.sd[key] = np.ascontiguousarray(value, dtype=np.float32)

    # ------------------------------------------------------------ helpers

    def _weight(self, base: str, w: np.ndarray, reparam: str | None) -> None:
        if reparam == "weight_norm":
            axes = tuple(range(1, w.ndim))
            norm = np.sqrt(np.sum(np.square(w, dtype=np.float64), axis=axes, keepdims=True))
            g = norm * (1.0 + 0.1 * self.rng.standard_normal(norm.shape))
            self._put(f"{base}.parametrizations.weight.original0", g)
            self._put(f"{base}.parametrizations.weight.original1", w)
        elif reparam == "spectral_norm":
            w_mat = w.reshape(w.shape[0], -1).astype(np.float64)
            u = self.rng.standard_normal(w_mat.shape[0])
            for _ in range(POWER_ITERATIONS):
                v = w_mat.T @ u
                v /= np.linalg.norm(v)
                u = w_mat @ v
                u /= np.linalg.norm(u)
            self._put(f"{base}.weight_orig", w)
            self._put(f"{base}.weight_u", u)
            self._put(f"{base}.weight_v", v)
        else:
            self._put(f"{base}.weight", w)

    def _bias(self, base: str, p: Mapping) -> None:
        if "bias" in p:
            self._put(f"{base}.bias", p["bias"])

    def conv(self, base: str, p: Mapping, reparam: str | None = None) -> None:
        k = np.asarray(p["kernel"])
        if k.ndim == 3:
            w = k.transpose(2, 1, 0)
        elif k.ndim == 4:
            w = k.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{base}: unexpected conv kernel ndim {k.ndim}")
        self._weight(base, w, reparam)
        self._bias(base, p)

    def conv1d_w(self, base: str, p: Mapping, reparam: str | None = None) -> None:
        self.conv(base, p["Conv_0"], reparam)

    def dense(self, base: str, p: Mapping) -> None:
        self._put(f"{base}.weight", np.asarray(p["kernel"]).T)
        self._bias(base, p)

    def dense_from_conv1(self, base: str, p: Mapping, reparam: str | None = None) -> None:
        self._weight(base, np.asarray(p["kernel"]).T[:, :, None], reparam)
        self._bias(base, p)

    def layer_norm(self, base: str, p: Mapping) -> None:
        self._put(f"{base}.weight", p["scale"])
        self._put(f"{base}.bias", p["bias"])

    def gamma_beta_norm(self, base: str, p: Mapping) -> None:
        self._put(f"{base}.gamma", p["scale"])
        self._put(f"{base}.beta", p["bias"])

    def batch_norm(self, base: str, p: Mapping | None = None, channels: int = 0) -> None:
        """Running statistics; with ``p``, its scale and bias as gamma and
        beta (an affine BatchNorm), without, ``channels`` of them and no
        weight or bias (``affine=False``)."""
        channels = p["scale"].shape[0] if p is not None else channels
        self._put(f"{base}.running_mean", 0.5 * self.rng.standard_normal(channels))
        self._put(f"{base}.running_var", self.rng.uniform(0.5, 2.0, channels))
        self.sd[f"{base}.num_batches_tracked"] = np.asarray(1000, dtype=np.int64)
        if p is not None:
            self._put(f"{base}.weight", p["scale"])
            self._put(f"{base}.bias", p["bias"])

    def film(self, base: str, p: Mapping) -> None:
        self.dense(f"{base}.fc", p["StyleFiLM_0"]["fc"])

    def channel(self, key: str, value) -> None:
        """A (1, 1, C) flax parameter stored (1, C, 1)."""
        self._put(key, np.asarray(value).transpose(0, 2, 1))

    # ------------------------------------------------------ shared blocks

    def ada_decoder_block(self, base: str, p: Mapping) -> None:
        self.film(f"{base}.norm1", p["norm1"])
        self.conv1d_w(f"{base}.conv1", p["conv1"])
        self.film(f"{base}.norm2", p["norm2"])
        self.conv1d_w(f"{base}.conv2", p["conv2"])
        if "shortcut" in p:
            self.conv1d_w(f"{base}.conv1x1", p["shortcut"])

    def ada_generator_block(self, base: str, p: Mapping) -> None:
        for i in range(3):
            self.channel(f"{base}.alpha1.{i}", p[f"alpha1_{i}"])
            self.channel(f"{base}.alpha2.{i}", p[f"alpha2_{i}"])
            self.film(f"{base}.adain1.{i}", p[f"adain1_{i}"])
            self.film(f"{base}.adain2.{i}", p[f"adain2_{i}"])
            self.conv1d_w(f"{base}.convs1.{i}", p[f"conv1_{i}"], "weight_norm")
            self.conv1d_w(f"{base}.convs2.{i}", p[f"conv2_{i}"], "weight_norm")

    def grn(self, base: str, p: Mapping) -> None:
        self._put(f"{base}.gamma", p["gamma"])
        self._put(f"{base}.beta", p["beta"])

    def generator_convnext_block(self, base: str, p: Mapping) -> None:
        self.adaptive_convnext_block(base, p)
        self._put(f"{base}.snake", p["snake"])

    def adaptive_convnext_block(self, base: str, p: Mapping) -> None:
        self.conv1d_w(f"{base}.dwconv", p["dwconv"])
        self.film(f"{base}.norm", p["norm"])
        self.dense(f"{base}.pwconv1", p["pwconv1"])
        self.grn(f"{base}.grn", p["GRN_0"])
        self.dense(f"{base}.pwconv2", p["pwconv2"])

    def mha(self, base: str, p: Mapping) -> None:
        for ref, ours in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out")):
            self.dense_from_conv1(f"{base}.conv_{ref}", p[ours])

    def conv_ffn(self, base: str, p: Mapping) -> None:
        self.conv1d_w(f"{base}.conv_1", p["conv1"])
        self.conv1d_w(f"{base}.conv_2", p["conv2"])

    def conformer_block(self, base: str, p: Mapping) -> None:
        for ff in ("ff1", "ff2"):
            self.film(f"{base}.{ff}.fn.norm", p[f"{ff}_norm"])
            self.dense(f"{base}.{ff}.fn.fn.net.0", p[ff]["Dense_0"])
            self.dense(f"{base}.{ff}.fn.fn.net.3", p[ff]["Dense_1"])
        self.film(f"{base}.attn.norm", p["attn_norm"])
        for name in ("to_q", "to_kv", "to_out"):
            self.dense(f"{base}.attn.fn.{name}", p["attn"][name])
        self.film(f"{base}.conv.norm", p["conv_norm"])
        conv = p["conv"]
        self.dense_from_conv1(f"{base}.conv.net.1", conv["pw_in"])
        self.conv1d_w(f"{base}.conv.net.3.conv", conv["dwconv"])
        self.batch_norm(f"{base}.conv.net.4", conv["bn"])
        self.dense_from_conv1(f"{base}.conv.net.6", conv["pw_out"])
        self.film(f"{base}.post_norm", p["post_norm"])

    def conformer(self, base: str, p: Mapping) -> None:
        for i in range(_count(p, "block_")):
            self.conformer_block(f"{base}.layers.{i}", p[f"block_{i}"])

    # ------------------------------------------------------------ modules

    def text_encoder(self, base: str, p: Mapping) -> None:
        self._put(f"{base}emb.weight", p["emb"]["embedding"])
        prenet = p["prenet"]
        self.dense_from_conv1(f"{base}prenet.proj", prenet["proj"])
        for i in range(_count(prenet, "conv_")):
            self.conv1d_w(f"{base}prenet.conv_layers.{i}", prenet[f"conv_{i}"])
            self.gamma_beta_norm(f"{base}prenet.norm_layers.{i}",
                                 prenet[f"norm_{i}"]["LayerNorm_0"])
        enc = p["encoder"]
        for i in range(_count(enc, "attn_")):
            self.mha(f"{base}encoder.attn_layers.{i}", enc[f"attn_{i}"])
            self.gamma_beta_norm(f"{base}encoder.norm_layers_1.{i}",
                                 enc[f"norm1_{i}"]["LayerNorm_0"])
            self.conv_ffn(f"{base}encoder.ffn_layers.{i}", enc[f"ffn_{i}"])
            self.gamma_beta_norm(f"{base}encoder.norm_layers_2.{i}",
                                 enc[f"norm2_{i}"]["LayerNorm_0"])
        self.dense_from_conv1(f"{base}proj_m", p["proj"])

    def decoder(self, base: str, p: Mapping) -> None:
        self.conv1d_w(f"{base}F0_conv", p["f0_conv"])
        self.conv1d_w(f"{base}N_conv", p["n_conv"])
        self.conv1d_w(f"{base}voiced_conv", p["voiced_conv"])
        self.ada_decoder_block(f"{base}encode", p["encode"])
        self.conv1d_w(f"{base}asr_res.0", p["asr_res"])
        for i in range(4):
            self.ada_decoder_block(f"{base}decode.{i}", p[f"decode_{i}"])

    def generator(self, base: str, p: Mapping) -> None:
        self.dense(f"{base}m_source.l_linear", p["source"]["merge"])
        for side in ("amp", "phase"):
            self.conv1d_w(f"{base}{side}_prior_conv", p[f"{side}_prior_conv"])
            self.ada_generator_block(f"{base}{side}_prior_block", p[f"{side}_prior_block"])
        self.layer_norm(f"{base}amp_final_layer_norm", p["amp_final_norm"])
        self.conv1d_w(f"{base}amp_output_conv", p["amp_output_conv"])
        self.conv1d_w(f"{base}phase_input_conv", p["phase_input_conv"])
        self.layer_norm(f"{base}phase_norm", p["phase_norm"])
        self.layer_norm(f"{base}phase_final_layer_norm", p["phase_final_norm"])
        self.conv1d_w(f"{base}phase_output_real_conv", p["phase_real_conv"])
        self.conv1d_w(f"{base}phase_output_imag_conv", p["phase_imag_conv"])
        for i in range(_count(p, "amp_convnext_")):
            self.generator_convnext_block(f"{base}amp_convnext.{i}", p[f"amp_convnext_{i}"])
        for i in range(_count(p, "upconv_")):
            self.conv1d_w(f"{base}upconvs.{i}", p[f"upconv_{i}"])
            self.generator_convnext_block(f"{base}upblocks.{i}", p[f"upblock_{i}"])
        for i in range(_count(p, "phase_convnext_")):
            self.generator_convnext_block(f"{base}phase_convnext.{i}",
                                          p[f"phase_convnext_{i}"])

    def multi_generator(self, base: str, p: Mapping) -> None:
        self.conv1d_w(f"{base}amp_input_conv", p["amp_input_conv"])
        self.layer_norm(f"{base}amp_norm", p["amp_norm"])
        self.conformer(f"{base}amp_conformer", p["amp_conformer"])
        self.generator(f"{base}basegen.", p["basegen"])

    def upsample_generator(self, p: Mapping, num_kernels: int = 3) -> None:
        self.conv1d_w("conv_post", p["conv_post"])
        n_up = _count(p, "up_")
        for i in range(n_up + 1):
            self.channel(f"alphas.{i}", p[f"alpha_{i}" if i < n_up else "alpha_post"])
        for i in range(n_up):
            up = p[f"up_{i}"]  # (k, in, out), pre-flipped along k
            self._weight(f"ups.{i}", np.asarray(up["kernel"])[::-1].transpose(1, 2, 0),
                         "weight_norm")
            self._put(f"ups.{i}.bias", up["bias"])
            self.conformer(f"conformers.{i}", p[f"conformer_{i}"])
            self.conv(f"noise_convs.{i}", p[f"noise_conv_{i}"])
            self.ada_generator_block(f"noise_res.{i}", p[f"noise_res_{i}"])
            for j in range(num_kernels):
                self.ada_generator_block(f"resblocks.{i * num_kernels + j}",
                                         p[f"resblock_{i}_{j}"])

    def mel_style_encoder(self, p: Mapping) -> None:
        core = p["core"]
        self.conv("shared.0", core["stem"], "spectral_norm")
        self.conv("shared.6", core["post"], "spectral_norm")
        self.dense("unshared", core["out"])
        for i in range(4):
            base, res = f"shared.{i + 1}", core[f"res_{i}"]
            self.conv(f"{base}.conv1", res["conv1"], "spectral_norm")
            self.conv(f"{base}.conv2", res["conv2"], "spectral_norm")
            if "conv1x1" in res:
                self.conv(f"{base}.conv1x1", res["conv1x1"], "spectral_norm")
            if "down" in res:
                self.conv(f"{base}.downsample_res.conv", res["down"], "spectral_norm")

    def pitch_style_encoder(self, p: Mapping) -> None:
        self.mel_style_encoder(p)
        self.dense_from_conv1("preconv", p["preconv"], "spectral_norm")

    def spec_discriminator(self, p: Mapping) -> None:
        for i in range(5):
            self.conv(f"discriminators.{i}", p[f"conv_{i}"])
            self.conv(f"out.{i}", p[f"out_{i}"])

    def context_free_discriminator(self, p: Mapping) -> None:
        for ref, ours in (("conv.0", "conv0"), ("conv.1", "conv1"), ("conv.2", "conv2"),
                          ("conv.3", "conv3"), ("temporal.0", "t0"), ("temporal.1", "t1"),
                          ("spectral.0", "s0"), ("spectral.1", "s1"), ("fusion", "fusion")):
            self.conv1d_w(f"{ref}.net.0", p[ours]["conv"])
            self.batch_norm(f"{ref}.net.1", p[ours]["norm"])
        self.dense_from_conv1("attn.1", p["attn_fc"])
        self.dense_from_conv1("last.0", p["last0"])
        self.dense_from_conv1("last.2", p["last1"])

    def pitch_discriminator(self, p: Mapping) -> None:
        for i in range(5):
            self.conv1d_w(f"discriminators.{i}", p[f"conv_{i}"])
            self.conv1d_w(f"out.{i}", p[f"out_{i}"])

    def text_aligner(self, p: Mapping) -> None:
        self.dense("encoder_output_layer", p["out"])
        for i in range(3):
            self.conv1d_w(f"encoder.layers.{i}.0", p[f"tdnn_{i}"])
            self.batch_norm(f"encoder.layers.{i}.2",
                            channels=p[f"tdnn_norm_{i}"]["scale"].shape[0])
        for i in range(5):
            self.dense(f"encoder.layers.3.ffn.{i * 3}", p[f"ffn_{i}"])

    def prosody_encoder(self, base: str, p: Mapping) -> None:
        for i in range(_count(p, "attn_")):
            self.mha(f"{base}attn_layers.{i}", p[f"attn_{i}"])
            self.film(f"{base}norm_layers_1.{i}", p[f"norm1_{i}"])
            self.conv_ffn(f"{base}ffn_layers.{i}", p[f"ffn_{i}"])
            self.film(f"{base}norm_layers_2.{i}", p[f"norm2_{i}"])
            self.dense_from_conv1(f"{base}proj_layers.{i}", p[f"proj_{i}"])

    def duration_predictor(self, p: Mapping) -> None:
        self.text_encoder("text_encoder.", p["text_encoder"])
        self.film("query_norm", p["query_norm"])
        self.film("key_norm", p["key_norm"])
        self.mha("cross_attention", p["cross_attention"])
        self.conv1d_w("cross_post.0", p["cross_post_dw"])
        self.dense_from_conv1("cross_post.2", p["cross_post_pw"])
        self.dense("duration_proj.linear_layer", p["duration_proj"])
        for i in range(_count(p, "convnext_")):
            self.adaptive_convnext_block(f"conv_next.{i}", p[f"convnext_{i}"])

    def pitch_energy_predictor(self, p: Mapping) -> None:
        self.text_encoder("text_encoder.", p["text_encoder"])
        self.prosody_encoder("prosody_encoder.", p["prosody_encoder"])
        self.dense_from_conv1("F0_proj", p["f0_proj"])
        self.dense_from_conv1("N_proj", p["n_proj"])
        for i in range(4):
            self.ada_decoder_block(f"F0.{i}", p[f"f0_{i}"])
            self.ada_decoder_block(f"N.{i}", p[f"n_{i}"])

    def speech_predictor(self, p: Mapping) -> None:
        self.text_encoder("text_encoder.", p["text_encoder"])
        self.decoder("decoder.", p["decoder"])
        self.multi_generator("generator.", p["generator"])


# registry name -> the _Inverse method that writes its state_dict
INVERSES = {
    "text_aligner": "text_aligner",
    "duration_predictor": "duration_predictor",
    "pitch_energy_predictor": "pitch_energy_predictor",
    "speech_predictor": "speech_predictor",
    "disc": "context_free_discriminator",
    "mrd0": "spec_discriminator",
    "mrd1": "spec_discriminator",
    "mrd2": "spec_discriminator",
    "speech_style_encoder": "mel_style_encoder",
    "pe_style_encoder": "pitch_style_encoder",
    "duration_style_encoder": "mel_style_encoder",
    "pitch_disc": "pitch_discriminator",
    "dur_disc": "pitch_discriminator",
}


def reference_models(mc: ModelConfig) -> Dict[str, torch.nn.Module]:
    """The 13 modules of an imported checkpoint, on the ``meta`` device
    (shapes only), in ``REFERENCE_MODEL_ORDER``."""
    from ..models import build_models, build_text_aligner
    from .checkpoint_import import REFERENCE_MODEL_ORDER

    mc = mc.model_copy(deep=True)
    mc.imported_weights = True
    with torch.device("meta"):
        models = {**build_models(mc), "text_aligner": build_text_aligner(mc)}
    return {name: models[name] for name in REFERENCE_MODEL_ORDER}


def reference_state_dicts(mc: ModelConfig, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Seeded reference state_dicts of the 13 models (numpy), with the flax
    trees they were inverted from: ``({name: state_dict}, {name: tree})``."""
    rng = np.random.default_rng(seed)
    sds, trees = {}, {}
    for name, module in reference_models(mc).items():
        trees[name] = _seeded_tree(module, rng)
        inv = _Inverse(rng)
        getattr(inv, INVERSES[name])(trees[name])
        sds[name] = inv.sd
    return sds, trees


def write_accelerate_checkpoint(out_dir: str, state_dicts: Mapping[str, Mapping]) -> list:
    """``torch.save`` of each state_dict as plain tensors, named as
    accelerate's ``save_state`` names them, in ``REFERENCE_MODEL_ORDER``.
    Returns the paths."""
    from .checkpoint_import import REFERENCE_MODEL_ORDER, accelerate_model_file

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, name in enumerate(REFERENCE_MODEL_ORDER):
        path = accelerate_model_file(out_dir, i)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in state_dicts[name].items()},
                   path)
        paths.append(path)
    return paths


def random_reference_checkpoint(out_dir: str, mc: ModelConfig, seed: int = 0) -> list:
    """A seeded accelerate checkpoint of model config ``mc`` in ``out_dir``;
    returns the 13 paths."""
    return write_accelerate_checkpoint(out_dir, reference_state_dicts(mc, seed)[0])


def random_reference_upsample_generator(module: torch.nn.Module, seed: int = 0
                                        ) -> Dict[str, np.ndarray]:
    """The reference ``generator.UpsampleGenerator`` state_dict (the
    ringformer vocoder) of the port's ``UpsampleGenerator(faithful=True)``
    ``module``: weight-normed ``ups``, BatchNorm at the conformers'
    ``net.4``; ``convert_upsample_generator`` reads it."""
    rng = np.random.default_rng(seed)
    inv = _Inverse(rng)
    inv.upsample_generator(_seeded_tree(module, rng), num_kernels=module.n_kernels)
    return inv.sd

