"""A ringformer voice through the port's recipe on the CPU, against the JAX
package: ``train --stage acoustic`` (acoustic -> textual -> duration),
``convert``, ``voicepack`` and ``speak``, all through the CLI with
``--device cpu``, on ``tests/fixtures.py::make_micro_dataset`` at the tiny
config with ``generator.type: ringformer`` (upsample_initial_channel 64,
rates (4, 5), iSTFT n_fft 60 / hop 15), one epoch of 2 steps per stage,
the slm term off.

* Each stage runs its 2 steps; the acoustic steps report finite ``mag``
  and ``phase``.
* ``convert`` writes the JAX flat layout: each of the six modules' keys
  and shapes equal the JAX tree of the ringformer ``build_model`` (shapes
  from ``jax.eval_shape``); the JAX ``InferencePackage`` loads it.
* ``voicepack``'s styles equal the JAX ``encode_all_styles`` with the
  package's weights (1e-4 of each style's largest magnitude).
* The package's acoustic phase equals the JAX acoustic function (composed
  as ``InferencePackage._acoustic_fn_and_args`` composes it) with an
  injected broadband prior, patched into the JAX ``generate_pcph`` as in
  tests/test_torch_ringformer_step.py: audio 5e-4 absolute
  (tests/test_torch_package.py says why), the predicted F0 nowhere within
  1e-2 Hz of the 20 Hz voicing threshold.
* ``speak`` writes a finite wav within [-1, 1] whose length is a
  multiple of the hop; a batch row equals its single call (5e-4, as
  tests/test_torch_package.py holds the FreeGAN rows): each row's pcph
  phase comes from its own generator.
* A ``generator.scan_stacks`` FreeGAN model exports its ConvNeXt stacks in
  the JAX scan layout (keys and shapes of the JAX ``build_model`` tree),
  and the package loads back into the port bitwise.
* A package whose ringformer emits another number of samples per frame
  than ``hop_length`` is refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from flax.traverse_util import flatten_dict

from fixtures import make_micro_dataset
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.export.package import InferencePackage as JaxPackage
from stylish_tts_tpu.models import build_model
from stylish_tts_tpu.models import ringformer as jax_ringformer
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.tts import voicepack as jvoicepack
from stylish_tts_torch.cli import train_cli, tts_cli
from stylish_tts_torch.convert.from_jax import flatten, module_from_jax
from stylish_tts_torch.data.wav import read_wav
from stylish_tts_torch.export.package import InferencePackage, export_checkpoint
from stylish_tts_torch.export.programs import frame_bucket
from stylish_tts_torch.models import INFERENCE_MODULES, build_models
from stylish_tts_torch.trainer.checkpoint import checkpoint_dir_name
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.utils.params_io import load_params_safetensors
from test_torch_export_voicepack import STYLE_RTOL, _jax_dataset
from test_torch_package import _jax_durations, _styles
from test_torch_synth_common import port_config, randn, tiny_jax_config

STAGES = ("acoustic", "textual", "duration")
LINES = ("ɔnðə kˈɑːntɹɛɹi", "hɛlˈoʊ wˈɝːld ɐɡˈɛn")
HOP = 300


def ringformer_jax_config(scan_stacks=False) -> JaxModelConfig:
    mc = tiny_jax_config()
    if scan_stacks:
        mc.generator.scan_stacks = True
        return mc
    mc.generator.type = "ringformer"
    mc.generator.upsample_initial_channel = 64
    mc.generator.upsample_rates = [4, 5]
    mc.generator.gen_istft_n_fft = 60
    mc.generator.gen_istft_hop_size = 15
    return mc


def jax_tree_shapes(mc: JaxModelConfig):
    """{module: {flat key: shape}} of the six package modules' JAX trees."""
    models = build_model(mc)
    n_t, n_f = 12, 8
    texts, lengths = jnp.ones((1, n_t), jnp.int32), jnp.full((1,), n_t, jnp.int32)
    align = jnp.ones((1, n_t, n_f)) / n_t
    pitch, zeros = jnp.full((1, n_f), 150.0), jnp.zeros((1, n_f))
    style = jnp.zeros((1, mc.style_dim))
    mel = jnp.zeros((1, mc.style_encoder.n_mels, n_f))
    inits = {
        "duration_predictor": lambda k: models["duration_predictor"].init(
            k, texts, lengths, style),
        "pitch_energy_predictor": lambda k: models["pitch_energy_predictor"].init(
            k, texts, lengths, align, style),
        "speech_predictor": lambda k: models["speech_predictor"].init(
            {"params": k}, texts, lengths, align, pitch, zeros, jnp.ones((1, n_f)),
            style, pitch, rng=k),
        "speech_style_encoder": lambda k: models["speech_style_encoder"].init(k, mel),
        "pe_style_encoder": lambda k: models["pe_style_encoder"].init(k, mel, pitch, zeros),
        "duration_style_encoder": lambda k: models["duration_style_encoder"].init(k, mel),
    }
    return {name: {k: tuple(v.shape) for k, v in flatten_dict(
        jax.eval_shape(fn, jax.random.PRNGKey(0)), sep="/").items()}
        for name, fn in inits.items()}


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("ringformer")
    data = make_micro_dataset(str(root / "data"), n_train=4, n_val=2,
                              uniform_duration=True)
    plan = {"epochs": 1, "probe_batch_max": 2, "lr": 1e-4}
    cfg = {
        "training": {"log_interval": 1, "data_workers": 2, "val_interval": 2,
                     "save_interval": 2},
        "training_plan": {stage: plan for stage in STAGES},
        "dataset": {"path": data},
        "validation": {"sample_count": 1},
        "loss_weight": {"slm": 0.0},
    }
    (root / "config.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    mc = port_config(ringformer_jax_config())
    (root / "model.yml").write_text(yaml.safe_dump(mc.model_dump()), encoding="utf-8")
    runner = CliRunner()

    def run(cli, *args):
        result = runner.invoke(cli, list(args), standalone_mode=False)
        assert result.exit_code == 0, result.output + repr(result.exception)
        return result.return_value

    trainer = run(train_cli, "train", "--config", str(root / "config.yml"),
                  "--model-config", str(root / "model.yml"), "--out", str(root / "out"),
                  "--device", "cpu", "--stage", "acoustic", "--record-steps")
    ckpt = str(root / "out" / "duration" / checkpoint_dir_name(1, 2))
    run(train_cli, "convert", "--config", str(root / "config.yml"), "--checkpoint", ckpt,
        "--out", str(root / "pkg"))
    styles = run(train_cli, "voicepack", "--config", str(root / "config.yml"),
                 "--checkpoint", ckpt, "--out", str(root / "vp.safetensors"), "--device", "cpu")
    (root / "lines.txt").write_text("\n".join(LINES) + "\n", encoding="utf-8")
    run(tts_cli, "speak", "--model", str(root / "pkg"), "--voicepack",
        str(root / "vp.safetensors"), "--text", str(root / "lines.txt"),
        "--out", str(root / "out.wav"), "--device", "cpu")
    return root, trainer, mc, styles


def test_ringformer_trains_the_three_stages(recipe):
    root, trainer, _mc, _voicepack_styles = recipe
    assert len(trainer.step_metrics) == 6
    for i, stage in enumerate(STAGES):
        assert trainer.stage_manifests[stage].current_total_step == 2
        assert os.path.isdir(root / "out" / stage / checkpoint_dir_name(1, 2))
        for m in trainer.step_metrics[2 * i: 2 * i + 2]:
            assert all(np.isfinite(list(m.values())))
            assert ({"mag", "phase"} <= set(m)) == (stage == "acoustic")
    assert [v["stage"] for v in trainer.validations] == list(STAGES)


def test_convert_writes_the_jax_layout(recipe):
    root, _trainer, _mc, _voicepack_styles = recipe
    tree = load_params_safetensors(str(root / "pkg" / "params.safetensors"))
    want = jax_tree_shapes(ringformer_jax_config())
    assert set(tree) == set(INFERENCE_MODULES) == set(want)
    for name in INFERENCE_MODULES:
        assert {k: v.shape for k, v in flatten(tree[name]).items()} == want[name], name
    jpkg = JaxPackage(str(root / "pkg"))
    assert jpkg.mc.generator.type == "ringformer"


def test_voicepack_styles_match_jax(recipe):
    """The styles ``voicepack`` encodes against the JAX ``encode_all_styles``
    with the package's weights and normalization: each within 1e-4 of its
    largest magnitude (tests/test_torch_export_voicepack.py's tolerance)."""
    root, _trainer, _mc, styles = recipe
    jmc = ringformer_jax_config()
    meta = json.loads((root / "pkg" / "metadata.json").read_text(encoding="utf-8"))
    ref = jvoicepack.encode_all_styles(
        _jax_dataset(str(root / "data"), "train-list.txt"), build_model(jmc),
        load_params_safetensors(str(root / "pkg" / "params.safetensors")),
        JaxNorm(**meta["normalization"]), jmc)
    np.testing.assert_array_equal(styles["lengths"], ref["lengths"])
    for key in ("speech", "pe", "duration"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(styles[key], r, rtol=0,
                                   atol=STYLE_RTOL * float(np.abs(r).max()), err_msg=key)


def test_package_acoustic_matches_jax(recipe, monkeypatch):
    root, _trainer, _mc, _voicepack_styles = recipe
    jpkg = JaxPackage(str(root / "pkg"))
    pkg = InferencePackage(str(root / "pkg"), device="cpu")
    tokens = pkg.tokenize(LINES[1])
    speech_style, pe_style, dur_style = _styles(pkg.mc, 20)
    texts, durations = _jax_durations(jpkg, tokens, dur_style)
    frames = frame_bucket(int(round(float(durations.sum()))))
    prior = np.tanh(randn((1, frames * HOP), 21, 0.3))
    lengths = np.array([tokens.shape[0]], np.int32)
    monkeypatch.setattr(jax_ringformer, "generate_pcph",
                        lambda *args, **kwargs: jnp.asarray(prior))
    alignment = jpkg.duration_processor.duration_to_alignment(jnp.asarray(durations), frames)

    def acoustic(pe_params, sp_params):
        pitch, energy = jpkg.models["pitch_energy_predictor"].apply(
            pe_params, jnp.asarray(texts), jnp.asarray(lengths), alignment,
            jnp.asarray(pe_style)[None])
        voiced = (pitch > 20.0).astype(jnp.float32)
        audio = jpkg.models["speech_predictor"].apply(
            sp_params, jnp.asarray(texts), jnp.asarray(lengths), alignment, pitch, energy,
            voiced, jnp.asarray(speech_style)[None], pitch,
            rng=jax.random.PRNGKey(0)).audio
        return pitch, audio

    ref_pitch, ref_audio = jax.jit(acoustic)(jpkg.params["pitch_energy_predictor"],
                                             jpkg.params["speech_predictor"])
    assert np.abs(np.asarray(ref_pitch) - 20.0).min() > 1e-2
    audio = pkg.acoustic(torch.from_numpy(texts).long(), torch.from_numpy(lengths).long(),
                         torch.from_numpy(durations), torch.from_numpy(pe_style)[None],
                         torch.from_numpy(speech_style)[None], frames,
                         prior=torch.from_numpy(prior))
    assert audio.shape == (1, frames * HOP)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), rtol=0, atol=5e-4)


def test_speak_and_batch_rows(recipe):
    root, _trainer, mc, _voicepack_styles = recipe
    audio = read_wav(str(root / "out.wav"), mc.sample_rate)
    assert audio.ndim == 1 and audio.shape[0] > 0 and audio.shape[0] % HOP == 0
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    pkg = InferencePackage(str(root / "pkg"), device="cpu")
    pkg.duration_stats = None  # two-phase, as the batch path
    t1, t2 = (pkg.tokenize(line) for line in LINES)
    styles = _styles(mc, 40)
    wavs = pkg.generate_speech_batch([t2, t1, t2], *styles)
    batch_frames = frame_bucket(max(w.shape[0] for w in wavs) // HOP)
    compared = 0
    for w, tok in zip(wavs, (t2, t1, t2)):
        single = pkg.generate_speech(tok, *styles)
        assert w.shape == single.shape and np.isfinite(w).all()
        if frame_bucket(single.shape[0] // HOP) == batch_frames:
            np.testing.assert_allclose(w, single, rtol=0, atol=5e-4)
            compared += 1
    assert compared >= 2
    np.testing.assert_allclose(wavs[0], wavs[2], rtol=0, atol=5e-4)


def test_scan_stacks_package_round_trip(tmp_path):
    jmc = ringformer_jax_config(scan_stacks=True)
    mc = port_config(jmc)
    torch.manual_seed(5)
    models = build_models(mc)
    out = export_checkpoint(models, mc, NormalizationStats(), str(tmp_path / "pkg"))
    tree = load_params_safetensors(os.path.join(out, "params.safetensors"))
    want = jax_tree_shapes(jmc)
    for name in INFERENCE_MODULES:
        assert {k: v.shape for k, v in flatten(tree[name]).items()} == want[name], name
    assert any("amp_convnext_scan/block/" in k for k in want["speech_predictor"])
    pkg = InferencePackage(out, device="cpu")
    for name, module in pkg.models.items():
        for k, v in module.state_dict().items():
            assert torch.equal(v, models[name].state_dict()[k]), (name, k)
    sd = module_from_jax(models["speech_predictor"], tree["speech_predictor"])
    assert set(sd) == set(models["speech_predictor"].state_dict())


def test_package_refuses_a_ringformer_of_another_hop(recipe, tmp_path):
    _root, _trainer, mc, _voicepack_styles = recipe
    other = mc.model_copy(deep=True)
    other.generator.gen_istft_hop_size = 10  # 200 samples per frame
    torch.manual_seed(0)
    out = export_checkpoint(build_models(other), other, NormalizationStats(),
                            str(tmp_path / "pkg"))
    with pytest.raises(ValueError, match="samples per frame"):
        InferencePackage(out, device="cpu")
