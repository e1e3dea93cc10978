"""The synthesis slice as a whole: inference packages shared by the JAX
package and the port, and the port's InferencePackage paths.

* A package written by the JAX ``export_checkpoint`` loads in the port;
  its durations equal the JAX duration function's (1e-4 absolute) and
  give the same frame bucket.
* The port's acoustic phase equals the JAX acoustic function, composed as
  ``InferencePackage._acoustic_fn_and_args`` composes it, with one
  change: an injected broadband prior instead of the stochastic source
  (no shared RNG stream; the deterministic harmonic prior's round-off
  phases are not comparable, see tests/test_torch_generator.py).
  Tolerance: pitch and energy 1e-4 * max |JAX|; audio 5e-4 absolute (the
  pitch that drives the decoder carries the pitch/energy predictor's own
  float32 error, ~1e-4 * max on both sides against float64, see
  tests/test_torch_text_predictors.py; the generator alone holds 1e-4).
* In the port: fused equals two-phase when the bucket fits (2e-4, the
  JAX package's own tolerance there); a batch row equals the single call
  when the buckets match (5e-4 as above: a batch of 3 runs other conv and
  matmul algorithms than a batch of 1, and the whole chain amplifies the
  difference); the same request gives the same audio.
* A package written by the port loads in the JAX ``InferencePackage``,
  with the same durations (1e-4 absolute).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylish_tts_tpu.export import package as jax_package_module
from stylish_tts_tpu.export.package import InferencePackage as JaxPackage
from stylish_tts_tpu.export.package import export_checkpoint as jax_export
from stylish_tts_tpu.models import build_model
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_torch.export.package import (
    InferencePackage, duration_stats_from_cache, export_checkpoint,
)
from stylish_tts_torch.export.programs import frame_bucket, text_bucket
from stylish_tts_torch.models import build_models
from stylish_tts_torch.trainer.normalization import NormalizationStats
from test_torch_synth_common import jax_params, port_config, randn, tiny_jax_config

LINES = ("ɔnðə kˈɑːntɹɛɹi", "hɛlˈoʊ wˈɝːld ɐɡˈɛn")
HOP = 300


@pytest.fixture(scope="module")
def jax_package(tmp_path_factory):
    """Tiny seeded weights (``jax_params``) written by the JAX export."""
    mc = tiny_jax_config()
    models = build_model(mc)
    L, F = 12, 8
    texts, lengths = jnp.ones((1, L), jnp.int32), jnp.full((1,), L, jnp.int32)
    align = jnp.ones((1, L, F)) / L
    pitch, energy = jnp.full((1, F), 150.0), jnp.zeros((1, F))
    style = jnp.zeros((1, mc.style_dim))
    style_mel = jnp.zeros((1, mc.style_encoder.n_mels, F))
    inits = {
        "duration_predictor": lambda k: models["duration_predictor"].init(
            k, texts, lengths, style),
        "pitch_energy_predictor": lambda k: models["pitch_energy_predictor"].init(
            k, texts, lengths, align, style),
        "speech_predictor": lambda k: models["speech_predictor"].init(
            {"params": k}, texts, lengths, align, pitch, energy, jnp.ones((1, F)),
            style, pitch, rng=k),
    }
    params = {name: jax_params(fn, seed=i) for i, (name, fn) in enumerate(inits.items())}
    # synthesis runs no style encoder (``voicepack`` does): the JAX writer
    # gets zeros of their shapes
    style_inits = {
        "speech_style_encoder": lambda k: models["speech_style_encoder"].init(k, style_mel),
        "pe_style_encoder": lambda k: models["pe_style_encoder"].init(
            k, style_mel, pitch, energy),
        "duration_style_encoder": lambda k: models["duration_style_encoder"].init(
            k, style_mel),
    }
    for name, fn in style_inits.items():
        shapes = jax.eval_shape(fn, jax.random.PRNGKey(0))
        params[name] = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    out = jax_export(params, mc, JaxNorm(), str(tmp_path_factory.mktemp("jaxpkg") / "pkg"))
    return out, JaxPackage(out), InferencePackage(out, device="cpu")


def _styles(mc, seed):
    return [randn((mc.style_dim,), seed + i) for i in range(3)]


def _jax_durations(jpkg, tokens, dur_style):
    n = tokens.shape[0]
    L = text_bucket(n)
    texts = np.zeros((1, L), np.int32)
    texts[0, :n] = tokens
    out = jpkg._duration_fn(L)(jpkg.params["duration_predictor"], jnp.asarray(texts),
                               jnp.asarray([n], jnp.int32), jnp.asarray(dur_style)[None])
    return texts, np.array(out)


def _port_durations(pkg, texts, n, dur_style):
    with torch.no_grad():
        return pkg.durations(torch.from_numpy(texts).long(), torch.tensor([n]),
                             torch.from_numpy(dur_style)[None]).numpy()


def test_jax_package_durations_in_the_port(jax_package):
    _, jpkg, pkg = jax_package
    for i, line in enumerate(LINES):
        tokens = pkg.tokenize(line)
        np.testing.assert_array_equal(tokens, jpkg.tokenize(line))
        _, _, dur_style = _styles(pkg.mc, 10 * i)
        texts, ref = _jax_durations(jpkg, tokens, dur_style)
        ours = _port_durations(pkg, texts, tokens.shape[0], dur_style)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
        assert frame_bucket(int(round(float(ours.sum())))) == \
            frame_bucket(int(round(float(ref.sum()))))


def test_acoustic_phase_matches_jax(jax_package):
    _, jpkg, pkg = jax_package
    mc = pkg.mc
    tokens = pkg.tokenize(LINES[1])
    speech_style, pe_style, dur_style = _styles(mc, 20)
    texts, durations = _jax_durations(jpkg, tokens, dur_style)
    total = int(round(float(durations.sum())))
    F = frame_bucket(total)
    prior = np.tanh(randn((1, F * HOP), 21, 0.3))
    lengths = np.array([tokens.shape[0]], np.int32)

    # the JAX acoustic function as _acoustic_fn_and_args composes it
    dp = jpkg.duration_processor
    alignment = dp.duration_to_alignment(jnp.asarray(durations), F)
    def acoustic(pe_params, sp_params):
        pitch, energy = jpkg.models["pitch_energy_predictor"].apply(
            pe_params, jnp.asarray(texts), jnp.asarray(lengths), alignment,
            jnp.asarray(pe_style)[None])
        voiced = (pitch > 20.0).astype(jnp.float32)
        audio = jpkg.models["speech_predictor"].apply(
            sp_params, jnp.asarray(texts), jnp.asarray(lengths), alignment, pitch, energy,
            voiced, jnp.asarray(speech_style)[None], pitch, rng=jax.random.PRNGKey(0),
            prior=jnp.asarray(prior)).audio
        return pitch, energy, audio

    ref_pitch, ref_energy, ref_audio = jax.jit(acoustic)(
        jpkg.params["pitch_energy_predictor"], jpkg.params["speech_predictor"])
    # the voiced threshold must not sit inside the tolerance
    assert np.abs(np.asarray(ref_pitch) - 20.0).min() > 1e-2

    t_texts, t_lengths = torch.from_numpy(texts).long(), torch.from_numpy(lengths).long()
    with torch.no_grad():
        t_align = pkg.duration_processor.duration_to_alignment(
            torch.from_numpy(durations), F)
        pitch, energy = pkg.models["pitch_energy_predictor"](
            t_texts, t_lengths, t_align, torch.from_numpy(pe_style)[None])
    for ours, ref in ((pitch, ref_pitch), (energy, ref_energy)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    audio = pkg.acoustic(t_texts, t_lengths, torch.from_numpy(durations),
                         torch.from_numpy(pe_style)[None],
                         torch.from_numpy(speech_style)[None], F,
                         prior=torch.from_numpy(prior))
    assert audio.shape == (1, F * HOP)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), rtol=0, atol=5e-4)


def test_fused_equals_two_phase(jax_package):
    _, _, pkg = jax_package
    tokens = pkg.tokenize(LINES[0])
    styles = _styles(pkg.mc, 30)
    pkg.duration_stats = None
    assert pkg._fused_frame_bucket(len(tokens), 1.0) is None
    two = pkg.generate_speech(tokens, *styles, fused=False)
    np.testing.assert_array_equal(two, pkg.generate_speech(tokens, *styles))
    np.testing.assert_array_equal(two, pkg.generate_speech(tokens, *styles, fused=False))
    with pytest.raises(ValueError):
        pkg.generate_speech(tokens, *styles, fused=True)
    assert two.ndim == 1 and two.shape[0] % HOP == 0 and np.isfinite(two).all()
    assert np.abs(two).max() <= 1.0

    F2 = frame_bucket(two.shape[0] // HOP)
    try:
        pkg.duration_stats = {"frames_per_token_p95": (F2 - 50) / len(tokens)}
        assert pkg._fused_frame_bucket(len(tokens), 1.0) == F2
        fused = pkg.generate_speech(tokens, *styles)
        assert fused.shape == two.shape
        np.testing.assert_allclose(fused, two, rtol=2e-4, atol=2e-4)
        # overflow: a bucket far below the prediction squeezes the durations
        pkg.duration_stats = {"frames_per_token_p95": 1.0 / len(tokens)}
        squeezed = pkg.generate_speech(tokens, *styles, fused=True)
        assert 0 < squeezed.shape[0] <= 100 * HOP and np.isfinite(squeezed).all()
    finally:
        pkg.duration_stats = None
    slow = pkg.generate_speech(tokens, *styles, speed=0.5)
    assert slow.shape[0] > two.shape[0]


def test_batch_row_equals_single(jax_package):
    _, _, pkg = jax_package
    t1, t2 = (pkg.tokenize(line) for line in LINES)
    styles = _styles(pkg.mc, 40)
    wavs = pkg.generate_speech_batch([t2, t1, t2], *styles)
    singles = {id(t): pkg.generate_speech(t, *styles, fused=False) for t in (t1, t2)}
    batch_frames = frame_bucket(max(w.shape[0] for w in wavs) // HOP)
    compared = 0
    for w, tok in zip(wavs, (t2, t1, t2)):
        single = singles[id(tok)]
        assert w.shape == single.shape and np.isfinite(w).all()
        if frame_bucket(single.shape[0] // HOP) == batch_frames:
            np.testing.assert_allclose(w, single, rtol=0, atol=5e-4)
            compared += 1
    assert compared >= 2
    # identical requests in one batch: the same random source per row
    np.testing.assert_allclose(wavs[0], wavs[2], rtol=0, atol=5e-4)


def test_port_package_read_by_jax(tmp_path):
    jmc = tiny_jax_config()
    torch.manual_seed(3)
    mc = port_config(jmc)
    out = export_checkpoint(build_models(mc), mc, NormalizationStats(),
                            str(tmp_path / "pkg"))
    jpkg = JaxPackage(out)
    pkg = InferencePackage(out, device="cpu")
    tokens = pkg.tokenize(LINES[0])
    _, _, dur_style = _styles(mc, 50)
    texts, ref = _jax_durations(jpkg, tokens, dur_style)
    ours = _port_durations(pkg, texts, tokens.shape[0], dur_style)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert (ours[0, :tokens.shape[0]] > 0).all()


def test_buckets_and_duration_stats_equal_jax():
    for n in (1, 32, 33, 200, 512):
        assert text_bucket(n) == jax_package_module.text_bucket(n)
    for f in (0, 1, 100, 101, 2999):
        assert frame_bucket(f) == jax_package_module.frame_bucket(f)
    with pytest.raises(ValueError):
        text_bucket(513)
    rng = np.random.default_rng(0)
    cache = {f"seg{i}": rng.uniform(1, 12, (1, int(rng.integers(3, 90)))).astype(np.float32)
             for i in range(50)}
    assert duration_stats_from_cache(cache) == \
        jax_package_module.duration_stats_from_cache(cache)
