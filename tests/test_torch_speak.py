"""The port's ``speak`` path: loudness, voicepacks, the hashed sentence
embedding and the CLI.

The numpy/scipy copies must give exactly the JAX package's outputs
(``assert_array_equal``; loudness to the last float bit, on the native
K-weighting pass and on the scipy path alike). ``speak --device
cpu`` writes a wav from a static voicepack (tiny config, random weights);
without ``--device`` it asks for CUDA and raises where there is none.
"""

import tracemalloc

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from scipy.signal import lfilter

from stylish_tts_tpu.textproc import embed as jembed
from stylish_tts_tpu.tts import loudness as jloudness
from stylish_tts_tpu.tts import voicepack as jvoicepack
from stylish_tts_torch import native
from stylish_tts_torch.cli import tts_cli
from stylish_tts_torch.data.wav import read_wav
from stylish_tts_torch.export.package import export_checkpoint
from stylish_tts_torch.export.programs import frame_bucket
from stylish_tts_torch.models import build_models
from stylish_tts_torch.textproc import embed
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.tts import loudness, voicepack
from test_torch_synth_common import port_config, tiny_jax_config

TEXTS = ["The quick brown fox.", "A second, longer sentence about the fox!",
         "hɛlˈoʊ wˈɝːld", "and the dog"]


def _styles(n=240, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "speech": rng.standard_normal((n, dim)).astype(np.float32),
        "pe": rng.standard_normal((n, dim)).astype(np.float32),
        "duration": rng.standard_normal((n, dim)).astype(np.float32),
        "lengths": rng.integers(5, 300, n).astype(np.int32),
    }


def _tone(seconds, rate, seed=1):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    return (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / rate)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


# 21.15 s and 38.25 s are a median and the longest book line at 24 kHz
# (the longest: 510 tokens x 6 frames x 300 samples); at 11025 Hz a 400 ms
# block (4410 samples) is not four 100 ms hops (1102 samples).
LINES = [
    pytest.param(0.2, 24000, id="0.2"),
    pytest.param(3.0, 24000, id="3.0"),
    pytest.param(21.15, 24000, id="21.15"),
    pytest.param(38.25, 24000, id="38.25"),
    pytest.param(3.0, 22050, id="3.0-22050"),
    pytest.param(3.0, 16000, id="3.0-16000"),
    pytest.param(3.0, 11025, id="3.0-11025"),
    pytest.param(38.25, 11025, id="38.25-11025"),
]


def _assert_equals_jax(seconds, rate, path):
    """Both entries give the JAX copy's bits, each call counted under ``path``."""
    audio = _tone(seconds, rate)
    before = dict(loudness.PATH)
    assert loudness.integrated_loudness(audio, rate) == \
        jloudness.integrated_loudness(audio, rate)
    np.testing.assert_array_equal(loudness.normalize_loudness(audio, rate),
                                  jloudness.normalize_loudness(audio, rate))
    counted = {k: v - before[k] for k, v in loudness.PATH.items()}
    assert counted == {"native": 0, "scipy": 0, path: 2}


@pytest.mark.parametrize("seconds, rate", LINES)
def test_loudness_equals_jax(seconds, rate):
    assert loudness._LIB is not None  # g++ is here: the native pass serves
    _assert_equals_jax(seconds, rate, "native")


@pytest.mark.parametrize("seconds, rate", LINES)
def test_loudness_scipy_path_equals_jax(seconds, rate, monkeypatch):
    """Where the native library cannot be built, scipy's two ``lfilter``
    passes serve, with the same bits."""
    monkeypatch.setattr(loudness, "_LIB", None)
    _assert_equals_jax(seconds, rate, "scipy")


@pytest.fixture(scope="module")
def loudness_lib(tmp_path_factory):
    build_dir = tmp_path_factory.mktemp("native")
    lib = native.build_loudness(build_dir)
    assert len(list(build_dir.glob("libstylish_loudness_*.so"))) == 1
    return lib


def _edge(kind):
    rng = np.random.default_rng(2)
    if kind == "zeros":
        return np.zeros(4800, np.float32)
    if kind.startswith("length-"):
        return rng.uniform(-1, 1, int(kind[7:])).astype(np.float32)
    if kind == "square":  # full scale, 110 Hz at 24 kHz
        return np.where(np.arange(24000) % 218 < 109, 1.0, -1.0).astype(np.float32)
    if kind == "subnormal":
        # float32 subnormals, then 4 s of zeros: the filters' decaying state
        # and the squares fall below 2.2e-308, subnormal in float64
        audio = np.zeros(96000, np.float32)
        audio[:100] = 1e-40 * rng.standard_normal(100)
        return audio
    audio = _tone(0.5, 24000)
    audio[1000] = np.nan if kind == "nan" else np.inf
    return audio


@pytest.mark.parametrize("signal, rate", [
    *[pytest.param(*p.values, id=f"line-{p.id}") for p in LINES],
    *[pytest.param(kind, 24000, id=kind) for kind in (
        "zeros", "length-1", "length-2", "length-3", "square", "subnormal", "nan", "inf")],
])
def test_native_k_weighting_equals_two_lfilter_passes(signal, rate, loudness_lib,
                                                      monkeypatch):
    audio = _tone(signal, rate) if isinstance(signal, float) else _edge(signal)
    monkeypatch.setattr(loudness, "_LIB", loudness_lib)
    (bs, as_), (bh, ah) = loudness._k_weighting_coeffs(rate)
    before = loudness.PATH["native"]
    sq = loudness._k_weighted_square(audio, rate)
    assert loudness.PATH["native"] == before + 1
    ref = lfilter(bh, ah, lfilter(bs, as_, audio.astype(np.float64))) ** 2
    assert sq.dtype == np.float64
    np.testing.assert_array_equal(sq, ref)


def test_loudness_blocks_take_no_block_matrix():
    """The block mean squares read a strided view of the squared signal.

    On a 38.25 s line at 24 kHz the allocation peak of `integrated_loudness`
    reads 1.02 times the float64 signal's bytes (the native pass's K-weighted
    signal squared, the one float64 array left); a gather of every block's
    samples into a (blocks, 9600) matrix read 12.9 times. The bound, 4 times,
    leaves room for scipy's path (2.0 times) and catches any per-block copy.
    """
    audio = _tone(38.25, 24000)
    signal_bytes = audio.shape[0] * 8
    tracemalloc.start()
    try:
        loudness.integrated_loudness(audio, 24000)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 * signal_bytes, peak / signal_bytes


def test_static_voicepack_equals_jax(tmp_path):
    styles = _styles()
    pack = voicepack.build_static_pack(styles)
    ref = jvoicepack.build_static_pack(styles)
    for key in ("speech", "pe", "duration"):
        np.testing.assert_array_equal(pack[key], ref[key])
    voicepack.save_static_voicepack(str(tmp_path / "vp.safetensors"), pack)
    loaded = jvoicepack.load_voicepack(str(tmp_path / "vp.safetensors"))
    ours = voicepack.load_voicepack(str(tmp_path / "vp.safetensors"))
    assert loaded["kind"] == ours["kind"] == "static"
    for count in (0, 7, 130, 600):
        for a, b in zip(voicepack.lookup_static_style(ours, count),
                        jvoicepack.lookup_static_style(loaded, count)):
            np.testing.assert_array_equal(a, b)


def test_hashed_embedding_and_dynamic_voicepack_equal_jax(tmp_path):
    ours = embed.get_embedder()(TEXTS)
    ref = np.stack([jembed._hashed_ngram_embed(t) for t in TEXTS])
    np.testing.assert_array_equal(ours, ref)
    styles = _styles(n=len(TEXTS))
    pack = voicepack.build_dynamic_pack(styles, TEXTS, embed.get_embedder())
    voicepack.save_dynamic_voicepack(str(tmp_path / "dyn.safetensors"), pack)
    loaded = jvoicepack.load_voicepack(str(tmp_path / "dyn.safetensors"))
    assert loaded["kind"] == "dynamic"
    query = embed.get_embedder()(["the brown fox"])[0]
    for a, b in zip(voicepack.lookup_dynamic_style(pack, query, k=2),
                    jvoicepack.lookup_dynamic_style(loaded, query, k=2)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    root = tmp_path_factory.mktemp("speak")
    torch.manual_seed(0)
    mc = port_config(tiny_jax_config())
    export_checkpoint(build_models(mc), mc, NormalizationStats(),
                      str(root / "pkg"))
    voicepack.save_static_voicepack(
        str(root / "vp.safetensors"), voicepack.build_static_pack(_styles(dim=mc.style_dim)))
    (root / "lines.txt").write_text("ɔnðə kˈɑːntɹɛɹi\n\nhɛlˈoʊ wˈɝːld ɐɡˈɛn\n",
                                    encoding="utf-8")
    return root, mc


def test_speak_on_the_cpu_writes_a_wav(package):
    root, mc = package
    out = root / "out.wav"
    result = CliRunner().invoke(tts_cli, [
        "speak", "--model", str(root / "pkg"), "--voicepack", str(root / "vp.safetensors"),
        "--text", str(root / "lines.txt"), "--out", str(out), "--device", "cpu",
    ])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert "(2 utterances)" in result.output
    # no duration stats: two-phase, both lines in text bucket 32
    assert "programs built while speaking: fused 0, duration 1, acoustic " in result.output
    audio = read_wav(str(out), mc.sample_rate)
    assert audio.ndim == 1 and audio.shape[0] > 0
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    assert audio.shape[0] % mc.hop_length == 0
    assert frame_bucket(audio.shape[0] // mc.hop_length) >= 100


def test_speak_without_device_needs_cuda(package):
    """``speak`` runs on ``cuda`` unless asked; it never carries on quietly
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, _ = package
    result = CliRunner().invoke(tts_cli, [
        "speak", "--model", str(root / "pkg"), "--voicepack", str(root / "vp.safetensors"),
        "--text", str(root / "lines.txt"), "--out", str(root / "x.wav"),
    ])
    assert result.exit_code != 0
    assert isinstance(result.exception, RuntimeError)
    assert "CUDA is not available" in str(result.exception)
    assert not (root / "x.wav").exists()
