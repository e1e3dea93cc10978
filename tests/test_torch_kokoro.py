"""Kokoro-82M in the port against its plain reference
(``ttsbench/reference/kokoro.py``: plain torch, Kokoro's unpadded batch-1
forward with the LSTM cell written out), on seeded random weights at cut
widths (2 ALBERT passes).

A module or a line run in a bucket larger than itself (the port) must
equal the unpadded forward of its own length: float32 module by module
with a written tolerance, and whole lines in float64, where the random
generator's chaos cannot hide a boundary error. The reference's bucket
path, which runs the port's own operations, is bitwise the port. A Kokoro
package exports, reloads and speaks the same samples, in process and
through ``speak``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from safetensors.torch import save_file

from stylish_tts_torch import cli
from stylish_tts_torch.cli import tts_cli
from stylish_tts_torch.config import KokoroConfig, ModelConfig
from stylish_tts_torch.data.wav import read_wav
from stylish_tts_torch.export import (
    InferencePackage, KokoroPackage, export_checkpoint, kokoro, open_package, package, programs,
)
from stylish_tts_torch.export.kokoro import FRAMES, load_voice, voice_row
from stylish_tts_torch.export.programs import BUILT, BucketPackage
from stylish_tts_torch.models import build_models
from stylish_tts_torch.models import kokoro as K
from stylish_tts_torch.tts.loudness import normalize_loudness
from ttsbench.reference import kokoro as R

SEED = 2**31 + 18
TINY = {
    "family": "kokoro", "hidden_dim": 32, "style_dim": 16, "n_layer": 2,
    "decoder_dim": 48, "asr_res_dim": 8,
    "plbert": {"hidden_size": 32, "num_attention_heads": 2, "intermediate_size": 64,
               "num_hidden_layers": 2, "embedding_size": 16},
    "istftnet": {"upsample_initial_channel": 32},
}
HEAD = {"weight_scale": 0.01, "frames_per_token": 3.0}
# float32, module by module: |port - reference| over the reference's peak
TOL32 = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny_config() -> KokoroConfig:
    return KokoroConfig.model_validate(TINY)


def both(dtype=torch.float32, seed=SEED):
    """(port modules, reference modules) from the reference's seeded
    weights."""
    cfg = tiny_config()
    ref = R.make_models(cfg.model_dump(), "cpu", seed, 150.0, HEAD)
    port = K.build_kokoro_models(cfg)
    for k, m in port.items():
        m.load_state_dict(ref[k].state_dict())
        m.eval().to(dtype)
        ref[k].to(dtype)
    return port, ref


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def pad_garbage(x: torch.Tensor, size: int, dim: int = -1) -> torch.Tensor:
    """``x`` padded along ``dim`` to ``size`` with large noise, which a
    padding-exact module must not read."""
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, 50.0 * torch.randn(shape, dtype=x.dtype)], dim=dim)


def line(n: int, seed: int = 0):
    rng = np.random.default_rng([seed, n])
    ids = torch.tensor([0] + list(rng.integers(1, 178, n)) + [0])
    ref_s = torch.tensor(0.5 * rng.standard_normal(2 * TINY["style_dim"]))
    return ids, ref_s


def bucketed(ids: torch.Tensor, L: int):
    texts = torch.zeros((1, L), dtype=torch.long)
    texts[0, :ids.shape[0]] = ids
    return texts, torch.tensor([ids.shape[0]])


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("dtype, tol", [(torch.float32, TOL32), (torch.float64, 1e-12)])
def test_length_lstm_matches_the_written_out_cell(dtype, tol):
    torch.manual_seed(1)
    lstm = K.LengthLSTM(12, 8).to(dtype)
    ref = R.BiLSTM(12, 8).to(dtype)
    ref.load_state_dict(lstm.state_dict())
    lengths = torch.tensor([7, 11, 3])
    x = torch.randn(3, 11, 12, dtype=dtype)
    with torch.no_grad():
        out = lstm(pad_garbage(x, 16, dim=1), lengths)
        for b, n in enumerate(lengths.tolist()):
            want = ref.unpadded(x[b, :n])
            assert gap(out[b, :n], want) < tol, b


@pytest.mark.parametrize("c_in, c_out, kernel, stride, padding",
                         [(8, 4, 20, 10, 5), (6, 3, 12, 6, 3), (5, 2, 6, 2, 2)])
def test_the_polyphase_transposed_conv_is_the_transposed_conv(c_in, c_out, kernel, stride,
                                                              padding):
    torch.manual_seed(5)
    conv = K.PolyphaseConvTranspose1d(c_in, c_out, kernel, stride, padding=padding).double()
    x = torch.randn(2, c_in, 17, dtype=torch.float64)
    with torch.no_grad():
        got = conv(x)
        want = torch.nn.ConvTranspose1d.forward(conv, x)
    assert got.shape == want.shape and gap(got, want) < 1e-14


def test_albert_in_a_bucket_matches_the_unpadded_encoder():
    port, ref = both()
    ids, _ = line(20)
    texts, lengths = bucketed(ids, 32)
    valid = K.text_valid(texts, lengths, torch.float32)
    with torch.no_grad():
        got = port["bert"](texts, valid)[0, :ids.shape[0]]
        want = ref["bert"](ids[None])[0]
    assert gap(got, want) < TOL32


@pytest.mark.parametrize("upsample", [False, True])
def test_adain_resblk_in_a_bucket_matches_the_unpadded_block(upsample):
    torch.manual_seed(2)
    block = K.AdainResBlk1d(8, 6, 4, upsample=upsample).eval()
    ref = R.AdainResBlk1d(8, 6, 4, upsample=upsample).eval()
    ref.load_state_dict(block.state_dict())
    n, size = 13, 20
    x, s = torch.randn(1, 8, n), torch.randn(1, 4)
    lengths = torch.tensor([n])
    out_n = 2 * n if upsample else n
    m_in = K.length_mask(lengths, size, x.dtype)
    m_out = K.length_mask(2 * lengths, 2 * size, x.dtype) if upsample else m_in
    with torch.no_grad():
        got = block(pad_garbage(x, size), s, m_in, m_out)[..., :out_n]
        want = ref(x, s)
    assert gap(got, want) < TOL32


def test_source_in_a_bucket_matches_the_unpadded_source():
    torch.manual_seed(3)
    src = K.SourceModuleHnNSF(24000, 300)
    ref = R.SourceModuleHnNSF(24000, 300)
    ref.load_state_dict(src.state_dict())
    n, size = 9, 14
    f0 = 150.0 + 40.0 * torch.randn(1, n)
    f0[0, 2] = 0.0  # an unvoiced frame
    noise = torch.randn(1, size * 300, 9)
    with torch.no_grad():
        got = src(pad_garbage(f0, size), torch.tensor([n]), noise)[:, :n * 300]
        want = ref.unpadded(f0, noise[:, :n * 300])
    assert gap(got, want) < TOL32


def decoder_inputs(port, n_frames, size, dtype):
    torch.manual_seed(4)
    hidden, style = TINY["hidden_dim"], TINY["style_dim"]
    asr = torch.randn(1, hidden, n_frames, dtype=dtype)
    f0 = 150.0 + 20.0 * torch.randn(1, 2 * n_frames, dtype=dtype)
    en = torch.randn(1, 2 * n_frames, dtype=dtype)
    s = torch.randn(1, style, dtype=dtype)
    noise = torch.randn(1, size * 600, 9, dtype=dtype)
    return asr, f0, en, s, noise


@pytest.mark.parametrize("part", ["generator", "decoder"])
def test_decoder_and_generator_in_a_bucket_match_the_unpadded_ones(part):
    port, ref = both(torch.float64)
    n, size = 23, 40
    asr, f0, en, s, noise = decoder_inputs(port, n, size, torch.float64)
    lengths = torch.tensor([n])
    samples = n * 600
    with torch.no_grad():
        if part == "generator":
            x = torch.randn(1, 32, 2 * n, dtype=torch.float64)
            got = port["decoder"].generator(pad_garbage(x, 2 * size), s, pad_garbage(f0, 2 * size),
                                            2 * lengths, noise)
            want = ref["decoder"].generator.unpadded(x, s, f0, noise[:, :samples])
        else:
            got = port["decoder"](pad_garbage(asr, size), pad_garbage(f0, 2 * size),
                                  pad_garbage(en, 2 * size), s, lengths, noise)
            want = ref["decoder"](asr, f0, en, s, noise[:, :samples])
    assert got.shape[1] == size * 600 and want.shape[1] == samples
    assert gap(got[:, :samples], want) < 1e-9


# ---------------------------------------------------------------- lines


def port_line(port, ids, ref_s, L, noise_frames=None):
    texts, lengths = bucketed(ids, L)
    dtype = ref_s.dtype
    with torch.no_grad():
        dur, d = K.durations(port, texts, lengths, ref_s[None], torch.tensor(1.0, dtype=dtype))
        f = int(dur.sum())
        F = noise_frames or ((f + 99) // 100) * 100
        noise = R.source_noise(1, F, 600, "cpu", dtype)
        audio = K.acoustic(port, texts, lengths, dur, d, ref_s[None], F, noise)
    return dur[0], audio[0], noise[0], (texts, lengths, dur, d, F, noise)


@pytest.mark.parametrize("n, L", [(5, 32), (17, 64), (38, 64), (40, 96)])
def test_a_bucketed_line_is_the_unpadded_forward_in_float64(n, L):
    """The four padding-exact points (the reverse LSTM from the line's
    end, valid-frame instance norms, zeros before the convs, the source's
    resampling and the STFT's reflection at the line's end): without any
    one of them the line reads far from the unpadded forward."""
    port, ref = both(torch.float64)
    ids, ref_s = line(n)
    dur, audio, noise, _ = port_line(port, ids, ref_s, L)
    with torch.no_grad():
        want_dur, want = R.forward_unpadded(ref, ids, ref_s, noise)
    assert torch.equal(dur[:ids.shape[0]], want_dur)
    assert torch.equal(dur[ids.shape[0]:], torch.zeros(L - ids.shape[0], dtype=dur.dtype))
    f = int(want_dur.sum())
    assert audio.shape[0] > f * 600 and want.shape[0] == f * 600
    assert gap(audio[:f * 600], want) < 1e-9


def test_the_reference_bucket_path_is_bitwise_the_port():
    port, ref = both(torch.float32)
    ids, ref_s = line(30, seed=5)
    ref_s = ref_s.float()
    dur, audio, _, (texts, lengths, _, d, F, noise) = port_line(port, ids, ref_s, 64)
    with torch.no_grad():
        want_dur, want_d = R.durations_bucket(ref, texts, lengths, ref_s[None],
                                              torch.tensor(1.0))
        want = R.acoustic_bucket(ref, texts, lengths, want_dur, want_d, ref_s[None], F, noise)
    assert torch.equal(dur, want_dur[0]) and torch.equal(d, want_d)
    assert torch.equal(audio, want[0])


def test_line_flops_count_the_recurrences_and_the_generator():
    count = R.LineFlops(tiny_config().model_dump())
    small, large = count(10, 30), count(10, 60)
    assert 0 < small < large
    assert count(10, 30) == small  # cached


# ---------------------------------------------------------------- package


def kokoro_package(tmp_path, vocab=None):
    cfg = tiny_config()
    if vocab:
        cfg = cfg.model_copy(update={"vocab": vocab})
    weights = R.make_weights(cfg.model_dump(), "cpu", SEED, 150.0, HEAD)
    models = build_models(cfg)
    for k, m in models.items():
        m.load_state_dict(weights[k])
    out = tmp_path / "pkg"
    export_checkpoint(models, cfg, None, str(out))
    return out


def test_a_kokoro_package_reloads_and_speaks_the_same_samples(tmp_path):
    out = kokoro_package(tmp_path)
    ids, ref_s = line(24, seed=7)
    ids, ref_s = ids.numpy().astype(np.int32), ref_s.float().numpy()
    first = open_package(str(out), device="cpu")
    assert isinstance(first, KokoroPackage)
    frames = dict(FRAMES)
    audio = first.generate_speech(ids, ref_s)
    assert FRAMES["real"] - frames["real"] == int(first.last_durations.sum())
    assert FRAMES["bucket"] - frames["bucket"] == 100
    assert audio.shape == (int(first.last_durations.sum()) * 600,)
    again = open_package(str(out), device="cpu").generate_speech(ids, ref_s)
    np.testing.assert_array_equal(audio, again)
    assert sorted(first._duration_fns) == [32] and sorted(first._acoustic_fns) == [(32, 100)]
    # the package's line is the reference's bucketed line
    ref = R.make_models(tiny_config().model_dump(), "cpu", SEED, 150.0, HEAD)
    texts, lengths = bucketed(torch.as_tensor(ids, dtype=torch.long), 32)
    with torch.no_grad():
        dur, d = R.durations_bucket(ref, texts, lengths, torch.as_tensor(ref_s)[None],
                                    torch.tensor(1.0))
        want = R.acoustic_bucket(ref, texts, lengths, dur, d, torch.as_tensor(ref_s)[None],
                                 100, R.source_noise(1, 100, 600, "cpu"))
    np.testing.assert_array_equal(audio, want[0, :audio.shape[0]].numpy())


def test_speak_with_a_kokoro_package(tmp_path):
    vocab = {c: i + 1 for i, c in enumerate("abcdefghij ")}
    out = kokoro_package(tmp_path, vocab)
    pack = R.make_voicepacks(1, SEED, width=2 * TINY["style_dim"])[0]
    save_file({"pack": torch.as_tensor(pack)}, str(tmp_path / "voice.safetensors"))
    (tmp_path / "lines.txt").write_text("abc def\n\nhij aab ccd\n", encoding="utf-8")
    result = CliRunner().invoke(tts_cli, [
        "speak", "--model", str(out), "--voicepack", str(tmp_path / "voice.safetensors"),
        "--text", str(tmp_path / "lines.txt"), "--out", str(tmp_path / "o.wav"),
        "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert "programs built while speaking: fused 0, duration 1, acoustic 1" in result.output
    assert "frames: real" in result.output
    pkg = open_package(str(out), device="cpu")
    want = []
    for text in ("abc def", "hij aab ccd"):
        ids = pkg.tokenize(text)
        assert ids[0] == 0 and ids[-1] == 0 and ids.shape[0] == len(text) + 2
        want.append(normalize_loudness(pkg.generate_speech(ids, voice_row(pack, ids.shape[0])),
                                       24000))
    wav = read_wav(str(tmp_path / "o.wav"), 24000)
    assert wav.shape[0] == sum(w.shape[0] for w in want)


def imports_of(module) -> set:
    """The modules that ``module``'s source imports, resolved to full names."""
    base = module.__name__.rsplit(".", 1)[0]
    names = set()
    for node in ast.walk(ast.parse(Path(module.__file__).read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            parent = base.rsplit(".", node.level - 1)[0] if node.level else ""
            full = ".".join(p for p in (parent, node.module) if p)
            names.add(full)
            names.update(f"{full}.{alias.name}" for alias in node.names)
    return names


def test_the_two_families_stand_on_one_bucket_package_base():
    """Both package classes derive from ``programs.BucketPackage`` and not
    from each other; the Kokoro module needs nothing of the Stylish one;
    ``speak`` names no family; the bucket rules, the seed and the programs'
    counter are defined once and still read from ``export.package``."""
    for cls in (InferencePackage, KokoroPackage):
        assert cls.__bases__ == (BucketPackage,)
    assert not issubclass(KokoroPackage, InferencePackage)
    assert not issubclass(InferencePackage, KokoroPackage)
    assert "stylish_tts_torch.export.package" not in imports_of(kokoro)
    assert "KokoroPackage" not in Path(cli.__file__).read_text(encoding="utf-8")
    for name in ("TEXT_BUCKETS", "FRAME_BUCKET_STEP", "SOURCE_SEED", "BUILT",
                 "text_bucket", "frame_bucket"):
        assert getattr(package, name) is getattr(programs, name)
        assert not hasattr(kokoro, name) or getattr(kokoro, name) is getattr(programs, name)


def test_kokoro_voice_files_load_as_rows_of_the_pack(tmp_path):
    pack = R.make_voicepacks(1, SEED)[0]
    torch.save(torch.as_tensor(pack)[:, None, :], str(tmp_path / "voice.pt"))  # kokoro's own
    save_file({"pack": torch.as_tensor(pack)}, str(tmp_path / "voice.safetensors"))
    for name in ("voice.pt", "voice.safetensors"):
        np.testing.assert_array_equal(load_voice(str(tmp_path / name)), pack)
    np.testing.assert_array_equal(voice_row(pack, 5 + 2), pack[4])
    np.testing.assert_array_equal(voice_row(pack, 600), pack[-1])


def test_warmup_and_a_batch_through_the_kokoro_programs(tmp_path):
    """``warmup`` over a batch of lines builds the programs those lines
    reach, and serving them afterwards builds none."""
    pkg = open_package(str(kokoro_package(tmp_path)), device="cpu")
    lines = [line(n, seed=9) for n in (20, 24, 33)]
    lines = [(i.numpy().astype(np.int32), s.float().numpy()) for i, s in lines]
    assert pkg.warmup(lines) == 2
    assert sorted(pkg._duration_fns) == [32, 64]
    assert sorted(pkg._acoustic_fns) == [(32, 100), (64, 200)]
    built = dict(BUILT)
    for ids, ref_s in lines:
        audio = pkg.generate_speech(ids, ref_s)
        assert audio.shape == (int(pkg.last_durations.sum()) * 600,)
    assert BUILT == built


def test_stylish_configurations_still_load_as_model_configs():
    for raw in ({}, {"generator": {"type": "ringformer"}}):
        assert isinstance(ModelConfig.model_validate(raw), ModelConfig)
    cfg = KokoroConfig.model_validate({"family": "kokoro"})
    assert cfg.frame_samples == 600 and cfg.hidden_dim == 512 and cfg.plbert.num_hidden_layers == 12
    assert set(build_models(tiny_config())) == set(K.KOKORO_MODULES)


def test_the_published_kokoro_config_loads_without_its_unread_keys():
    """The benchmark's file keeps every key of Kokoro-82M's config.json;
    the schema holds only those the forward reads and ignores the rest."""
    import json
    from pathlib import Path

    raw = json.loads((Path(__file__).parent.parent / "ttsbench/configs/kokoro.json").read_text())
    cfg = KokoroConfig.model_validate(raw["model"])
    assert cfg == KokoroConfig()
    unread = {"dim_in", "dropout", "max_conv_dim", "multispeaker", "n_mels"}
    assert unread <= set(raw["model"]) and not unread & set(cfg.model_dump())
    assert "dropout" in raw["model"]["plbert"] and "dropout" not in cfg.plbert.model_dump()
