"""F5-TTS v1 Base in the port against its plain reference
(``ttsbench/reference/f5.py``: plain torch, F5-TTS's unpadded batch-1
forward, each guidance row its own forward, attention and RoPE written
out, Vocos's iSTFT through ``irfft``), on seeded random weights at cut
widths (width 64, depth 2, 4 heads of 16, 2 text blocks, 16 mels, Vocos
32 wide with 2 layers, n_fft 64, hop 16, 4 steps).

A chunk sampled at a frame bucket larger than itself must equal the
unpadded forward at its own frames: in float64, to 1e-9 of the mel's peak,
whatever the bucket's padding holds; each planted fault of the masks or of
the guidance fails that. Vocos at a bucket equals the unpadded vocoder to
the float32 rounding of the port's iSTFT (a float32 island). A package
exports, opens through ``open_package`` and speaks through ``speak``.
"""

import contextlib

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from stylish_tts_torch.cli import tts_cli
from stylish_tts_torch.config import F5Config
from stylish_tts_torch.data.wav import read_wav, write_wav
from stylish_tts_torch.dsp import mel as dsp_mel
from stylish_tts_torch.dsp import stft as dsp_stft
from stylish_tts_torch.export import export_checkpoint, open_package
from stylish_tts_torch.export.f5 import BUILT, NFE, F5Package, cross_fade
from stylish_tts_torch.export.programs import BUILT as STYLISH_BUILT
from stylish_tts_torch.export.programs import FRAMES, frame_bucket
from stylish_tts_torch.models import build_models
from stylish_tts_torch.models import f5 as M
from stylish_tts_torch.tts.loudness import normalize_loudness
from stylish_tts_torch.utils import trace
from ttsbench.reference import f5 as R
from ttsbench.reference.stts.dsp import mel as frozen_mel
from ttsbench.reference.stts.dsp import stft as frozen_stft

SEED = 2**31 + 22
MELS, HOP = 16, 16
TINY = {
    "arch": {"dim": 64, "depth": 2, "heads": 4, "dim_head": 16, "text_dim": 32,
             "conv_layers": 2},
    "mel_spec": {"n_mel_channels": MELS, "n_fft": 64, "hop_length": HOP, "win_length": 64},
    "vocos": {"input_channels": MELS, "dim": 32, "intermediate_dim": 96, "num_layers": 2,
              "n_fft": 64, "hop_length": HOP},
    "sampler": {"nfe_step": 4},
    "vocab_size": 40,
}
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?")}
# (chunk frames, reference frames, text ids): at a bucket's edge (F = T),
# one frame past it, and two inside buckets
CHUNKS = [(100, 30, 40), (101, 45, 50), (137, 40, 60), (283, 90, 120)]


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_config(**over) -> F5Config:
    return F5Config.model_validate({**TINY, **over})


@pytest.fixture(scope="module")
def both64():
    """(port modules, reference modules) in float64 from the reference's
    seeded weights."""
    model = tiny_config().model_dump()
    ref = R.make_models(model, "cpu", SEED)
    port = M.build_f5_models(tiny_config())
    for k, m in port.items():
        m.load_state_dict(ref[k].state_dict())
        m.eval().double()
        ref[k].double()
    return port, ref


def chunk(total: int, ref: int, n_text: int, seed: int = 0) -> R.Chunk:
    rng = np.random.default_rng([seed, total])
    ids = torch.zeros(total, dtype=torch.long)
    ids[:n_text] = torch.as_tensor(rng.integers(0, TINY["vocab_size"], n_text)) + 1
    return R.Chunk(ids=ids, cond=torch.as_tensor(rng.standard_normal((ref, MELS))),
                   noise=R.draw_noise(total, MELS, seed).double(), audio_frames=ref - 1)


def bucketed_sample(dit, c: R.Chunk) -> torch.Tensor:
    """The port's sampler at the chunk's frame bucket, the padding of the
    mel and of x_0 filled with large noise that it must not read."""
    total, ref = c.noise.shape[0], c.cond.shape[0]
    size = frame_bucket(total)
    ids = torch.zeros((1, size), dtype=torch.long)
    ids[0, :total] = c.ids
    cond = 50 * torch.randn((1, size, MELS), dtype=torch.float64)
    cond[0, :ref] = c.cond
    noise = 50 * torch.randn((1, size, MELS), dtype=torch.float64)
    noise[0, :total] = c.noise
    s = tiny_config().sampler
    with torch.no_grad():
        out = M.sample(dit, ids, cond, noise, torch.tensor([ref]), torch.tensor([total]),
                       M.sway_times(s.nfe_step, s.sway_sampling_coef), s.cfg_strength)
    assert torch.all(out[0, total:] == 0)
    return out[0, :total]


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


# ---------------------------------------------------------------- the sampler


@pytest.mark.parametrize("total, ref, n_text", CHUNKS)
def test_a_bucketed_chunk_is_the_unpadded_forward_in_float64(both64, total, ref, n_text):
    port, models = both64
    c = chunk(total, ref, n_text)
    with torch.no_grad():
        want = R.sample(models, tiny_config().model_dump(), c)["mel"]
    assert gap(bucketed_sample(port["dit"], c), want) < 1e-9


def _patch(obj, name, make):
    @contextlib.contextmanager
    def planted():
        saved = getattr(obj, name)
        setattr(obj, name, make(saved))
        try:
            yield
        finally:
            setattr(obj, name, saved)
    return planted


FAULTS = {
    "no key mask": _patch(M.Attention, "forward",
                          lambda f: lambda self, x, rope, key_mask=None: f(self, x, rope)),
    "no GRN mask": _patch(M.GRN, "forward", lambda f: lambda self, x, mask=None: f(self, x)),
    "no position-conv mask": _patch(M.ConvPositionEmbedding, "forward",
                                    lambda f: lambda self, x, mask=None: f(self, x)),
    "RoPE on the first head only": _patch(
        M, "apply_rope",
        lambda f: lambda x, cos, sin: torch.cat([f(x[:, :1], cos, sin), x[:, 1:]], dim=1)),
    "unconditioned row keeps its text": _patch(
        M.TextEmbedding, "conditioning",
        lambda f: lambda self, ids, mask=None: self.forward(
            torch.cat([ids, ids]), (ids == 0).expand(2, -1),
            None if mask is None else mask.expand(2, -1, -1))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_comparison(both64, fault):
    port, models = both64
    c = chunk(*CHUNKS[2])
    with torch.no_grad():
        want = R.sample(models, tiny_config().model_dump(), c)["mel"]
    with FAULTS[fault]():
        got = bucketed_sample(port["dit"], c)
    assert gap(got, want) > 1e-6, fault


def test_the_first_velocity_is_the_references(both64):
    port, models = both64
    c = chunk(*CHUNKS[3])
    total, ref = c.noise.shape[0], c.cond.shape[0]
    size = frame_bucket(total)
    ids = torch.zeros((1, size), dtype=torch.long)
    ids[0, :total] = c.ids
    cond = torch.zeros((1, size, MELS), dtype=torch.float64)
    cond[0, :ref] = c.cond
    noise = torch.zeros((1, size, MELS), dtype=torch.float64)
    noise[0, :total] = c.noise
    with torch.no_grad():
        want = R.sample(models, tiny_config().model_dump(), c)["velocity"]
        cc = M.conditioning(port["dit"], ids, cond, torch.tensor([ref]), torch.tensor([total]))
        got = M.guided_velocity(port["dit"], noise, cc, 0.0, 2.0)[0, :total]
    assert gap(got, want) < 1e-9


@pytest.mark.parametrize("generated", [100, 137])
def test_vocos_at_a_bucket_is_the_unpadded_vocoder(both64, generated):
    """Up to the iSTFT the two agree in float64; the port's iSTFT is a
    float32 island, so the waveform agrees to float32 rounding (2e-6 of
    the peak: a few ulps through the inverse DFT's sums of 33 bins)."""
    port, models = both64
    mel = torch.randn((generated, MELS), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(generated))
    size = frame_bucket(generated)
    padded = 50 * torch.randn((1, MELS, size), dtype=torch.float64)
    padded[0, :, :generated] = mel.T
    with torch.no_grad():
        want = models["vocos"](mel)
        valid = (torch.arange(size) < generated)[None]
        feats = port["vocos"].backbone(padded, valid[:, None, :])
        got = M.vocode(port["vocos"], padded, torch.tensor([generated]))[0]
        feats = port["vocos"].head.out(feats)[0, :generated]
        ref_feats = models["vocos"].features(mel)
    assert gap(feats, ref_feats) < 1e-12
    assert got.shape == (size * HOP,) and want.shape == (generated * HOP,)
    assert gap(got[:generated * HOP], want) < 2e-6


def test_the_sway_schedule_the_frame_rule_and_chunk_text():
    times = M.sway_times(32, -1.0)
    assert len(times) == 33 and times[0] == 0.0 and times[-1] == pytest.approx(1.0, abs=1e-15)
    assert all(abs(t - (1 - np.cos(np.pi / 2 * k / 32))) < 1e-15 for k, t in enumerate(times))
    assert all(b > a for a, b in zip(times, times[1:]))
    assert M.sway_times(8, -1.0) == R.sway_times(8, -1.0)
    # ref 6 s at 15 bytes a second: 562 frames, 90 bytes, a 240-byte budget
    assert M.max_chars(90, 6.0, 22.0, 1.0) == 240
    assert M.chunk_frames(562, 90, 240, 330, 1.0, 4096) == 562 + int(562 / 90 * 240)
    assert M.chunk_frames(562, 90, 9, 99, 1.0, 4096) == 562 + int(562 / 90 * 9 / 0.3)
    assert M.chunk_frames(10, 90, 10, 300, 1.0, 4096) == 301  # at least the text + 1
    assert M.chunk_frames(937, 15, 900, 915, 1.0, 4096) == 4096
    text = ("The first sentence is here. A second one, with a comma! And a third? "
            "Short. Then a much longer closing sentence that goes on and on.")
    for budget in (10, 30, 60, 200):
        got = M.chunk_text(text, budget)
        assert got == R.chunk_text(text, budget)
        assert " ".join(got).split() == text.split()
    # a sentence longer than the budget is a chunk of its own
    assert M.chunk_text(text, 30) == [
        "The first sentence is here.", "A second one, with a comma!", "And a third? Short.",
        "Then a much longer closing sentence that goes on and on."]


def test_the_published_sizes_and_the_reference_layout():
    """336M DiT parameters (vocabulary 2,545) and 13.5M in Vocos, named as
    the reference's, so that one state dict loads into both."""
    with torch.device("meta"):
        port = M.build_f5_models(F5Config())
        ref = R.build(R.config(F5Config().model_dump()))
    counts = {k: sum(p.numel() for p in m.parameters()) for k, m in port.items()}
    assert counts == {"dit": 337_096_804, "vocos": 13_531_650}
    for k in port:
        assert {n: p.shape for n, p in port[k].state_dict().items()} == \
            {n: p.shape for n, p in ref[k].state_dict().items()}
    with torch.device("meta"):
        assert set(build_models(F5Config())) == set(M.F5_MODULES)


def test_attention_flops_are_the_references_products():
    from ttsbench.flops import count_flops

    model = tiny_config().model_dump()
    with torch.device("meta"):
        block = R.build(R.config(model))["dit"].transformer_blocks[0]
    h = torch.zeros((50, 64), device="meta")
    cos = torch.zeros((50, 8), device="meta")

    def attention():
        with torch.no_grad():
            block.attention(h, cos, cos)

    projections = 4 * 2 * 50 * 64 * 64
    per_call = count_flops(attention) - projections
    assert per_call * 2 * 2 * 4 == R.attention_flops(model, 50)  # depth 2, 2 rows, 4 steps


# ---------------------------------------------------------------- the DSP


@pytest.mark.parametrize("case", ["freegan_head", "ringformer_head", "mel"])
def test_the_shared_dsp_is_bitwise_as_before_for_present_callers(case):
    """FreeGAN's and ringformer's generator heads call ``istft`` as before,
    and the Stylish mel is ``MelSpectrogram`` at power 2: each bitwise the
    frozen copy of the code before the F5 options."""
    g = torch.Generator().manual_seed(SEED)
    if case == "mel":
        audio = torch.randn((2, 4000), generator=g)
        kw = dict(n_mels=80, n_fft=2048, win_length=1200, hop_length=300, sample_rate=24000)
        assert torch.equal(dsp_mel.MelSpectrogram(**kw)(audio),
                           frozen_mel.MelSpectrogram(**kw)(audio))
        return
    real, imag = torch.randn((2, 2, 33, 40), generator=g)
    kw = (dict(normalize_window=False, uniform_scale=True) if case == "freegan_head"
          else dict(normalize_window=True, length=40 * 16))
    assert torch.equal(dsp_stft.istft(real, imag, 64, 16, 64, center=True, **kw),
                       frozen_stft.istft(real, imag, 64, 16, 64, center=True, **kw))


def test_the_magnitude_log_mel_is_vocos_mel():
    audio = torch.randn(3000, generator=torch.Generator().manual_seed(1))
    cfg = tiny_config().mel_spec
    port = dsp_mel.MelSpectrogram(n_mels=MELS, n_fft=64, win_length=64, hop_length=HOP,
                                  sample_rate=24000, power=1.0, log_floor=1e-5)(audio[None])[0]
    want = R.log_mel(audio, cfg).T
    assert port.shape == want.shape == (MELS, 3000 // HOP + 1)
    assert float((port - want).abs().max()) < 1e-4


def test_same_padding_and_a_frame_mask_are_the_istft_of_the_frames_alone():
    g = torch.Generator().manual_seed(3)
    real, imag = torch.randn((2, 1, 33, 30), generator=g)
    whole = dsp_stft.istft(real, imag, 64, 16, 64, padding="same")
    assert whole.shape == (1, 30 * 16)
    mask = (torch.arange(30) < 21)[None]
    masked = dsp_stft.istft(real, imag, 64, 16, 64, padding="same", frame_mask=mask)
    alone = dsp_stft.istft(real[..., :21], imag[..., :21], 64, 16, 64, padding="same")
    torch.testing.assert_close(masked[:, :21 * 16], alone, rtol=0, atol=1e-6)
    assert torch.all(masked[:, 21 * 16 + 24:] == 0)
    with pytest.raises(ValueError):
        dsp_stft.istft(real, imag, 64, 16, 64, padding="valid")


# ---------------------------------------------------------------- the package


def f5_package(tmp_path, vocab=None, **over):
    cfg = tiny_config(vocab=vocab or {}, **over)
    weights = R.make_weights(cfg.model_dump(), "cpu", SEED)
    models = M.build_f5_models(cfg)
    for k, m in models.items():
        m.load_state_dict(weights[k])
    out = tmp_path / "pkg"
    export_checkpoint(models, cfg, None, str(out))
    return out


def voice_audio(seconds: float, seed: int = 5) -> np.ndarray:
    t = np.arange(int(seconds * 24000)) / 24000
    rng = np.random.default_rng(seed)
    return (0.05 * np.sin(2 * np.pi * 140 * t) + 0.01 * rng.standard_normal(t.shape)
            ).astype(np.float32)


def test_open_package_picks_f5_and_a_chunk_is_the_references(tmp_path):
    out = f5_package(tmp_path)
    pkg = open_package(str(out), device="cpu")
    assert isinstance(pkg, F5Package) and pkg.dtype == torch.float32
    audio = voice_audio(0.1)
    rng = np.random.default_rng(4)
    ref_ids, gen_ids = rng.integers(0, 40, 12), rng.integers(0, 40, 30)
    voice = pkg.make_voice(audio, ref_ids, 12)
    assert voice.mel.shape == (audio.shape[0] // HOP + 1, MELS)
    assert voice.audio_frames == audio.shape[0] // HOP
    before = (dict(FRAMES), dict(NFE), dict(BUILT))
    wave = pkg.generate_speech(gen_ids, voice, seed=9)
    total = M.chunk_frames(voice.audio_frames, 12, 30, 42, 1.0, 4096)
    assert FRAMES["real"] - before[0]["real"] == total
    assert FRAMES["bucket"] - before[0]["bucket"] == frame_bucket(total)
    assert NFE["cond"] - before[1]["cond"] == NFE["uncond"] - before[1]["uncond"] == 4
    assert BUILT["sample"] - before[2]["sample"] == 1 == BUILT["vocode"] - before[2]["vocode"]
    assert set(STYLISH_BUILT) == {"fused", "duration", "acoustic"}
    assert wave.shape == ((total - voice.audio_frames) * HOP,)
    assert list(pkg._sample_fns) == [frame_bucket(total)]
    model = tiny_config().model_dump()
    refs = R.make_models(model, "cpu", SEED)
    with torch.no_grad():
        want = R.speak_chunk(refs, model, R.make_chunk(model, audio, ref_ids, 12, gen_ids, 30,
                                                       9, "cpu"))
    # float32 on both sides; the two mels of the clip differ by rounding
    assert gap(torch.as_tensor(wave), want["audio"]) < 1e-4
    probe = pkg.probe(gen_ids, voice, seed=9)
    assert probe["velocity"].shape == (total, MELS)
    assert gap(torch.as_tensor(probe["velocity"]), want["velocity"]) < 1e-4
    assert 0 < probe["residual_max"] < 1e3
    again = open_package(str(out), device="cpu").generate_speech(gen_ids, voice, seed=9)
    np.testing.assert_array_equal(wave, again)


def test_warmup_builds_every_program_the_chunks_reach(tmp_path):
    pkg = open_package(str(f5_package(tmp_path)), device="cpu")
    rng = np.random.default_rng(6)
    voice = pkg.make_voice(voice_audio(0.1), rng.integers(0, 40, 12), 12)
    chunks = [(rng.integers(0, 40, n), voice, None, 1.0, k) for k, n in enumerate((10, 30, 31))]
    assert pkg.warmup(chunks) == (2, 2)
    built = dict(BUILT)
    for ids, v, _, _, seed in chunks:
        pkg.generate_speech(ids, v, seed=seed)
    assert BUILT == built


def test_speak_with_an_f5_package(tmp_path):
    out = f5_package(tmp_path, VOCAB)
    write_wav(str(tmp_path / "voice.wav"), voice_audio(0.1), 24000)
    (tmp_path / "voice.txt").write_text("a voice", encoding="utf-8")
    (tmp_path / "lines.txt").write_text("hello there.\n\nanother line, and more.\n",
                                        encoding="utf-8")
    result = CliRunner().invoke(tts_cli, [
        "speak", "--model", str(out), "--voicepack", str(tmp_path / "voice.wav"),
        "--text", str(tmp_path / "lines.txt"), "--out", str(tmp_path / "o.wav"),
        "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert "(2 utterances)" in result.output and "DiT evaluations: cond 8, uncond 8" in result.output
    assert "programs built while speaking: sample " in result.output
    pkg = open_package(str(out), device="cpu")
    voice = pkg.load_voice(str(tmp_path / "voice.wav"))
    assert voice.text_bytes == len("a voice.  ")
    want = [normalize_loudness(pkg.speak_line(text, voice), 24000)
            for text in ("hello there.", "another line, and more.")]
    wav = read_wav(str(tmp_path / "o.wav"), 24000)
    assert wav.shape[0] == sum(w.shape[0] for w in want)


def test_a_line_over_the_budget_is_cut_into_cross_faded_chunks(tmp_path):
    """A voice of 10 bytes over 0.1 s under a 0.3 s chunk limit has a
    budget of 20 bytes: three chunks of the line, chunk k drawn from seed
    k, joined with the cross-fade."""
    pkg = open_package(str(f5_package(tmp_path, VOCAB,
                                      sampler={"nfe_step": 4, "max_seconds": 0.3})),
                       device="cpu")
    voice = pkg.make_voice(voice_audio(0.1), pkg.tokenize("a voice.  "), 10)
    text = "one two three. four five six. seven eight nine."
    pieces = M.chunk_text(text, M.max_chars(10, voice.seconds, 0.3, 1.0))
    assert pieces == ["one two three.", "four five six.", "seven eight nine."]
    joined = pkg.speak_line(text, voice)
    waves = [pkg.generate_speech(pkg.tokenize(p), voice, gen_bytes=len(p), seed=k)
             for k, p in enumerate(pieces)]
    np.testing.assert_array_equal(joined, cross_fade(waves, int(0.15 * 24000)))
    assert joined.dtype == np.float32


def test_a_chunk_records_its_spans_under_the_profiler(tmp_path):
    pkg = open_package(str(f5_package(tmp_path)), device="cpu")
    rng = np.random.default_rng(8)
    voice = pkg.make_voice(voice_audio(0.1), rng.integers(0, 40, 12), 12)
    ids = rng.integers(0, 40, 20)
    pkg.generate_speech(ids, voice)  # builds the programs outside the window
    lo = len(trace.spans())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pkg.generate_speech(ids, voice)
    spans = trace.spans()[lo:]
    names = [s.name for s in spans]
    for name in ("speak.line", "speak.prep", "speak.sample", "speak.vocode", "speak.fetch",
                 "program.replay"):
        assert name in names, name
    line = next(s for s in spans if s.name == "speak.line")
    sample = next(s for s in spans if s.name == "speak.sample")
    assert sample.parent == line.id and line.start <= sample.start <= sample.end <= line.end
    fetches = [s for s in spans if s.name == "speak.fetch"]
    assert {f.parent for f in fetches} == {sample.id, line.id}
