"""Synthesis programs per bucket (``export/programs.py``), ``warmup``,
``warmup_grid`` and ``convert --exported-program``, against the JAX
package and the port's eager phase functions, on the CPU at the synthesis
tests' small config (``tiny_jax_config``: ``small_model_config()`` with
n_fft 128), for both generator families.

* ``warmup_grid`` equals the JAX ``warmup_grid`` without stats, on the
  stats of 400 simulated utterances and on a wide spread (thinned to 8 with
  the warning, as ``tests/test_export.py`` holds the JAX one), with a
  ``max_frames_per_text`` cut, and over a hypothesis sweep of p05 <= p50 <=
  p95 in [1, 15].
* ``warmup(text_buckets=[32], max_frames_per_text=300)`` returns the JAX
  count and leaves the JAX ``_acoustic_fns`` and ``_fused_fns`` keys, on
  one package (written by the port, with duration stats) read by both. The
  JAX ``warmup`` raises on its first fused program when the package has
  stats (``_fused_fn_and_args`` gives 6 arguments to a function of 7: no
  ``speech_style``), so this file hands its ``_fused_fn_and_args`` the
  missing zeros, on the JAX side only and without changing the package.
* The source draws (``draw_sources``) against the generators they stand
  for: bitwise, per row (synthesis) and from one generator (training).
* Each program against the eager method it runs: bitwise (on the CPU a
  program is the eager call on its static inputs): durations, acoustic and
  fused at B = 1 and B = 3; two speeds through one fused program, the
  cache unchanged.
* ``generate_speech`` through the programs against the JAX
  ``generate_speech``: 5e-4 absolute, ``tests/test_torch_package.py``'s
  audio tolerance, with one broadband prior injected on both sides (no RNG
  stream is shared, and a harmonic prior's round-off phases are not
  comparable: that file says why). The fused path is compared where its
  bucket holds the durations; a squeezed fused call is held bitwise
  against the eager ``fused``: with identical squeezed durations the JAX
  and port acoustic functions part by 5.5e-4 at the bucket's last frames.
* The miss path: nothing warmed, one call builds exactly one fused
  program; ``fused=False`` builds one duration and one acoustic program.
* After one call the phase functions copy nothing from the host and read
  no value back (what a CUDA graph capture needs), on the ``meta`` device.
* ``convert --exported-program --device cpu``: the ``.pt2`` loads with
  ``torch.export.load``; its output equals the eager acoustic phase at
  (32, 100) within 1e-6 of its peak, and, fed the JAX package's own source
  draws (``PRNGKey(0)`` split as the JAX speech predictor splits it), the
  JAX ``_acoustic_fn(32, 100)`` within 5e-4 (its frames unvoiced, checked,
  so that the source is the drawn noise alone); the JAX package reads the
  package.
* On the card (``gpu``, skipped here): captured programs against the eager
  calls.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from stylish_tts_tpu.export import package as jax_package_module
from stylish_tts_tpu.export.package import InferencePackage as JaxPackage
from stylish_tts_torch.export import package as package_module
from stylish_tts_torch.export.package import (
    InferencePackage, export_checkpoint, exported_program_path, warmup_grid,
)
from stylish_tts_torch.export.programs import TEXT_BUCKETS, BucketProgram, frame_bucket
from stylish_tts_torch.models import build_models
from stylish_tts_torch.models import generator as generator_module
from stylish_tts_torch.models.generator import SourceDraws
from stylish_tts_torch.trainer.normalization import NormalizationStats
from test_torch_package import _styles
from test_torch_synth_common import port_config, randn, tiny_jax_config

LINES = ("ɔnðə kˈɑːntɹɛɹi", "hɛlˈoʊ wˈɝːld ɐɡˈɛn")
HOP = 300
AUDIO_ATOL = 5e-4
EXPORT_RTOL = 1e-6
# p95 8 frames per token: both lines' frame buckets hold their durations
STATS = {"frames_per_token_p05": 2.0, "frames_per_token_p50": 5.0,
         "frames_per_token_p95": 8.0}
FAMILIES = ("freegan", "ringformer")


def family_config(family: str):
    jmc = tiny_jax_config()
    if family == "ringformer":
        jmc.generator.type = "ringformer"
        jmc.generator.upsample_initial_channel = 64
        jmc.generator.upsample_rates = [4, 5]
        jmc.generator.gen_istft_n_fft = 60
        jmc.generator.gen_istft_hop_size = 15
    return jmc


def write_package(path, family: str, duration_stats=None, f0_bias=None) -> str:
    mc = port_config(family_config(family))
    torch.manual_seed(7)
    models = build_models(mc)
    with torch.no_grad():
        if f0_bias is not None:
            models["pitch_energy_predictor"].f0_proj.bias.fill_(f0_bias)
        if family == "ringformer":
            # a random conv_post saturates the tanh (tests/test_torch_ringformer.py)
            models["speech_predictor"].generator.conv_post.weight.mul_(0.1)
    return export_checkpoint(models, mc, NormalizationStats(), str(path),
                             duration_stats=duration_stats)


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """One package of each family with duration stats, on the CPU."""
    root = tmp_path_factory.mktemp("programs")
    return {f: write_package(root / f, f, STATS, f0_bias=150.0) for f in FAMILIES}


def fresh(packages, family) -> InferencePackage:
    return InferencePackage(packages[family], device="cpu")


def prior_np(batch: int, frames: int) -> np.ndarray:
    """A broadband excitation, a function of its shape alone."""
    return np.tanh(randn((batch, frames * HOP), frames, 0.3))


# ---- warmup_grid -----------------------------------------------------------


def simulated_stats():
    """The 400-utterance alignment cache of tests/test_export.py."""
    rng = np.random.default_rng(0)
    cache = {}
    for i in range(400):
        n = int(rng.integers(5, 120))
        fpt = rng.normal(5.5, 0.8)
        cache[f"seg{i}"] = np.full((1, n), max(fpt, 1.0), np.float32)
    ours = package_module.duration_stats_from_cache(cache)
    assert ours == jax_package_module.duration_stats_from_cache(cache)
    return ours


WIDE = {"frames_per_token_p05": 2.0, "frames_per_token_p50": 6.0,
        "frames_per_token_p95": 12.0}


@pytest.mark.parametrize("case", ["no_stats", "simulated", "wide", "cut", "cut_wide"])
def test_warmup_grid_equals_jax(case, caplog):
    stats = {"no_stats": None, "simulated": simulated_stats(), "wide": WIDE,
             "cut": simulated_stats(), "cut_wide": WIDE}[case]
    cut = 900 if case.startswith("cut") else None
    with caplog.at_level(logging.WARNING, logger="stylish_tts_torch"):
        ours = warmup_grid(TEXT_BUCKETS, stats, cut)
    ref = jax_package_module.warmup_grid(TEXT_BUCKETS, stats, cut)
    assert ours == ref and ours
    if cut:
        assert max(F for _, F in ours) <= cut
    thinned = [r for r in caplog.records if "thinning to 8" in r.getMessage()]
    if stats is WIDE:
        assert thinned, "the wide spread is thinned with a warning"
        assert all(sum(1 for L2, _ in ours if L2 == L) <= 8 for L in TEXT_BUCKETS)
    assert warmup_grid([32], stats, 300) == jax_package_module.warmup_grid([32], stats, 300)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(1.0, 15.0, allow_nan=False), min_size=3, max_size=3),
       st.sampled_from([None, 300, 1000, 2500]))
def test_warmup_grid_sweep_equals_jax(quantiles, cut):
    p05, p50, p95 = sorted(quantiles)
    stats = {"frames_per_token_p05": p05, "frames_per_token_p50": p50,
             "frames_per_token_p95": p95}
    assert warmup_grid(TEXT_BUCKETS, stats, cut) == \
        jax_package_module.warmup_grid(TEXT_BUCKETS, stats, cut)
    for p in (p05, p95):
        fused = package_module.fused_grid(TEXT_BUCKETS, p, cut)
        assert all(F % 100 == 0 and (not cut or F <= cut) for _, F in fused)


# ---- warmup against the JAX warmup ------------------------------------------


@pytest.fixture(scope="module")
def jax_warmed(packages):
    """The JAX package of the FreeGAN voice, warmed once (with the missing
    ``speech_style`` handed to its fused programs) and with the broadband
    prior injected into its speech predictor for the synthesis check."""
    orig = JaxPackage._fused_fn_and_args

    def with_speech_style(self, L, F):
        fn, args = orig(self, L, F)
        if len(args) == 6:  # (params, texts, lengths, dur, pe, inv_speed)
            args = args[:5] + (jnp.zeros((1, self.mc.style_dim)),) + args[5:]
        return fn, args

    class PriorShim:
        def __init__(self, inner):
            self.inner = inner

        def apply(self, params, *args, **kwargs):
            b, _, frames = args[2].shape  # the fine alignment (B, L, F)
            return self.inner.apply(params, *args, prior=jnp.asarray(prior_np(b, frames)),
                                    **kwargs)

    jpkg = JaxPackage(packages["freegan"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPackage, "_fused_fn_and_args", with_speech_style)
        jpkg.models["speech_predictor"] = PriorShim(jpkg.models["speech_predictor"])
        count = jpkg.warmup(text_buckets=[32], max_frames_per_text=300)
    return jpkg, count


def test_warmup_count_and_keys_equal_jax(packages, jax_warmed):
    jpkg, count = jax_warmed
    pkg = fresh(packages, "freegan")
    assert pkg.warmup(text_buckets=[32], max_frames_per_text=300) == count == 6
    assert sorted(pkg._acoustic_fns) == sorted(jpkg._acoustic_fns)
    assert sorted(pkg._fused_fns) == sorted(jpkg._fused_fns)
    assert sorted(pkg._duration_fns) == sorted(jpkg._duration_fns) == [32]
    for cache in (pkg._duration_fns, pkg._acoustic_fns, pkg._fused_fns):
        assert all(list(entry) == [1] for entry in cache.values())
    # a second warmup counts the same grid and builds nothing new
    programs = {k: v[1] for k, v in pkg._acoustic_fns.items()}
    assert pkg.warmup(text_buckets=[32], max_frames_per_text=300) == count
    assert all(pkg._acoustic_fns[k][1] is p for k, p in programs.items())


def test_warmup_without_stats_builds_the_jax_grid(tmp_path):
    pkg = InferencePackage(write_package(tmp_path / "pkg", "freegan"), device="cpu")
    grid = jax_package_module.warmup_grid([32, 64], None, 600)
    assert pkg.warmup(text_buckets=[32, 64], max_frames_per_text=600) == len(grid)
    assert sorted(pkg._acoustic_fns) == sorted(grid) and not pkg._fused_fns


def test_generate_speech_equals_jax(packages, jax_warmed, monkeypatch):
    jpkg, _ = jax_warmed
    pkg = fresh(packages, "freegan")
    monkeypatch.setattr(generator_module.SineSource, "forward",
                        lambda self, f0, *a, **k: torch.from_numpy(prior_np(*f0.shape)))
    for i, line in enumerate(LINES):
        tokens = pkg.tokenize(line)
        styles = _styles(pkg.mc, 60 + 10 * i)
        for fused in (True, False):
            ours = pkg.generate_speech(tokens, *styles, fused=fused)
            ref = np.asarray(jpkg.generate_speech(tokens, *styles, fused=fused))
            assert ours.shape == ref.shape and ours.shape[0] % HOP == 0
            np.testing.assert_allclose(ours, ref, rtol=0, atol=AUDIO_ATOL)
    # every request went through a program of its bucket
    assert len(pkg._duration_fns) == 1 and pkg._acoustic_fns and pkg._fused_fns


# ---- source draws ------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_source_draws_equal_the_generators(packages, family):
    pkg = fresh(packages, family)
    sp = pkg.models["speech_predictor"]
    tokens = [pkg.tokenize(line) for line in LINES]
    for batch in (1, 3):
        texts, lengths = pkg._texts([tokens[i % 2] for i in range(batch)])
        durations = torch.from_numpy(np.abs(randn(texts.shape, 70 + batch)) + 2.0)
        styles = [torch.from_numpy(randn((batch, pkg.mc.style_dim), 80 + i, 0.5))
                  for i in range(2)]
        draws = pkg.source_draws(batch, 100)
        assert draws is pkg.source_draws(batch, 100)
        with_draws = pkg.acoustic(texts, lengths, durations, *styles, 100,
                                  source_draws=draws)
        with_generators = pkg.acoustic(texts, lengths, durations, *styles, 100)
        assert torch.equal(with_draws, with_generators)
        # training's one generator for the batch: drawn in the same order
        pitch = torch.full((batch, 40), 150.0)
        pitch[:, 10:14] = 0.0
        voiced = (pitch > 20).float()
        source = (sp.generator.basegen.source if family == "freegan" else None)
        one = sp.draw_sources(batch, 40, torch.Generator().manual_seed(5), "cpu")
        if source is not None:
            a = source(pitch, torch.Generator().manual_seed(5))
            assert torch.equal(a, source(pitch, None, draws=one))
        else:
            from stylish_tts_torch.models.ringformer import generate_pcph
            hop = sp.generator.prior_hop
            a = generate_pcph(pitch, voiced, hop, 24000, torch.Generator().manual_seed(5))
            assert torch.equal(a, generate_pcph(pitch, voiced, hop, 24000,
                                                rand_ini=one.rand_ini))
    if family == "freegan":
        assert draws.noise.shape == (3, 9, 100 * HOP)
    else:
        assert draws.noise is None and draws.rand_ini.shape == (3, 1)


# ---- programs against the eager methods --------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_programs_equal_eager(packages, family):
    pkg = fresh(packages, family)
    sd = pkg.mc.style_dim
    tokens = [pkg.tokenize(line) for line in LINES]
    for batch in (1, 3):
        texts, lengths = pkg._texts([tokens[i % 2] for i in range(batch)])
        L = texts.shape[1]
        du, pe, sp = (torch.from_numpy(randn((batch, sd), 90 + 3 * batch + i, 0.5))
                      for i in range(3))
        durations = pkg._duration_fn(L, batch)(texts, lengths, du)
        assert torch.equal(durations, pkg.durations(texts, lengths, du))
        frames = frame_bucket(int(durations.sum(1).max().round()))
        audio = pkg._acoustic_fn(L, frames, batch)(texts, lengths, durations, pe, sp)
        assert torch.equal(audio, pkg.acoustic(texts, lengths, durations, pe, sp, frames))
        assert audio.shape == (batch, frames * HOP)
        program = pkg._fused_fn(L, 100, batch)
        for speed in (1.0, 1.3):
            inv = torch.tensor(1.0 / speed)
            got, totals = program(texts, lengths, du, pe, sp, inv)
            ref, ref_totals = pkg.fused(texts, lengths, du, pe, sp, 1.0 / speed, 100)
            assert torch.equal(got, ref) and torch.equal(totals, ref_totals)
    assert sorted(pkg._fused_fns[(32, 100)]) == [1, 3]
    assert len(pkg._fused_fns) == 1  # two speeds, one program per batch size
    with pytest.raises(ValueError):
        program(texts[:, :16], lengths, du, pe, sp, inv)


@pytest.mark.parametrize("family", FAMILIES)
def test_miss_path_builds_one_program(packages, family):
    pkg = fresh(packages, family)
    tokens = pkg.tokenize(LINES[0])
    styles = _styles(pkg.mc, 100)
    assert not (pkg._duration_fns or pkg._acoustic_fns or pkg._fused_fns)
    audio = pkg.generate_speech(tokens, *styles)
    assert audio.size > 0 and np.isfinite(audio).all()
    assert len(pkg._fused_fns) == 1 and not pkg._acoustic_fns and not pkg._duration_fns
    (entry,) = pkg._fused_fns.values()
    assert list(entry) == [1] and isinstance(entry[1], BucketProgram)
    np.testing.assert_array_equal(audio, pkg.generate_speech(tokens, *styles))
    two = pkg.generate_speech(tokens, *styles, fused=False)
    assert two.size > 0 and np.isfinite(two).all()
    assert len(pkg._duration_fns) == 1 and len(pkg._acoustic_fns) == 1
    # a squeezed fused call (its bucket below the durations) equals eager
    pkg.duration_stats = {"frames_per_token_p95": 1.0}
    squeezed = pkg.generate_speech(tokens, *styles)
    texts, lengths = pkg._texts([tokens])
    sp, pe, du = (torch.from_numpy(s)[None] for s in styles)
    ref, totals = pkg.fused(texts, lengths, du, pe, sp, 1.0, 100)
    assert int(totals[0]) < two.shape[0] // HOP
    np.testing.assert_array_equal(squeezed, ref[0, :int(totals[0]) * HOP].numpy())
    batch = pkg.generate_speech_batch([tokens, pkg.tokenize(LINES[1])], *styles)
    assert len(batch) == 2 and all(np.isfinite(w).all() for w in batch)
    assert {b for entry in pkg._acoustic_fns.values() for b in entry} == {1, 2}


# ---- no host sync after the first call ---------------------------------------


class HostWatch(TorchDispatchMode):
    """Records every op that reads a host tensor or a value back."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if func is torch.ops.aten._local_scalar_dense.default or any(
                isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in flat):
            self.seen.append(str(func))
        return func(*args, **kwargs)


@pytest.mark.parametrize("family", FAMILIES)
def test_phase_functions_stay_on_the_device(packages, family):
    """The three phase functions on the ``meta`` device: the first call may
    make the cached tables and bases (a program's warm-up does); a second
    call reads no host tensor and no value back, as a CUDA graph capture
    requires."""
    pkg = fresh(packages, family)
    meta = torch.device("meta")
    for module in pkg.models.values():
        module.to(meta)
    pkg.device = meta
    F = 100
    texts, lengths, durations, du, pe, sp = pkg._example(2, 32, "durations", "style",
                                                         "style", "style")
    n_harm = pkg.models["speech_predictor"].generator.draw_sources(
        1, 1, None, "cpu").rand_ini.shape[1]
    draws = SourceDraws(torch.empty((2, n_harm), device=meta),
                        torch.empty((2, n_harm, F * HOP), device=meta)
                        if family == "freegan" else None)
    inv = torch.ones((), device=meta)
    for call in range(2):
        watch = HostWatch()
        with watch:
            pkg.durations(texts, lengths, du)
            pkg.acoustic(texts, lengths, durations, pe, sp, F, source_draws=draws)
            pkg.fused(texts, lengths, du, pe, sp, inv, F, source_draws=draws)
    assert watch.seen == []


# ---- convert --exported-program ----------------------------------------------


def jax_source_draws(frames: int) -> SourceDraws:
    """The FreeGAN sine source's draws in the JAX acoustic function:
    ``PRNGKey(0)`` -> (smoothing, generator) -> (phase, noise)."""
    _, gen_key = jax.random.split(jax.random.PRNGKey(0))
    k_phase, k_noise = jax.random.split(gen_key)
    rand_ini = jax.random.uniform(k_phase, (1, 9)).at[:, 0].set(0.0)
    noise = jax.random.normal(k_noise, (1, 9, frames * HOP))
    return SourceDraws(torch.from_numpy(np.array(rand_ini)), torch.from_numpy(np.array(noise)))


def write_checkpoint(root, family: str) -> tuple:
    """A stage checkpoint of seeded weights as ``convert`` reads it
    (``state.pt``'s modules, the normalization, the model config) and a
    config whose dataset holds no cache."""
    import yaml

    from stylish_tts_torch.trainer.checkpoint import STATE_FILE

    mc = port_config(family_config(family))
    torch.manual_seed(7)
    models = build_models(mc)
    ckpt = root / "checkpoint_00001_step_000000002"
    ckpt.mkdir(parents=True)
    torch.save({"models": {k: m.state_dict() for k, m in models.items()}},
               ckpt / STATE_FILE)
    NormalizationStats().save(str(ckpt / "normalization.json"))
    (ckpt / "model_config.json").write_text(mc.model_dump_json(), encoding="utf-8")
    (root / "data").mkdir()
    (root / "config.yml").write_text(yaml.safe_dump({"dataset": {"path": str(root / "data")}}),
                                     encoding="utf-8")
    return ckpt, root / "config.yml"


def test_convert_exported_program(tmp_path):
    from stylish_tts_torch.cli import train_cli

    ckpt, cfg = write_checkpoint(tmp_path, "freegan")
    common = ["convert", "--config", str(cfg), "--checkpoint", str(ckpt)]
    result = CliRunner().invoke(train_cli, common + ["--out", str(tmp_path / "plain")])
    assert result.exit_code == 0, result.output
    assert not (tmp_path / "plain" / "exported_program").exists()
    pkg_dir = str(tmp_path / "pkg")
    result = CliRunner().invoke(train_cli, common + ["--out", pkg_dir, "--exported-program",
                                                     "--device", "cpu"])
    assert result.exit_code == 0, result.output
    path = exported_program_path(pkg_dir)
    assert path.endswith("exported_program/acoustic_L32_F100.pt2")
    program = torch.export.load(path)

    pkg = InferencePackage(pkg_dir, device="cpu")
    module, args = pkg._acoustic_module_and_args(32, 100)
    assert [tuple(a.shape) for a in args] == [(1, 32), (1,), (1, 32), (1, 16), (1, 16),
                                              (1, 9), (1, 9, 100 * HOP)]
    with torch.no_grad():
        out = program.module()(*args)
        eager = pkg.acoustic(*args[:5], 100)
    peak = float(eager.abs().max())
    assert out.shape == eager.shape == (1, 100 * HOP) and peak > 0
    np.testing.assert_allclose(out.numpy(), eager.numpy(), rtol=0, atol=EXPORT_RTOL * peak)

    # the JAX package reads the directory, and its acoustic function at
    # (32, 100) equals the program fed the JAX package's own draws
    jpkg = JaxPackage(pkg_dir)
    _, jargs = jpkg._acoustic_fn_and_args(32, 100)
    ref = np.asarray(jpkg._acoustic_fn(32, 100)(*jargs))
    texts, lengths, durations, pe, sp = (torch.from_numpy(np.array(a)) for a in jargs[1:])
    texts, lengths = texts.long(), lengths.long()
    with torch.no_grad():
        alignment = pkg.duration_processor.duration_to_alignment(durations, 100)
        pitch, _ = pkg.models["pitch_energy_predictor"](texts, lengths, alignment, pe)
    assert float(pitch.max()) < 10.0, "unvoiced: the source is the drawn noise alone"
    draws = jax_source_draws(100)
    with torch.no_grad():
        ours = program.module()(texts, lengths, durations, pe, sp, draws.rand_ini,
                                draws.noise)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=AUDIO_ATOL)


def test_exported_ringformer_program_equals_eager(tmp_path):
    pkg_dir = write_package(tmp_path / "pkg", "ringformer")
    path = package_module._emit_exported_program(pkg_dir, "cpu")
    pkg = InferencePackage(pkg_dir, device="cpu")
    module, args = pkg._acoustic_module_and_args(32, 100)
    assert [tuple(a.shape) for a in args][5:] == [(1, 1)]
    with torch.no_grad():
        out = torch.export.load(path).module()(*args)
        eager = pkg.acoustic(*args[:5], 100)
        plain = module(*args)
    peak = float(eager.abs().max())
    assert torch.equal(plain, eager) and peak > 0
    np.testing.assert_allclose(out.numpy(), eager.numpy(), rtol=0, atol=EXPORT_RTOL * peak)


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_captured_programs_equal_eager_on_the_card(packages, family, cuda):
    pkg = InferencePackage(packages[family], device="cuda")
    tokens = pkg.tokenize(LINES[1])
    texts, lengths = pkg._texts([tokens])
    du, pe, sp = (torch.from_numpy(randn((1, pkg.mc.style_dim), 110 + i, 0.5)).cuda()
                  for i in range(3))
    got, totals = pkg._fused_fn(32, 200)(texts, lengths, du, pe, sp,
                                         torch.ones((), device=cuda))
    assert pkg._fused_fns[(32, 200)][1].graph is not None
    ref, ref_totals = pkg.fused(texts, lengths, du, pe, sp, 1.0, 200)
    assert torch.equal(totals, ref_totals)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
