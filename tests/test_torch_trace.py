"""The port's spans and counters (``stylish_tts_torch/utils/trace.py``), on
the CPU at the synthesis tests' tiny config:

* with no ``torch.profiler`` session nothing is recorded and ``span``
  returns one shared object;
* under ``torch.profiler.profile(activities=[CPU])`` each stage's step
  records ``train.step`` with its step number; the acoustic and textual
  steps record their phases inside it, and the host's syncs
  (``train.sync.*``) inside the updates, all with the step's number;
* the host tensors the step reads (the phase loss's weights, the slm's
  resampling kernel and position buckets) are made once per device, with
  the values they had;
* ``generate_speech`` records ``speak.line`` with the line's number around
  ``speak.prep``, ``program.replay`` and ``speak.fetch``, on the fused path
  and on the two-phase one;
* ``programs.built`` counts one build per bucket, with or without a
  session, and a replay is one ``program.replay`` span per call;
* the loader's ``loader.load`` and ``loader.put`` come from its worker
  thread, ``loader.wait`` from the consumer's, each with the batch number;
* ``normalize_loudness`` records ``loudness.blocks`` and stays bitwise
  equal to the JAX copy;
* spans nest per thread, and a span without a unit takes its parent's;
* the buffer drops its oldest spans at its cap and counts them;
* the counters are entries of one registry.
"""

import threading
import time
from collections import deque
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fixtures import make_micro_dataset
from stylish_tts_tpu.tts import loudness as jloudness
from stylish_tts_torch.config import Config, ModelConfig
from stylish_tts_torch.data import loader as loader_mod
from stylish_tts_torch.data.dataset import FilePathDataset
from stylish_tts_torch.data.sampler import BatchSizeTable, DynamicBatchSampler
from stylish_tts_torch import losses
from stylish_tts_torch.export.package import InferencePackage, export_checkpoint
from stylish_tts_torch.export.programs import BUILT
from stylish_tts_torch.models import build_models, slm
from stylish_tts_torch.ops import ctc_cuda
from stylish_tts_torch.text import TextCleaner
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import (
    Batch, StepContext, make_acoustic_step, make_duration_step, make_textual_step,
)
from stylish_tts_torch.tts import loudness
from stylish_tts_torch.utils import trace
from test_torch_synth_common import port_config, randn, tiny_jax_config

B, L, F, HOP = 2, 10, 40, 300
STATS = {"frames_per_token_p05": 2.0, "frames_per_token_p50": 5.0,
         "frames_per_token_p95": 8.0}
PHASES = ("train.features", "train.gen.forward", "train.gen.backward", "train.gen.update",
          "train.disc.forward", "train.disc.backward", "train.disc.update")


@contextmanager
def session():
    """A CPU profiler session; yields the list that receives the spans
    recorded inside it."""
    got = []
    lo = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        yield got
    hi = time.time_ns()
    got.extend(s for s in trace.spans() if lo <= s.start and s.end <= hi)


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def inside(child, parent) -> bool:
    return parent.start <= child.start and child.end <= parent.end


def _batch(seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(F * HOP) / 24000.0
    audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 220, (B, 1)) * tt)
    durs = np.full((B, L), F // L)
    return Batch(*map(torch.from_numpy, (
        audio.astype(np.float32), rng.integers(1, 170, (B, L)).astype(np.int32),
        np.array([L, L - 3], np.int32), rng.uniform(90, 250, (B, F)).astype(np.float32),
        durs.astype(np.int32))))


@pytest.fixture(scope="module")
def mc():
    return port_config(tiny_jax_config())


def _step(mc, stage):
    torch.manual_seed(0)
    state = create_stage_train_state(build_models(mc), "cpu", stage, seed=0)
    ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                      stage_steps=50, base_lr=1e-4)
    if stage == "duration":
        classes = mc.duration_predictor.duration_classes
        return state, make_duration_step(ctx, torch.ones(classes))
    return state, {"acoustic": make_acoustic_step, "textual": make_textual_step}[stage](ctx)


def test_no_span_is_recorded_without_a_profiler_session():
    before = trace.spans()
    assert trace.span("a") is trace.span("b", 3)
    with trace.span("a", 1), trace.span("b"):
        pass
    assert trace.spans() == before
    with session() as got:
        with trace.span("a", 1), trace.span("b"):
            pass
    assert [s.name for s in got] == ["b", "a"]
    with trace.span("c"):
        pass
    assert trace.spans()[-1].name == "a"


@pytest.mark.parametrize("stage", ["acoustic", "textual", "duration"])
def test_a_step_records_its_span_tree(mc, stage):
    state, step = _step(mc, stage)
    step(state, _batch(0))  # the first call builds what it caches
    with session() as got:
        step(state, _batch(1))
    steps = by_name(got, "train.step")
    assert len(steps) == 1 and steps[0].unit == 1 and steps[0].parent is None
    top = steps[0]
    assert all(s.unit == 1 and inside(s, top) for s in got if s.name.startswith("train."))
    syncs = [s for s in got if s.name.startswith("train.sync.")]
    # the G flags, the D multipliers, the D flags, the EMA terms
    discs = {"acoustic": 4, "textual": 1, "duration": 1}[stage]
    assert sorted(s.name for s in syncs) == sorted(
        ["train.sync.finite"] * 2 + ["train.sync.lr_mult"] * discs + ["train.sync.ema"])
    ids = {s.id: s for s in got}
    assert all(ids[s.parent].name in ("train.gen.update", "train.disc.update")
               for s in syncs)
    names = {s.name for s in got}
    if stage == "duration":
        assert names >= {"train.gen.update", "train.disc.forward", "train.disc.backward",
                         "train.disc.update"}
        return
    phases = [by_name(got, name) for name in PHASES]
    assert all(len(p) == 1 and p[0].parent == top.id for p in phases)
    # the phases in the step's order, one after another
    assert all(a[0].end <= b[0].start for a, b in zip(phases, phases[1:]))


@pytest.mark.parametrize("which", ["phase_weights", "resample_kernel", "position_buckets"])
def test_the_steps_host_tensors_are_made_once_per_device(which):
    import math

    cpu = torch.device("cpu")
    if which == "phase_weights":
        made, again = losses.phase_weights(513, cpu), losses.phase_weights(513, cpu)
        base = math.exp(math.log(2.5) / 256)
        want = torch.pow(torch.tensor(base), torch.arange(513.0))[None, :, None]
    elif which == "resample_kernel":
        made, again = slm.resample_kernel(cpu), slm.resample_kernel(cpu)
        want = torch.from_numpy(slm._resample_kernel(24000, 16000))
    else:
        made, again = slm.position_buckets(49, cpu), slm.position_buckets(49, cpu)
        want = torch.from_numpy(slm._relative_position_buckets(49, 49))
    assert again is made and made.device == cpu
    assert made.dtype == want.dtype and torch.equal(made, want)
    with torch.inference_mode():
        assert not slm.position_buckets(50, cpu).is_inference()


@pytest.fixture(scope="module")
def package(tmp_path_factory, mc):
    torch.manual_seed(7)
    path = tmp_path_factory.mktemp("trace_pkg") / "pkg"
    export_checkpoint(build_models(mc), mc, NormalizationStats(), str(path),
                      duration_stats=STATS)
    return str(path)


def _speak(pkg, seed, n=12, fused=None):
    tokens = np.random.default_rng(seed).integers(1, 170, n).astype(np.int32)
    return pkg.generate_speech(tokens, *[randn((pkg.mc.style_dim,), seed + i)
                                         for i in range(3)], fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_generate_speech_records_the_line_tree(package, fused):
    pkg = InferencePackage(package, device="cpu")
    with session() as got:
        first = _speak(pkg, 0, fused=fused)
        again = _speak(pkg, 0, fused=fused)
    np.testing.assert_array_equal(first, again)
    lines = by_name(got, "speak.line")
    assert [s.unit for s in lines] == [1, 2]
    phases = ["fused"] if fused else ["duration", "acoustic"]
    for line in lines:
        kids = sorted((s for s in got if s.parent == line.id), key=lambda s: s.start)
        assert all(s.unit == line.unit and inside(s, line) for s in kids)
        assert [s.name for s in kids] == ["speak.prep", "program.replay",
                                          "speak.fetch"] * len(phases)


def test_programs_are_counted_per_build_and_per_call(package):
    pkg = InferencePackage(package, device="cpu")
    built = dict(BUILT)
    _speak(pkg, 0)  # one fused bucket, built outside a session
    with session() as got:
        for seed in range(1, 3):
            _speak(pkg, seed)
        _speak(pkg, 0, n=40)  # a second text bucket
        _speak(pkg, 0, fused=False)
        _speak(pkg, 1, fused=False)
    assert {k: BUILT[k] - built[k] for k in BUILT} == {"fused": 2, "duration": 1,
                                                       "acoustic": 1}
    assert sum(len(v) for v in pkg._fused_fns.values()) == 2
    # one replay a call: three fused lines, two two-phase ones
    assert len(by_name(got, "program.replay")) == 3 + 2 * 2


def test_loader_spans_come_from_the_worker_thread(tmp_path):
    data = make_micro_dataset(str(tmp_path / "data"), n_train=6, n_val=1,
                              with_caches=False)
    with open(f"{data}/train-list.txt", encoding="utf-8") as f:
        lines = f.readlines()
    ds = FilePathDataset(data_list=lines, root_path=f"{data}/wav-dir",
                         text_cleaner=TextCleaner(ModelConfig().symbol),
                         sample_rate=24000, coarse_hop_length=300)
    bins, _ = ds.time_bins()
    table = BatchSizeTable(probe_batch_max=2)
    table.plan(list(bins))
    sampler = DynamicBatchSampler(bins, table, drop_last=False, seed=3)
    with session() as got:
        served = list(loader_mod.PrefetchLoader(ds, sampler, 300, require_pitch=False,
                                                device_put=lambda b: b, use_native=False))
    n = len(served)
    assert n == len(sampler) >= 2
    main = threading.get_ident()
    for name, thread in (("loader.load", "worker"), ("loader.put", "worker"),
                         ("loader.wait", "main")):
        spans = by_name(got, name)
        # the consumer's last wait is for the end of the batches
        assert [s.unit for s in spans] == list(range(n + (name == "loader.wait")))
        assert all((s.thread == main) == (thread == "main") for s in spans)
    for load, put in zip(by_name(got, "loader.load"), by_name(got, "loader.put")):
        assert load.end <= put.start and load.thread == put.thread


@pytest.mark.parametrize("seconds", [0.2, 3.0])
def test_traced_loudness_equals_jax(seconds):
    rng = np.random.default_rng(1)
    n = int(seconds * 24000)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / 24000)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
    with session() as got:
        out = loudness.normalize_loudness(audio, 24000)
    np.testing.assert_array_equal(out, jloudness.normalize_loudness(audio, 24000))
    # the K-weighting pass, then the block means; a line shorter than one
    # 400 ms block has none
    assert [s.name for s in got] == \
        ["loudness.filter"] + (["loudness.blocks"] if seconds > 0.4 else [])


def test_spans_nest_per_thread_and_take_their_parents_unit():
    def work(unit, out):
        with trace.span("outer", unit):
            time.sleep(0.01)
            with trace.span("inner"):
                time.sleep(0.01)

    with session() as got:
        threads = [threading.Thread(target=work, args=(u, None)) for u in (5, 6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    outer = {s.unit: s for s in by_name(got, "outer")}
    for inner in by_name(got, "inner"):
        parent = next(s for s in outer.values() if s.id == inner.parent)
        assert inner.unit == parent.unit and inner.thread == parent.thread
        assert parent.parent is None and inside(inner, parent)
    assert sorted(outer) == [5, 6] and outer[5].thread != outer[6].thread


def test_the_buffer_drops_the_oldest_at_its_cap_and_counts_them(monkeypatch):
    monkeypatch.setattr(trace, "_buffer", deque(maxlen=3))
    dropped = trace.DROPPED["spans"]
    with session():
        for i in range(5):
            with trace.span("s", i):
                pass
    assert [s.unit for s in trace.spans()] == [2, 3, 4]
    assert trace.DROPPED["spans"] - dropped == 2


def test_counters_are_one_registry():
    assert loader_mod.BATCHES is trace.COUNTERS["loader.batches"]
    assert set(loader_mod.BATCHES) == {"native", "scipy"}
    assert ctc_cuda.LAUNCHES is trace.counter("ctc.launches")
    assert BUILT is trace.COUNTERS["programs.built"]
    assert trace.DROPPED is trace.COUNTERS["trace.dropped"]
