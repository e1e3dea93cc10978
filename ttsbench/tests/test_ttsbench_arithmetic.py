"""The metric arithmetic, the traffic's seeding and the import guard."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from ttsbench import harness
from ttsbench.harness import ROOT, RunRecord, load_cell, load_reader

TRAIN = json.loads((ROOT / "ttsbench/traffic/train_acoustic.json").read_text())
BOOK = json.loads((ROOT / "ttsbench/traffic/speak_book.json").read_text())


def test_rate_is_all_work_over_the_whole_window():
    assert harness.rate(30.0, 12.0) == 2.5
    with pytest.raises(ValueError):
        harness.rate(1.0, 0.0)


def test_p95_over_all_values_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 19, 20, 21, 400):
        v = rng.lognormal(size=n).tolist()
        assert harness.p95(v) == pytest.approx(float(np.percentile(v, 95)), rel=1e-12)


def test_p95_reads_the_tail_not_a_chunk_median():
    v = [1.0] * 90 + [100.0] * 10
    assert harness.p95(v) == pytest.approx(100.0)


@pytest.mark.parametrize("intervals, expected", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),
    ([(5, 6), (0, 1), (0.5, 2)], 3.0),
])
def test_union_counts_overlaps_once(intervals, expected):
    assert harness.union_length(intervals) == pytest.approx(expected)


def test_idle_share_is_one_minus_the_union():
    run = RunRecord(units=2, window_s=10e-9,
                    device=[(0, 4, "a"), (2, 6, "b"), (8, 9, "c")])
    assert run.busy_s == pytest.approx(7e-9)
    assert load_reader("device_idle_share.train")(run) == pytest.approx(30.0)
    assert load_reader("device_ms_per_step.train")(run) == pytest.approx(3.5e-6)
    assert load_reader("device_ops_per_line.synth")(run) == 1.5


def test_gaps_and_breakdown():
    device = [(10, 20, "k1"), (30, 60, "k2"), (70, 75, "k1")]
    assert harness.gaps([(s, e) for s, e, _ in device], 0, 100) == [
        (0, 10), (20, 30), (60, 70), (75, 100)]
    spans = {"loudness": [(76, 99)]}
    b = harness.breakdown(device, spans, 0, 100)
    assert b["device_ops"][0] == ["k2", 30e-9]
    assert b["idle_gaps"][0] == ["loudness", 25e-9]


def test_readers_return_nothing_without_data():
    empty = RunRecord(units=0, window_s=1.0)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert load_reader(m["name"])(empty) is None, m["name"]


def test_mfu_is_flops_over_window_times_peak():
    run = RunRecord(units=4, window_s=2.0, flops=989e12 * 0.05)
    assert load_reader("mfu.train")(run) == pytest.approx(2.5)


def test_every_cell_loads_with_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert cell.checks and set(cell.checks) <= {
            "first_disc_real_gap", "first_decoder_gap", "median_change_gap",
            "first_loss_gap", "wave_gap", "mel_gap"}
        for row in cell.checks.values():
            # no upper: only a fault whose reading is infinite sets it
            assert row["lower"] < row["limit"] and (row["upper"] is None
                                                    or row["limit"] < row["upper"])


def test_output_gap_is_a_relative_norm_and_infinite_on_a_shape_change():
    import torch

    from ttsbench import checks

    ref = [torch.tensor([3.0, 4.0]), torch.tensor([[0.0]])]
    assert checks.output_gap([torch.tensor([3.0, 4.5]), torch.tensor([[0.0]])], ref) \
        == pytest.approx(0.1)
    assert checks.output_gap([torch.tensor([3.0])] + ref[1:], ref) == float("inf")
    assert checks.output_gap(None, ref) == float("inf")
    assert checks.output_gap([torch.tensor([3.0, float("nan")]), ref[1]], ref) == float("inf")


def test_first_calls_keep_the_first_output_only():
    import torch

    from ttsbench import checks

    lin = torch.nn.Linear(2, 1)
    first = checks.FirstCalls({"lin": lin})
    x = torch.ones(1, 2)
    a = lin(x)
    lin(2 * x)
    out = first.close()
    lin(3 * x)
    assert len(out["lin"]) == 1 and torch.equal(out["lin"][0], a.detach())


def test_mel_gap_ignores_phase_and_sees_a_level_change():
    from ttsbench import checks

    sr, hop = 24000, 300
    mel = {"n_fft": 2048, "hop_length": hop, "win_length": 1200, "n_mels": 80,
           "sample_rate": sr}
    t = np.arange(sr) / sr
    noise = 1e-3 * np.random.default_rng(0).standard_normal(sr)
    ref = 0.3 * np.sin(2 * np.pi * 200 * t) + noise
    shifted = 0.3 * np.sin(2 * np.pi * 200 * t + 1.0) + noise
    louder = 1.1 * ref
    assert checks.mel_gap(ref, ref, hop, mel) == 0.0
    phase = checks.mel_gap(shifted, ref, hop, mel)
    level = checks.mel_gap(louder, ref, hop, mel)
    assert level == pytest.approx(0.1, rel=1e-6)
    assert phase < 0.01 * level
    assert checks.mel_gap(ref[:-2 * hop], ref, hop, mel) == float("inf")
    assert checks.wave_gap(shifted, ref, hop) > 0.9
    click = ref.copy()
    click[sr // 2] += 0.5
    assert checks.wave_gap(click, ref, hop) > 1.0


def test_judge_compares_only_the_numbers_with_a_limit(capsys):
    from ttsbench import checks

    limits = {"a": {"limit": 1.0}}
    assert checks.judge({"a": 0.5, "b": 9.0}, limits) == (True, {"a": {"value": 0.5,
                                                                        "limit": 1.0}})
    assert not checks.judge({"a": 1.5, "b": 0.0}, limits)[0]
    assert not checks.judge({"a": float("inf")}, limits)[0]
    assert "logged b 9.0" in capsys.readouterr().err
    with pytest.raises(KeyError):
        checks.judge({"b": 0.0}, limits)


def test_train_traffic_repeats_from_a_seed():
    from ttsbench.traffic.train_stage import batch_order, clip_audio, corpus_rows

    seed = 2**31 + 99
    a, b = corpus_rows(TRAIN, seed, "abc"), corpus_rows(TRAIN, seed, "abc")
    assert a == b and corpus_rows(TRAIN, seed + 1, "abc") != a
    assert np.array_equal(clip_audio(a[0])[0], clip_audio(b[0])[0])
    o1, o2 = batch_order(TRAIN, seed), batch_order(TRAIN, seed)
    first = [next(o1) for _ in range(8)]
    assert first == [next(o2) for _ in range(8)]
    # an epoch's batches hold every clip once
    assert sorted(sum(first[:4], [])) == list(range(TRAIN["clips"]))
    assert all(TRAIN["clip_seconds"][0] * 24000 <= r["samples"] <= TRAIN["clip_seconds"][1]
               * 24000 for r in a)


def test_book_traffic_repeats_from_a_seed():
    from ttsbench.reference.stts.config import ModelConfig
    from ttsbench.reference.stts.text import TextCleaner
    from ttsbench.traffic.speak_lines import line_order, make_pool, make_voices, pack

    mc = ModelConfig()
    sym = mc.symbol.letters_ipa.replace("'", "")
    seed = 2**31 + 5
    p1 = make_pool(BOOK, seed, sym, TextCleaner(mc.symbol))
    p2 = make_pool(BOOK, seed, sym, TextCleaner(mc.symbol))
    assert len(p1) == BOOK["pool"]
    assert all(np.array_equal(x["tokens"], y["tokens"]) and x["voice"] == y["voice"]
               for x, y in zip(p1, p2))
    assert max(x["tokens"].shape[0] for x in p1) <= BOOK["max_tokens"]
    assert np.array_equal(line_order(BOOK, seed, 50), line_order(BOOK, seed, 50))
    assert np.array_equal(make_voices(BOOK, seed, 8), make_voices(BOOK, seed, 8))
    assert pack([3, 3, 3], 7) == [7, 3]


@pytest.mark.parametrize("names, found", [
    (["jax", "numpy"], ["jax"]),
    (["jax.numpy", "jaxtyping", "jax_utils"], ["jax.numpy"]),
    (["stylish_tts_tpu.models", "stylish_tts_torch.models"], ["stylish_tts_tpu.models"]),
    (["flax.linen", "optax", "jaxlib.xla_client"], ["flax.linen", "jaxlib.xla_client", "optax"]),
    (["torch", "stylish_tts_torch"], []),
])
def test_import_guard_compares_top_level_names_whole(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_imports_no_jax_and_the_reference_nothing_of_the_program():
    code = ("import sys, ttsbench.run, ttsbench.traffic.train_stage, "
            "ttsbench.traffic.speak_lines, ttsbench.control, ttsbench.reference.train, "
            "ttsbench.reference.synth; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & set(harness.FORBIDDEN)
    assert "stylish_tts_torch" not in tops


def test_run_refuses_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "ttsbench.run", "--workload",
                           "freegan.speak_book", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
