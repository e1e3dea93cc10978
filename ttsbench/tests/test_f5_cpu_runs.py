"""Whole runs of the cell ``f5.speak_book`` at a tiny size on the CPU (the
harness's look for a card skipped): the reference agrees with the port, and
a fault planted under the timed path makes ``correct`` false. The
traffic's packing is F5-TTS's ``chunk_text``, and its pool and order come
from the seeds. On a card (``gpu``-marked), the cell's bfloat16 control at
the cell's own size fails the limit."""

from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch

from ttsbench.harness import RunRecord, load_cell, load_reader
from ttsbench.run import measure
from ttsbench.traffic import f5_lines

SEED = 2**31 + 122
TINY_F5 = {
    "arch": {"dim": 64, "depth": 2, "heads": 4, "dim_head": 16, "text_dim": 32,
             "conv_layers": 2},
    "mel_spec": {"n_mel_channels": 16, "n_fft": 256, "hop_length": 64, "win_length": 256},
    "vocos": {"input_channels": 16, "dim": 32, "intermediate_dim": 96, "num_layers": 2,
              "n_fft": 256, "hop_length": 64},
    "sampler": {"nfe_step": 4, "max_seconds": 2.0},
    "vocab_size": 40,
}
TINY_CHUNKS = {"pool": 6, "voices": 2, "ref_seconds": [0.5, 0.7], "ref_bytes_per_s": 60.0,
               "sentence_median_bytes": 25, "chapter_sentences": 6, "strata": 2,
               "check_chunks": 2, "trace_seconds": 1}


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# the tiny cell's limit: its float32 sound runs read ~1e-7 (the clip's two
# mels differ by rounding), the planted faults ~2e-4
TINY_LIMIT = 1e-5


def tiny_f5(limits: bool = False):
    cell = load_cell("f5.speak_book")
    model = copy.deepcopy(cell.config["model"])
    for k, v in TINY_F5.items():
        model[k] = {**model[k], **v} if isinstance(v, dict) else v
    cell.config = {**cell.config, "model": model}
    cell.traffic = {**cell.traffic, **TINY_CHUNKS}
    limit = TINY_LIMIT if limits else math.inf
    cell.checks = {k: {"limit": limit} for k in cell.checks}
    return cell


def test_reference_agrees_with_the_port(tmp_path):
    out = measure(tiny_f5(), SEED, 0.5, False, "cpu", tmp_path)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    # float32 on both sides: the clip's mel differs by rounding (the port's
    # framed DFT against torch.stft) and moves the output by little more
    assert out["checks"]["mel_gap"]["value"] <= TINY_LIMIT / 10, out["checks"]


def test_sample_ms_reads_the_programs_span(tmp_path):
    """``sample_ms_per_line.synth`` reads the program's span
    ``speak.sample`` of the chunks served in the window (the spans record
    under any profiler session; the CPU's here)."""
    import time

    cell = tiny_f5()
    driver = f5_lines.Driver(cell.config, cell.traffic, SEED, "cpu", tmp_path)
    driver.prepare()
    driver.serve(0)  # builds the chunk's programs outside the window
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        lo = time.time_ns()
        driver.serve(0)
        driver.serve(0)
        hi = time.time_ns()
    run = RunRecord(units=2, window_s=(hi - lo) / 1e9, lo=lo, hi=hi)
    ms = load_reader("sample_ms_per_line.synth")(run)
    assert 0 < ms < (hi - lo) / 1e6 / 2


def test_the_attention_readers_count_the_named_kernels_over_the_real_flops():
    device = [(0, 2_000_000, "fmha_cutlassF_f16_aligned_64x64_rf_sm80"),
              (1_000_000, 3_000_000, "pytorch_flash::flash_fwd_kernel"),
              (3_000_000, 9_000_000, "sm90_xmma_gemm_f16f16")]
    run = RunRecord(units=2, window_s=1.0, device=device)
    assert load_reader("attention_ms_per_line.synth")(run) == pytest.approx(1.5)
    assert load_reader("attention_roofline.synth")(run) is None  # no count of the work
    run.attention_flops = 989e12 * 3e-3 * 0.25
    assert load_reader("attention_roofline.synth")(run) == pytest.approx(25.0)


@pytest.mark.parametrize("fault", ["no_key_mask", "uncond_text"])
def test_a_planted_fault_makes_correct_false(fault, tmp_path):
    from ttsbench.f5_control import FAULTS

    from stylish_tts_torch.models import f5

    cell = tiny_f5(limits=True)
    if fault == "uncond_text":
        saved = f5.TextEmbedding.conditioning
        f5.TextEmbedding.conditioning = lambda self, ids, mask=None: self.forward(
            torch.cat([ids, ids]), (ids == 0).expand(2, -1), mask.expand(2, -1, -1))
        try:
            out = measure(cell, SEED, 0.5, False, "cpu", tmp_path)
        finally:
            f5.TextEmbedding.conditioning = saved
    else:
        with FAULTS[fault]():
            out = measure(cell, SEED, 0.5, False, "cpu", tmp_path)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def test_the_packing_is_chunk_text_and_the_pool_repeats_from_the_seeds():
    from stylish_tts_torch.models.f5 import chunk_text

    rng = np.random.default_rng(3)
    for budget in (40, 120, 240):
        lengths = np.clip(np.round(rng.lognormal(np.log(90), 0.5, 30)), 2, budget).astype(int)
        text = " ".join("x" * (n - 1) + "." for n in lengths)
        assert f5_lines.pack(lengths, budget) == [len(c) for c in chunk_text(text, budget)]
    params = load_cell("f5.speak_book").traffic
    a = f5_lines.make_pool(params, SEED, 2545, 22.0)
    b = f5_lines.make_pool(params, SEED, 2545, 22.0)
    c = f5_lines.make_pool(params, SEED + 1, 2545, 22.0)
    assert len(a) == params["pool"]
    assert all(np.array_equal(x["ids"], y["ids"]) and x["noise_seed"] == y["noise_seed"]
               for x, y in zip(a, b))
    # the sizes follow sizes_seed alone; the ids and draws follow --seed
    assert [x["bytes"] for x in a] == [x["bytes"] for x in c]
    assert any(not np.array_equal(x["ids"], y["ids"]) for x, y in zip(a, c))
    frames = list(range(len(a)))
    order = f5_lines.chunk_order(frames, params, SEED, 64)
    assert np.array_equal(order, f5_lines.chunk_order(frames, params, SEED, 64))
    # every round of 16 holds one chunk of each stratum
    assert sorted(order[:16] // 8) == list(range(16))


@pytest.mark.gpu
def test_f5_control_fails_the_limit_at_the_cells_size(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own size runs on a CUDA card")
    from ttsbench.f5_control import reading

    cell = load_cell("f5.speak_book")
    cell.config = {**cell.config, "model": {**cell.config["model"], "dit_dtype": "bfloat16"}}
    numbers = reading(cell, SEED, "cuda", tmp_path, None)
    assert any(numbers[k] > row["limit"] for k, row in cell.checks.items()), numbers
