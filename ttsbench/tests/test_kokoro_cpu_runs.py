"""Whole runs of the cell ``kokoro.speak_book`` at a tiny size on the CPU
(the harness's look for a card skipped): the reference agrees with the
port, and a fault planted under the timed path makes ``correct`` false. On
a card (``gpu``-marked), the cell's control at the cell's own size fails a
limit."""

from __future__ import annotations

import contextlib
import copy
import math

import pytest
import torch

from ttsbench.harness import load_cell
from ttsbench.run import measure

SEED = 2**31 + 118
TINY_KOKORO = {
    "hidden_dim": 32, "style_dim": 16, "n_layer": 2, "decoder_dim": 48, "asr_res_dim": 8,
    "plbert": {"hidden_size": 32, "num_attention_heads": 2, "intermediate_size": 64,
               "num_hidden_layers": 2, "embedding_size": 16},
    "istftnet": {"upsample_initial_channel": 32},
}
TINY_LINES = {"pool": 6, "sentence_median_tokens": 12, "max_tokens": 40,
              "chapter_sentences": 6, "voices": 2, "check_lines": 2, "strata": 2,
              "trace_seconds": 1}


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_kokoro(limits: bool = False):
    cell = load_cell("kokoro.speak_book")
    model = copy.deepcopy(cell.config["model"])
    for k, v in TINY_KOKORO.items():
        model[k] = {**model[k], **v} if isinstance(v, dict) else v
    cell.config = {**cell.config, "model": model}
    cell.traffic = {**cell.traffic, **TINY_LINES}
    if not limits:
        cell.checks = {k: {"limit": math.inf} for k in cell.checks}
    return cell


def run(cell, tmp_path):
    return measure(cell, SEED, 0.5, False, "cpu", tmp_path)


def test_reference_agrees_with_the_port(tmp_path):
    out = run(tiny_kokoro(), tmp_path)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    for number, row in out["checks"].items():
        assert row["value"] <= 1e-6, (number, row)


@contextlib.contextmanager
def reverse_over_the_bucket():
    """The reverse LSTMs start in the bucket's padding, not at the line's
    last step."""
    from stylish_tts_torch.models import kokoro

    saved = kokoro.reverse_index

    def whole(lengths, size):
        t = torch.arange(size, device=lengths.device)[None, :].expand(lengths.shape[0], -1)
        return size - 1 - t

    kokoro.reverse_index = whole
    try:
        yield
    finally:
        kokoro.reverse_index = saved


@contextlib.contextmanager
def spoken_faster():
    """Every line is spoken at speed 1.25 (each id's 3 frames become 2)."""
    from stylish_tts_torch.export.kokoro import KokoroPackage

    saved = KokoroPackage.generate_speech

    def faster(self, tokens, ref_s, speed=1.0):
        return saved(self, tokens, ref_s, speed=1.25 * speed)

    KokoroPackage.generate_speech = faster
    try:
        yield
    finally:
        KokoroPackage.generate_speech = saved


@contextlib.contextmanager
def the_next_voice_row():
    """The timed path speaks each line with its voicepack's next row; the
    reference picks its own row, so only the comparison can see it."""
    from stylish_tts_torch.export import kokoro

    saved = kokoro.voice_row

    def next_row(pack, n_ids):
        return saved(pack, n_ids + 1)

    kokoro.voice_row = next_row
    try:
        yield
    finally:
        kokoro.voice_row = saved


@pytest.mark.parametrize("fault", [reverse_over_the_bucket, spoken_faster,
                                   the_next_voice_row])
def test_a_planted_fault_makes_correct_false(fault, tmp_path):
    with fault():
        out = run(tiny_kokoro(limits=True), tmp_path)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.gpu
def test_kokoro_control_fails_a_limit_at_the_cells_size(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own size runs on a CUDA card")
    from ttsbench.traffic.kokoro_lines import control as kokoro_control

    cell = load_cell("kokoro.speak_book")
    numbers = kokoro_control(cell, SEED, "cuda")
    assert any(numbers[k] > row["limit"] for k, row in cell.checks.items()), numbers

