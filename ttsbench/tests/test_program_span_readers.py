"""The readers of the program's spans (``ttsbench/program_spans.py``) on
spans planted in the program's buffer and planted device intervals: each
reader's arithmetic, the cut to the traced window, and nothing reported
where the program has no spans or no trace module (a parent commit)."""

from __future__ import annotations

import sys
from collections import deque

import pytest

from stylish_tts_torch.utils import trace
from ttsbench import program_spans
from ttsbench.harness import RunRecord, load_reader

TRAIN = ("host_busy_ms_per_step.train", "sync_wait_ms.train", "idle_after_sync_ms.train",
         "loader_load_ms.train")
SYNTH = ("host_ms_per_line.synth", "loudness_blocks_ms_per_line.synth")


def span(name, start, end, unit=None, parent=None, thread=1):
    return trace.Span(name, start, end, 0, parent, unit, thread)


# two steps in the window [1000, 3000] ns; a step before it, and a load
# that begins before it
TRAIN_SPANS = [
    span("train.step", 100, 900, 0),
    span("loader.load", 900, 1100, 1, thread=2),
    span("train.step", 1000, 2000, 1),
    span("train.sync.finite", 1200, 1300, 1),
    span("loader.put", 1100, 1150, 1, thread=2),
    span("train.sync.ema", 1800, 1900, 1),
    span("loader.load", 1500, 1600, 2, thread=2),
    span("train.step", 2000, 3000, 2),
    span("train.sync.finite", 2500, 2600, 2),
]
# idle gaps: [1250, 1400] holds the end at 1300, [1800, 1950] the end at
# 1900, [2550, 2700] the end at 2600; [1000, 1010] none
TRAIN_DEVICE = [(1010, 1250, "k"), (1400, 1800, "k"), (1950, 2550, "k"), (2700, 3000, "k")]
SYNTH_SPANS = [
    span("speak.line", 1000, 1500, 1),
    span("speak.prep", 1000, 1050, 1),
    span("speak.fetch", 1400, 1500, 1),
    span("loudness.blocks", 1600, 1700),
    span("speak.line", 2000, 2600, 2),
    span("speak.fetch", 2500, 2600, 2),
    span("loudness.blocks", 2700, 2750),
]
EXPECTED = {
    # (1000 + 1000 - 300) / 2 steps
    "host_busy_ms_per_step.train": 850e-6,
    "sync_wait_ms.train": 150e-6,
    "idle_after_sync_ms.train": 225e-6,
    # the load cut to 100 ns, the put 50, the second load 100
    "loader_load_ms.train": 125e-6,
    "host_ms_per_line.synth": 450e-6,
    "loudness_blocks_ms_per_line.synth": 75e-6,
}


def plant(monkeypatch, spans):
    monkeypatch.setattr(trace, "_buffer", deque(spans, maxlen=trace.CAPACITY))


def run(device=()):
    return RunRecord(units=2, window_s=2e-6, device=list(device), lo=1000, hi=3000)


@pytest.mark.parametrize("metric", TRAIN + SYNTH)
def test_each_reader_on_planted_spans(monkeypatch, metric):
    plant(monkeypatch, TRAIN_SPANS if metric in TRAIN else SYNTH_SPANS)
    assert load_reader(metric)(run(TRAIN_DEVICE)) == pytest.approx(EXPECTED[metric])


def test_spans_are_cut_to_the_window(monkeypatch):
    plant(monkeypatch, TRAIN_SPANS)
    found = program_spans.spans(run())
    assert [(s.start, s.end) for s in found["train.step"]] == [(1000, 2000), (2000, 3000)]
    assert [(s.start, s.end) for s in found["loader.load"]] == [(1000, 1100), (1500, 1600)]
    assert sorted(program_spans.named(found, "train.sync.")) == ["train.sync.ema",
                                                                 "train.sync.finite"]


def test_no_reading_without_the_cells_spans(monkeypatch):
    plant(monkeypatch, SYNTH_SPANS)
    for metric in TRAIN:
        assert load_reader(metric)(run(TRAIN_DEVICE)) is None, metric
    plant(monkeypatch, TRAIN_SPANS)
    for metric in SYNTH:
        assert load_reader(metric)(run(TRAIN_DEVICE)) is None, metric
    plant(monkeypatch, [])
    for metric in TRAIN + SYNTH:
        assert load_reader(metric)(run(TRAIN_DEVICE)) is None, metric


def test_no_reading_from_a_program_without_the_trace_module(monkeypatch):
    plant(monkeypatch, TRAIN_SPANS + SYNTH_SPANS)
    # as at a commit without the module: no attribute, no importable module
    monkeypatch.delattr(sys.modules["stylish_tts_torch.utils"], "trace")
    monkeypatch.setitem(sys.modules, "stylish_tts_torch.utils.trace", None)
    assert program_spans.spans(run()) is None
    for metric in TRAIN + SYNTH:
        assert load_reader(metric)(run(TRAIN_DEVICE)) is None, metric
