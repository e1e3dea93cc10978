"""The program's spans and the device trace share one clock: in a traced
window of a speak cell, every device operation of a line starts after the
span that issued it starts (an input copy from the host after the line's
``speak.prep``, every other operation after its first ``program.replay``)
and ends before the line's last ``speak.fetch`` ends. The readers of
``ttsbench/program_spans.py`` rest on it: ``idle_after_sync_ms.train`` sets
the program's spans against the device's idle gaps.

``clock_margins`` on planted spans and operations on the CPU; on a card
(``gpu``-marked), the traced window of ``freegan.speak_book`` at the cell's
own size, its margins printed (``-s``)."""

from __future__ import annotations

import bisect
import json

import pytest
import torch

from stylish_tts_torch.utils import trace
from ttsbench import program_spans

SEED = 2**31 + 977
MARGINS = ("prep_start_to_copy_start", "replay_start_to_op_start", "op_end_to_fetch_end")


def clock_margins(found: dict, device) -> dict:
    """Each device operation ``(start, end, name)`` against the spans of the
    line it starts in (from the start of the line's first ``speak.prep`` to
    that of the next line's): the smallest margin of each order in ns, the
    operations that break one (``misses``) and those that start before the
    first line (``outside``)."""
    lines: dict = {}
    for name in ("speak.prep", "program.replay", "speak.fetch"):
        for s in found.get(name, ()):
            lines.setdefault(s.unit, {}).setdefault(name, []).append(s)
    order = sorted(lines, key=lambda u: min(s.start for s in lines[u]["speak.prep"]))
    starts = [min(s.start for s in lines[u]["speak.prep"]) for u in order]
    margins = {k: [] for k in MARGINS}
    outside = 0
    for start, end, name in device:
        k = bisect.bisect_right(starts, start) - 1
        if k < 0:
            outside += 1
            continue
        line = lines[order[k]]
        if name.startswith("Memcpy HtoD"):
            margins["prep_start_to_copy_start"].append(start - starts[k])
        else:
            replay = min(s.start for s in line["program.replay"])
            margins["replay_start_to_op_start"].append(start - replay)
        margins["op_end_to_fetch_end"].append(max(s.end for s in line["speak.fetch"]) - end)
    return {"lines": len(order), "ops": len(device), "outside": outside,
            "smallest": {k: min(v) for k, v in margins.items() if v},
            "misses": {k: sum(m < 0 for m in v) for k, v in margins.items()}}


def span(name, start, end, unit):
    return trace.Span(name, start, end, 0, None, unit, 1)


# two lines: prep, replay, fetch; the host's loudness step between them
FOUND = {
    "speak.prep": [span("speak.prep", 1000, 1100, 1), span("speak.prep", 5000, 5100, 2)],
    "program.replay": [span("program.replay", 1100, 1300, 1),
                       span("program.replay", 5100, 5300, 2)],
    "speak.fetch": [span("speak.fetch", 1300, 2000, 1), span("speak.fetch", 5300, 6000, 2)],
}
DEVICE = [(1040, 1050, "Memcpy HtoD (Pageable -> Device)"), (1150, 1800, "kernel"),
          (1810, 1900, "Memcpy DtoH (Device -> Pageable)"),
          (5020, 5030, "Memcpy HtoD (Pageable -> Device)"), (5120, 5900, "kernel")]


def test_margins_of_operations_inside_their_spans():
    out = clock_margins(FOUND, DEVICE)
    assert out["lines"] == 2 and out["ops"] == 5 and out["outside"] == 0
    assert out["smallest"] == {"prep_start_to_copy_start": 20,
                               "replay_start_to_op_start": 20, "op_end_to_fetch_end": 100}
    assert not any(out["misses"].values())


@pytest.mark.parametrize("op, missed", [
    ((1090, 1200, "kernel"), "replay_start_to_op_start"),  # before its replay
    ((1500, 2100, "kernel"), "op_end_to_fetch_end"),  # past the line's fetch
    # an input copy stamped before its line's prep: it lands in the line
    # before, past that line's fetch
    ((4990, 4995, "Memcpy HtoD (Pageable -> Device)"), "op_end_to_fetch_end"),
    ((900, 950, "kernel"), None),  # before the first line
])
def test_an_operation_off_its_spans_is_a_miss(op, missed):
    out = clock_margins(FOUND, DEVICE + [op])
    if missed is None:
        assert out["outside"] == 1 and not any(out["misses"].values())
    else:
        assert out["misses"][missed] == 1 and out["outside"] == 0


@pytest.mark.gpu
def test_device_operations_lie_inside_their_lines_spans_on_a_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the clock check reads a traced window on a CUDA card")
    from ttsbench.harness import configure_torch, load_cell
    from ttsbench.traffic.speak_lines import Driver

    configure_torch()
    cell = load_cell("freegan.speak_book")
    driver = Driver(cell.config, cell.traffic, SEED, "cuda", tmp_path)
    driver.setup()
    record = driver.traced_window(cell.traffic["trace_seconds"])
    driver.release()
    found = program_spans.spans(record)
    out = clock_margins(found, record.device)
    print("clock", json.dumps(out))
    assert out["lines"] == record.units >= 10 and out["ops"] > 0, out
    assert out["outside"] == 0 and not any(out["misses"].values()), out
