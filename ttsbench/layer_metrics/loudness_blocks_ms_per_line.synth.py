"""post-processing (tts/loudness.py integrated_loudness): the program's span
``loudness.blocks`` (the 400 ms blocks' mean squares), mean per line, in
ms."""

from ttsbench import program_spans


def read(run):
    if not run.units:
        return None
    found = program_spans.spans(run)
    if not found or "loudness.blocks" not in found:
        return None
    return program_spans.total_ms(found, "loudness.blocks") / run.units
