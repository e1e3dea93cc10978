"""programs (export/f5.py generate_speech): the program's span
``speak.sample``, from the sample program's replay (the text conditioning
and every guided Euler step of a chunk, one CUDA graph) to its mel on hand,
mean per chunk, in ms."""

from ttsbench import program_spans


def read(run):
    if not run.units:
        return None
    found = program_spans.spans(run)
    if not found or "speak.sample" not in found:
        return None
    return program_spans.total_ms(found, "speak.sample") / run.units
