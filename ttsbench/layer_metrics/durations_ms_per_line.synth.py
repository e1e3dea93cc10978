"""programs (export/kokoro.py generate_speech, the two-phase path): the
program's span ``speak.durations``, from the duration program's replay to
the durations on the host, mean per line, in ms."""

from ttsbench import program_spans


def read(run):
    if not run.units:
        return None
    found = program_spans.spans(run)
    if not found or "speak.durations" not in found:
        return None
    return program_spans.total_ms(found, "speak.durations") / run.units
